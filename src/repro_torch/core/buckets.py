"""Bucketed (delta-stepping) wave schedule — torch rendering of
``repro.core.buckets``.

The rounds schedule (core/relax.py) settles every epoch to fixpoint.  The
bucketed schedule defers that work: insertion-mode relaxation is monotone,
so any delivery order reaches the same fixpoint.

  * ingest epochs do only what correctness needs at once: a deletion runs
    invalidation (seed -> mark -> SetToInfinity) right away and defers the
    recomputation pull and every push wave; an insertion only enqueues its
    tails as push obligations;
  * the deferred work lives in a ``PendingState``: ``push`` marks vertices
    whose current distance has not been offered to their out-neighbours
    yet, ``pull`` marks invalidated vertices awaiting their bulk
    DistanceQuery;
  * a *drain* (at query / checkpoint) settles the pending set one bucket at
    a time: each wave activates only the pending vertices whose distance
    lies in the lowest nonempty bucket ``[q*w, (q+1)*w)``.

The drained ``dist`` is the unique fixpoint of the monotone Bellman
operator over the live edges, so it equals the rounds schedule's bit for
bit; parents follow from the shared smallest-src-id rule.  Round accounting
counts executed waves, as the rounds schedule does, but the totals of the
two schedules differ.

The reference's ``lax.while_loop`` advances buckets with no host sync;
here ``run_drain`` reads the pending flags back once per wave (one read for
all lanes of an ``[S, N]`` stack, whose finished lanes count no further
round, as under the reference's vmapped loop), so rounds are host
integers.  Every function takes one tree (``[N]`` masks) or a lane stack
(``[S, N]``); the reference's ``*_batched`` entry points are the same
functions here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import delete as del_mod
from repro_torch.core import ingest, relax
from repro_torch.core.relax import RelaxStats
from repro_torch.core.state import INF, EdgePool, SSSPState

WAVE_SCHEDULES = ("rounds", "buckets")


@dataclasses.dataclass
class PendingState:
    """Deferred-work masks carried across bucketed epochs (bool[N] each, or
    [S, N] on a batched multi-source engine)."""

    push: torch.Tensor   # settled-but-unoffered vertices (push obligations)
    pull: torch.Tensor   # invalidated vertices awaiting the bulk DistanceQuery


def empty_pending(num_vertices: int, num_sources: int | None = None,
                  device: torch.device | str = "cpu") -> PendingState:
    shape = ((num_vertices,) if num_sources is None
             else (num_sources, num_vertices))
    return PendingState(push=torch.zeros(shape, dtype=torch.bool,
                                         device=device),
                        pull=torch.zeros(shape, dtype=torch.bool,
                                         device=device))


def pending_occupancy(pend: PendingState) -> tuple[torch.Tensor, torch.Tensor]:
    """Device occupancy of the pending masks — (push, pull) counts as i32
    scalars, or [S] vectors on a batched engine; the engine folds them into
    its obs counters at drain entry (no host read)."""
    return (pend.push.sum(-1, dtype=torch.int32),
            pend.pull.sum(-1, dtype=torch.int32))


def bucket_limit(cur: torch.Tensor, bucket_width: float) -> torch.Tensor:
    """Exclusive upper bound of the lowest nonempty bucket given the minimum
    pending distance ``cur``: ``(floor(cur / w) + 1) * w`` in f32.  XLA
    rewrites the reference's division by its static width into a product
    with the f32 reciprocal, which rounds differently for widths such as
    0.3; the port computes that product, so every limit matches the
    reference's bit for bit.  ``bucket_width=inf`` degenerates to one
    all-encompassing bucket (== the plain converge drain)."""
    width = np.float32(bucket_width)
    recip = np.float32(1.0) / width   # f32 scalars: exact as torch operands
    return (torch.floor(cur * float(recip)) + 1.0) * float(width)


def bucket_active(dist: torch.Tensor, push: torch.Tensor,
                  bucket_width: float) -> torch.Tensor:
    """Active mask for one drain wave: pending vertices inside each lane's
    lowest nonempty bucket.  The strict-progress guard ``dist == cur`` keeps
    the minimum pending vertex active even if float rounding ever lands the
    bucket limit at or below ``cur``."""
    cur = torch.where(push, dist, INF).amin(-1, keepdim=True)
    limit = bucket_limit(cur, bucket_width)
    return push & ((dist < limit) | (dist == cur))


def enqueue_push(pend: PendingState, frontier: torch.Tensor,
                 dist: torch.Tensor) -> PendingState:
    """Fold an ADD epoch's frontier (inserted-edge tails) into the pending
    push set — 'relax from the tails', deferred.  Unreachable tails
    (dist=inf) are pruned: if a later wave improves them, the improved mask
    re-enqueues them.  ``frontier`` is the shared [N] tail mask; ``dist``
    may be [N] or [S, N] (broadcasts)."""
    return PendingState(push=pend.push | (frontier & torch.isfinite(dist)),
                        pull=pend.pull)


# ------------------------------------------------------------ lazy deletion --
def lazy_invalidate(sssp: SSSPState, pend: PendingState,
                    del_src: torch.Tensor, del_dst: torch.Tensor, *,
                    num_vertices: int, use_doubling: bool
                    ) -> tuple[SSSPState, PendingState, del_mod.DeleteStats]:
    """Invalidation-only deletion epoch (the reference's
    ``_lazy_invalidate_one``, vmapped there for lanes): seed from the
    CURRENT witness forest, mark the dependent subtree in the lanes with a
    seed, SetToInfinity — and defer the recomputation into the pending
    state.  Correct on a partially settled tree because ``parent`` always
    witnesses ``dist`` over live edges."""
    seed = del_mod.deletion_seed_for_edges(sssp, del_src, del_dst,
                                           num_vertices)
    any_seed = relax.host_flags(seed)
    if not np.any(any_seed):
        return sssp, pend, del_mod.empty_delete_stats(seed)
    aff, inv_rounds, dist, parent = del_mod.invalidate(
        sssp, seed, use_doubling=use_doubling, gate=any_seed)
    # invalidated vertices stop offering; they re-enter via the drain pull
    pend = PendingState(push=pend.push & torch.isfinite(dist),
                        pull=pend.pull | aff)
    zero = torch.zeros(seed.shape[:-1], dtype=torch.int64, device=seed.device)
    stats = del_mod.DeleteStats(
        invalidation_rounds=inv_rounds, affected=aff.sum(-1),
        recompute_rounds=relax.no_rounds(seed), recompute_messages=zero)
    return SSSPState(dist=dist, parent=parent, source=sssp.source), pend, stats


def lazy_delete(sssp: SSSPState, edges: EdgePool, pend: PendingState,
                del_src: torch.Tensor, del_dst: torch.Tensor,
                slots: torch.Tensor, *, num_vertices: int,
                use_doubling: bool = True):
    """One deletion event of the bucketed schedule: deactivate the slots (in
    place), seed + mark + invalidate, update the pending masks.  The pool
    is shared by all lanes; seeds and marks are per lane."""
    ingest.apply_dels(edges, slots)
    sssp, pend, stats = lazy_invalidate(
        sssp, pend, del_src, del_dst, num_vertices=num_vertices,
        use_doubling=use_doubling)
    return sssp, edges, pend, stats


Wave = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


# ------------------------------------------------------------------- drains --
def run_drain(dist: torch.Tensor, parent: torch.Tensor, pend: PendingState,
              *, bucket_width: float, wave: Wave, pull_wave: Wave
              ) -> tuple[torch.Tensor, torch.Tensor, RelaxStats]:
    """Generic drain loop, shared by every backend's drain.

    ``wave(dist, parent, active) -> (dist', parent', improved)`` is one
    frontier-masked relaxation wave; ``pull_wave(dist, parent, aff)`` is the
    backend's bulk DistanceQuery into the accumulated invalidated set.  Both
    evaluate the same candidate sets with the same smallest-src-id tie rule
    in every backend, so the wave sequence — hence (dist, parent) AND the
    round/message counters — is bit-identical across backends.

    One pull (a round in each lane that had anything to pull; a lane with
    nothing to pull gets no improvement from it), then threshold-paced
    waves: the bucket limit is recomputed from each lane's minimum pending
    distance every wave, so settling the lowest bucket and advancing to
    the next is emergent.  The wave loop is the ``waves`` phase span of an
    enabled epoch, as ``relax.converged_loop``'s."""
    any_pull = relax.host_flags(pend.pull)
    rounds = relax.no_rounds(dist) + any_pull
    push = pend.push
    msgs = torch.zeros(dist.shape[:-1], dtype=torch.int64, device=dist.device)
    if np.any(any_pull):
        dist, parent, imp = pull_wave(dist, parent, pend.pull)
        push = push | imp
        msgs += imp.sum(-1)
    waves = 0
    with obs_mod.phase("waves") as span:
        while True:
            go = relax.host_flags(push)   # the per-wave host sync
            if not np.any(go):
                break
            active = bucket_active(dist, push, bucket_width)
            dist, parent, improved = wave(dist, parent, active)
            push = (push & ~active) | improved
            msgs += improved.sum(-1)
            rounds += go
            waves += 1
        if span is not None:
            span.iterations = waves
    return dist, parent, RelaxStats(rounds=rounds, messages=msgs)


def drained(sssp: SSSPState, pend: PendingState, dist: torch.Tensor,
            parent: torch.Tensor) -> tuple[SSSPState, PendingState]:
    """The settled state and an empty pending set, after a drain."""
    return (SSSPState(dist=dist, parent=parent, source=sssp.source),
            PendingState(push=torch.zeros_like(pend.push),
                         pull=torch.zeros_like(pend.pull)))


def segment_drain(sssp: SSSPState, edges: EdgePool, pend: PendingState, *,
                  num_vertices: int, bucket_width: float
                  ) -> tuple[SSSPState, PendingState, RelaxStats]:
    """COO scatter-min drain (the segment backend's bucketed settle)."""

    def wave(dist, parent, active):
        return relax.relax_round(dist, parent, edges, active,
                                 num_vertices=num_vertices)

    def pull_wave(dist, parent, aff):
        return del_mod.pull_once(dist, parent, edges, aff, num_vertices)

    dist, parent, stats = run_drain(
        sssp.dist, sssp.parent, pend, bucket_width=bucket_width,
        wave=wave, pull_wave=pull_wave)
    return (*drained(sssp, pend, dist, parent), stats)


# the reference's vmapped lane-stack entry points: the functions above take
# [S, N] lanes themselves
lazy_delete_batched = lazy_delete
segment_drain_batched = segment_drain
