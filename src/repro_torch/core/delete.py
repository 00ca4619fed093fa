"""Deletion mode: invalidation + recomputation (paper §4.1, Listings 4/8/9);
torch rendering of ``repro.core.delete``.

Invalidation marks the affected subtree T(v) over the implicit parent
forest (children of v are the vertices whose ``parent`` is v):

* ``mark_subtree_flood`` — the paper-faithful wave-by-wave flood (one round
  per tree level), and
* ``mark_subtree_doubling`` — pointer doubling, O(log depth) rounds: each
  round folds ``aff |= aff[ptr]`` and jumps ``ptr := ptr[ptr]``.

Recomputation: affected vertices get ``dist=inf, parent=-1``, *pull* once
from all valid in-neighbours (bulk ``DistanceQuery``), then ordinary
monotone push relaxation re-converges.

Like ``core/relax.py``, the reference's ``lax.while_loop``s become Python
loops that read their condition back once per round.  An epoch whose seed is
empty (a non-tree deletion) returns at once with zero stats after one
``any(seed)`` read; the reference runs the no-op epoch on device and gates
every stat on ``any(seed)``, which gives the same state and the same stats.

Every function also takes a lane stack (``[S, N]`` trees and seeds over the
shared pool; the reference vmaps these epochs).  A lane with no seed is
gated out of the marking (``gate``) and counts no round, as under the
reference's vmapped loops, and each loop still reads one flag vector per
round for all lanes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import relax
from repro_torch.core.relax import BIG, segment_min
from repro_torch.core.state import INF, NO_PARENT, EdgePool, SSSPState


class DeleteStats(NamedTuple):
    invalidation_rounds: int | np.ndarray   # i64[S] for lanes
    affected: torch.Tensor        # i64[] or [S] — |T|, size of the subtree
    recompute_rounds: int | np.ndarray
    recompute_messages: torch.Tensor


Step = Callable[[torch.Tensor, torch.Tensor],
                tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _mark_loop(step: Step, aff: torch.Tensor, ptr: torch.Tensor,
               gate: bool | np.ndarray | None
               ) -> tuple[torch.Tensor, int | np.ndarray]:
    """Run ``step(aff, ptr) -> (aff, ptr, grew)`` while a lane grows,
    counting each lane's rounds while its own ``grew & gate`` held (the
    reference's loop condition; ``gate`` None = every lane).  One flag read
    per round.  A lane that stopped growing is a fixed point of ``step``
    and a gated-out lane has an empty seed, whose marking stays empty, so
    the whole stack steps together and only the counts are per lane.
    The loop is the ``mark`` phase span of an enabled epoch, its passes
    the span's ``iterations``."""
    rounds = relax.no_rounds(aff)
    live = (np.ones(aff.shape[:-1], bool) if gate is None
            else np.asarray(gate))
    passes = 0
    with obs_mod.phase("mark") as span:
        while live.any():
            aff, ptr, grew = step(aff, ptr)
            rounds += live if aff.dim() == 2 else int(live)
            live = live & relax.host(grew)
            passes += 1
        if span is not None:
            span.iterations = passes
    return aff, rounds


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` within each lane (``idx`` shaped like ``t``)."""
    return t.gather(-1, idx.long())


def mark_subtree_flood(parent: torch.Tensor, seed: torch.Tensor,
                       gate: bool | np.ndarray | None = None
                       ) -> tuple[torch.Tensor, int | np.ndarray]:
    """Paper-faithful successor flood. ``seed``: bool[N] (or [S, N]).
    Returns (aff, rounds)."""
    has = parent >= 0
    safe = parent.clamp(min=0)

    def step(aff, ptr):
        # a vertex joins T if its parent is already in T
        new = aff | (has & _gather(aff, safe))
        return new, ptr, (new != aff).any(-1)

    return _mark_loop(step, seed, parent, gate)


def mark_subtree_doubling(parent: torch.Tensor, seed: torch.Tensor,
                          gate: bool | np.ndarray | None = None
                          ) -> tuple[torch.Tensor, int | np.ndarray]:
    """Pointer-doubling descendant marking: O(log depth) rounds.  The loop
    runs until the pointers are fully collapsed even when ``aff`` stops
    growing mid-way (gap distributions can stall a round and resume)."""

    def step(aff, ptr):
        valid = ptr >= 0
        safe = ptr.clamp(min=0)
        new_aff = aff | (valid & _gather(aff, safe))
        # double: ptr := ptr[ptr] (stays -1 once off-tree)
        nxt = torch.where(valid, _gather(ptr, safe), NO_PARENT)
        return new_aff, nxt, (new_aff != aff).any(-1) | (nxt != ptr).any(-1)

    return _mark_loop(step, seed, parent, gate)


def pull_once(dist: torch.Tensor, parent: torch.Tensor, edges: EdgePool,
              aff: torch.Tensor, num_vertices: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bulk DistanceQuery wave (Listing 9): affected vertices pull their
    best offer from valid (finite-dist) in-neighbours.  Returns
    (dist', parent', improved) — the improved mask is the push frontier the
    recomputation continues from."""
    src_d = dist[..., edges.src]
    live = edges.active & aff[..., edges.dst] & torch.isfinite(src_d)
    cand = torch.where(live, src_d + edges.w, INF)
    best = segment_min(cand, edges.dst, num_vertices, INF)
    improved = best < dist
    hit = live & (cand == best[..., edges.dst]) & improved[..., edges.dst]
    new_parent = segment_min(torch.where(hit, edges.src, BIG), edges.dst,
                             num_vertices, BIG)
    return (torch.where(improved, best, dist),
            torch.where(improved, new_parent, parent), improved)


def invalidate(sssp: SSSPState, seed: torch.Tensor, *, use_doubling: bool,
               gate: bool | np.ndarray | None = None
               ) -> tuple[torch.Tensor, int | np.ndarray, torch.Tensor,
                          torch.Tensor]:
    """The layout-free half of a deletion epoch, shared by every backend:
    mark T (in the lanes ``gate`` lets through), never the source itself,
    and reset it.  Returns (aff, invalidation_rounds, dist, parent)."""
    mark = mark_subtree_doubling if use_doubling else mark_subtree_flood
    aff, rounds = mark(sssp.parent, seed, gate)
    vid = torch.arange(seed.shape[-1], device=seed.device)
    aff = aff & (vid != sssp.source[..., None])
    return (aff, rounds, torch.where(aff, INF, sssp.dist),
            torch.where(aff, NO_PARENT, sssp.parent))


def empty_delete_stats(seed: torch.Tensor) -> DeleteStats:
    """All-zero stats for the lanes of ``seed``."""
    zero = torch.zeros(seed.shape[:-1], dtype=torch.int64, device=seed.device)
    rounds = relax.no_rounds(seed)
    return DeleteStats(rounds, zero, rounds, zero)


def recompute_stats(aff: torch.Tensor, inv_rounds, improved: torch.Tensor,
                    stats: relax.RelaxStats,
                    any_seed: bool | np.ndarray) -> DeleteStats:
    """A deletion epoch's stats: the bulk pull counts as one recompute
    round in every lane that had a seed (the reference gates it on
    ``any(seed)``), its improvements as messages."""
    return DeleteStats(
        invalidation_rounds=inv_rounds,
        affected=aff.sum(-1),
        recompute_rounds=stats.rounds + any_seed,
        recompute_messages=stats.messages + improved.sum(-1))


def invalidate_and_recompute(sssp: SSSPState, edges: EdgePool,
                             seed: torch.Tensor, *, num_vertices: int,
                             use_doubling: bool = True
                             ) -> tuple[SSSPState, DeleteStats]:
    """Full deletion epoch given invalidation seeds (bool[N]).

    ``seed`` marks heads of deleted tree edges (possibly several — a batched
    run of deletions invalidates the union of subtrees before any
    recomputation starts).
    """
    any_seed = relax.host_flags(seed)
    if not np.any(any_seed):
        return sssp, empty_delete_stats(seed)
    aff, inv_rounds, dist, parent = invalidate(
        sssp, seed, use_doubling=use_doubling, gate=any_seed)
    # Bulk DistanceQuery into affected vertices only, then ordinary monotone
    # relaxation from the re-seeded vertices drains the epoch.
    dist, parent, improved = pull_once(dist, parent, edges, aff, num_vertices)
    state, stats = relax.relax_until_converged(
        SSSPState(dist=dist, parent=parent, source=sssp.source), edges,
        improved, num_vertices=num_vertices)
    return state, recompute_stats(aff, inv_rounds, improved, stats, any_seed)


def deletion_seed_for_edges(sssp: SSSPState, del_src: torch.Tensor,
                            del_dst: torch.Tensor, num_vertices: int
                            ) -> torch.Tensor:
    """Listing 4: only deletions of *tree* edges (parent[head]==tail) seed
    invalidation; non-tree deletions need no algorithmic work.  A lane
    stack gets one seed per lane (``[S, N]``; the reference's
    ``deletion_seed_for_edges_batched``): whether a deleted edge is a tree
    edge depends on each lane's parent forest."""
    safe = del_dst.clamp(0, num_vertices - 1)
    is_tree = sssp.parent[..., safe] == del_src
    return relax.mark_vertices(safe, is_tree & (del_dst >= 0), num_vertices)


# the reference's vmapped lane-stack entry point: the function above takes
# [S, N] lanes itself
deletion_seed_for_edges_batched = deletion_seed_for_edges
