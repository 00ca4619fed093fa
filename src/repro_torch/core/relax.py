"""Monotone (insertion-mode) relaxation — the bulk equivalent of the paper's
``DistanceUpdate`` flood (Listing 3/5); torch rendering of
``repro.core.relax``.

One *round* delivers every in-flight ``DistanceUpdate`` simultaneously:

    cand_e  = dist[src_e] + w_e                (for active, frontier-masked e)
    best_v  = min over {e : dst_e == v} cand_e (scatter-min)
    improved_v = best_v < dist_v
    parent_v  := src of an edge attaining best_v (ties -> smallest src id)

and the engine loops rounds until no vertex improves.  Monotonicity of the
paper's insertion mode makes this reordering exact: the fixpoint is the same
as under any asynchronous delivery order.

The reference drives the loop with ``lax.while_loop`` on device.  Eager torch
has no counterpart, so ``converged_loop`` is a Python loop that reads the
loop condition (``frontier.any()``) back to the host once per wave — the
per-wave host sync this port pays.  Rounds are therefore host integers;
message counts stay device tensors until a query reads them.

Lanes: every function here also takes a stack of S trees — ``dist``,
``parent`` and the frontier ``[S, N]`` over ONE shared edge pool (the
batched multi-source engine; the reference vmaps its epochs over the
source axis).  ``converged_loop`` then reads the S lanes' flags back in one
sync per wave and advances a lane's round count only while that lane's own
frontier is non-empty, as the reference's vmapped ``while_loop`` freezes a
finished lane's carry; a wave over an empty frontier changes nothing, so
the finished lanes ride along unchanged.

The straggler bound (``max_rounds``, DESIGN.md §7): a bounded epoch stops
after ``max_rounds`` waves and is re-issued with the improved frontier
until it converges; 0 = unbounded.  Monotone relaxation is idempotent, so
the re-issued sequence reaches the unbounded epoch's fixpoint.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core.state import INF, EdgePool, SSSPState

BIG = 2**31 - 1   # "no candidate" key of the smallest-src-id pass


class RelaxStats(NamedTuple):
    rounds: int | np.ndarray  # BSP rounds until convergence (i64[S] lanes)
    messages: torch.Tensor    # i64[] or [S] — DistanceUpdate deliveries


def host(flags: torch.Tensor) -> bool | np.ndarray:
    """Per-lane flags read back to the host in ONE sync: a bool for a 0-d
    tensor, a bool[S] array for an [S] one.  Every loop condition of the
    eager epochs is read through here or ``host_flags``; inside an enabled
    epoch the read and the host time it blocked count on the innermost
    open span (``repro_torch.obs``)."""
    obs = obs_mod.ACTIVE
    if obs is None:
        return bool(flags) if flags.dim() == 0 else flags.cpu().numpy()
    t0 = time.perf_counter_ns()
    out = bool(flags) if flags.dim() == 0 else flags.cpu().numpy()
    obs.tracer.read(time.perf_counter_ns() - t0)
    return out


def host_flags(mask: torch.Tensor) -> bool | np.ndarray:
    """``mask.any(-1)`` read back in one sync: whether each lane's mask
    (``[N]`` or ``[S, N]``) has a set entry."""
    return host(mask.any(-1))


def no_rounds(like: torch.Tensor) -> int | np.ndarray:
    """A zero round count shaped like ``like``'s lanes."""
    return 0 if like.dim() == 1 else np.zeros(like.shape[0], np.int64)


def segment_min(vals: torch.Tensor, seg: torch.Tensor, num_segments: int,
                fill: float | int) -> torch.Tensor:
    """``jax.ops.segment_min`` over the last axis: per-segment min, ``fill``
    where a segment is empty (+inf for values, ``BIG`` for the src-id key
    pass).  ``vals`` may carry leading lane axes; ``seg`` is shared."""
    out = torch.full((*vals.shape[:-1], num_segments), fill,
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(-1, seg.long().expand_as(vals), vals, "amin",
                               include_self=True)


def relax_round(dist: torch.Tensor, parent: torch.Tensor, edges: EdgePool,
                frontier: torch.Tensor, *, num_vertices: int,
                tie_perm: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bulk message wave ([N] or [S, N] lanes over the shared pool).
    Returns (dist, parent, new_frontier).

    ``tie_perm`` (i32[N], a permutation) overrides the tie order: the
    parent is the minimizing src whose ``tie_perm[src]`` is smallest (a
    second segment-min picks that src among the winners).  The
    ReMo-from-scratch baseline draws one per query to model the async
    runtime's arbitrary choice among equally short trees (paper §5.4)."""
    live = edges.active & frontier[..., edges.src]
    cand = torch.where(live, dist[..., edges.src] + edges.w, INF)
    best = segment_min(cand, edges.dst, num_vertices, INF)
    improved = best < dist
    # argmin edge per dst, tie-break by smallest src id (deterministic; the
    # same rule every backend and the kernel apply)
    hit = live & (cand == best[..., edges.dst]) & improved[..., edges.dst]
    key = edges.src if tie_perm is None else tie_perm[edges.src.long()]
    cand_key = torch.where(hit, key, BIG)
    new_parent = segment_min(cand_key, edges.dst, num_vertices, BIG)
    if tie_perm is not None:
        win = hit & (cand_key == new_parent[..., edges.dst])
        new_parent = segment_min(torch.where(win, edges.src, BIG),
                                 edges.dst, num_vertices, BIG)
    dist = torch.where(improved, best, dist)
    parent = torch.where(improved, new_parent, parent)
    return dist, parent, improved


Wave = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def converged_loop(dist: torch.Tensor, parent: torch.Tensor,
                   frontier: torch.Tensor, wave: Wave, *,
                   max_rounds: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, int | np.ndarray,
                              torch.Tensor]:
    """The shared wave-to-fixpoint driver: loop ``wave(dist, parent,
    frontier) -> (dist, parent, improved)`` while the frontier is non-empty,
    for at most ``max_rounds`` waves when that is positive.  Returns (dist,
    parent, rounds, messages) with the reference's counting: one round per
    executed wave, one message per improvement — per lane for an [S, N]
    stack, where a lane counts a round only while its own frontier is
    non-empty (one flag read per wave for all S lanes).

    The reference bounds each vmapped lane by its own ``rounds <
    max_rounds``.  A lane whose frontier empties stays empty, so every lane
    still going has run every wave so far and its round count is the wave
    count: stopping the loop after ``max_rounds`` waves freezes each lane
    where its own bound would, and no lane past its bound is relaxed
    again.  The bound is checked before the flag read, so a bounded epoch
    reads the host no more often than an unbounded one.  The loop is the
    ``waves`` phase span of an enabled epoch, its waves the span's
    ``iterations``."""
    rounds = no_rounds(dist)
    msgs = torch.zeros(dist.shape[:-1], dtype=torch.int64, device=dist.device)
    frontier = frontier.expand(dist.shape)   # an ADD frontier is shared
    waves = 0
    with obs_mod.phase("waves") as span:
        while not (max_rounds and waves >= max_rounds):
            go = host_flags(frontier)   # the per-wave host sync
            if not np.any(go):
                break
            dist, parent, frontier = wave(dist, parent, frontier)
            msgs += frontier.sum(-1)
            rounds += go
            waves += 1
        if span is not None:
            span.iterations = waves
    return dist, parent, rounds, msgs


def relax_until_converged(sssp: SSSPState, edges: EdgePool,
                          frontier: torch.Tensor, *, num_vertices: int,
                          max_rounds: int = 0,
                          tie_perm: torch.Tensor | None = None
                          ) -> tuple[SSSPState, RelaxStats]:
    """Run rounds until fixpoint (== the paper's epoch drain; it terminates:
    distances strictly decrease and are bounded below), or for at most
    ``max_rounds`` rounds when that is positive (the straggler bound,
    ``converged_loop``), with ``relax_round``'s ``tie_perm``.  The sharded
    engine bounds its epochs through ``DistConfig.max_rounds``."""

    def wave(dist, parent, frontier):
        return relax_round(dist, parent, edges, frontier,
                           num_vertices=num_vertices, tie_perm=tie_perm)

    dist, parent, rounds, msgs = converged_loop(
        sssp.dist, sssp.parent, frontier, wave, max_rounds=max_rounds)
    return (SSSPState(dist=dist, parent=parent, source=sssp.source),
            RelaxStats(rounds=rounds, messages=msgs))


def full_frontier(num_vertices: int, device: torch.device | str = "cuda"
                  ) -> torch.Tensor:
    """Every vertex in the frontier: bool[N] of ones on ``device``."""
    return torch.ones(num_vertices, dtype=torch.bool, device=device)


def mark_vertices(vertices: torch.Tensor, upd: torch.Tensor,
                  num_vertices: int) -> torch.Tensor:
    """bool[N] with ``vertices[i]`` set where ``upd[i]`` — the reference's
    ``f.at[v].max(upd)``; ``[S, N]`` where ``upd`` is ``[S, m]`` (one mask
    per lane over the shared ids).  A max-reduce, not an assignment: a
    repeated vertex whose copies disagree stays set, whatever the write
    order."""
    f = torch.zeros((*upd.shape[:-1], num_vertices), dtype=torch.uint8,
                    device=vertices.device)
    f.scatter_reduce_(-1, vertices.long().expand(upd.shape),
                      upd.to(torch.uint8), "amax")
    return f.bool()


def frontier_from_vertices(vertices: torch.Tensor,
                           num_vertices: int) -> torch.Tensor:
    """Boolean frontier from a (possibly padded with -1) vertex id list."""
    return mark_vertices(vertices.clamp(0, num_vertices - 1), vertices >= 0,
                         num_vertices)
