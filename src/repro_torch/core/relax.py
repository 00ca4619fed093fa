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
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.state import INF, EdgePool, SSSPState

BIG = 2**31 - 1   # "no candidate" key of the smallest-src-id pass


class RelaxStats(NamedTuple):
    rounds: int              # BSP rounds until convergence
    messages: torch.Tensor   # i64[] — DistanceUpdate deliveries (improvements)


def segment_min(vals: torch.Tensor, seg: torch.Tensor, num_segments: int,
                fill: float | int) -> torch.Tensor:
    """``jax.ops.segment_min``: per-segment min, ``fill`` where a segment is
    empty (+inf for values, ``BIG`` for the src-id key pass)."""
    out = torch.full((num_segments,), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, seg.long(), vals, "amin", include_self=True)


def relax_round(dist: torch.Tensor, parent: torch.Tensor, edges: EdgePool,
                frontier: torch.Tensor, *, num_vertices: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bulk message wave. Returns (dist, parent, new_frontier)."""
    live = edges.active & frontier[edges.src]
    cand = torch.where(live, dist[edges.src] + edges.w, INF)
    best = segment_min(cand, edges.dst, num_vertices, INF)
    improved = best < dist
    # argmin edge per dst, tie-break by smallest src id (deterministic; the
    # same rule every backend and the kernel apply)
    hit = live & (cand == best[edges.dst]) & improved[edges.dst]
    cand_key = torch.where(hit, edges.src, BIG)
    new_parent = segment_min(cand_key, edges.dst, num_vertices, BIG)
    dist = torch.where(improved, best, dist)
    parent = torch.where(improved, new_parent, parent)
    return dist, parent, improved


Wave = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def converged_loop(dist: torch.Tensor, parent: torch.Tensor,
                   frontier: torch.Tensor, wave: Wave
                   ) -> tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
    """The shared wave-to-fixpoint driver: loop ``wave(dist, parent,
    frontier) -> (dist, parent, improved)`` while the frontier is non-empty.
    Returns (dist, parent, rounds, messages) with the reference's counting:
    one round per executed wave, one message per improvement."""
    rounds = 0
    msgs = torch.zeros((), dtype=torch.int64, device=dist.device)
    while bool(frontier.any()):   # the per-wave host sync
        dist, parent, frontier = wave(dist, parent, frontier)
        msgs += frontier.sum()
        rounds += 1
    return dist, parent, rounds, msgs


def relax_until_converged(sssp: SSSPState, edges: EdgePool,
                          frontier: torch.Tensor, *, num_vertices: int
                          ) -> tuple[SSSPState, RelaxStats]:
    """Run rounds until fixpoint (== the paper's epoch drain; it terminates:
    distances strictly decrease and are bounded below).  The reference's
    ``max_rounds`` bound serves only its sharded straggler path and comes
    with the sharded engine."""

    def wave(dist, parent, frontier):
        return relax_round(dist, parent, edges, frontier,
                           num_vertices=num_vertices)

    dist, parent, rounds, msgs = converged_loop(
        sssp.dist, sssp.parent, frontier, wave)
    return (SSSPState(dist=dist, parent=parent, source=sssp.source),
            RelaxStats(rounds=rounds, messages=msgs))


def mark_vertices(vertices: torch.Tensor, upd: torch.Tensor,
                  num_vertices: int) -> torch.Tensor:
    """bool[N] with ``vertices[i]`` set where ``upd[i]`` — the reference's
    ``f.at[v].max(upd)``.  A max-reduce, not an assignment: a repeated
    vertex whose copies disagree stays set, whatever the write order."""
    f = torch.zeros(num_vertices, dtype=torch.uint8, device=vertices.device)
    f.scatter_reduce_(0, vertices.long(), upd.to(torch.uint8), "amax")
    return f.bool()


def frontier_from_vertices(vertices: torch.Tensor,
                           num_vertices: int) -> torch.Tensor:
    """Boolean frontier from a (possibly padded with -1) vertex id list."""
    return mark_vertices(vertices.clamp(0, num_vertices - 1), vertices >= 0,
                         num_vertices)
