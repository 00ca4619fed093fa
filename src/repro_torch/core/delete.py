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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import relax
from repro_torch.core.relax import BIG, segment_min
from repro_torch.core.state import INF, NO_PARENT, EdgePool, SSSPState


class DeleteStats(NamedTuple):
    invalidation_rounds: int
    affected: torch.Tensor        # i64[] — |T|, size of invalidated subtree
    recompute_rounds: int
    recompute_messages: torch.Tensor


def mark_subtree_flood(parent: torch.Tensor, seed: torch.Tensor
                       ) -> tuple[torch.Tensor, int]:
    """Paper-faithful successor flood. ``seed``: bool[N]. Returns (aff, rounds)."""
    has = parent >= 0
    safe = parent.clamp(min=0)
    aff, rounds = seed, 0
    while True:
        # a vertex joins T if its parent is already in T
        new = aff | (has & aff[safe])
        rounds += 1
        grew = bool((new != aff).any())
        aff = new
        if not grew:
            return aff, rounds


def mark_subtree_doubling(parent: torch.Tensor, seed: torch.Tensor
                          ) -> tuple[torch.Tensor, int]:
    """Pointer-doubling descendant marking: O(log depth) rounds.  The loop
    runs until the pointers are fully collapsed even when ``aff`` stops
    growing mid-way (gap distributions can stall a round and resume)."""
    aff, ptr, rounds = seed, parent, 0
    while True:
        valid = ptr >= 0
        safe = ptr.clamp(min=0)
        new_aff = aff | (valid & aff[safe])
        # double: ptr := ptr[ptr] (stays -1 once off-tree)
        nxt = torch.where(valid, ptr[safe], NO_PARENT)
        rounds += 1
        grew = bool((new_aff != aff).any() | (nxt != ptr).any())
        aff, ptr = new_aff, nxt
        if not grew:
            return aff, rounds


def pull_once(dist: torch.Tensor, parent: torch.Tensor, edges: EdgePool,
              aff: torch.Tensor, num_vertices: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bulk DistanceQuery wave (Listing 9): affected vertices pull their
    best offer from valid (finite-dist) in-neighbours.  Returns
    (dist', parent', improved) — the improved mask is the push frontier the
    recomputation continues from."""
    src_d = dist[edges.src]
    live = edges.active & aff[edges.dst] & torch.isfinite(src_d)
    cand = torch.where(live, src_d + edges.w, INF)
    best = segment_min(cand, edges.dst, num_vertices, INF)
    improved = best < dist
    hit = live & (cand == best[edges.dst]) & improved[edges.dst]
    new_parent = segment_min(torch.where(hit, edges.src, BIG), edges.dst,
                             num_vertices, BIG)
    return (torch.where(improved, best, dist),
            torch.where(improved, new_parent, parent), improved)


def invalidate(sssp: SSSPState, seed: torch.Tensor, *, use_doubling: bool
               ) -> tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """The layout-free half of a deletion epoch, shared by every backend:
    mark T, never the source itself, and reset it.  Returns
    (aff, invalidation_rounds, dist, parent)."""
    mark = mark_subtree_doubling if use_doubling else mark_subtree_flood
    aff, rounds = mark(sssp.parent, seed)
    aff[sssp.source.long()] = False
    return (aff, rounds, torch.where(aff, INF, sssp.dist),
            torch.where(aff, NO_PARENT, sssp.parent))


def empty_delete_stats(device: torch.device) -> DeleteStats:
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return DeleteStats(0, zero, 0, zero)


def invalidate_and_recompute(sssp: SSSPState, edges: EdgePool,
                             seed: torch.Tensor, *, num_vertices: int,
                             use_doubling: bool = True
                             ) -> tuple[SSSPState, DeleteStats]:
    """Full deletion epoch given invalidation seeds (bool[N]).

    ``seed`` marks heads of deleted tree edges (possibly several — a batched
    run of deletions invalidates the union of subtrees before any
    recomputation starts).
    """
    if not bool(seed.any()):
        return sssp, empty_delete_stats(seed.device)
    aff, inv_rounds, dist, parent = invalidate(sssp, seed,
                                               use_doubling=use_doubling)
    # Bulk DistanceQuery into affected vertices only, then ordinary monotone
    # relaxation from the re-seeded vertices drains the epoch.
    dist, parent, improved = pull_once(dist, parent, edges, aff, num_vertices)
    state, stats = relax.relax_until_converged(
        SSSPState(dist=dist, parent=parent, source=sssp.source), edges,
        improved, num_vertices=num_vertices)
    return state, DeleteStats(
        invalidation_rounds=inv_rounds,
        affected=aff.sum(),
        recompute_rounds=stats.rounds + 1,
        recompute_messages=stats.messages + improved.sum())


def deletion_seed_for_edges(sssp: SSSPState, del_src: torch.Tensor,
                            del_dst: torch.Tensor, num_vertices: int
                            ) -> torch.Tensor:
    """Listing 4: only deletions of *tree* edges (parent[head]==tail) seed
    invalidation; non-tree deletions need no algorithmic work."""
    safe = del_dst.clamp(0, num_vertices - 1)
    is_tree = sssp.parent[safe] == del_src
    return relax.mark_vertices(safe, is_tree & (del_dst >= 0), num_vertices)
