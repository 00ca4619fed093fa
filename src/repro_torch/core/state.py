"""Graph + SSSP-tree state for the SSSP-Del engine (torch rendering of
``repro.core.state``).

The dynamic graph lives in fixed-capacity pools:

  * an edge pool in COO form (``src``, ``dst``, ``w``, ``active``) that the
    ingestion layer patches IN PLACE (the reference's functional
    ``.at[slot].set`` would copy the whole pool per batch; at 10M slots an
    in-place scatter is the only affordable rendering), and
  * per-vertex SSSP state: ``dist`` (+inf == unreached) and ``parent``
    (-1 == no predecessor).

Storage dtypes match the reference exactly (i32 ids, f32 weights and
distances, bool active) so checkpoints of the two packages compare bit for
bit.  Successor sets are implicit, as in the reference: the children of
``v`` are exactly ``{u : parent[u] == v}``.
"""
from __future__ import annotations

import dataclasses

import torch

INF = float("inf")
NO_PARENT = -1


@dataclasses.dataclass
class EdgePool:
    """Fixed-capacity COO edge pool.

    Inactive slots have ``active == False`` and are ignored by every wave.
    ``src``/``dst`` of inactive slots are kept in-range (0) so gathers stay safe.
    """

    src: torch.Tensor     # i32[E]
    dst: torch.Tensor     # i32[E]
    w: torch.Tensor       # f32[E]
    active: torch.Tensor  # bool[E]

    @staticmethod
    def empty(capacity: int, device: torch.device | str) -> "EdgePool":
        return EdgePool(
            src=torch.zeros(capacity, dtype=torch.int32, device=device),
            dst=torch.zeros(capacity, dtype=torch.int32, device=device),
            w=torch.zeros(capacity, dtype=torch.float32, device=device),
            active=torch.zeros(capacity, dtype=torch.bool, device=device),
        )


@dataclasses.dataclass
class SSSPState:
    """Per-vertex SSSP tree state."""

    dist: torch.Tensor    # f32[N]; +inf == unreached
    parent: torch.Tensor  # i32[N]; -1 == none (source or unreached)
    source: torch.Tensor  # i32[] scalar

    @staticmethod
    def init(num_vertices: int, source: int,
             device: torch.device | str) -> "SSSPState":
        dist = torch.full((num_vertices,), INF, dtype=torch.float32,
                          device=device)
        dist[source] = 0.0
        parent = torch.full((num_vertices,), NO_PARENT, dtype=torch.int32,
                            device=device)
        return SSSPState(dist=dist, parent=parent,
                         source=torch.tensor(source, dtype=torch.int32,
                                             device=device))


@dataclasses.dataclass
class GraphState:
    """Full engine state: topology pool + SSSP tree.  ``cursor`` is carried
    only so checkpoints keep the reference's key set (slot reuse is planned
    host-side; nothing advances it)."""

    edges: EdgePool
    sssp: SSSPState
    cursor: torch.Tensor  # i32[]

    @staticmethod
    def init(num_vertices: int, edge_capacity: int, source: int,
             device: torch.device | str) -> "GraphState":
        return GraphState(
            edges=EdgePool.empty(edge_capacity, device),
            sssp=SSSPState.init(num_vertices, source, device),
            cursor=torch.tensor(0, dtype=torch.int32, device=device),
        )


def validate_state(state: GraphState, num_vertices: int) -> dict[str, bool]:
    """Cheap invariant probes used by tests (computed on the state's device,
    returned as Python bools)."""
    e, s = state.edges, state.sssp
    in_range = torch.all((e.src >= 0) & (e.src < num_vertices)
                         & (e.dst >= 0) & (e.dst < num_vertices))
    pos_w = torch.all(torch.where(e.active, e.w > 0, True))
    src_ok = s.dist[s.source.long()] == 0.0
    parent_range = torch.all((s.parent >= -1) & (s.parent < num_vertices))
    # every reached non-source vertex has a parent; unreached have none
    reached = torch.isfinite(s.dist)
    non_src = torch.arange(num_vertices, device=s.dist.device) != s.source
    has_parent_ok = torch.all(torch.where(reached & non_src, s.parent >= 0,
                                          True))
    no_parent_ok = torch.all(torch.where(~reached, s.parent == NO_PARENT,
                                         True))
    return {
        "edges_in_range": bool(in_range),
        "weights_positive": bool(pos_w),
        "source_dist_zero": bool(src_ok),
        "parent_in_range": bool(parent_range),
        "reached_have_parent": bool(has_parent_ok),
        "unreached_have_no_parent": bool(no_parent_ok),
    }
