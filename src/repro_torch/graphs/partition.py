"""Vertex partitioning for the shared-nothing sharded engine (host-side
numpy), copied from ``repro.graphs.partition``.

The paper's model: "each node owns a disjoint subset of vertices and their
edges".  Vertices are cut into P contiguous ranges *balanced by in-degree*
(edge-balanced), because the per-partition relaxation cost is proportional
to owned in-edges, not owned vertices.  Edges are owned by the partition of
their **dst**, so the scatter-min of each relaxation round is
partition-local; only ``dist[src]`` crosses partitions.
"""
from __future__ import annotations

import numpy as np


def edge_balanced_ranges(n: int, dst: np.ndarray, parts: int) -> np.ndarray:
    """Returns boundaries b[0..parts] with b[0]=0, b[parts]=n such that each
    vertex range [b[i], b[i+1]) owns ~equal numbers of in-edges."""
    deg = np.bincount(dst, minlength=n).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(deg)])
    total = csum[-1]
    targets = (np.arange(1, parts) * total) // parts
    cuts = np.searchsorted(csum, targets, side="left")
    b = np.concatenate([[0], cuts, [n]])
    return np.maximum.accumulate(b)  # enforce monotonicity for empty parts


def uniform_ranges(n: int, parts: int) -> np.ndarray:
    b = (np.arange(parts + 1) * n) // parts
    return b


def owner_of(vertices: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Partition id owning each vertex (bounds as from *_ranges)."""
    return np.clip(np.searchsorted(bounds, vertices, side="right") - 1,
                   0, len(bounds) - 2)


def pad_ranges_to_equal(bounds: np.ndarray) -> int:
    """Static per-partition capacity = max range width (device arrays must be
    equal-shaped across shards)."""
    return int(np.max(np.diff(bounds)))


def relabel_to_uniform(bounds: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, int]:
    """Vertex relabeling that turns variable-width ranges into the uniform
    layout the device mesh wants.

    Device shards must be equal-shaped, but ``edge_balanced_ranges`` produces
    variable-width ranges.  The bridge is a permutation into a *padded* id
    space: partition ``p``'s vertices are packed at ``[p*npp, p*npp+width_p)``
    where ``npp = max range width``; the tail of each padded range is unused
    (no edges ever reference it, so it is inert in every epoch).

    Returns ``(perm, inv, npp)``: ``perm`` (i32[n]) maps original -> padded
    id, ``inv`` (i32[parts*npp]) maps padded -> original with -1 on padding.
    """
    widths = np.diff(bounds)
    parts = len(widths)
    npp = int(widths.max()) if parts else 0
    n = int(bounds[-1])
    v = np.arange(n)
    own = owner_of(v, bounds)
    perm = (own * npp + (v - bounds[own])).astype(np.int32)
    inv = np.full(parts * npp, -1, np.int32)
    inv[perm] = v
    return perm, inv, npp


def edge_balanced_relabeling(n: int, dst: np.ndarray, parts: int
                             ) -> tuple[np.ndarray, np.ndarray, int]:
    """Edge-balanced placement as a relabeling: cut ``n`` vertices into
    ``parts`` ranges of ~equal in-degree mass (from a reference ``dst``
    sample, e.g. the expected stream), then relabel to the uniform padded
    layout.  Feed ``perm``/``inv`` to the sharded engine (or apply ``perm``
    to src/dst before ``DistributedSSSP.place_edges``) so each shard owns
    ~equal relaxation work instead of ~equal vertex counts."""
    return relabel_to_uniform(edge_balanced_ranges(n, dst, parts))
