"""Reference oracle: textbook Dijkstra on the *current* graph snapshot.

Used by unit/property tests to validate the dynamic engine after every epoch.
Pure numpy + heapq — a copy of ``repro.core.oracle``, independent of every
torch code path.
"""
from __future__ import annotations

import heapq

import numpy as np


def dijkstra(
    num_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    source: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (dist f64[N] with inf, parent i64[N] with -1)."""
    heads: list[list[tuple[int, float]]] = [[] for _ in range(num_vertices)]
    for u, v, wt in zip(src.tolist(), dst.tolist(), w.tolist()):
        heads[u].append((v, float(wt)))
    dist = np.full(num_vertices, np.inf)
    parent = np.full(num_vertices, -1, np.int64)
    dist[source] = 0.0
    pq: list[tuple[float, int]] = [(0.0, source)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for v, wt in heads[u]:
            nd = d + wt
            if nd < dist[v]:
                dist[v] = nd
                parent[v] = u
                heapq.heappush(pq, (nd, v))
    return dist, parent


def check_tree(
    num_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    source: int,
    dist: np.ndarray,
    parent: np.ndarray,
    atol: float = 1e-4,
) -> None:
    """Assert (dist, parent) is a valid SSSP solution for the snapshot.

    Distances must match Dijkstra exactly (within fp tolerance); the parent
    pointers must form a *valid* shortest-path tree — the specific tree may
    legitimately differ from Dijkstra's (multiple optima), so we check the
    tree property (dist[v] == dist[parent[v]] + w(parent[v], v), edge exists)
    rather than parent equality.
    """
    ref_dist, _ = dijkstra(num_vertices, src, dst, w, source)
    got = np.asarray(dist, np.float64)
    if not np.allclose(np.where(np.isinf(ref_dist), 1e30, ref_dist),
                       np.where(np.isinf(got), 1e30, got), atol=atol, rtol=1e-5):
        bad = np.nonzero(~np.isclose(
            np.where(np.isinf(ref_dist), 1e30, ref_dist),
            np.where(np.isinf(got), 1e30, got), atol=atol, rtol=1e-5))[0]
        raise AssertionError(
            f"dist mismatch at {bad[:10]}: ref={ref_dist[bad[:10]]} got={got[bad[:10]]}")

    wmap = {}
    for u, v, wt in zip(src.tolist(), dst.tolist(), w.tolist()):
        key = (u, v)
        wmap[key] = min(wmap.get(key, np.inf), float(wt))
    par = np.asarray(parent)
    for v in range(num_vertices):
        p = int(par[v])
        if v == source:
            continue
        if np.isinf(ref_dist[v]):
            assert p == -1, f"unreached vertex {v} has parent {p}"
            continue
        assert p >= 0, f"reached vertex {v} lacks a parent"
        assert (p, v) in wmap, f"parent edge ({p},{v}) not in graph"
        assert abs((got[p] + wmap[(p, v)]) - got[v]) < max(atol, 1e-5 * max(1.0, abs(got[v]))), (
            f"tree edge ({p},{v}) not tight: {got[p]} + {wmap[(p, v)]} != {got[v]}")
