"""Graph generators (host-side numpy), copied from ``repro.graphs.generators``
— the ones the port's streams use.  The same seed gives the same arrays as
the reference, so a stream built here replays bit-for-bit through both
packages.

* ``rmat`` — R-MAT with Graph500 parameters (a, b, c, d) = (0.57, 0.19,
  0.19, 0.05), the paper's RMAT(20) source, weights U(0, 4) floored at
  1e-3: power-law in-degree hubs, the sliced backend's workload;
* ``erdos_renyi`` — uniform random digraphs;
* ``power_law_hubs`` — a few hubs on ~30 % of the edges, out-degree hubs
  by default, in-degree hubs with ``orientation="in"`` (the examples'
  ``--power-law`` / ``--hubs`` stream);
* ``grid2d`` — a rows x cols lattice with unit weights (deep trees, ties
  everywhere: the baselines' stability workload).
"""
from __future__ import annotations

import numpy as np


def rmat(scale: int, edge_factor: int = 16, *, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, weights: tuple[float, float] = (0.0, 4.0),
         dedup: bool = True) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Graph500-style R-MAT. Returns (n, src, dst, w); weights in (lo, hi]."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        go_b = (r >= a) & (r < ab)
        go_c = (r >= ab) & (r < abc)
        go_d = r >= abc
        src += ((go_c | go_d).astype(np.int64)) << bit
        dst += ((go_b | go_d).astype(np.int64)) << bit
    keep = src != dst  # drop self-loops (paper: simple graphs)
    src, dst = src[keep], dst[keep]
    if dedup:
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        idx.sort()
        src, dst = src[idx], dst[idx]
    lo, hi = weights
    w = lo + (hi - lo) * rng.random(len(src)).astype(np.float32)
    w = np.maximum(w, 1e-3).astype(np.float32)  # strictly positive (termination)
    return n, src, dst, w


def erdos_renyi(n: int, m: int, *, seed: int = 0,
                weights: tuple[float, float] = (0.5, 2.0)
                ) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Uniform random simple digraph with ``m`` edges and U(lo, hi) weights."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 4 * m)
    dst = rng.integers(0, n, 4 * m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    src, dst = src[idx][:m], dst[idx][:m]
    lo, hi = weights
    w = (lo + (hi - lo) * rng.random(len(src))).astype(np.float32)
    return n, src, dst, w


def grid2d(rows: int, cols: int, *, bidirectional: bool = True,
           weight: float = 1.0
           ) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """rows x cols lattice; vertex id = r*cols + c.  Edges in the
    reference's order: row-major, the right neighbour before the one
    below, then (``bidirectional``) every reverse edge."""
    n = rows * cols
    v = np.arange(n, dtype=np.int64).reshape(rows, cols)
    right = np.zeros((rows, cols), bool)
    right[:, :-1] = True
    down = np.zeros((rows, cols), bool)
    down[:-1, :] = True
    # per vertex: its right edge, then its down edge
    src = np.stack([v, v], -1)[np.stack([right, down], -1)]
    dst = np.stack([v + 1, v + cols], -1)[np.stack([right, down], -1)]
    if bidirectional:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    w = np.full(len(src), weight, np.float32)
    return n, src, dst, w


def power_law_hubs(n: int, m: int, n_hubs: int = 3, *, seed: int = 0,
                   orientation: str = "out"
                   ) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Hub-heavy digraph: ~30% of edges touch one of ``n_hubs`` hubs, the
    rest are uniform.

    ``orientation="out"`` (the reference's default) puts the hub mass on
    the *source* side (high out-degree hubs — large reachable sets, the
    source-selection regime).  ``"in"`` puts it on the *destination* side
    (high in-degree hubs — the regime that stresses by-destination edge
    layouts: dense ELL pads every row to the hub degree, the sliced/hybrid
    backend exists for exactly this shape — DESIGN.md §6).  Both draw the
    same random stream, and each equals the reference's.
    """
    if orientation not in ("out", "in"):
        raise ValueError(f"orientation must be 'out' or 'in'; got "
                         f"{orientation!r}")
    rng = np.random.default_rng(seed)
    hubs = rng.choice(n, n_hubs, replace=False)
    m_hub = m // 3
    hub_end = np.concatenate([
        rng.choice(hubs, m_hub),
        rng.integers(0, n, m - m_hub),
    ])
    uni_end = rng.integers(0, n, m)
    src, dst = ((hub_end, uni_end) if orientation == "out"
                else (uni_end, hub_end))
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    src, dst = src[idx], dst[idx]
    w = np.ones(len(src), np.float32)  # paper: unit weights for real graphs
    return n, src, dst, w


def top_in_degree_sources(n: int, dst: np.ndarray, k: int = 3) -> np.ndarray:
    """Stand-in for the paper's PageRank-on-transpose source selection: the
    top in-degree vertices."""
    deg = np.bincount(dst, minlength=n)
    return np.argsort(-deg)[:k]
