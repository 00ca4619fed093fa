"""Graph generators (host-side numpy), copied from ``repro.graphs.generators``
— the ones the port's streams use.  The same seed gives the same arrays as
the reference, so a stream built here replays bit-for-bit through both
packages.
"""
from __future__ import annotations

import numpy as np


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


def top_in_degree_sources(n: int, dst: np.ndarray, k: int = 3) -> np.ndarray:
    """Stand-in for the paper's PageRank-on-transpose source selection: the
    top in-degree vertices."""
    deg = np.bincount(dst, minlength=n)
    return np.argsort(-deg)[:k]
