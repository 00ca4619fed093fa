"""The plain reference and the comparison that decides ``correct``.

The reference works each tree out again from the live arc set alone
(``Stream.live_arcs``): Bellman-Ford in plain torch, every arc relaxed a
pass until no distance moves.  It imports nothing of the program and takes
nothing the program made.  The weights are integers, so float32 path sums
are exact below 2^24 and ``dist`` is compared exactly; ``bellman_ford`` in
float32 raises once a finite distance reaches 2^24, where that stops.

The program keeps one shortest-path tree among possibly many (ties are
common with integer weights), so its ``parent`` is judged by what a tree
must be: for every reached vertex other than the source, ``parent[v]`` is
a live arc (p, v) with ``dist[p] + w(p, v) == dist[v]`` (weights are
positive, so such pointers have no cycle); the source and every unreached
vertex have parent -1.

``bellman_ford(..., dtype=torch.bfloat16)`` is the control: the same
reference in the next precision below the configuration's float32.
"""
from __future__ import annotations

import numpy as np
import torch

NO_PARENT = -1
EXACT_BELOW = 2 ** 24     # float32 holds every integer below it exactly
_BIG = torch.iinfo(torch.int64).max


def bellman_ford(n: int, src: torch.Tensor, dst: torch.Tensor,
                 w: torch.Tensor, source: int,
                 dtype: torch.dtype = torch.float32
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist f32[n] with inf, parent i64[n] with -1) from ``source``; the
    parent is the smallest tail among the arcs that attain ``dist``.  In
    float32, a ``ValueError`` where a finite distance reaches
    ``EXACT_BELOW``: past it path sums round and the exact comparison
    would judge rounded numbers."""
    dist = torch.full((n,), float("inf"), dtype=dtype, device=src.device)
    dist[source] = 0
    wd = w.to(dtype)
    while True:
        cand = dist[src] + wd
        new = dist.scatter_reduce(0, dst, cand, "amin", include_self=True)
        if torch.equal(new, dist):
            break
        dist = new
    hit = (cand == dist[dst]) & torch.isfinite(cand)
    parent = torch.full((n,), _BIG, dtype=torch.int64, device=src.device)
    parent.scatter_reduce_(0, dst, torch.where(hit, src, _BIG), "amin")
    parent[(parent == _BIG) | ~torch.isfinite(dist)] = NO_PARENT
    parent[source] = NO_PARENT
    if dtype == torch.float32:
        far = float(dist[torch.isfinite(dist)].max())
        if far >= EXACT_BELOW:
            raise ValueError(f"reference: a distance reaches {far} >= 2^24, "
                             "where float32 path sums stop being exact")
    return dist.to(torch.float32), parent


def judge(n: int, arcs: tuple[torch.Tensor, ...], source: int,
          dist: np.ndarray, parent: np.ndarray,
          ref_dist: torch.Tensor | None = None) -> dict[str, int]:
    """Counts of vertices where ``(dist, parent)`` departs from the
    reference's tree over ``arcs``: ``dist_wrong`` (not equal to the
    reference's distance) and ``parent_wrong`` (not a tree edge as the
    module docstring defines it, or not -1 where it must be)."""
    src, dst, w = arcs
    dev = src.device
    if ref_dist is None:
        ref_dist, _ = bellman_ford(n, src, dst, w, source)
    got = torch.as_tensor(np.asarray(dist, np.float32), device=dev)
    par = torch.as_tensor(np.asarray(parent, np.int64), device=dev)
    dist_wrong = int((got != ref_dist).sum())   # inf == inf is equal

    key = src * n + dst
    key, order = torch.sort(key)
    wk = w[order]
    reached = torch.isfinite(ref_dist)
    reached[source] = False
    v = torch.nonzero(reached).flatten()
    p = par[v]
    in_range = (p >= 0) & (p < n)
    want = p.clamp(0, n - 1) * n + v
    if len(key):
        at = torch.searchsorted(key, want).clamp(max=len(key) - 1)
        tight = ((key[at] == want)
                 & (ref_dist[p.clamp(0, n - 1)] + wk[at] == ref_dist[v]))
    else:
        tight = torch.zeros_like(in_range)
    bad_tree = int((~(in_range & tight)).sum())
    bad_root = int((par[~reached] != NO_PARENT).sum())
    return {"dist_wrong": dist_wrong, "parent_wrong": bad_tree + bad_root}
