"""Host-side triplet index construction for DimeNet-style directional MP.

For each directed edge e_ji = (j -> i), its triplets are the edges
e_kj = (k -> j) with k != i: message m_kj feeds m_ji through the angular
basis.  We emit flat (t_kj, t_ji) edge-index arrays, padded/capped to a
static budget (mega-graphs: uniform per-edge cap, recorded in DESIGN.md §9).
"""
from __future__ import annotations

import numpy as np


def build_triplets(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                   *, budget: int | None = None, per_edge_cap: int = 8,
                   seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (t_kj, t_ji, mask), each of length ``budget`` (or exact count
    when budget is None).

    t_kj[t] / t_ji[t] index into the edge arrays; mask marks real triplets.
    """
    E = len(src)
    rng = np.random.default_rng(seed)
    # in-edges of each node: CSR over dst
    order = np.argsort(dst, kind="stable")
    eid_by_dst = order
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    np.cumsum(indptr, out=indptr)

    t_kj, t_ji = [], []
    for e in range(E):
        j, i = src[e], dst[e]
        lo, hi = indptr[j], indptr[j + 1]
        cand = eid_by_dst[lo:hi]                 # edges (k -> j)
        cand = cand[src[cand] != i]              # exclude backtracking k == i
        if per_edge_cap and len(cand) > per_edge_cap:
            cand = rng.choice(cand, per_edge_cap, replace=False)
        t_kj.extend(cand.tolist())
        t_ji.extend([e] * len(cand))

    t_kj = np.asarray(t_kj, np.int32)
    t_ji = np.asarray(t_ji, np.int32)
    n = len(t_kj)
    if budget is None:
        return t_kj, t_ji, np.ones(n, bool)
    out_kj = np.zeros(budget, np.int32)
    out_ji = np.zeros(budget, np.int32)
    mask = np.zeros(budget, bool)
    m = min(n, budget)
    if n > budget:   # uniform downsample (documented cap)
        take = rng.choice(n, budget, replace=False)
        out_kj[:], out_ji[:], mask[:] = t_kj[take], t_ji[take], True
    else:
        out_kj[:m], out_ji[:m], mask[:m] = t_kj[:m], t_ji[:m], True
    return out_kj, out_ji, mask


def triplet_budget(num_edges: int, factor: float = 2.0,
                   cap: int = 134_217_728) -> int:
    """Static triplet budget for dry-run input specs: factor·E, capped."""
    return int(min(num_edges * factor, cap))
