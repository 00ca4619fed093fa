"""Host-side graph sampling substrate (numpy, CSR-based).

``minibatch_lg`` requires a real neighbor sampler: given seed nodes and a
fanout schedule (GraphSAGE's 25-10 / the shape's 15-10), sample a k-hop
neighborhood and emit a *padded COO subgraph* with relabelled node ids.
Every GNN arch consumes this one format (models/gnn/common.py), so the
sampler is shared substrate, not per-arch code.

Static shapes: the subgraph is padded to its worst case
  n_sub = B * (1 + f1 + f1*f2 ...),  e_sub = B * (f1 + f1*f2 ...)
with ``edge_mask`` marking real edges — required for JIT cache stability.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    node_ids: np.ndarray   # i32[n_sub] — global ids (padded with 0)
    src: np.ndarray        # i32[e_sub] — local (relabelled) ids
    dst: np.ndarray        # i32[e_sub]
    edge_mask: np.ndarray  # bool[e_sub]
    node_mask: np.ndarray  # bool[n_sub]
    seed_slots: np.ndarray # i32[B] — local ids of the seed nodes


def subgraph_capacity(batch: int, fanout: tuple[int, ...]) -> tuple[int, int]:
    n, e, layer = 1, 0, 1
    for f in fanout:
        layer *= f
        n += layer
        e += layer
    return batch * n, batch * e


class NeighborSampler:
    """Uniform fanout sampler over a CSR adjacency (in-neighbors: the
    aggregation direction, matching dst-owned edges everywhere else)."""

    def __init__(self, num_nodes: int, src: np.ndarray, dst: np.ndarray):
        order = np.argsort(dst, kind="stable")
        self.cols = np.ascontiguousarray(src[order]).astype(np.int64)
        self.indptr = np.zeros(num_nodes + 1, np.int64)
        np.add.at(self.indptr, dst + 1, 1)
        np.cumsum(self.indptr, out=self.indptr)
        self.num_nodes = num_nodes

    def _sample_nbrs(self, nodes: np.ndarray, k: int,
                     rng: np.random.Generator) -> np.ndarray:
        """(M,) -> (M, k) sampled in-neighbors, -1 where degree == 0."""
        lo, hi = self.indptr[nodes], self.indptr[nodes + 1]
        deg = hi - lo
        out = np.full((len(nodes), k), -1, np.int64)
        has = deg > 0
        if has.any():
            r = rng.integers(0, np.maximum(deg[has], 1)[:, None],
                             size=(int(has.sum()), k))
            out[has] = self.cols[lo[has, None] + r]
        return out

    def sample(self, seeds: np.ndarray, fanout: tuple[int, ...],
               seed: int = 0) -> SampledSubgraph:
        rng = np.random.default_rng(seed)
        B = len(seeds)
        n_cap, e_cap = subgraph_capacity(B, fanout)

        # frontier-by-frontier expansion; relabel greedily (no dedup across
        # branches — tree-structured subgraph, the GraphSAGE semantics)
        node_ids = np.zeros(n_cap, np.int64)
        node_mask = np.zeros(n_cap, bool)
        src = np.zeros(e_cap, np.int64)
        dst = np.zeros(e_cap, np.int64)
        emask = np.zeros(e_cap, bool)

        node_ids[:B] = seeds
        node_mask[:B] = True
        frontier_slots = np.arange(B)
        n_ptr, e_ptr = B, 0
        for f in fanout:
            fr_nodes = node_ids[frontier_slots]
            fr_valid = node_mask[frontier_slots]
            nbrs = self._sample_nbrs(fr_nodes, f, rng)           # (M, f)
            M = len(frontier_slots)
            new_slots = n_ptr + np.arange(M * f)
            valid = fr_valid[:, None] & (nbrs >= 0)
            node_ids[new_slots] = np.maximum(nbrs, 0).reshape(-1)
            node_mask[new_slots] = valid.reshape(-1)
            # edges: sampled neighbor (src) -> frontier node (dst)
            src[e_ptr:e_ptr + M * f] = new_slots
            dst[e_ptr:e_ptr + M * f] = np.repeat(frontier_slots, f)
            emask[e_ptr:e_ptr + M * f] = valid.reshape(-1)
            frontier_slots = new_slots
            n_ptr += M * f
            e_ptr += M * f

        return SampledSubgraph(
            node_ids=node_ids.astype(np.int32),
            src=src.astype(np.int32), dst=dst.astype(np.int32),
            edge_mask=emask, node_mask=node_mask,
            seed_slots=np.arange(B, dtype=np.int32))


def build_batch(sub: SampledSubgraph, feats: np.ndarray, labels: np.ndarray,
                pos: np.ndarray | None = None) -> dict:
    """Materialize the padded-subgraph training batch dict consumed by the
    GNN loss functions (gathers features host-side; at scale this gather is
    the input pipeline's job, overlapped with the previous step)."""
    n = len(sub.node_ids)
    batch = {
        "feats": feats[sub.node_ids].astype(np.float32),
        "src": sub.src, "dst": sub.dst, "edge_mask": sub.edge_mask,
        "labels": np.where(sub.node_mask, labels[sub.node_ids], -1
                           ).astype(np.int32),
        "label_mask": np.zeros(n, bool),
    }
    batch["label_mask"][sub.seed_slots] = True   # loss only on seeds
    if pos is not None:
        batch["pos"] = pos[sub.node_ids].astype(np.float32)
    return batch
