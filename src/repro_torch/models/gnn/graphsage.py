"""GraphSAGE (Hamilton et al., arXiv:1706.02216), mean aggregator.

Assigned config: 2 layers, d_hidden=128, sample sizes 25-10 (training-time
neighbor fanout — realized by the host-side sampler in graphs/sampler.py,
which emits a padded COO subgraph consumed by the same forward as the
full-graph shapes).

Layer: h'_v = ReLU(W_self h_v + W_nbr mean_{u in N(v)} h_u), L2-normalized
(as in the paper).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.gnn import common as C
from repro_torch.models.params import ParamTree, normal


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_out: int = 41
    sample_sizes: tuple[int, ...] = (25, 10)
    normalize: bool = True


class GraphSAGE(ParamTree):
    def __init__(self, cfg: SAGEConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, feats, src, dst, edge_mask=None):
        return sage_forward(self, feats, src, dst, self.cfg, edge_mask)


def init_sage(cfg: SAGEConfig, generator: torch.Generator | None = None,
              device="cuda") -> GraphSAGE:
    layers = []
    d_prev = cfg.d_in
    for _ in range(cfg.n_layers):
        d_out = cfg.d_hidden
        w_self = normal((d_prev, d_out), generator, device) / math.sqrt(d_prev)
        layers.append({
            "w_self": w_self,
            "w_nbr": normal((d_prev, d_out), generator, device)
                     / math.sqrt(d_prev),
            "b": torch.zeros((d_out,), dtype=torch.float32,
                             device=w_self.device),
        })
        d_prev = d_out
    head = normal((d_prev, cfg.n_out), generator, device) / math.sqrt(d_prev)
    return GraphSAGE(cfg, {"layers": layers, "head": head})


def sage_forward(params, feats, src, dst, cfg: SAGEConfig,
                 edge_mask=None) -> torch.Tensor:
    """Full-graph/subgraph forward over COO edges src->dst."""
    n = feats.shape[0]
    h = feats
    for lyr in params.layers:
        nbr = C.segment_mean(h[src], dst, n, edge_mask)
        h = torch.relu(h @ lyr.w_self.to(h.dtype)
                       + nbr @ lyr.w_nbr.to(h.dtype) + lyr.b.to(h.dtype))
        if cfg.normalize:
            h = h / torch.clamp(
                torch.linalg.vector_norm(h.to(torch.float32), dim=-1,
                                         keepdim=True), min=1e-6).to(h.dtype)
    return h @ params.head.to(h.dtype)


def sage_node_loss(params, batch, cfg: SAGEConfig):
    out = sage_forward(params, batch["feats"], batch["src"], batch["dst"],
                       cfg, batch.get("edge_mask"))
    return C.node_classification_loss(out, batch["labels"],
                                      batch["label_mask"])


def sage_graph_loss(params, batch, cfg: SAGEConfig):
    flat, B, n = C.flatten_graphs(batch)
    out = sage_forward(params, flat["feats"], flat["src"], flat["dst"], cfg,
                       flat["edge_mask"])
    pred = torch.sum(C.masked_node_mean(out.reshape(B, n, -1), None), dim=-1)
    return C.graph_regression_loss(pred, batch["target"])
