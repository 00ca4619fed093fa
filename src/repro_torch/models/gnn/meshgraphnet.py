"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): Encode-Process-Decode.

Assigned config: 15 message-passing layers, d_hidden=128, sum aggregation,
2-layer MLPs (+LayerNorm after every MLP, residual node/edge updates).

Edge features are geometric: [pos_dst - pos_src, |pos_dst - pos_src|] (4
features) — for non-mesh shapes the data layer supplies synthetic
coordinates.  The reference's ``lax.scan(jax.checkpoint(body))`` over the
stacked layers is a loop over ``at(blocks, i)``, each layer checkpointed.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.gnn import common as C
from repro_torch.models.params import ParamTree, at


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2      # hidden layers per MLP
    d_in: int = 16           # node input features
    n_out: int = 8           # node output dim (e.g. classes or dynamics dim)
    aggregator: str = "sum"


class MeshGraphNet(ParamTree):
    def __init__(self, cfg: MGNConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, feats, pos, src, dst, edge_mask=None):
        return mgn_forward(self, feats, pos, src, dst, self.cfg, edge_mask)


def _mlp_dims(d_in: int, d_h: int, d_out: int, n_hidden: int) -> list[int]:
    return [d_in] + [d_h] * n_hidden + [d_out]


def init_mgn(cfg: MGNConfig, generator: torch.Generator | None = None,
             device="cuda") -> MeshGraphNet:
    d = cfg.d_hidden
    enc_n = C.init_mlp(_mlp_dims(cfg.d_in, d, d, cfg.mlp_layers),
                       generator, device)
    enc_e = C.init_mlp(_mlp_dims(4, d, d, cfg.mlp_layers), generator, device)
    dec = C.init_mlp(_mlp_dims(d, d, cfg.n_out, cfg.mlp_layers),
                     generator, device)
    dev = enc_n["w"][0].device

    def one_layer():
        return {
            "edge_mlp": C.init_mlp(_mlp_dims(3 * d, d, d, cfg.mlp_layers),
                                   generator, device),
            "edge_ln": C.init_layernorm(d, dev),
            "node_mlp": C.init_mlp(_mlp_dims(2 * d, d, d, cfg.mlp_layers),
                                   generator, device),
            "node_ln": C.init_layernorm(d, dev),
        }

    return MeshGraphNet(cfg, {
        "enc_n": enc_n, "enc_e": enc_e,
        "enc_n_ln": C.init_layernorm(d, dev),
        "enc_e_ln": C.init_layernorm(d, dev),
        "blocks": C.stacked(cfg.n_layers, one_layer), "dec": dec})


AGGREGATORS = {"sum": C.segment_sum, "mean": C.segment_mean,
               "max": C.segment_max}


def mgn_forward(params, feats, pos, src, dst, cfg: MGNConfig,
                edge_mask=None) -> torch.Tensor:
    """feats (N, d_in); pos (N, 3); src/dst (E,) -> node outputs (N, n_out)."""
    n = feats.shape[0]
    vec, dist = C.edge_vectors(pos, src, dst)
    e_in = torch.cat([vec, dist[:, None]], dim=-1).to(feats.dtype)

    h = C.layernorm(params.enc_n_ln, C.mlp(params.enc_n, feats))
    e = C.layernorm(params.enc_e_ln, C.mlp(params.enc_e, e_in))

    agg = AGGREGATORS[cfg.aggregator]

    def body(h, e, i):
        blk = at(params.blocks, i)
        # edge update: e' = e + LN(MLP([e, h_src, h_dst]))
        msg_in = torch.cat([e, h[src], h[dst]], dim=-1)
        e = e + C.layernorm(blk.edge_ln, C.mlp(blk.edge_mlp, msg_in))
        # node update: h' = h + LN(MLP([h, sum_in e']))
        inc = agg(e, dst, n, edge_mask)
        h = h + C.layernorm(blk.node_ln,
                            C.mlp(blk.node_mlp, torch.cat([h, inc], dim=-1)))
        return h, e

    for i in range(cfg.n_layers):
        h, e = checkpoint(body, h, e, i, use_reentrant=False)
    return C.mlp(params.dec, h)


def mgn_node_loss(params, batch, cfg: MGNConfig):
    out = mgn_forward(params, batch["feats"], batch["pos"], batch["src"],
                      batch["dst"], cfg, batch.get("edge_mask"))
    return C.node_classification_loss(out, batch["labels"], batch["label_mask"])


def mgn_graph_loss(params, batch, cfg: MGNConfig):
    """Batched molecules: the flat forward over the disjoint union; mean
    over each graph's nodes, summed -> one scalar a graph."""
    flat, B, n = C.flatten_graphs(batch)
    out = mgn_forward(params, flat["feats"], flat["pos"], flat["src"],
                      flat["dst"], cfg, flat["edge_mask"])
    pred = torch.sum(C.masked_node_mean(out.reshape(B, n, -1), None), dim=-1)
    return C.graph_regression_loss(pred, batch["target"])
