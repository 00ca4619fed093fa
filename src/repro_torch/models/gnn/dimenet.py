"""DimeNet (Klicpera et al., arXiv:2003.03123): directional message passing.

Assigned config: 6 interaction blocks, d_hidden=128, n_bilinear=8,
n_spherical=7, n_radial=6.

Messages live on *edges* m_ji; the interaction block refines them with
two-hop (triplet) terms k->j->i weighted by a joint radial x angular basis
through a bilinear tensor.  Triplet index lists (t_kj, t_ji) are
precomputed host-side (graphs/triplets.py) with a static padded budget.

Generic-graph adaptation: node "atom types" are replaced by an MLP over the
node features; positions come from the data layer.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.gnn import common as C
from repro_torch.models.params import ParamTree, at, normal


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_in: int = 16
    n_out: int = 8
    cutoff: float = 5.0
    n_res_pre: int = 1          # residual MLPs before the skip
    n_res_post: int = 2         # after


class DimeNet(ParamTree):
    def __init__(self, cfg: DimeNetConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, feats, pos, src, dst, t_kj, t_ji, edge_mask=None,
                triplet_mask=None):
        return dimenet_forward(self, feats, pos, src, dst, t_kj, t_ji,
                               self.cfg, edge_mask, triplet_mask)


def init_dimenet(cfg: DimeNetConfig, generator: torch.Generator | None = None,
                 device="cuda") -> DimeNet:
    d = cfg.d_hidden

    def mlp(dims):
        return C.init_mlp(dims, generator, device)

    emb = {
        "node": mlp([cfg.d_in, d]),
        "rbf": mlp([cfg.n_radial, d]),
        "edge": mlp([3 * d, d]),
    }

    def one_block():
        return {
            "w_rbf": mlp([cfg.n_radial, d]),
            "w_sbf": mlp([cfg.n_spherical * cfg.n_radial, cfg.n_bilinear]),
            "w_kj": mlp([d, d]),
            "w_ji": mlp([d, d]),
            "bilinear": normal((cfg.n_bilinear, d, d), generator, device)
                        / math.sqrt(d),
            "res_pre": C.stacked(cfg.n_res_pre, lambda: mlp([d, d, d])),
            "w_skip": mlp([d, d]),
            "res_post": C.stacked(cfg.n_res_post, lambda: mlp([d, d, d])),
        }

    def one_out():
        return {"w_rbf": mlp([cfg.n_radial, d]),
                "mlp": mlp([d, d, cfg.n_out])}

    return DimeNet(cfg, {"emb": emb,
                         "blocks": C.stacked(cfg.n_blocks, one_block),
                         "outs": C.stacked(cfg.n_blocks + 1, one_out)})


def _res(stack, x):
    """Apply a stacked set of residual MLPs (leading dim = count)."""
    for i in range(stack.w[0].shape[0]):
        p = at(stack, i)
        x = x + C.mlp(p, x, final_act=False)
    return x


def dimenet_forward(params, feats, pos, src, dst, t_kj, t_ji,
                    cfg: DimeNetConfig, edge_mask=None, triplet_mask=None
                    ) -> torch.Tensor:
    """Returns per-node outputs (N, n_out).

    src/dst (E,): directed edges j->i (src=j, dst=i); messages m indexed by
    edge.  t_kj/t_ji (T,): triplet edge indices — edge (k->j) feeding edge
    (j->i).
    """
    n = feats.shape[0]
    vec, dist = C.edge_vectors(pos, src, dst)
    u = C.envelope(dist, cfg.cutoff)
    rbf = C.radial_bessel(dist, cfg.n_radial, cfg.cutoff) * u[:, None]

    # triplet angle at j between edges (k->j) and (j->i):
    #   a = vec(j->i), b = -vec(k->j)
    a = vec[t_ji]
    b = -vec[t_kj]
    cos_ang = torch.sum(a * b, -1) / torch.clamp(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), min=1e-9)
    ang = C.angular_fourier(cos_ang, cfg.n_spherical)         # (T, n_sph)
    sbf = (ang[:, :, None] * rbf[t_kj][:, None, :]).reshape(
        -1, cfg.n_spherical * cfg.n_radial)                   # (T, n_sph*n_rad)

    h = C.mlp(params.emb.node, feats)                          # (N, d)
    rbf_e = C.mlp(params.emb.rbf, rbf)
    m = C.mlp(params.emb.edge, torch.cat([h[src], h[dst], rbf_e], dim=-1))
    m = F.silu(m)
    if edge_mask is not None:
        m = torch.where(edge_mask[:, None], m, 0.0)

    def out_block(p, m_edges, rbf_, i_dst):
        g = C.mlp(p.w_rbf, rbf_) * m_edges
        node = C.segment_sum(g, i_dst, n, edge_mask)
        return C.mlp(p.mlp, node)

    out = out_block(at(params.outs, 0), m, rbf, dst)

    def body(m, i):
        blk, out_p = at(params.blocks, i), at(params.outs, i + 1)
        rbf_g = C.mlp(blk.w_rbf, rbf)                          # (E, d)
        sbf_g = C.mlp(blk.w_sbf, sbf)                          # (T, n_bil)
        x_ji = F.silu(C.mlp(blk.w_ji, m))
        x_kj = F.silu(C.mlp(blk.w_kj, m)) * rbf_g              # (E, d)
        xk = x_kj[t_kj]                                        # (T, d)
        # einsum("tb,tf,bfh->th"): the (T, b·f) outer product against the
        # bilinear tensor flattened to (b·f, h); no (T, b, f, h) tensor
        nb, d = blk.bilinear.shape[:2]
        tri = (sbf_g[:, :, None] * xk[:, None, :]).reshape(-1, nb * d) \
            @ blk.bilinear.reshape(nb * d, -1)
        if triplet_mask is not None:
            tri = torch.where(triplet_mask[:, None], tri, 0.0)
        agg = C.segment_sum(tri, t_ji, m.shape[0])             # (E, d)
        mm = x_ji + agg
        mm = _res(blk.res_pre, mm)
        mm = m + C.mlp(blk.w_skip, F.silu(mm))
        mm = _res(blk.res_post, mm)
        if edge_mask is not None:
            mm = torch.where(edge_mask[:, None], mm, 0.0)
        o = out_block(out_p, mm, rbf, dst)
        return mm, o

    os_ = []
    for i in range(cfg.n_blocks):
        m, o = checkpoint(body, m, i, use_reentrant=False)
        os_.append(o)
    return out + torch.sum(torch.stack(os_), dim=0)


def dimenet_node_loss(params, batch, cfg: DimeNetConfig):
    out = dimenet_forward(params, batch["feats"], batch["pos"], batch["src"],
                          batch["dst"], batch["t_kj"], batch["t_ji"], cfg,
                          batch.get("edge_mask"), batch.get("triplet_mask"))
    return C.node_classification_loss(out, batch["labels"],
                                      batch["label_mask"])


def dimenet_graph_loss(params, batch, cfg: DimeNetConfig):
    flat, B, n = C.flatten_graphs(batch, tri=True)
    out = dimenet_forward(params, flat["feats"], flat["pos"], flat["src"],
                          flat["dst"], flat["t_kj"], flat["t_ji"], cfg,
                          flat["edge_mask"], flat["triplet_mask"])
    pred = torch.sum(out.reshape(B, n, -1), dim=(1, 2))
    return C.graph_regression_loss(pred, batch["target"])
