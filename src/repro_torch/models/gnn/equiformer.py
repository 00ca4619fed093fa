"""Equiformer-V2 (Liao et al., arXiv:2306.12059) — eSCN-style equivariant
graph attention, SO(2)-restricted.

Assigned config: 12 layers, d_hidden=128, l_max=6, m_max=2, 8 heads.

Representation: each node carries real spherical-tensor features
``x (N, C, d)`` where C enumerates (l, m) with l <= l_max and |m| <=
min(l, m_max).  For l_max=6, m_max=2: C = 1+3+5+5+5+5+5 = 29.

Per-edge message (the eSCN convolution, z-alignment simplified to azimuthal
phase factorization):

  1. gather source features, rotate each (+m, -m) pair by -m*phi_e
     (phi = edge azimuth) — the SO(2) frame alignment;
  2. per-(l,m) SO(2) linear maps (complex pair mixing for m>0);
  3. radial-angular gains: MLP([bessel(d), cos^k(theta)]) -> per-l scale;
  4. 8-head graph attention: logits from the invariant (m=0) channels,
     scatter-softmax over incoming edges (all heads at once);
  5. rotate back (+m*phi), segment-sum into destination nodes.

Node update: per-l channel mixing + equivariant RMS norm (norm taken over
the m multiplet per (l, channel)) + gated FFN (invariant gate from l=0).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.gnn import common as C
from repro_torch.models.params import ParamTree, at, normal


@dataclasses.dataclass(frozen=True)
class EqV2Config:
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_radial: int = 8
    n_theta: int = 4
    d_in: int = 16
    n_out: int = 8
    cutoff: float = 5.0

    # ---- static coefficient bookkeeping (numpy)
    def coef_table(self):
        """Returns (l_of, m_of) int arrays over the C coefficients; order:
        for each l: m=0, then (+1,-1), (+2,-2) up to min(l, m_max)."""
        ls, ms = [], []
        for l in range(self.l_max + 1):
            ls.append(l); ms.append(0)
            for m in range(1, min(l, self.m_max) + 1):
                ls.extend([l, l]); ms.extend([m, -m])
        return np.array(ls), np.array(ms)

    @property
    def n_coef(self) -> int:
        return len(self.coef_table()[0])

    @property
    def n_l(self) -> int:
        return self.l_max + 1

    def pair_index(self):
        """Indices of (+m, -m) coefficient pairs: (plus, minus, m, l)."""
        ls, ms = self.coef_table()
        plus, minus, mm, ll = [], [], [], []
        for i in range(len(ls)):
            if ms[i] > 0:
                j = np.nonzero((ls == ls[i]) & (ms == -ms[i]))[0][0]
                plus.append(i); minus.append(j)
                mm.append(ms[i]); ll.append(ls[i])
        return (np.array(plus), np.array(minus), np.array(mm), np.array(ll))

    def m0_index(self):
        ls, ms = self.coef_table()
        idx = np.nonzero(ms == 0)[0]
        return idx, ls[idx]


class EquiformerV2(ParamTree):
    def __init__(self, cfg: EqV2Config, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, feats, pos, src, dst, edge_mask=None):
        return eqv2_forward(self, feats, pos, src, dst, self.cfg, edge_mask)


def init_eqv2(cfg: EqV2Config, generator: torch.Generator | None = None,
              device="cuda") -> EquiformerV2:
    d, nl = cfg.d_hidden, cfg.n_l
    n_pair = len(cfg.pair_index()[0])
    s = 1.0 / np.sqrt(d)

    def rand(shape):
        return normal(shape, generator, device) * s

    def one_layer():
        so2_w0 = rand((nl, d, d))
        dev = so2_w0.device
        return {
            "so2_w0": so2_w0,
            "so2_wr": rand((n_pair, d, d)),
            "so2_wi": rand((n_pair, d, d)),
            "radial": C.init_mlp([cfg.n_radial + cfg.n_theta, d, nl],
                                 generator, device),
            "attn": C.init_mlp([nl * d, d, cfg.n_heads], generator, device),
            "node_mix": rand((nl, d, d)),
            "ln_scale": torch.ones((nl, d), dtype=torch.float32, device=dev),
            "ffn_gate": C.init_mlp([d, d, d], generator, device),
            "ffn_mix": rand((nl, d, d)),
            "ffn_ln": torch.ones((nl, d), dtype=torch.float32, device=dev),
        }

    return EquiformerV2(cfg, {
        "embed": C.init_mlp([cfg.d_in, d, d], generator, device),
        "blocks": C.stacked(cfg.n_layers, one_layer),
        "head": C.init_mlp([d, d, cfg.n_out], generator, device),
    })


def _equiv_norm(x, l_of, scale, eps=1e-6):
    """Equivariant RMS norm: normalize per (node, l, channel) by the RMS over
    the m multiplet.  x (N, C, d); l_of (C,) static numpy."""
    nl = int(l_of.max()) + 1
    li = torch.as_tensor(l_of, device=x.device)
    sq = x.to(torch.float32) ** 2
    per_l = sq.new_zeros((sq.shape[0], nl, sq.shape[2])).index_add(1, li, sq)
    cnt = torch.as_tensor(np.bincount(l_of, minlength=nl).astype(np.float32),
                          device=x.device)
    rms = torch.sqrt(per_l / cnt[None, :, None] + eps)       # (N, nl, d)
    return (x / rms[:, li] * scale[li][None]).to(x.dtype)


def eqv2_forward(params, feats, pos, src, dst, cfg: EqV2Config,
                 edge_mask=None) -> torch.Tensor:
    n = feats.shape[0]
    dev = feats.device
    l_np, _ = cfg.coef_table()
    plus, minus, pm, pl = (torch.as_tensor(a, device=dev)
                           for a in cfg.pair_index())
    m0_idx = torch.as_tensor(cfg.m0_index()[0], device=dev)
    l_of = torch.as_tensor(l_np, device=dev)
    nc, nl, d, H = cfg.n_coef, cfg.n_l, cfg.d_hidden, cfg.n_heads

    vec, dist = C.edge_vectors(pos, src, dst)
    # edge angles: theta (polar, vs z), phi (azimuth)
    cos_t = vec[:, 2] / torch.clamp(dist, min=1e-9)
    phi = torch.atan2(vec[:, 1], vec[:, 0] + 1e-12)
    rbf = C.radial_bessel(dist, cfg.n_radial, cfg.cutoff) \
        * C.envelope(dist, cfg.cutoff)[:, None]
    tbf = cos_t[:, None] ** torch.arange(cfg.n_theta, dtype=torch.float32,
                                         device=dev)
    rad_in = torch.cat([rbf, tbf], dim=-1)                  # (E, n_rad+n_th)

    cph = torch.cos(pm[None, :] * phi[:, None])             # (E, n_pair)
    sph = torch.sin(pm[None, :] * phi[:, None])

    # initial embedding: invariant features in the l=0 slot
    x = feats.new_zeros((n, nc, d))
    x[:, 0, :] = C.mlp(params.embed, feats)

    def layer(x, i):
        blk = at(params.blocks, i)
        msg = x[src]                                        # (E, C, d)
        # --- SO(2) frame alignment (rotate pairs by -m phi)
        xp, xm = msg[:, plus], msg[:, minus]                # (E, P, d)
        rp = cph[..., None] * xp + sph[..., None] * xm
        rm = -sph[..., None] * xp + cph[..., None] * xm
        x0 = msg[:, m0_idx]                                 # (E, nl, d)
        # --- per-(l,m) SO(2) linear
        y0 = torch.einsum("eld,ldf->elf", x0, blk.so2_w0.to(x.dtype))
        wr, wi = blk.so2_wr.to(x.dtype), blk.so2_wi.to(x.dtype)
        yp = (torch.einsum("epd,pdf->epf", rp, wr)
              - torch.einsum("epd,pdf->epf", rm, wi))
        ym = (torch.einsum("epd,pdf->epf", rp, wi)
              + torch.einsum("epd,pdf->epf", rm, wr))
        # --- radial-angular gains per l
        g = C.mlp(blk.radial, rad_in)                       # (E, nl)
        y0 = y0 * g[..., None]
        yp = yp * g[:, pl][..., None]
        ym = ym * g[:, pl][..., None]
        # --- attention from invariants, every head at once
        logits = C.mlp(blk.attn, y0.reshape(-1, nl * d)) \
            / np.sqrt(d / H)                                # (E, H)
        alpha = C.segment_softmax(logits, dst, n, edge_mask)

        def weight_heads(y):                                # (E, K, d)
            yh = y.reshape(y.shape[0], y.shape[1], H, d // H)
            return (yh * alpha[:, None, :, None]).reshape(y.shape)

        y0, yp, ym = weight_heads(y0), weight_heads(yp), weight_heads(ym)
        # --- rotate back (+m phi)
        bp = cph[..., None] * yp - sph[..., None] * ym
        bm = sph[..., None] * yp + cph[..., None] * ym
        out = msg.new_zeros((msg.shape[0], nc, d))
        out[:, m0_idx] = y0
        out[:, plus] = bp
        out[:, minus] = bm
        agg = C.segment_sum(out, dst, n, edge_mask)         # (N, C, d)
        # --- node update: per-l mixing (weight gathered per coefficient)
        # + equivariant norm
        w_mix = blk.node_mix.to(x.dtype)[l_of]              # (C, d, d)
        mixed = torch.einsum("ncd,cdf->ncf", agg, w_mix)
        x = x + _equiv_norm(mixed, l_np, blk.ln_scale)
        # --- gated FFN: invariant gate from l=0 broadcast over coefficients
        gate = F.silu(C.mlp(blk.ffn_gate, x[:, 0, :]))      # (N, d)
        w_ffn = blk.ffn_mix.to(x.dtype)[l_of]
        val = torch.einsum("ncd,cdf->ncf", x, w_ffn)
        return x + _equiv_norm(val * gate[:, None, :], l_np, blk.ffn_ln)

    for i in range(cfg.n_layers):
        x = checkpoint(layer, x, i, use_reentrant=False)
    return C.mlp(params.head, x[:, 0, :])                   # invariant readout


def eqv2_node_loss(params, batch, cfg: EqV2Config):
    out = eqv2_forward(params, batch["feats"], batch["pos"], batch["src"],
                       batch["dst"], cfg, batch.get("edge_mask"))
    return C.node_classification_loss(out, batch["labels"],
                                      batch["label_mask"])


def eqv2_graph_loss(params, batch, cfg: EqV2Config):
    flat, B, n = C.flatten_graphs(batch)
    out = eqv2_forward(params, flat["feats"], flat["pos"], flat["src"],
                       flat["dst"], cfg, flat["edge_mask"])
    pred = torch.sum(C.masked_node_mean(out.reshape(B, n, -1), None), dim=-1)
    return C.graph_regression_loss(pred, batch["target"])
