"""Shared GNN substrate: MLPs, segment aggregators, bases, loss heads.

Message passing is a gather over an edge index (``h[src]``) and a scatter
into the destination nodes (``index_add`` / ``scatter_reduce``), as the
reference builds it from ``jnp.take`` and ``jax.ops.segment_*``.  On the
card ``index_add`` adds with atomics in no fixed order, so sums there are
close to the CPU's, not bit-identical.

Uniform graph form (all four archs, all four shapes):

  * flat COO: feats (N,F) [+ pos (N,3)], src/dst (E,) int32, edge_mask (E,);
  * batched molecules: the same per graph with a leading B dim, run as one
    disjoint graph (``flatten_graphs``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.models.params import normal


# ------------------------------------------------------------------ MLPs ----

def init_mlp(dims: Sequence[int], generator, device) -> dict:
    """Weights N(0, 1)/sqrt(fan_in), zero biases on every layer (the
    reference's ``final_bias=False`` changes nothing, so it is not
    taken)."""
    ws, bs = [], []
    for i in range(len(dims) - 1):
        ws.append(normal((dims[i], dims[i + 1]), generator, device)
                  / math.sqrt(dims[i]))
        bs.append(torch.zeros((dims[i + 1],), dtype=torch.float32,
                              device=ws[-1].device))
    return {"w": ws, "b": bs}


def stacked(n: int, make) -> dict:
    """``n`` trees from ``make()`` stacked leaf by leaf on a new leading
    axis (the reference's ``vmap`` over init keys)."""
    trees = [make() for _ in range(n)]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(t[k] for t in leaves)) for k in leaves[0]}
        if isinstance(leaves[0], list):
            return [stack(*xs) for xs in zip(*leaves)]
        return torch.stack(leaves)
    return stack(*trees)


def mlp(params, x: torch.Tensor, *, act=F.silu, final_act: bool = False
        ) -> torch.Tensor:
    n = len(params.w)
    for i, (w, b) in enumerate(zip(params.w, params.b)):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def init_layernorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p.scale + p.bias).to(dt)


# ----------------------------------------------------------- aggregators ----

def _rows(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (vals.ndim - mask.ndim))


def segment_sum(vals, dst, n, mask=None):
    if mask is not None:
        vals = torch.where(_rows(mask, vals), vals, 0)
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    return out.index_add(0, dst, vals)


def segment_mean(vals, dst, n, mask=None):
    s = segment_sum(vals, dst, n, mask)
    ones = (torch.ones(vals.shape[0], dtype=vals.dtype, device=vals.device)
            if mask is None else mask.to(vals.dtype))
    cnt = segment_sum(ones, dst, n)
    return s / torch.clamp(cnt, min=1.0).reshape(
        (n,) + (1,) * (vals.ndim - 1))


def _segment_amax(vals, dst, n):
    """``jax.ops.segment_max``: -inf in empty segments; tied maxima share
    the gradient evenly."""
    out = vals.new_full((n,) + tuple(vals.shape[1:]), -math.inf)
    idx = dst.to(torch.int64).reshape((-1,) + (1,) * (vals.ndim - 1))
    return out.scatter_reduce(0, idx.expand_as(vals), vals, "amax",
                              include_self=False)


def segment_max(vals, dst, n, mask=None):
    if mask is not None:
        vals = torch.where(_rows(mask, vals), vals,
                           torch.finfo(vals.dtype).min)
    out = _segment_amax(vals, dst, n)
    # empty segments -> 0, and clamp -inf
    return torch.maximum(out, torch.zeros_like(out))


def segment_softmax(logits, dst, n, mask=None):
    """Numerically-stable scatter softmax (graph attention), over every
    trailing column of ``logits`` at once."""
    lg = logits.to(torch.float32)
    if mask is not None:
        lg = torch.where(_rows(mask, lg), lg, -1e30)
    mx = _segment_amax(lg, dst, n)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(lg - mx[dst])
    if mask is not None:
        ex = torch.where(_rows(mask, ex), ex, 0.0)
    den = segment_sum(ex, dst, n)
    return (ex / torch.clamp(den[dst], min=1e-30)).to(logits.dtype)


# ------------------------------------------------------------------ bases ----

def radial_bessel(d: torch.Tensor, n_radial: int, cutoff: float
                  ) -> torch.Tensor:
    """DimeNet's radial Bessel basis: sqrt(2/c)·sin(nπd/c)/d (d>0)."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    d = torch.clamp(d.to(torch.float32), min=1e-9)[..., None]
    c = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=torch.float32,
                                device=d.device))
    return c * torch.sin(n * math.pi * d / cutoff) / d


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for an int ``y > 0`` by square-and-multiply, rounded as
    ``lax.integer_pow`` rounds (the polynomial below cancels to ~1e-6)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def envelope(d: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """Smooth polynomial cutoff envelope u(d) (DimeNet eq. 8 family)."""
    x = torch.clamp(d.to(torch.float32) / cutoff, 0.0, 1.0)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    return 1.0 + a * _ipow(x, p) + b * _ipow(x, p + 1) + c * _ipow(x, p + 2)


def angular_fourier(cos_angle: torch.Tensor, n_spherical: int
                    ) -> torch.Tensor:
    """Angular basis cos(l·α), l = 0..n_spherical-1."""
    ang = torch.arccos(torch.clamp(cos_angle.to(torch.float32), -1.0, 1.0))
    l = torch.arange(n_spherical, dtype=torch.float32, device=ang.device)
    return torch.cos(ang[..., None] * l)


# ------------------------------------------------------- geometry helpers ----

def edge_vectors(pos: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """Returns (vec (E,3), dist (E,)) for edges src->dst."""
    v = pos[dst] - pos[src]
    d = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-12))
    return v, d


def masked_node_mean(x: torch.Tensor, node_mask: torch.Tensor | None
                     ) -> torch.Tensor:
    """Graph readout: mean over valid nodes. x (..., N, d) -> (..., d)."""
    if node_mask is None:
        return torch.mean(x, dim=-2)
    m = node_mask.to(x.dtype)[..., None]
    return torch.sum(x * m, dim=-2) / torch.clamp(torch.sum(m, dim=-2),
                                                  min=1.0)


def flatten_graphs(batch: dict, tri: bool = False) -> tuple[dict, int, int]:
    """A batch of B molecule graphs (leading B dim) as one disjoint flat
    graph: nodes and edges concatenated, edge ids offset by b·n and triplet
    ids by b·e.  Returns (flat batch, B, n)."""
    B, n = batch["feats"].shape[:2]
    e = batch["src"].shape[1]
    node_off = (torch.arange(B, device=batch["src"].device) * n)[:, None]
    flat = {"feats": batch["feats"].reshape(B * n, -1),
            "src": (batch["src"] + node_off).reshape(-1),
            "dst": (batch["dst"] + node_off).reshape(-1),
            "edge_mask": batch["edge_mask"].reshape(-1)}
    if "pos" in batch:
        flat["pos"] = batch["pos"].reshape(B * n, 3)
    if tri:
        edge_off = node_off // n * e
        flat["t_kj"] = (batch["t_kj"] + edge_off).reshape(-1)
        flat["t_ji"] = (batch["t_ji"] + edge_off).reshape(-1)
        flat["triplet_mask"] = batch["triplet_mask"].reshape(-1)
    return flat, B, n


# ------------------------------------------------------------- loss heads ----

def node_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                             mask: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Masked softmax CE over nodes; labels int32, mask bool."""
    lg = logits.to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    safe = torch.clamp(labels, min=0).to(torch.int64)
    gold = torch.take_along_dim(lg, safe[:, None], dim=-1)[:, 0]
    m = (mask & (labels >= 0)).to(torch.float32)
    n = torch.clamp(torch.sum(m), min=1.0)
    loss = torch.sum((logz - gold) * m) / n
    acc = torch.sum((torch.argmax(lg, -1) == labels) * m) / n
    return loss, {"loss": loss, "acc": acc}


def graph_regression_loss(pred: torch.Tensor, target: torch.Tensor
                          ) -> tuple[torch.Tensor, dict]:
    err = pred.to(torch.float32) - target.to(torch.float32)
    loss = torch.mean(err * err)
    return loss, {"loss": loss, "mae": torch.mean(torch.abs(err))}
