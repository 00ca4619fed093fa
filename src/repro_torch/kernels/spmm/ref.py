"""Plain-torch ELL gather-reduce SpMM (kernel K4's plain version), the
counterpart of ``repro.kernels.spmm.ref.spmm_ell_ref`` (GNN neighbour
aggregation):

    out[i, :] = agg_{k : mask[i,k]} feats[nbr_idx[i, k], :]

agg in {sum, mean, max}.  It computes what the Pallas kernel body
(``repro.kernels.spmm.spmm._make_kernel``) and the CUDA kernel compute:
f32 accumulation over k in index order 0..K-1, one rounding to feats'
dtype at the end; mean = sum / max(count, 1) in f32; max starts from
finfo(f32).min, takes a NaN among the live cells as ``jnp.max`` does, and
gives 0 for an all-masked row.  So on the card kernel and plain version
agree bit for bit.  Every index is clamped into [0, S) before the gather:
a masked cell's value is never used (the sampler writes -1 for a missing
neighbour), and a live one past the end reads row S-1, as a JAX gather
does.
``weights`` (per cell, the embedding bag's) exist on this plain path only.
"""
from __future__ import annotations

import torch

AGGS = ("sum", "mean", "max")
F32_MIN = torch.finfo(torch.float32).min


def take_max(m: torch.Tensor, v: torch.Tensor,
             live: torch.Tensor) -> torch.Tensor:
    """The running max ``m`` after cell value ``v`` where ``live``: ``v``
    wins unless ``m`` is NaN, if it is NaN or larger (the kernel's rule)."""
    return torch.where(live & ~m.isnan() & (v.isnan() | (m < v)), v, m)


def spmm_ell_ref(feats: torch.Tensor, nbr_idx: torch.Tensor,
                 nbr_mask: torch.Tensor, agg: str = "sum", *,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """feats (S, F) f32/bf16; nbr_idx (R, K) int; nbr_mask (R, K) bool;
    weights (R, K) or None -> (R, F) in feats' dtype."""
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    rows, k = nbr_idx.shape
    safe = nbr_idx.long().clamp(0, feats.shape[0] - 1)
    acc = torch.full((rows, feats.shape[1]), F32_MIN if agg == "max" else 0.0,
                     dtype=torch.float32, device=feats.device)
    for j in range(k):
        live = nbr_mask[:, j, None]
        g = feats[safe[:, j]].float()
        if weights is not None:
            g = g * weights[:, j, None].float()
        acc = (take_max(acc, g, live) if agg == "max"
               else torch.where(live, acc + g, acc))
    if agg == "mean":
        acc = acc / nbr_mask.sum(1, keepdim=True).clamp(min=1).float()
    elif agg == "max":
        acc = torch.where(nbr_mask.any(1, keepdim=True), acc, 0.0)
    return acc.to(feats.dtype)
