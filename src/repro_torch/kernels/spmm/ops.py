"""``neighbor_reduce``: differentiable neighbour aggregation (the
GraphSAGE / MeshGraphNet hot path) on kernel K4 — torch rendering of
``repro.kernels.spmm.ops``, whose custom VJP becomes a
``torch.autograd.Function``.

The reference has no backward kernel: its VJP is JAX's AD of the jnp
oracle.  So the backward here is plain torch on any device, following
JAX's rules: each live cell scatters its row's cotangent (divided by the
row's count for mean) into ``feats[nbr_idx[i, k]]``; masked cells give
nothing (a -1 never reaches row 0); for max, the row's cotangent is split
equally among the cells that attain the max (``reduce_max``'s JVP), so a
NaN row sends NaN to its live cells; an all-masked row passes nothing.  A
live index outside [0, S) passes nothing either: the forward read it
clamped, but JAX's transposed gather drops it.  The scatter is ``index_add_`` in f32, rounded once to feats' dtype;
on a CUDA device it adds with atomics in no fixed order.  ``bag_lookup``'s
backward is this one's sum/mean with the mask ``idx >= 0``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmm.ref import F32_MIN, spmm_ell_ref
from repro_torch.kernels.spmm.spmm import spmm_ell


def spmm_ell_grad(feats: torch.Tensor, nbr_idx: torch.Tensor,
                  nbr_mask: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                  agg: str) -> torch.Tensor:
    """d(feats) for cotangent ``g`` of ``out = spmm_ell_ref(...)`` (``out``
    is read for max only)."""
    s = feats.shape[0]
    rows, cells = (nbr_mask & (nbr_idx >= 0) & (nbr_idx < s)).nonzero(
        as_tuple=True)
    g = g.float()
    if agg == "mean":
        g = g / nbr_mask.sum(1, keepdim=True).clamp(min=1).float()
    if agg == "max":
        safe = nbr_idx.long().clamp(0, s - 1)
        vals = torch.where(nbr_mask[..., None], feats[safe].float(), F32_MIN)
        eq = vals == out.float()[:, None]
        share = torch.where(nbr_mask.any(1, keepdim=True), g, 0.0) / eq.sum(1)
        contrib = (share[:, None] * eq)[rows, cells]
    else:
        contrib = g[rows]
    dfeats = torch.zeros(feats.shape, dtype=torch.float32,
                         device=feats.device)
    dfeats.index_add_(0, nbr_idx[rows, cells].long(), contrib)
    return dfeats.to(feats.dtype)


class _NeighborReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, nbr_idx, nbr_mask, agg, use_kernel):
        out = (spmm_ell(feats, nbr_idx, nbr_mask, agg=agg) if use_kernel
               else spmm_ell_ref(feats, nbr_idx, nbr_mask, agg))
        ctx.agg = agg
        ctx.save_for_backward(feats, nbr_idx, nbr_mask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        feats, nbr_idx, nbr_mask, out = ctx.saved_tensors
        return (spmm_ell_grad(feats, nbr_idx, nbr_mask, out, g, ctx.agg),
                None, None, None, None)


def neighbor_reduce(feats: torch.Tensor, nbr_idx: torch.Tensor,
                    nbr_mask: torch.Tensor, agg: str = "sum",
                    use_kernel: bool | None = None) -> torch.Tensor:
    """Differentiable ``spmm_ell`` (only ``feats`` takes a gradient).
    ``use_kernel`` None (the default) or True: the K4 wrapper, which runs
    the kernel on CUDA tensors and the plain version on CPU ones; False:
    the plain version on any device."""
    return _NeighborReduce.apply(feats, nbr_idx, nbr_mask, agg,
                                 use_kernel is not False)
