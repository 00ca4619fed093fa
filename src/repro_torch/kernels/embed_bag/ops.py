"""``bag_lookup``: the differentiable embedding-bag lookup (the recsys
training path) on kernel K5 — torch rendering of
``repro.kernels.embed_bag.ops``, whose custom VJP becomes a
``torch.autograd.Function``.

The reference has no backward kernel: its VJP is JAX's AD of the jnp
oracle, the transposed scatter-add into the table.  So the backward here
is plain torch on any device, ``neighbor_reduce``'s with the mask
``idx >= 0``: each live slot adds its bag's cotangent (divided by the
bag's count for mean) to ``table[idx[b, l]]``; a -1 slot adds nothing (row
0 gets nothing from padding), nor does a live index past the table.  The scatter is ``index_add_`` in f32,
rounded once to the table's dtype; on a CUDA device it adds with atomics
in no fixed order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embed_bag.embed_bag import embedding_bag
from repro_torch.kernels.embed_bag.ref import embedding_bag_ref
from repro_torch.kernels.spmm.ops import spmm_ell_grad


class _BagLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx, agg, use_kernel):
        out = (embedding_bag(table, idx, agg=agg) if use_kernel
               else embedding_bag_ref(table, idx, agg=agg))
        ctx.agg = agg
        ctx.save_for_backward(table, idx)
        return out

    @staticmethod
    def backward(ctx, g):
        table, idx = ctx.saved_tensors
        return (spmm_ell_grad(table, idx, idx >= 0, None, g, ctx.agg), None,
                None, None)


def bag_lookup(table: torch.Tensor, idx: torch.Tensor, agg: str = "sum",
               use_kernel: bool | None = None) -> torch.Tensor:
    """Differentiable ``embedding_bag`` (only ``table`` takes a gradient).
    ``use_kernel`` None (the default) or True: the K5 wrapper, which runs
    the kernel on CUDA tensors and the plain version on CPU ones; False:
    the plain version on any device."""
    return _BagLookup.apply(table, idx, agg, use_kernel is not False)
