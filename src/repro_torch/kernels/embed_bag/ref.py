"""Plain-torch embedding-bag (kernel K5's plain version), the counterpart
of ``repro.kernels.embed_bag.ref.embedding_bag_ref`` (the recsys lookup):

    out[b, :] = agg_{l : idx[b, l] >= 0} table[idx[b, l], :]  (* wt[b, l])

agg in {sum, mean}; -1 marks a padding slot.  It is K4's plain version
(``spmm_ell_ref``) with the mask ``idx >= 0``: f32 accumulation over l in
index order 0..L-1, mean = sum / max(count, 1) in f32, one rounding to the
table's dtype at the end, as the Pallas kernel body
(``repro.kernels.embed_bag.embed_bag._make_kernel``) and the CUDA kernel
compute — on the card kernel and plain version agree bit for bit.  A
padding slot's row is never used; a live index past the table reads its
last row, as a JAX gather clamps.  ``weights`` (per slot) exist on this
plain path only, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmm.ref import spmm_ell_ref

AGGS = ("sum", "mean")


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      agg: str = "sum") -> torch.Tensor:
    """table (V, D) f32/bf16; idx (B, L) int, -1 = padding; weights (B, L)
    or None -> (B, D) in the table's dtype."""
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    return spmm_ell_ref(table, idx, idx >= 0, agg, weights=weights)
