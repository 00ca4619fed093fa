"""Gradient compression: int8 quantization with error feedback (EF-SGD
family), for a gradient all-reduce over a slow link (the reference's
cross-pod one).

Error feedback keeps the quantization noise from accumulating: the
residual e_t is added back before the next quantization, making the
scheme unbiased in the long run (Karimireddy et al., 2019).

The reference's collectives (``pmax`` / ``psum`` over a named axis inside
``shard_map``) become reductions over the participants on the one
controller, as ``core/distributed.py`` renders its collectives: the
participants' tensors come stacked on a leading dimension (or as a list),
and the reduced value — the same for every participant — comes back
once.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _stack(xs) -> torch.Tensor:
    return xs if isinstance(xs, torch.Tensor) else torch.stack(list(xs))


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q int8, scale f32); rounds half
    to even, as ``jnp.round``."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(xs: torch.Tensor | Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """Quantize -> all-reduce int8 (as int32 accumulate) -> dequantize,
    over the participants of ``xs`` ([P, ...] or a list of P tensors).

    Each participant re-quantizes to the largest scale first (the
    reference's ``pmax``) so the int32 sum is exact in the shared grid."""
    xs = _stack(xs)
    qs, scales = zip(*(quantize_int8(x) for x in xs))
    smax = torch.max(torch.stack(scales))
    total = torch.zeros(xs.shape[1:], dtype=torch.int32, device=xs.device)
    for q, scale in zip(qs, scales):
        q_shared = torch.clamp(torch.round(q.to(torch.float32)
                                           * (scale / smax)),
                               -127, 127).to(torch.int8)
        total += q_shared.to(torch.int32)
    return total.to(torch.float32) * smax


def ef_init(grads_like: dict) -> dict:
    """Zero error-feedback memory, one f32 tensor a leaf (stacked over the
    participants when the gradients are)."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}


def ef_compress_tree(grads: dict, ef: dict) -> tuple[dict, dict]:
    """Error-feedback compressed all-reduce over ``{name: [P, ...]}``
    gradients with their ``[P, ...]`` memories.

    Returns (reduced grads ``{name: [...]}``, new memories ``[P, ...]``)."""
    red, new_ef = {}, {}
    for k, g in grads.items():
        corrected = g.to(torch.float32) + ef[k]
        sent = torch.stack([dequantize_int8(*quantize_int8(c))
                            for c in corrected])
        new_ef[k] = corrected - sent
        red[k] = compressed_psum(corrected)
    return red, new_ef


def compression_ratio(tree: dict) -> float:
    """Wire bytes int8 / f32 (plus one f32 scale per tensor)."""
    f32 = sum(x.numel() * 4 for x in tree.values())
    i8 = sum(x.numel() * 1 + 4 for x in tree.values())
    return i8 / f32
