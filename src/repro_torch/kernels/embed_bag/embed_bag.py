"""Embedding-bag lookup (kernel K5) — wrapper of the hand-written Hopper
kernel ``csrc/embedding_bag.cu``, the port of the Pallas TPU kernel
``repro.kernels.embed_bag.embed_bag.embedding_bag``.

``embedding_bag(table, idx, *, agg) -> out (B, D)`` computes exactly
``embedding_bag_ref(table, idx, agg=agg)`` (ref.py).  Tensors on the CPU
take that plain version; tensors on a CUDA device launch the kernel or
raise — there is no fallback.  ``embedding_bag.launches`` counts kernel
launches (a plain integer; callers reset it to 0 to count one run).  The
TPU kernel's ``block_bags`` and ``interpret`` have no counterpart: any B,
L and D.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.embed_bag.ref import AGGS, embedding_bag_ref

SOURCE = Path(__file__).parent / "csrc" / "embedding_bag.cu"
DTYPES = (torch.float32, torch.bfloat16)   # the C interface's dtype codes


@functools.cache
def launcher():
    """The kernel's C launcher, built at first use and bound once per
    process."""
    return build.launcher(SOURCE, "embedding_bag_launch",
                          [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                          + [ctypes.c_int] * 5)


def _check(table: torch.Tensor, idx: torch.Tensor,
           dev: torch.device) -> None:
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(
            f"embedding_bag: tensors must share one CUDA device; got "
            f"{dev}, {idx.device}")
    if table.dtype not in DTYPES or idx.dtype != torch.int32:
        raise ValueError(
            f"embedding_bag: expected (f32 or bf16, i32); got "
            f"({table.dtype}, {idx.dtype})")
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(
            f"embedding_bag: expected table (V, D), idx (B, L); got "
            f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("embedding_bag: tensors must be contiguous")
    if table.shape[0] == 0 and idx.numel():
        raise ValueError("embedding_bag: the table has no rows to gather")


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  agg: str = "sum") -> torch.Tensor:
    """table (V, D) f32/bf16; idx (B, L) i32, -1 = padding, a live index
    clamped to at most V - 1 -> (B, D) in the table's dtype."""
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    dev = table.device        # read once: each read builds a device object
    if dev.type == "cpu" and idx.device.type == "cpu":
        return embedding_bag_ref(table, idx, agg=agg)
    _check(table, idx, dev)
    (bags, slots), (v, d) = idx.shape, table.shape
    out = table.new_empty((bags, d))
    if bags == 0 or d == 0:
        return out
    build.launch("embedding_bag", launcher(), dev, table.data_ptr(),
                 idx.data_ptr(), out.data_ptr(), bags, slots, d, v,
                 AGGS.index(agg), DTYPES.index(table.dtype))
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
