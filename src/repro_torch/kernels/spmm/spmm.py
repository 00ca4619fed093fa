"""ELL gather-reduce SpMM (kernel K4) — wrapper of the hand-written Hopper
kernel ``csrc/spmm_ell.cu``, the port of the Pallas TPU kernel
``repro.kernels.spmm.spmm.spmm_ell``.

``spmm_ell(feats, nbr_idx, nbr_mask, *, agg) -> out (R, F)`` computes
exactly ``spmm_ell_ref`` (ref.py).  Tensors on the CPU take that plain
version; tensors on a CUDA device launch the kernel or raise — there is no
fallback.  ``spmm_ell.launches`` counts kernel launches (a plain integer;
callers reset it to 0 to count one run).  The TPU kernel's ``block_rows``,
``block_feat`` and ``interpret`` have no counterpart: any R, K and F.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.spmm.ref import AGGS, spmm_ell_ref

SOURCE = Path(__file__).parent / "csrc" / "spmm_ell.cu"
DTYPES = (torch.float32, torch.bfloat16)   # the C interface's dtype codes


@functools.cache
def launcher():
    """The kernel's C launcher, built at first use and bound once per
    process."""
    return build.launcher(SOURCE, "spmm_ell_launch",
                          [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                          + [ctypes.c_int] * 5)


def _check(feats: torch.Tensor, nbr_idx: torch.Tensor,
           nbr_mask: torch.Tensor) -> None:
    dev = feats.device
    if dev.type != "cuda" or nbr_idx.device != dev or nbr_mask.device != dev:
        raise ValueError(
            f"spmm_ell: tensors must share one CUDA device; got "
            f"{feats.device}, {nbr_idx.device}, {nbr_mask.device}")
    if (feats.dtype not in DTYPES or nbr_idx.dtype != torch.int32
            or nbr_mask.dtype != torch.bool):
        raise ValueError(
            f"spmm_ell: expected (f32 or bf16, i32, bool); got "
            f"({feats.dtype}, {nbr_idx.dtype}, {nbr_mask.dtype})")
    if (feats.dim() != 2 or nbr_idx.dim() != 2
            or nbr_idx.shape != nbr_mask.shape):
        raise ValueError(
            f"spmm_ell: expected feats (S, F), nbr_idx = nbr_mask (R, K); "
            f"got {tuple(feats.shape)}, {tuple(nbr_idx.shape)}, "
            f"{tuple(nbr_mask.shape)}")
    if not (feats.is_contiguous() and nbr_idx.is_contiguous()
            and nbr_mask.is_contiguous()):
        raise ValueError("spmm_ell: tensors must be contiguous")
    if feats.shape[0] == 0 and nbr_idx.numel():
        raise ValueError("spmm_ell: feats has no rows to gather")


def spmm_ell(feats: torch.Tensor, nbr_idx: torch.Tensor,
             nbr_mask: torch.Tensor, *, agg: str = "sum") -> torch.Tensor:
    """feats (S, F) f32/bf16; nbr_idx (R, K) i32, a live cell's index
    clamped into [0, S); nbr_mask (R, K) bool -> (R, F) in feats' dtype."""
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    if all(t.device.type == "cpu" for t in (feats, nbr_idx, nbr_mask)):
        return spmm_ell_ref(feats, nbr_idx, nbr_mask, agg)
    _check(feats, nbr_idx, nbr_mask)
    (rows, k), (s, f) = nbr_idx.shape, feats.shape
    out = torch.empty((rows, f), dtype=feats.dtype, device=feats.device)
    if rows == 0 or f == 0:
        return out
    build.launch("spmm_ell", launcher(), feats.device, feats.data_ptr(),
                 nbr_idx.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(),
                 rows, k, f, s, AGGS.index(agg), DTYPES.index(feats.dtype))
    spmm_ell.launches += 1
    return out


spmm_ell.launches = 0
