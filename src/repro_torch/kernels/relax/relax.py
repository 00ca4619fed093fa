"""ELLPACK min-plus relaxation (kernel K1) — wrapper of the hand-written
Hopper kernel ``csrc/ellpack_relax.cu``, the port of the Pallas TPU kernel
``repro.kernels.relax.relax.ellpack_relax``.

``ellpack_relax(offers, nbr_idx, nbr_w) -> (best f32[R], arg i32[R])``
computes exactly ``ellpack_relax_ref`` (ref.py).  Tensors on the CPU take
that plain version; tensors on a CUDA device launch the kernel or raise —
there is no fallback.  ``ellpack_relax.launches`` counts kernel launches
(a plain integer; callers reset it to 0 to count one run).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.relax.ref import ellpack_relax_ref

SOURCE = Path(__file__).parent / "csrc" / "ellpack_relax.cu"


@functools.cache
def load() -> build.Built:
    """Build (at first use) and bind the kernel library, once per process."""
    built = build.load(SOURCE)
    fn = built.lib.ellpack_relax_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


def _check(offers: torch.Tensor, nbr_idx: torch.Tensor,
           nbr_w: torch.Tensor) -> None:
    dev = offers.device
    if dev.type != "cuda" or nbr_idx.device != dev or nbr_w.device != dev:
        raise ValueError(
            f"ellpack_relax: tensors must share one CUDA device; got "
            f"{offers.device}, {nbr_idx.device}, {nbr_w.device}")
    if (offers.dtype, nbr_idx.dtype, nbr_w.dtype) != (
            torch.float32, torch.int32, torch.float32):
        raise ValueError(
            f"ellpack_relax: expected (f32, i32, f32); got "
            f"({offers.dtype}, {nbr_idx.dtype}, {nbr_w.dtype})")
    if (offers.dim() != 1 or nbr_idx.dim() != 2
            or nbr_idx.shape != nbr_w.shape or nbr_idx.shape[1] < 1):
        raise ValueError(
            f"ellpack_relax: expected offers (N,), nbr_idx = nbr_w (R, K>=1); "
            f"got {tuple(offers.shape)}, {tuple(nbr_idx.shape)}, "
            f"{tuple(nbr_w.shape)}")
    if not (offers.is_contiguous() and nbr_idx.is_contiguous()
            and nbr_w.is_contiguous()):
        raise ValueError("ellpack_relax: tensors must be contiguous")


def ellpack_relax(offers: torch.Tensor, nbr_idx: torch.Tensor,
                  nbr_w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """best[i], arg[i] = min-plus reduction of row i's in-neighbors.

    Shapes: offers (N,) f32; nbr_idx (R, K) i32 (entries in [0, N)); nbr_w
    (R, K) f32 (+inf padding and tombstones).  No row-count constraint.
    """
    if (offers.device.type == "cpu" and nbr_idx.device.type == "cpu"
            and nbr_w.device.type == "cpu"):
        return ellpack_relax_ref(offers, nbr_idx, nbr_w)
    _check(offers, nbr_idx, nbr_w)
    rows, k = nbr_idx.shape
    best = torch.empty(rows, dtype=torch.float32, device=offers.device)
    arg = torch.empty(rows, dtype=torch.int32, device=offers.device)
    if rows == 0:
        return best, arg
    lib = load().lib
    with torch.cuda.device(offers.device):
        stream = torch.cuda.current_stream(offers.device).cuda_stream
        err = lib.ellpack_relax_launch(
            offers.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(),
            best.data_ptr(), arg.data_ptr(), rows, k, stream)
    if err:
        raise RuntimeError(f"ellpack_relax: kernel launch failed with CUDA "
                           f"error {err}")
    ellpack_relax.launches += 1
    return best, arg


ellpack_relax.launches = 0
