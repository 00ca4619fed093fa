"""ELLPACK min-plus relaxation (kernel K1) — wrapper of the hand-written
Hopper kernel ``csrc/ellpack_relax.cu``, the port of the Pallas TPU kernel
``repro.kernels.relax.relax.ellpack_relax``.

``ellpack_relax(offers, nbr_idx, nbr_w) -> (best f32[R], arg i32[R])``
computes exactly ``ellpack_relax_ref`` (ref.py).  Its lane form takes
``offers`` (S, N) — S trees over the one shared block — and gives (S, R)
in ONE launch, each lane what a single-lane call on it gives.  Tensors on
the CPU take the plain version; tensors on a CUDA device launch the kernel
or raise — there is no fallback.  ``ellpack_relax.launches`` counts kernel
launches and ``.lane_launches`` those of the lane form (plain integers;
callers reset them to 0 to count one run).

The kernel has two variants, chosen by its C launcher: ``variant`` gives
the rule.  ``wave_bytes`` is the bytes one call must move, its bound.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.relax.ref import ellpack_relax_ref

SOURCE = Path(__file__).parent / "csrc" / "ellpack_relax.cu"


def variant(nbr_idx: torch.Tensor, nbr_w: torch.Tensor) -> str:
    """The kernel variant the C launcher picks for an ELL block: "vector"
    (a lane loads 4 cells as one float4 of weights and one int4 of
    indices) where K % 4 == 0 and both blocks start on a 16-byte boundary,
    else "scalar" (one cell a lane; e.g. a view at an odd cell offset, as
    ``sliced_gather_min`` passes one run of slices)."""
    aligned = (nbr_idx.data_ptr() | nbr_w.data_ptr()) % 16 == 0
    return "vector" if nbr_w.shape[1] % 4 == 0 and aligned else "scalar"


def wave_bytes(num_offers: int, rows: int, k: int, live_cells: int,
               lanes: int = 1) -> int:
    """Bytes one K1 call must move, each input read once and each output
    written once, counted on the block's own data: the offers vector
    (4N per lane), every weight (4RK), the index of each finite-weight cell
    (4 live; a +inf weight makes its candidate +inf whatever the index
    says), best + arg (8R per lane).  The block is shared by the lanes, so
    it counts once whatever ``lanes`` is."""
    return (lanes * (4 * num_offers + 8 * rows) + 4 * rows * k
            + 4 * live_cells)


@functools.cache
def launcher(lanes: bool = False):
    """The kernel's C launcher (the lane form's with ``lanes``), built at
    first use and bound once per process."""
    if lanes:
        return build.launcher(SOURCE, "ellpack_relax_lanes_launch",
                              [ctypes.c_void_p] * 5 + [
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int])
    return build.launcher(SOURCE, "ellpack_relax_launch",
                          [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                                   ctypes.c_int])


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
    if (offers.dim() not in (1, 2) or nbr_idx.dim() != 2
            or nbr_idx.shape != nbr_w.shape or nbr_idx.shape[1] < 1):
        raise ValueError(
            f"ellpack_relax: expected offers (N,) or (S, N), nbr_idx = "
            f"nbr_w (R, K>=1); "
            f"got {tuple(offers.shape)}, {tuple(nbr_idx.shape)}, "
            f"{tuple(nbr_w.shape)}")
    if not (offers.is_contiguous() and nbr_idx.is_contiguous()
            and nbr_w.is_contiguous()):
        raise ValueError("ellpack_relax: tensors must be contiguous")


def ellpack_relax(offers: torch.Tensor, nbr_idx: torch.Tensor,
                  nbr_w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """best[i], arg[i] = min-plus reduction of row i's in-neighbors (per
    lane for (S, N) offers).

    Shapes: offers (N,) or (S, N) f32; nbr_idx (R, K) i32 (entries in
    [0, N)); nbr_w (R, K) f32 (+inf padding and tombstones).  No row-count
    constraint.
    """
    if (offers.device.type == "cpu" and nbr_idx.device.type == "cpu"
            and nbr_w.device.type == "cpu"):
        return ellpack_relax_ref(offers, nbr_idx, nbr_w)
    _check(offers, nbr_idx, nbr_w)
    rows, k = nbr_idx.shape
    lanes = offers.shape[:-1]
    best = torch.empty((*lanes, rows), dtype=torch.float32,
                       device=offers.device)
    arg = torch.empty((*lanes, rows), dtype=torch.int32, device=offers.device)
    if best.numel() == 0:
        return best, arg
    ptrs = (offers.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(),
            best.data_ptr(), arg.data_ptr())
    if lanes:
        build.launch("ellpack_relax", launcher(True), offers.device, *ptrs,
                     rows, k, offers.shape[-1], lanes[0])
        ellpack_relax.lane_launches += 1
    else:
        build.launch("ellpack_relax", launcher(), offers.device, *ptrs,
                     rows, k)
    ellpack_relax.launches += 1
    return best, arg


ellpack_relax.launches = 0
ellpack_relax.lane_launches = 0
