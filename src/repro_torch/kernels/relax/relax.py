"""ELLPACK min-plus relaxation (kernel K1) — wrapper of the hand-written
Hopper kernel ``csrc/ellpack_relax.cu``, the port of the Pallas TPU kernel
``repro.kernels.relax.relax.ellpack_relax``.

``ellpack_relax(offers, nbr_idx, nbr_w) -> (best f32[R], arg i32[R])``
computes exactly ``ellpack_relax_ref`` (ref.py).  Its lane form takes
``offers`` (S, N) — S trees over the one shared block — and gives (S, R)
in ONE launch, each lane what a single-lane call on it gives.  The kernel
gathers the lanes' offers lane-minor (``lane_minor``: one load a cell
for up to 8 lanes); a caller that runs several blocks over the same
offers (one per width run of a sliced layout, one per partition of a
mesh) makes that copy once and passes it as ``offers_minor=``, else the
wrapper makes it.  Tensors on the CPU take the plain versions; tensors on
a CUDA device launch the kernels or raise — there is no fallback.
``ellpack_relax.launches`` counts K1 launches, ``.lane_launches`` those of
the lane form and ``lane_minor.launches`` the interleaves (plain
integers; callers reset them to 0 to count one run).

The kernel has two variants, chosen by its C launcher: ``variant`` gives
the rule.  ``wave_bytes`` is the bytes one call must move, its bound.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.relax.ref import (ellpack_relax_ref, lane_minor_ref,
                                           lane_minor_shape)

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


@functools.cache
def interleave_launcher():
    """The lane-minor interleave's C launcher (``lane_minor_launch``, in
    the kernel's library)."""
    return build.launcher(SOURCE, "lane_minor_launch",
                          [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
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


def lane_minor(offers: torch.Tensor, active: torch.Tensor | None = None
               ) -> torch.Tensor:
    """(S, N) offers as K1's lane form gathers them: (groups, N, W), W =
    ``lane_group(S)`` lanes a group, out[g, v, j] = offers[g * W + j, v],
    +inf past the last lane and where ``active`` (if given, (S, N) bool)
    is False.  CPU tensors take ``lane_minor_ref``; on a CUDA device one
    interleave launch (``lane_minor.cuh``, the pass K2's lane form runs
    inside its own launch), or a view of the offers for one lane and no
    mask."""
    if offers.device.type == "cpu" and (active is None
                                        or active.device.type == "cpu"):
        return lane_minor_ref(offers, active)
    if (offers.dim() != 2 or offers.dtype != torch.float32
            or not offers.is_contiguous() or offers.device.type != "cuda"
            or (active is not None and (
                active.shape != offers.shape or active.dtype != torch.bool
                or active.device != offers.device
                or not active.is_contiguous()))):
        raise ValueError(
            f"lane_minor: expected contiguous f32 (S, N) offers on a CUDA "
            f"device and an optional bool mask of their shape; got "
            f"{offers.dtype} {tuple(offers.shape)} on {offers.device}")
    s, n = offers.shape
    if s == 1 and active is None:
        return offers.view(lane_minor_shape(1, n))
    out = torch.empty(lane_minor_shape(s, n), dtype=torch.float32,
                      device=offers.device)
    if out.numel():
        build.launch("lane_minor", interleave_launcher(), offers.device,
                     offers.data_ptr(),
                     0 if active is None else active.data_ptr(),
                     out.data_ptr(), n, s)
        lane_minor.launches += 1
    return out


lane_minor.launches = 0


class LaneMinorOnce:
    """``lane_minor`` of the last offers tensor it was given, made again
    only for another tensor or one written in place since (``_version``):
    the sharded wave hands every partition of a device the same gathered
    offers, so a mesh wave makes one copy a device, not one a partition.
    None for one lane's (N,) offers."""

    def __init__(self):
        self._of: tuple[torch.Tensor, int] | None = None
        self._copy: torch.Tensor | None = None

    def __call__(self, offers: torch.Tensor) -> torch.Tensor | None:
        if offers.dim() != 2:
            return None
        if (self._of is None or self._of[0] is not offers
                or self._of[1] != offers._version):
            self._copy = lane_minor(offers)
            self._of = (offers, offers._version)
        return self._copy


def ellpack_relax(dist: torch.Tensor, nbr_idx: torch.Tensor,
                  nbr_w: torch.Tensor, *,
                  offers_minor: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """best[i], arg[i] = min-plus reduction of row i's in-neighbors (per
    lane for (S, N) dist).

    Shapes: dist (N,) or (S, N) f32, the offers (+inf where a source does
    not offer: the waves pass frontier-masked distances); nbr_idx (R, K)
    i32 (entries in [0, N)); nbr_w (R, K) f32 (+inf padding and
    tombstones).  No row-count constraint.  ``offers_minor``:
    ``lane_minor(dist)`` already made (for (S, N) dist only; the kernel
    reads the offers from it).
    """
    if (dist.device.type == "cpu" and nbr_idx.device.type == "cpu"
            and nbr_w.device.type == "cpu" and (
                offers_minor is None or offers_minor.device.type == "cpu")):
        return ellpack_relax_ref(dist, nbr_idx, nbr_w,
                                 offers_minor=offers_minor)
    _check(dist, nbr_idx, nbr_w)
    rows, k = nbr_idx.shape
    lanes = dist.shape[:-1]
    if offers_minor is not None and (
            not lanes or tuple(offers_minor.shape) != lane_minor_shape(
                *dist.shape)
            or offers_minor.dtype != torch.float32
            or offers_minor.device != dist.device
            or not offers_minor.is_contiguous()
            or offers_minor.data_ptr() % 16):
        raise ValueError(
            f"ellpack_relax: offers_minor must be the contiguous, 16-byte "
            f"aligned f32 lane-minor copy of (S, N) dist on "
            f"{dist.device}; got {offers_minor.dtype} "
            f"{tuple(offers_minor.shape)} on {offers_minor.device} for "
            f"dist {tuple(dist.shape)}")
    best = torch.empty((*lanes, rows), dtype=torch.float32,
                       device=dist.device)
    arg = torch.empty((*lanes, rows), dtype=torch.int32, device=dist.device)
    if best.numel() == 0:
        return best, arg
    if lanes:
        minor = lane_minor(dist) if offers_minor is None else offers_minor
        build.launch("ellpack_relax", launcher(True), dist.device,
                     minor.data_ptr(), nbr_idx.data_ptr(), nbr_w.data_ptr(),
                     best.data_ptr(), arg.data_ptr(), rows, k,
                     dist.shape[-1], lanes[0])
        ellpack_relax.lane_launches += 1
    else:
        build.launch("ellpack_relax", launcher(), dist.device,
                     dist.data_ptr(), nbr_idx.data_ptr(),
                     nbr_w.data_ptr(), best.data_ptr(), arg.data_ptr(),
                     rows, k)
    ellpack_relax.launches += 1
    return best, arg


ellpack_relax.launches = 0
ellpack_relax.lane_launches = 0
