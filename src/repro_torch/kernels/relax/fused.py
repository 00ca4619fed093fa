"""Fused hybrid sliced-ELL + overflow-COO wave (kernel K2) — wrapper of the
hand-written Hopper kernel ``csrc/fused_sliced_relax.cu``, the port of the
Pallas TPU kernel ``repro.kernels.relax.fused.fused_sliced_relax``; plus the
run-group helper and the TPU kernel's cost model, copied from that module.

``fused_sliced_relax(dist, active, layout) -> (best f32[R], arg i32[R])``
computes exactly ``fused_sliced_relax_ref`` (ref.py) over the layout's
arrays: the frontier-masked ELL lane over the flat buffer, the overflow COO
lane and the lane combine in one call, ``arg = INT_MAX`` where nothing is
finite.  ``dist`` / ``active`` may be ``[S, N]``, S trees over the one
layout: one launch serves all S lanes and gives ``[S, R]``, each lane what
a single-lane call on it gives; it first interleaves the masked offers
lane-minor (``ref.lane_minor_ref(dist, active)``) into scratch the wrapper
allocates beside the keys, so one gather serves up to 8 lanes.  Tensors
on the CPU take the plain version; tensors on a CUDA device launch the
kernel or raise — there is no fallback.  ``fused_sliced_relax.launches``
counts kernel launches and ``.lane_launches`` those of the lane form
(plain integers; callers reset them to 0 to count one run).

The TPU kernel makes one ``pallas_call`` per distinct-width run and rescans
the whole overflow segment in each; the CUDA kernel reads the segment once
per wave (one 64-bit ``atomicMin`` per live entry) and then covers all rows
in one launch, one thread block per chunk of ``block_table`` — the
layout's geometry, made on the host once per layout and kept on the device
beside it with its sizes (``ChunkTable``, held by ``SlicedEllState``).
The wrapper takes the table and every size from the layout object and
refuses one whose table was made for other widths.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.graphs.csr import slice_offsets, width_runs
from repro_torch.kernels import build
from repro_torch.kernels.relax.ref import (fused_sliced_relax_ref,
                                           lane_minor_shape)

SOURCE = Path(__file__).parent / "csrc" / "fused_sliced_relax.cu"
BLOCK_CELLS = 1024   # cells per chunk; the kernel's kChunk


def block_table(widths: tuple[int, ...] | list[int],
                slice_rows: int) -> np.ndarray:
    """The ELL pass's chunk table for the flat sliced layout of
    ``widths``: each run of equal-width slices (one row-major ``(rows,
    k)`` block at its ``slice_offsets`` offset) cut into chunks of
    ``max(BLOCK_CELLS, k)`` cells, whole rows each.  Returns i32[4 *
    chunks], one ``(first cell, first row, log2 k, cells)`` quadruple per
    chunk (one thread block each), in row order."""
    wid = np.asarray(widths, np.int64)
    if not len(wid):
        return np.zeros(0, np.int32)
    starts = np.flatnonzero(np.r_[True, wid[1:] != wid[:-1]])
    k = wid[starts]
    cells = np.diff(np.r_[starts, len(wid)]) * slice_rows * k
    cell0 = slice_offsets(widths, slice_rows)[starts]
    chunk = np.maximum(BLOCK_CELLS, k)
    per_run = -(-cells // chunk)
    run = np.repeat(np.arange(len(starts)), per_run)
    j = np.arange(len(run)) - np.repeat(np.cumsum(per_run) - per_run,
                                        per_run)
    off = j * chunk[run]
    table = np.stack([cell0[run] + off,
                      starts[run] * slice_rows + off // k[run],
                      np.log2(k[run]).astype(np.int64),
                      np.minimum(chunk[run], cells[run] - off)], axis=1)
    return table.astype(np.int32).ravel()


@dataclasses.dataclass(frozen=True)
class ChunkTable:
    """K2's chunk table of one flat sliced layout with the sizes the kernel
    is launched with, made once per layout (``build``) and kept beside it:
    a wave does no host work or copy for it."""

    blocks: torch.Tensor          # i32[4 * chunks], ``block_table``
    widths: tuple[int, ...]       # the layout it was made for
    slice_rows: int
    rows: int                     # R = len(widths) * slice_rows
    cells: int                    # L, cells of the flat buffer
    wide: bool                    # a slice wider than a warp (k > 32)

    @staticmethod
    def build(widths: tuple[int, ...], slice_rows: int,
              device: torch.device | str) -> "ChunkTable":
        """The table of ``widths`` (kept as given: a layout that holds the
        same tuple object matches it without a comparison)."""
        return ChunkTable(
            blocks=torch.tensor(block_table(widths, slice_rows),
                                device=device),
            widths=widths, slice_rows=slice_rows,
            rows=len(widths) * slice_rows,
            cells=int(slice_offsets(widths, slice_rows)[-1]),
            wide=max(widths, default=0) > 32)


def slice_run_groups(widths: tuple[int, ...] | list[int],
                     slice_rows: int) -> list[tuple[int, int]]:
    """Merge runs of equal-width slices and split each into a
    multiple-of-256-rows main block plus a remainder: list of
    ``(k, n_slices)`` groups, in row order (the reference's tiling)."""
    per_blk = max(1, 256 // slice_rows)
    groups: list[tuple[int, int]] = []
    for k, cnt in width_runs(widths):
        main = (cnt // per_blk) * per_blk
        if main:
            groups.append((k, main))
        if cnt - main:
            groups.append((k, cnt - main))
    return groups


def fused_cost(widths: tuple[int, ...] | list[int], slice_rows: int,
               num_vertices: int, overflow_cap: int) -> dict[str, float]:
    """The TPU kernel's analytic flop/byte model of one fused wave, summed
    over its per-run calls (copied from the reference): every run re-reads
    dist/active and rescans the whole overflow triplet.  The CUDA kernel
    reads each input once per wave — ``wave_bytes`` is its model."""
    C = max(overflow_cap, 1)
    flops = 0.0
    bytes_ = 0.0
    for k, cnt in width_runs(widths):
        rows_g = slice_rows * cnt
        flops += 3.0 * rows_g * k + 4.0 * C
        bytes_ += (5.0 * num_vertices       # dist f32 + active bool
                   + 8.0 * rows_g * k       # idx i32 + w f32 tiles
                   + 12.0 * C               # overflow triplet, per run
                   + 8.0 * rows_g)          # best f32 + arg i32 out
    return {"flops": flops, "bytes": bytes_,
            "intensity": flops / max(bytes_, 1.0)}


def wave_bytes(num_vertices: int, cells: int, live_cells: int,
               overflow_cap: int, live_overflow: int, rows: int,
               lanes: int = 1) -> int:
    """Bytes one K2 wave must move, each input read once and each output
    written once, counted on the layout's own data: dist + active (5N per
    lane), every weight (4L + 4C), the index of each finite-weight cell and
    the source and row of each finite-weight overflow entry (4 live_L +
    8 live_C; a +inf weight makes its candidate +inf whatever the index
    says), best + arg (8R per lane).  The layout is shared by the lanes, so
    it counts once whatever ``lanes`` is.  With every entry live and one
    lane it is 5N + 8L + 12C + 8R."""
    return (lanes * (5 * num_vertices + 8 * rows) + 4 * cells
            + 4 * live_cells + 4 * overflow_cap + 8 * live_overflow)


@functools.cache
def launcher(lanes: bool = False):
    """The kernel's C launcher (the lane form's with ``lanes``), built at
    first use and bound once per process."""
    if lanes:
        return build.launcher(SOURCE, "fused_sliced_relax_lanes_launch",
                              [ctypes.c_void_p] * 12
                              + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
                              + [ctypes.c_longlong] * 2)
    return build.launcher(SOURCE, "fused_sliced_relax_launch",
                          [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 3
                          + [ctypes.c_int] * 2)


def fused_sliced_relax(dist: torch.Tensor, active: torch.Tensor, layout
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One hybrid wave over the ``R`` rows of ``layout`` — a
    ``SlicedEllState`` or any object with its ``flat_idx``, ``flat_w``,
    ``osrc``, ``odst``, ``ow``, ``widths`` and ``table`` (the layout's
    ``ChunkTable``): the flat buffer is laid out by ``sliced_geometry(widths,
    slice_rows)`` and a row's overflow entries are those with ``odst == r``;
    cell and overflow sources index ``dist``, ``odst`` lies in [0, R).
    ``active`` masks offer sources (all True for an unmasked pull wave);
    ``dist`` and ``active`` are ``[N]`` or ``[S, N]`` (S lanes, one launch).
    Raises ``ValueError``, on any device, where the layout has no table,
    its table was made for other widths or another slice height, or its
    flat buffer is not the table's size; the kernel also skips a chunk that would reach past the
    flat buffer or the rows."""
    t = layout.table
    if t is None or t.slice_rows != layout.slice_rows or (
            t.widths is not layout.widths
            and t.widths != tuple(layout.widths)):
        raise ValueError(
            "fused_sliced_relax: the layout's chunk table is missing or "
            "was made for another layout")
    flat_idx, flat_w = layout.flat_idx, layout.flat_w
    osrc, odst, ow = layout.osrc, layout.odst, layout.ow
    if flat_w.shape[0] != t.cells:
        raise ValueError(
            f"fused_sliced_relax: the layout of {len(t.widths)} slices of "
            f"{t.slice_rows} rows has {t.cells} cells; got flat_w of "
            f"{flat_w.shape[0]}")
    tensors = (dist, active, flat_idx, flat_w, osrc, odst, ow, t.blocks)
    if all(x.device.type == "cpu" for x in tensors):
        return fused_sliced_relax_ref(dist, active, flat_idx, flat_w, osrc,
                                      odst, ow, widths=t.widths,
                                      slice_rows=t.slice_rows)
    f32, i32 = torch.float32, torch.int32
    dev = build.check_args(
        "fused_sliced_relax", flat_idx=(flat_idx, i32), flat_w=(flat_w, f32),
        osrc=(osrc, i32), odst=(odst, i32), ow=(ow, f32),
        blocks=(t.blocks, i32))
    if (dist.device != dev or active.device != dev or dist.dtype != f32
            or active.dtype != torch.bool or dist.dim() not in (1, 2)
            or dist.shape != active.shape or not dist.is_contiguous()
            or not active.is_contiguous()
            or flat_idx.shape != flat_w.shape
            or not osrc.shape == odst.shape == ow.shape
            or t.blocks.data_ptr() % 16):
        raise ValueError(
            f"fused_sliced_relax: expected contiguous f32 dist and bool "
            f"active of one shape, (N,) or (S, N), on {dev}, flat_idx = "
            f"flat_w and osrc = odst = ow shapes and a 16-byte aligned "
            f"table; got {[(tuple(x.shape), x.dtype, str(x.device)) for x in tensors]}")
    lanes = dist.shape[:-1]
    best = torch.empty((*lanes, t.rows), dtype=f32, device=dev)
    arg = torch.empty((*lanes, t.rows), dtype=i32, device=dev)
    if best.numel() == 0:
        return best, arg
    words = t.blocks.shape[0]
    if lanes:
        # scratch: the lane-minor masked offers and the lane-minor keys
        groups, n, w = lane_minor_shape(lanes[0], dist.shape[-1])
        if lanes[0] == 1:
            key = torch.empty(t.rows, dtype=torch.int64, device=dev)
            offers_t = dist
        else:
            key = torch.empty((groups, t.rows, w), dtype=torch.int64,
                              device=dev)
            offers_t = torch.empty((groups, n, w), dtype=f32, device=dev)
        ptrs = [x.data_ptr() for x in (dist, active, flat_idx, flat_w,
                                       t.blocks, osrc, odst, ow, key,
                                       offers_t, best, arg)]
        build.launch("fused_sliced_relax", launcher(True), dev, *ptrs,
                     t.rows, t.cells, ow.shape[0], n, words // 4,
                     BLOCK_CELLS, lanes[0], int(t.wide), key.numel(),
                     offers_t.numel() if lanes[0] > 1 else 0)
        fused_sliced_relax.lane_launches += 1
    else:
        key = torch.empty(best.shape, dtype=torch.int64, device=dev)
        ptrs = [x.data_ptr() for x in (dist, active, flat_idx, flat_w,
                                       t.blocks, osrc, odst, ow, key, best,
                                       arg)]
        build.launch("fused_sliced_relax", launcher(), dev, *ptrs,
                     t.rows, t.cells, ow.shape[0], words // 4, BLOCK_CELLS)
    fused_sliced_relax.launches += 1
    return best, arg


fused_sliced_relax.launches = 0
fused_sliced_relax.lane_launches = 0
