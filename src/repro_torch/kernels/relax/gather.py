"""Gathered-edges relaxation (kernel K3) for the sparse frontier path —
wrapper of the hand-written Hopper kernel ``csrc/gathered_rows_relax.cu``,
the port of the Pallas TPU kernel
``repro.kernels.relax.gather.gathered_rows_relax``.

``gathered_rows_relax(src_dist, src_ids, nbr, w, mask, *, num_rows) ->
(best f32[num_rows], arg i32[num_rows])`` computes exactly
``gathered_rows_relax_ref`` (ref.py): candidates ``src_dist + w`` of the
masked-in slots scatter-min'd into their ``nbr`` rows, ``arg`` the smallest
``src_ids`` attaining each row's min, INT_MAX where no slot hit.  Its lane
form ``gathered_rows_relax_lanes`` takes ``[S, E]`` edge lists — S trees,
each with its own compacted frontier — and gives ``[S, R]`` in one launch
sequence, each lane what a single-lane call on it gives (the reference runs
the single kernel under ``jax.vmap``).  Tensors on the CPU take the plain
versions; tensors on a CUDA device launch the kernel or raise — there is no
fallback.  ``gathered_rows_relax.launches`` counts the single-lane
kernel's launches and ``.lane_launches`` the lane form's (plain integers;
callers reset them to 0 to count one run).  ``wave_bytes`` is the bytes one
call must move, its bound.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.relax.ref import (gathered_rows_relax_lanes_ref,
                                           gathered_rows_relax_ref)

SOURCE = Path(__file__).parent / "csrc" / "gathered_rows_relax.cu"

__all__ = ["gathered_rows_relax", "gathered_rows_relax_lanes",
           "gathered_rows_relax_lanes_ref", "gathered_rows_relax_ref",
           "launcher", "wave_bytes"]


def wave_bytes(edges: int, masked_in: int, rows: int, lanes: int = 1) -> int:
    """Bytes one K3 call must move, each input read once and each output
    written once, counted on the call's own data: one mask byte per slot
    (E a lane), src_dist, src_ids, nbr and w of each masked-in slot (16
    bytes each, ``masked_in`` summed over the lanes; a masked-out slot is
    dropped whatever they say), best + arg (8R a lane)."""
    return lanes * (edges + 8 * rows) + 16 * masked_in


@functools.cache
def launcher(lanes: bool = False):
    """The kernel's C launcher (the lane form's with ``lanes``), built at
    first use and bound once per process."""
    if lanes:
        return build.launcher(SOURCE, "gathered_rows_relax_lanes_launch",
                              [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3)
    return build.launcher(SOURCE, "gathered_rows_relax_launch",
                          [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2)


def _check(kernel: str, tensors: tuple, ndim: int) -> torch.device:
    src_dist, src_ids, nbr, w, mask = tensors
    f32, i32 = torch.float32, torch.int32
    dev = build.check_args(
        kernel, ndim=ndim, src_dist=(src_dist, f32), src_ids=(src_ids, i32),
        nbr=(nbr, i32), w=(w, f32), mask=(mask, torch.bool))
    if len({tuple(t.shape) for t in tensors}) != 1:
        raise ValueError(f"{kernel}: the five edge arrays must share one "
                         f"shape; got {[tuple(t.shape) for t in tensors]}")
    return dev


def gathered_rows_relax(src_dist: torch.Tensor, src_ids: torch.Tensor,
                        nbr: torch.Tensor, w: torch.Tensor,
                        mask: torch.Tensor, *, num_rows: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Five edge-aligned 1-D arrays of one length E (f32, i32, i32, f32,
    bool); masked-in slots must have ``nbr`` in [0, num_rows) and
    ``src_ids`` >= 0."""
    tensors = (src_dist, src_ids, nbr, w, mask)
    if all(t.device.type == "cpu" for t in tensors):
        return gathered_rows_relax_ref(src_dist, src_ids, nbr, w, mask,
                                       num_rows=num_rows)
    dev = _check("gathered_rows_relax", tensors, 1)
    best = torch.empty(num_rows, dtype=torch.float32, device=dev)
    arg = torch.empty(num_rows, dtype=torch.int32, device=dev)
    if num_rows == 0:
        return best, arg
    key = torch.empty(num_rows, dtype=torch.int64, device=dev)
    build.launch("gathered_rows_relax", launcher(), dev,
                 *(t.data_ptr() for t in (*tensors, key, best, arg)),
                 mask.shape[0], num_rows)
    gathered_rows_relax.launches += 1
    return best, arg


def gathered_rows_relax_lanes(src_dist: torch.Tensor, src_ids: torch.Tensor,
                              nbr: torch.Tensor, w: torch.Tensor,
                              mask: torch.Tensor, *, num_rows: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The lane form: five ``[S, E]`` arrays (the dtypes and rules of
    ``gathered_rows_relax``, lane by lane), lane s's slots scattered into
    its own ``num_rows`` rows.  Returns (best f32[S, R], arg i32[S, R])."""
    tensors = (src_dist, src_ids, nbr, w, mask)
    if all(t.device.type == "cpu" for t in tensors):
        return gathered_rows_relax_lanes_ref(src_dist, src_ids, nbr, w, mask,
                                             num_rows=num_rows)
    dev = _check("gathered_rows_relax_lanes", tensors, 2)
    lanes, edges = mask.shape
    best = torch.empty((lanes, num_rows), dtype=torch.float32, device=dev)
    arg = torch.empty((lanes, num_rows), dtype=torch.int32, device=dev)
    if best.numel() == 0:
        return best, arg
    key = torch.empty((lanes, num_rows), dtype=torch.int64, device=dev)
    build.launch("gathered_rows_relax_lanes", launcher(True), dev,
                 *(t.data_ptr() for t in (*tensors, key, best, arg)),
                 edges, num_rows, lanes)
    gathered_rows_relax.lane_launches += 1
    return best, arg


gathered_rows_relax.launches = 0
gathered_rows_relax.lane_launches = 0
