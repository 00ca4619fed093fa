"""Gathered-edges relaxation (kernel K3) for the sparse frontier path —
wrapper of the hand-written Hopper kernel ``csrc/gathered_rows_relax.cu``,
the port of the Pallas TPU kernel
``repro.kernels.relax.gather.gathered_rows_relax``.

``gathered_rows_relax(src_dist, src_ids, nbr, w, mask, *, num_rows) ->
(best f32[num_rows], arg i32[num_rows])`` computes exactly
``gathered_rows_relax_ref`` (ref.py): candidates ``src_dist + w`` of the
masked-in slots scatter-min'd into their ``nbr`` rows, ``arg`` the smallest
``src_ids`` attaining each row's min, INT_MAX where no slot hit.  Tensors on
the CPU take that plain version; tensors on a CUDA device launch the kernel
or raise — there is no fallback.  ``gathered_rows_relax.launches`` counts
kernel launches (a plain integer; callers reset it to 0 to count one run).
``wave_bytes`` is the bytes one call must move, its bound.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.relax.ref import gathered_rows_relax_ref

SOURCE = Path(__file__).parent / "csrc" / "gathered_rows_relax.cu"

__all__ = ["gathered_rows_relax", "gathered_rows_relax_ref", "launcher",
           "wave_bytes"]


def wave_bytes(edges: int, masked_in: int, rows: int) -> int:
    """Bytes one K3 call must move, each input read once and each output
    written once, counted on the call's own data: one mask byte per slot
    (E), src_dist, src_ids, nbr and w of each masked-in slot (16 bytes
    each; a masked-out slot is dropped whatever they say), best + arg
    (8R)."""
    return edges + 16 * masked_in + 8 * rows


@functools.cache
def launcher():
    """The kernel's C launcher, built at first use and bound once per
    process."""
    return build.launcher(SOURCE, "gathered_rows_relax_launch",
                          [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2)


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
    f32, i32 = torch.float32, torch.int32
    dev = build.check_args(
        "gathered_rows_relax", src_dist=(src_dist, f32),
        src_ids=(src_ids, i32), nbr=(nbr, i32), w=(w, f32),
        mask=(mask, torch.bool))
    if len({t.shape[0] for t in tensors}) != 1:
        raise ValueError(f"gathered_rows_relax: the five edge arrays must "
                         f"share one length; got "
                         f"{[tuple(t.shape) for t in tensors]}")
    best = torch.empty(num_rows, dtype=f32, device=dev)
    arg = torch.empty(num_rows, dtype=i32, device=dev)
    if num_rows == 0:
        return best, arg
    key = torch.empty(num_rows, dtype=torch.int64, device=dev)
    build.launch("gathered_rows_relax", launcher(), dev,
                 *(t.data_ptr() for t in (src_dist, src_ids, nbr, w, mask,
                                          key, best, arg)),
                 mask.shape[0], num_rows)
    gathered_rows_relax.launches += 1
    return best, arg


gathered_rows_relax.launches = 0
