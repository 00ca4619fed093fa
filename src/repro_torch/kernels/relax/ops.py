"""``relax_wave``: one relaxation wave in ELL layout — kernel K1 (or its
plain version) composed with the engine's update rule; torch rendering of
``repro.kernels.relax.ops``.

Frontier masking: sources outside the frontier are masked to +inf *before*
the gather, so a wave only delivers offers from vertices that improved last
round — the ELL rendering of the segment path's ``active & frontier[src]``
edge mask.
"""
from __future__ import annotations

import torch

from repro_torch.core.state import INF
from repro_torch.kernels.relax.ref import ellpack_relax_ref
from repro_torch.kernels.relax.relax import ellpack_relax


def relax_wave(dist: torch.Tensor, parent: torch.Tensor,
               nbr_idx: torch.Tensor, nbr_w: torch.Tensor, *,
               frontier: torch.Tensor | None = None, use_kernel: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One relaxation wave (frontier-masked when given) of one tree
    (``dist`` [N]) or of S lanes (``dist`` [S, N]) over the shared block.

    ``nbr_idx``/``nbr_w`` may have more rows than ``dist`` (the planner's
    row padding); the extra rows are all-+inf and are sliced off.
    ``use_kernel`` routes through the K1 wrapper (the CUDA kernel on a CUDA
    tensor: one launch for all lanes); False calls the plain version on any
    device.  Returns (dist', parent', improved).
    """
    n = dist.shape[-1]
    offers = dist if frontier is None else torch.where(frontier, dist, INF)
    fn = ellpack_relax if use_kernel else ellpack_relax_ref
    best, arg = fn(offers, nbr_idx, nbr_w)
    best, arg = best[..., :n], arg[..., :n]
    improved = best < dist
    return (torch.where(improved, best, dist),
            torch.where(improved, arg, parent), improved)
