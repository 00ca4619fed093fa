"""Plain-torch version of the ELLPACK min-plus relaxation kernel (K1), the
counterpart of ``repro.kernels.relax.ref.ellpack_relax_ref``.

Semantics (one bulk "DistanceUpdate" wave in ELL layout):

    cand[i, k] = offers[nbr_idx[i, k]] + nbr_w[i, k]
    best[i]    = min_k cand[i, k]                      (+inf padded entries lose)
    arg[i]     = min {nbr_idx[i,k] : cand[i,k] == best[i]}   (-1 if best == +inf)

Ties break toward the smallest *neighbor id* — the segment path's
smallest-src-id rule, so every backend picks bit-identical parents.  The CPU
tests run this; ``chip_smoke.py`` holds the CUDA kernel against it.
"""
from __future__ import annotations

import torch

_BIG = 2**31 - 1


def ellpack_relax_ref(offers: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    cand = offers[nbr_idx] + nbr_w                         # (R, K)
    best = cand.amin(dim=1)
    is_min = cand == best[:, None]
    arg = torch.where(is_min, nbr_idx, _BIG).amin(dim=1)
    arg = torch.where(torch.isfinite(best), arg, -1)
    return best, arg.to(torch.int32)
