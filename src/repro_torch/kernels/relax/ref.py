"""Plain-torch versions of the relaxation kernels K1, K2 and K3 — what the
CPU runs, and what ``chip_smoke.py`` and the card tests hold each CUDA
kernel against.

K1, the counterpart of ``repro.kernels.relax.ref.ellpack_relax_ref`` (one
bulk "DistanceUpdate" wave in ELL layout):

    cand[i, k] = offers[nbr_idx[i, k]] + nbr_w[i, k]
    best[i]    = min_k cand[i, k]                      (+inf padded entries lose)
    arg[i]     = min {nbr_idx[i,k] : cand[i,k] == best[i]}   (-1 if best == +inf)

Ties break toward the smallest *neighbor id* — the segment path's
smallest-src-id rule, so every backend picks bit-identical parents.  The CPU
tests run this; ``chip_smoke.py`` holds the CUDA kernel against it.

K2, ``fused_sliced_relax_ref``: one hybrid sliced-ELL + overflow-COO wave
as the reference's unfused composition ``combine_lanes(sliced_gather_min,
overflow_min)`` over ``offers = where(active, dist, inf)``; ``arg`` is
INT_MAX where no candidate is finite.  The three lane functions live here
and the sliced backend's unfused wave imports them.

K1 and K2's plain versions also take a leading lane axis — ``offers`` /
``dist`` / ``active`` (S, N), S trees over the one shared layout — and give
(S, R), lane for lane what S single-lane calls give: the CPU route of the
batched engine and the card's oracle for the kernels' lane forms.  The
lane forms gather their offers lane-minor: ``lane_minor_ref`` is the plain
version of that interleave (``lane_group`` lanes a group, +inf past the
last lane), and ``ellpack_relax_ref`` / ``sliced_gather_min`` take such a
copy through ``offers_minor=`` and read the offers from it.

K3, ``gathered_rows_relax_ref``: the counterpart of
``repro.kernels.relax.gather.gathered_rows_relax_ref`` — candidates
``src_dist + w`` scatter-min'd into ``nbr`` rows, masked slots dropped,
``arg`` = the smallest ``src_ids`` attaining the row min (INT_MAX if none).
Its lane form ``gathered_rows_relax_lanes_ref`` takes ``[S, E]`` edge lists
and gives ``[S, R]``, lane for lane what ``jax.vmap`` of the reference
gives: the CPU route of the batched sparse wave and the card's oracle for
K3's lane form.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.graphs.csr import width_runs

_BIG = 2**31 - 1
_INF = float("inf")


LANE_GROUP = 8   # the most lanes one gather serves


def lane_group(lanes: int) -> int:
    """Lanes a group of the lane-minor layout (W): the smallest power of
    two >= ``lanes``, at most ``LANE_GROUP``; the kernels' rule
    (``lane_minor.cuh``)."""
    return min(LANE_GROUP, 1 << max(0, lanes - 1).bit_length())


def lane_minor_shape(lanes: int, n: int) -> tuple[int, int, int]:
    """(groups, N, W) of the lane-minor copy of (``lanes``, N) offers."""
    w = lane_group(lanes)
    return -(-lanes // w), n, w


def lane_minor_ref(offers: torch.Tensor, active: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """(S, N) offers lane-minor: out[g, v, j] = offers[g * W + j, v], +inf
    past the last lane and where ``active`` (if given, (S, N) bool) is
    False."""
    s, n = offers.shape
    g, _, w = lane_minor_shape(s, n)
    src = offers if active is None else torch.where(active, offers, _INF)
    out = torch.full((g * w, n), _INF, dtype=offers.dtype,
                     device=offers.device)
    out[:s] = src
    return out.view(g, w, n).transpose(1, 2).contiguous()


def _check_minor(offers: torch.Tensor, minor: torch.Tensor) -> None:
    if offers.dim() != 2 or tuple(minor.shape) != lane_minor_shape(
            *offers.shape):
        raise ValueError(
            f"offers_minor: expected the lane-minor copy "
            f"{lane_minor_shape(*offers.shape) if offers.dim() == 2 else '?'}"
            f" of (S, N) offers; got {tuple(minor.shape)} for offers "
            f"{tuple(offers.shape)}")


def ellpack_relax_ref(dist: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_w: torch.Tensor, *,
                      offers_minor: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    if offers_minor is not None:
        # the lanes' offers read from their lane-minor copy
        _check_minor(dist, offers_minor)
        g, n, w = offers_minor.shape
        lanes = offers_minor.transpose(1, 2).reshape(g * w, n)
        dist = lanes[:dist.shape[0]]
    cand = dist[..., nbr_idx] + nbr_w                    # ([S,] R, K)
    best = cand.amin(dim=-1)
    is_min = cand == best[..., None]
    arg = torch.where(is_min, nbr_idx, _BIG).amin(dim=-1)
    arg = torch.where(torch.isfinite(best), arg, -1)
    return best, arg.to(torch.int32)


def _segment_min(vals: torch.Tensor, seg: torch.Tensor, num_segments: int,
                 fill: float | int) -> torch.Tensor:
    """Per-segment min over the last axis (``seg`` shared by the lanes)."""
    out = torch.full((*vals.shape[:-1], num_segments), fill,
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(-1, seg.long().expand_as(vals), vals, "amin",
                               include_self=True)


def sliced_gather_min(offers: torch.Tensor, flat_idx: torch.Tensor,
                      flat_w: torch.Tensor, *, widths: tuple[int, ...],
                      slice_rows: int,
                      relax: Callable[..., tuple[torch.Tensor, torch.Tensor]]
                      = ellpack_relax_ref,
                      offers_minor: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ELL lane of one hybrid wave: (best f32[R], arg i32[R]) for R =
    len(widths) * slice_rows rows, arg the smallest minimizing neighbor id
    (-1 where best is +inf, K1's rule).  Each run of equal-width slices is
    one contiguous (rows, k) block of the flat buffer and one ``relax``
    call (K1 or its plain version; the reference splits a run into 256-row
    tiles, the rows are the same).  ``offers_minor``, the lane-minor copy
    of (S, N) offers, made once for the wave, goes to every run's call."""
    kw = {} if offers_minor is None else {"offers_minor": offers_minor}
    bests, args_ = [], []
    off = 0
    for k, cnt in width_runs(widths):
        rows_g = slice_rows * cnt
        blk = slice(off, off + rows_g * k)
        b, a = relax(offers, flat_idx[blk].view(rows_g, k),
                     flat_w[blk].view(rows_g, k), **kw)
        bests.append(b)
        args_.append(a)
        off += rows_g * k
    return torch.cat(bests, dim=-1), torch.cat(args_, dim=-1)


def overflow_min(offers: torch.Tensor, osrc: torch.Tensor, odst: torch.Tensor,
                 ow: torch.Tensor, nrows: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The overflow lane: a scatter-min over the hub surplus, INT_MAX where
    a row gets no finite candidate.  ``odst`` holds row ids in [0, nrows)."""
    ocand = offers[..., osrc] + ow         # +inf entries can never win
    obest = _segment_min(ocand, odst, nrows, _INF)
    ohit = (ocand == obest[..., odst]) & (ocand < _INF)
    oarg = _segment_min(torch.where(ohit, osrc, _BIG), odst, nrows, _BIG)
    return obest, oarg


def combine_lanes(best: torch.Tensor, arg: torch.Tensor, obest: torch.Tensor,
                  oarg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-combine the two lanes per row; parent ties break toward the
    smallest in-neighbor id ACROSS both lanes (each lane already reports its
    smallest minimizing id, so the combine is a scalar min per row)."""
    comb = torch.minimum(best, obest)
    ell_key = torch.where((best == comb) & (best < _INF), arg, _BIG)
    coo_key = torch.where((obest == comb) & (obest < _INF), oarg, _BIG)
    return comb, torch.minimum(ell_key, coo_key)


def fused_sliced_relax_ref(dist: torch.Tensor, active: torch.Tensor,
                           flat_idx: torch.Tensor, flat_w: torch.Tensor,
                           osrc: torch.Tensor, odst: torch.Tensor,
                           ow: torch.Tensor, *, widths: tuple[int, ...],
                           slice_rows: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(best f32[R], arg i32[R]) for R = len(widths) * slice_rows rows
    (``[S, R]`` for ``[S, N]`` dist and active)."""
    offers = torch.where(active, dist, _INF)
    best, arg = sliced_gather_min(offers, flat_idx, flat_w, widths=widths,
                                  slice_rows=slice_rows)
    obest, oarg = overflow_min(offers, osrc, odst, ow, best.shape[-1])
    return combine_lanes(best, arg, obest, oarg)


def gathered_rows_relax_ref(src_dist: torch.Tensor, src_ids: torch.Tensor,
                            nbr: torch.Tensor, w: torch.Tensor,
                            mask: torch.Tensor, *, num_rows: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked slots scatter into an extra row ``num_rows`` that is sliced
    off — torch's scatter raises on an out-of-range index where the
    reference's ``mode="drop"`` drops it."""
    cand = torch.where(mask, src_dist + w, _INF)
    tgt = torch.where(mask, nbr, num_rows).long()
    best = torch.full((num_rows + 1,), _INF, dtype=torch.float32,
                      device=cand.device)
    best.scatter_reduce_(0, tgt, cand, "amin")
    hit = (cand == best[tgt]) & (cand < _INF)
    key = torch.where(hit, src_ids, _BIG).to(torch.int32)
    arg = torch.full((num_rows + 1,), _BIG, dtype=torch.int32,
                     device=cand.device)
    arg.scatter_reduce_(0, tgt, key, "amin")
    return best[:num_rows], arg[:num_rows]


def gathered_rows_relax_lanes_ref(src_dist: torch.Tensor,
                                  src_ids: torch.Tensor, nbr: torch.Tensor,
                                  w: torch.Tensor, mask: torch.Tensor, *,
                                  num_rows: int
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """S lanes' ``[S, E]`` edge lists, each into its own ``num_rows`` rows:
    one ``gathered_rows_relax_ref`` over the ``S * E`` slots with lane s's
    rows at ``s * num_rows + nbr``.  A min and a smallest-id argmin do not
    depend on the order of the slots, so each lane is bit-identical to a
    single-lane call on it.  Returns (best f32[S, R], arg i32[S, R])."""
    lanes = src_dist.shape[0]
    off = (torch.arange(lanes, dtype=torch.int64, device=nbr.device)
           * num_rows)[:, None]
    best, arg = gathered_rows_relax_ref(
        src_dist.reshape(-1), src_ids.reshape(-1),
        (nbr + off).reshape(-1), w.reshape(-1), mask.reshape(-1),
        num_rows=lanes * num_rows)
    return best.view(lanes, num_rows), arg.view(lanes, num_rows)
