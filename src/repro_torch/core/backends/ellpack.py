"""Dense ELLPACK backend: incrementally maintained by-destination ELL block
behind the RelaxBackend protocol (torch rendering of
``repro.core.backends.ellpack``, single-device side).

  * ADD  — the host planner assigns each new edge a (row, k) cell past the
    row's fill high-water mark; the device patch is one idempotent scatter.
  * DEL  — resolved entirely on device: each deleted edge's cell is found by
    matching the source id in its destination row and tombstoned (w := +inf).
  * weight-decrease (``on_duplicate="min"``) — device-side match + min-scatter.
  * overflow — when a row's fill would exceed K, the planner rebuilds the
    whole block from the host COO mirror with K doubled (next pow2 of twice
    the max in-degree) and tombstones compacted away.

The patch ops update the block IN PLACE (the reference's functional scatters
would copy the R*K block per batch).  They tolerate pad_pow2-repeated rows:
every scatter that could meet a repeat with a different value is a
max/min-reduce (``scatter_reduce_``), never an assignment — an assignment
would let a padded no-op entry overwrite a live cell.

Every wave goes through kernel K1 (``kernels/relax``) when ``use_kernel``;
epochs mirror core/relax.py and core/delete.py exactly — same frontier
evolution, same smallest-src-id tie-break — so (dist, parent) are
bit-identical to the segment backend and to the reference.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core import delete as del_mod
from repro_torch.core import ingest
from repro_torch.core.backends.base import (ELL_BLOWUP_RATIO, RelaxBackend,
                                            rank_within_rows, register)
from repro_torch.core.relax import RelaxStats, converged_loop
from repro_torch.core.state import INF, SSSPState
from repro_torch.graphs import csr as csr_mod
from repro_torch.kernels.relax.ops import relax_wave

_next_pow2 = csr_mod.next_pow2


@dataclasses.dataclass
class EllState:
    """Device-resident dense-ELL view of the active edge set (one global K).

    ``fill`` is each row's occupancy high-water mark: cells at k >= fill[r]
    have never been written; cells below it are live edges or tombstones
    (w == +inf).  Rows n..R-1 are block padding and stay empty.
    """

    nbr_idx: torch.Tensor  # i32[R, K] in-neighbor ids (0 where empty/tombstone)
    nbr_w: torch.Tensor    # f32[R, K] weights (+inf where empty/tombstone)
    fill: torch.Tensor     # i32[R]

    @property
    def k(self) -> int:
        return self.nbr_w.shape[1]

    @property
    def rows(self) -> int:
        return self.nbr_w.shape[0]

    @staticmethod
    def from_host(idx: np.ndarray, ww: np.ndarray, fill: np.ndarray,
                  device: torch.device | str) -> "EllState":
        return EllState(nbr_idx=torch.tensor(idx, device=device),
                        nbr_w=torch.tensor(ww, device=device),
                        fill=torch.tensor(fill, device=device))


# --------------------------------------------------------------- patch ops --
def ell_append(ell: EllState, rows: torch.Tensor, kpos: torch.Tensor,
               src: torch.Tensor, w: torch.Tensor) -> EllState:
    """Write fresh edges into planner-assigned cells, in place.  pad_pow2
    repeats carry the same (row, kpos, src, w), so the assignments are
    idempotent; the fill marks take a max-reduce."""
    r, k = rows.long(), kpos.long()
    ell.nbr_idx[r, k] = src
    ell.nbr_w[r, k] = w
    ell.fill.scatter_reduce_(0, r, kpos + 1, "amax")
    return ell


def _match_cell(ell: EllState, rows: torch.Tensor, src: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Locate each (src -> rows) edge's live cell: (kpos, found).

    Live edges are unique per (row, src) — the slot allocator dedups — so at
    most one finite-weight cell matches; unmatched rows give kpos 0 (the
    first maximal index, as ``jnp.argmax``)."""
    r = rows.long()
    hit = (ell.nbr_idx[r] == src[:, None]) & torch.isfinite(ell.nbr_w[r])
    return hit.to(torch.int32).argmax(dim=1), hit.any(dim=1)


def _flat_cells(ell: EllState, rows: torch.Tensor,
                kpos: torch.Tensor) -> torch.Tensor:
    return rows.long() * ell.k + kpos


def ell_delete(ell: EllState, rows: torch.Tensor,
               src: torch.Tensor) -> EllState:
    """Tombstone deleted edges (w := +inf), located on device by source-id
    match.  Unmatched or padded entries scatter -inf into cell (row, 0)
    under a max-reduce — a no-op — so the scatter is order-free."""
    kpos, found = _match_cell(ell, rows, src)
    val = torch.where(found, INF, -INF)
    ell.nbr_w.view(-1).scatter_reduce_(0, _flat_cells(ell, rows, kpos), val,
                                       "amax")
    return ell


def ell_update_min(ell: EllState, rows: torch.Tensor, src: torch.Tensor,
                   w: torch.Tensor) -> EllState:
    """Weight-decrease of existing edges (on_duplicate="min"): device-side
    match + min-reduce (+inf = no-op for unmatched/padded entries)."""
    kpos, found = _match_cell(ell, rows, src)
    val = torch.where(found, w, INF)
    ell.nbr_w.view(-1).scatter_reduce_(0, _flat_cells(ell, rows, kpos), val,
                                       "amin")
    return ell


# ------------------------------------------------------------ host planner --
class EllPlanner:
    """Host control plane for the ELL block (numpy copy of the reference's):
    assigns append cells, detects overflow, and rebuilds (with capacity
    doubling) from the host COO mirror.  Keeps only dense per-row fill
    counts — deletions and weight updates are resolved on device.

    Rows are padded up to a multiple of ``block_rows`` exactly as in the
    reference, so block shapes and rebuild counts compare one to one (the
    CUDA kernel itself takes any row count).
    """

    def __init__(self, num_vertices: int, *, block_rows: int = 256,
                 init_k: int = 8):
        self.n = num_vertices
        bm = min(block_rows, _next_pow2(max(num_vertices, 1)))
        self.rows = -(-num_vertices // bm) * bm      # ceil to block multiple
        self.k = max(1, init_k)
        self.fill = np.zeros(self.rows, np.int32)
        self.rebuilds = 0
        self._warned_blowup = False

    def empty_host(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.zeros((self.rows, self.k), np.int32),
                np.full((self.rows, self.k), INF, np.float32),
                np.zeros(self.rows, np.int32))

    def plan_appends(self, rows: np.ndarray) -> np.ndarray | None:
        """Assign a distinct cell past the fill mark to each fresh edge.

        Returns kpos i32[m] (and advances the fill marks), or None when any
        row would overflow K — the caller must rebuild instead.
        """
        m = len(rows)
        if m == 0:
            return np.empty(0, np.int32)
        rows = np.asarray(rows, np.int64)
        counts = np.bincount(rows, minlength=self.n)
        if int((self.fill[:self.n] + counts[:self.n]).max(initial=0)) > self.k:
            return None
        kpos = self.fill[rows] + rank_within_rows(rows)
        np.maximum.at(self.fill, rows, kpos + 1)
        return kpos.astype(np.int32)

    def required_k(self, dst: np.ndarray) -> int:
        """The K the doubling policy wants for a live edge set."""
        deg = (np.bincount(np.asarray(dst, np.int64), minlength=self.n)
               if len(dst) else np.zeros(self.n, np.int64))
        return max(self.k, _next_pow2(max(2 * int(deg.max(initial=0)), 1)))

    def rebuild_host(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rebuild the block from the live COO edge set (host mirror):
        compacts tombstones and doubles K when the degree itself (not
        churn) caused the overflow."""
        self.k = self.required_k(dst)
        cells, live = self.rows * self.k, len(dst)
        if (live and cells > ELL_BLOWUP_RATIO * live
                and not self._warned_blowup):
            warnings.warn(
                f"dense-ELL rebuild allocates {cells} cells (K={self.k} x "
                f"{self.rows} rows) for {live} live edges — more than "
                f"{ELL_BLOWUP_RATIO}x blowup; the hub-aware sliced layout "
                f"avoids this", RuntimeWarning, stacklevel=3)
            self._warned_blowup = True
        idx, ww, fill = csr_mod.ell_from_coo(
            self.n, src, dst, w, k=self.k, n_rows=self.rows)
        self.fill = fill
        self.rebuilds += 1
        return idx, ww, fill


# ------------------------------------------------------------------ epochs --
def ell_relax_until_converged(sssp: SSSPState, nbr_idx: torch.Tensor,
                              nbr_w: torch.Tensor, frontier: torch.Tensor, *,
                              use_kernel: bool = False
                              ) -> tuple[SSSPState, RelaxStats]:
    """ELL rendering of relax.relax_until_converged: frontier-masked waves to
    fixpoint.  Same candidate sets, same tie-break => bit-identical results."""

    def wave(dist, parent, frontier):
        return relax_wave(dist, parent, nbr_idx, nbr_w, frontier=frontier,
                          use_kernel=use_kernel)

    dist, parent, rounds, msgs = converged_loop(
        sssp.dist, sssp.parent, frontier, wave)
    return (SSSPState(dist=dist, parent=parent, source=sssp.source),
            RelaxStats(rounds=rounds, messages=msgs))


def ell_invalidate_and_recompute(sssp: SSSPState, nbr_idx: torch.Tensor,
                                 nbr_w: torch.Tensor, seed: torch.Tensor, *,
                                 use_doubling: bool = True,
                                 use_kernel: bool = False
                                 ) -> tuple[SSSPState, del_mod.DeleteStats]:
    """Deletion epoch on the ELL block (paper Listings 4/8/9).

    Invalidation is core/delete.py's (it does not touch edges).  The bulk
    DistanceQuery pull is ONE unmasked ELL wave: every row gathers offers
    from all in-neighbors at once (+inf sources — other affected vertices —
    and tombstones offer nothing); improvements are applied to affected rows
    only, matching the segment path's ``aff[dst]`` edge mask.
    """
    if not bool(seed.any()):
        return sssp, del_mod.empty_delete_stats(seed.device)
    aff, inv_rounds, dist, parent = del_mod.invalidate(
        sssp, seed, use_doubling=use_doubling)
    dist_p, parent_p, improved = relax_wave(dist, parent, nbr_idx, nbr_w,
                                            use_kernel=use_kernel)
    improved = improved & aff
    dist = torch.where(improved, dist_p, dist)
    parent = torch.where(improved, parent_p, parent)
    state, stats = ell_relax_until_converged(
        SSSPState(dist=dist, parent=parent, source=sssp.source), nbr_idx,
        nbr_w, improved, use_kernel=use_kernel)
    return state, del_mod.DeleteStats(
        invalidation_rounds=inv_rounds,
        affected=aff.sum(),
        recompute_rounds=stats.rounds + 1,
        recompute_messages=stats.messages + improved.sum())


# ----------------------------------------------------------------- backend --
@register
class EllpackBackend(RelaxBackend):
    """RelaxBackend over the dense ELL block: EllPlanner host control plane,
    in-place patch ops, ELL epoch waves on K1, doubling rebuilds from the
    mirror."""

    name = "ellpack"

    def __init__(self, cfg, num_vertices, *, use_kernel=False, device="cpu"):
        super().__init__(cfg, num_vertices, use_kernel=use_kernel,
                         device=device)
        self.planner = EllPlanner(num_vertices, block_rows=cfg.ell_block_rows,
                                  init_k=cfg.ell_init_k)
        self.state = EllState.from_host(*self.planner.empty_host(),
                                        self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _rebuild(self, alloc) -> None:
        self.state = EllState.from_host(
            *self.planner.rebuild_host(*alloc.active_coo()), self.device)

    def apply_adds(self, plan, alloc):
        """Incremental ELL maintenance for one ADD batch.

        Fresh edges get planner-assigned cells (one idempotent scatter);
        weight-decreases resolve their cell on device.  Overflow of any
        row's fill mark triggers a full rebuild from the host COO mirror —
        which already contains this batch, so no patch follows.
        """
        fresh = plan.fresh
        rows = plan.dst[fresh].astype(np.int64)
        kpos = self.planner.plan_appends(rows)
        if kpos is None:
            self._rebuild(alloc)
            return
        if len(rows):
            ell_append(self.state, *map(self._dev, ingest.pad_pow2(
                rows.astype(np.int32), kpos, plan.src[fresh],
                plan.w[fresh])))
        if not fresh.all():
            upd = ~fresh
            ell_update_min(self.state, *map(self._dev, ingest.pad_pow2(
                plan.dst[upd], plan.src[upd], plan.w[upd])))

    def apply_dels(self, rows, src):
        ell_delete(self.state, self._dev(rows), self._dev(src))

    def relax(self, sssp, edges, frontier):
        return ell_relax_until_converged(
            sssp, self.state.nbr_idx, self.state.nbr_w, frontier,
            use_kernel=self.use_kernel)

    def delete(self, sssp, edges, seed):
        return ell_invalidate_and_recompute(
            sssp, self.state.nbr_idx, self.state.nbr_w, seed,
            use_doubling=self.cfg.use_doubling, use_kernel=self.use_kernel)

    def restore(self, alloc):
        self.planner = EllPlanner(self.n, block_rows=self.cfg.ell_block_rows,
                                  init_k=self.cfg.ell_init_k)
        self._rebuild(alloc)
