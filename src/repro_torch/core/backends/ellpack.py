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
epochs mirror core/relax.py, core/delete.py and core/buckets.py exactly —
same frontier evolution, same smallest-src-id tie-break — so (dist, parent)
are bit-identical to the segment backend and to the reference.  Each epoch
takes one tree or a lane stack ([S, N], the reference's ``ell_*_batched``);
a lane stack's wave is ONE K1 launch for all S lanes over the shared block.

Sharded side (``ShardedEllpack``): one window-local planner per partition
and one ELL block per partition on its device; the sharded wave launches K1
once per partition, on that partition's ``(rows_pp, K)`` block against the
gathered global offers.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core import buckets
from repro_torch.core import delete as del_mod
from repro_torch.core import ingest, relax
from repro_torch.core.backends.base import (ELL_BLOWUP_RATIO, RelaxBackend,
                                            ShardedBackend, rank_within_rows,
                                            register, register_sharded)
from repro_torch.core.relax import RelaxStats, converged_loop
from repro_torch.core.state import INF, SSSPState
from repro_torch.graphs import csr as csr_mod
from repro_torch.kernels.relax.ops import relax_wave
from repro_torch.kernels.relax.ref import ellpack_relax_ref
from repro_torch.kernels.relax.relax import LaneMinorOnce, ellpack_relax

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


def ell_invariants(ell: EllState) -> dict[str, bool]:
    """Occupancy invariants over the device fill marks (diagnostics/tests):
    every cell at or past a row's fill mark must be empty (+inf), and fill
    must stay within the block width — the device fill state has not
    drifted from the host planner's."""
    beyond = (torch.arange(ell.k, device=ell.fill.device)[None, :]
              >= ell.fill[:, None])
    return {
        "beyond_fill_empty": bool(torch.where(beyond, torch.isinf(ell.nbr_w),
                                              True).all()),
        "fill_in_range": bool(((ell.fill >= 0) & (ell.fill <= ell.k)).all()),
    }


# ------------------------------------------------------------ host planner --
class EllPlanner:
    """Host control plane for the ELL block (numpy copy of the reference's):
    assigns append cells, detects overflow, and rebuilds (with capacity
    doubling) from the host COO mirror.  Keeps only dense per-row fill
    counts — deletions and weight updates are resolved on device.

    Rows are padded up to a multiple of ``block_rows`` exactly as in the
    reference, so block shapes and rebuild counts compare one to one (the
    CUDA kernel itself takes any row count).

    ``row0`` makes the planner window-local: it plans rows for the vertex
    window ``[row0, row0 + num_vertices)`` and takes *global* destination
    ids everywhere — the sharded engine runs one planner per partition.
    """

    def __init__(self, num_vertices: int, *, block_rows: int = 256,
                 init_k: int = 8, row0: int = 0):
        self.n = num_vertices
        self.row0 = row0
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
        """Assign a distinct cell past the fill mark to each fresh edge
        (``rows``: global dst ids within this planner's window).

        Returns kpos i32[m] (and advances the fill marks), or None when any
        row would overflow K — the caller must rebuild instead.

        Invariant: ``fill[r] <= K`` on every row (a rebuild sets fill to the
        in-degree, which ``ell_from_coo`` holds within K; an append advances
        fill to at most K).  A row the batch does not touch therefore cannot
        overflow, and the check reads the batch's rows alone: the batch
        overflows iff its largest cell ``kpos`` reaches K.  That costs the
        rank's sort, O(m log m), and nothing of the row count.  A batch
        large against the rows (m log2 m >= n, where the dense count costs
        no more than that sort: the base-window load) is first checked by
        one dense count, O(n + m), so an overflowing one returns before it
        pays the sort.
        """
        m = len(rows)
        if m == 0:
            return np.empty(0, np.int32)
        rows = np.asarray(rows, np.int64) - self.row0
        if m * m.bit_length() >= self.n:
            counts = np.bincount(rows, minlength=self.n)[:self.n]
            if int((self.fill[:self.n] + counts).max(initial=0)) > self.k:
                return None
        kpos = self.fill[rows] + rank_within_rows(rows)
        if int(kpos.max()) >= self.k:
            return None
        np.maximum.at(self.fill, rows, kpos + 1)
        return kpos.astype(np.int32)

    def required_k(self, dst: np.ndarray) -> int:
        """The K the doubling policy wants for a live edge set."""
        deg = (np.bincount(np.asarray(dst, np.int64) - self.row0,
                           minlength=self.n)
               if len(dst) else np.zeros(self.n, np.int64))
        return max(self.k, _next_pow2(max(2 * int(deg.max(initial=0)), 1)))

    def rebuild_host(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                     k: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rebuild the block from the live COO edge set (host mirror):
        compacts tombstones and doubles K when the degree itself (not
        churn) caused the overflow.  ``k`` is ``required_k(dst)`` when the
        caller has it already."""
        self.k = self.required_k(dst) if k is None else k
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
            self.n, src, dst, w, k=self.k, n_rows=self.rows,
            row0=self.row0)
        self.fill = fill
        self.rebuilds += 1
        return idx, ww, fill


# ------------------------------------------------------------------ epochs --
def ell_relax_until_converged(sssp: SSSPState, nbr_idx: torch.Tensor,
                              nbr_w: torch.Tensor, frontier: torch.Tensor, *,
                              max_rounds: int = 0, use_kernel: bool = False
                              ) -> tuple[SSSPState, RelaxStats]:
    """ELL rendering of relax.relax_until_converged: frontier-masked waves to
    fixpoint, or for at most ``max_rounds`` waves when that is positive.
    Same candidate sets, same tie-break => bit-identical results."""

    def wave(dist, parent, frontier):
        return relax_wave(dist, parent, nbr_idx, nbr_w, frontier=frontier,
                          use_kernel=use_kernel)

    dist, parent, rounds, msgs = converged_loop(
        sssp.dist, sssp.parent, frontier, wave, max_rounds=max_rounds)
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
    any_seed = relax.host_flags(seed)
    if not np.any(any_seed):
        return sssp, del_mod.empty_delete_stats(seed)
    aff, inv_rounds, dist, parent = del_mod.invalidate(
        sssp, seed, use_doubling=use_doubling, gate=any_seed)
    dist, parent, improved = ell_pull(dist, parent, nbr_idx, nbr_w, aff,
                                      use_kernel=use_kernel)
    state, stats = ell_relax_until_converged(
        SSSPState(dist=dist, parent=parent, source=sssp.source), nbr_idx,
        nbr_w, improved, use_kernel=use_kernel)
    return state, del_mod.recompute_stats(aff, inv_rounds, improved, stats,
                                          any_seed)


def ell_pull(dist: torch.Tensor, parent: torch.Tensor, nbr_idx: torch.Tensor,
             nbr_w: torch.Tensor, aff: torch.Tensor, *, use_kernel: bool
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bulk DistanceQuery pull as ONE unmasked ELL wave, improvements
    applied to affected rows only (the segment path's ``aff[dst]`` mask;
    unaffected rows cannot improve on a converged tree)."""
    dist_p, parent_p, improved = relax_wave(dist, parent, nbr_idx, nbr_w,
                                            use_kernel=use_kernel)
    improved = improved & aff
    return (torch.where(improved, dist_p, dist),
            torch.where(improved, parent_p, parent), improved)


def ell_drain(sssp: SSSPState, nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
              pend: buckets.PendingState, *, bucket_width: float,
              use_kernel: bool = False
              ) -> tuple[SSSPState, buckets.PendingState, RelaxStats]:
    """Bucketed drain on the ELL block: the pull is the deletion epoch's
    (one unmasked wave, then ``improved &= aff``), so the drain's improved
    sets — hence its wave sequence and stats — match the segment drain's."""

    def wave(dist, parent, active):
        return relax_wave(dist, parent, nbr_idx, nbr_w, frontier=active,
                          use_kernel=use_kernel)

    def pull_wave(dist, parent, aff):
        return ell_pull(dist, parent, nbr_idx, nbr_w, aff,
                        use_kernel=use_kernel)

    dist, parent, stats = buckets.run_drain(
        sssp.dist, sssp.parent, pend, bucket_width=bucket_width,
        wave=wave, pull_wave=pull_wave)
    return (*buckets.drained(sssp, pend, dist, parent), stats)


# the reference's vmapped lane-stack entry points: the epochs above take
# [S, N] lanes themselves
ell_relax_batched = ell_relax_until_converged
ell_delete_batched = ell_invalidate_and_recompute
ell_drain_batched = ell_drain


# ----------------------------------------------------------------- backend --
@register
class EllpackBackend(RelaxBackend):
    """RelaxBackend over the dense ELL block: EllPlanner host control plane,
    in-place patch ops, ELL epoch waves on K1, doubling rebuilds from the
    mirror."""

    name = "ellpack"

    def __init__(self, cfg, num_vertices, *, use_kernel=False, device="cpu",
                 defer_blowup=False):
        super().__init__(cfg, num_vertices, use_kernel=use_kernel,
                         device=device)
        self.planner = EllPlanner(num_vertices, block_rows=cfg.ell_block_rows,
                                  init_k=cfg.ell_init_k)
        self.state = EllState.from_host(*self.planner.empty_host(),
                                        self.device)
        self.blowup = False   # set by rebuilds; read by the "auto" fallback
        # the caller swaps layouts on blowup, so a blown-up block is not built
        self.defer_blowup = defer_blowup

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _rebuild(self, alloc, *, defer_blowup: bool = False) -> bool:
        """Rebuild from the pool mirror; returns whether the block's K*R
        cells exceed ELL_BLOWUP_RATIO x the live edges (not built then
        when ``defer_blowup``)."""
        src, dst, w = alloc.active_coo()
        k = self.planner.required_k(dst)
        blowup = self.planner.rows * k > ELL_BLOWUP_RATIO * max(len(dst), 1)
        if not (blowup and defer_blowup):
            self.state = EllState.from_host(
                *self.planner.rebuild_host(src, dst, w, k), self.device)
        return blowup

    def apply_adds(self, plan, alloc):
        """Incremental ELL maintenance for one ADD batch.

        Fresh edges get planner-assigned cells (one idempotent scatter);
        weight-decreases resolve their cell on device.  Overflow of any
        row's fill mark triggers a full rebuild from the host COO mirror —
        which already contains this batch, so no patch follows.  A rebuild
        sets ``blowup`` when its K*R cells exceed ELL_BLOWUP_RATIO x the
        live edges; with ``defer_blowup`` (the engine's
        ``relax_backend="auto"``, which then swaps to the sliced layout) the
        block is not built (at RMAT(20) it would be 2^31 cells, only to be
        discarded).
        """
        fresh = plan.fresh
        rows = plan.dst[fresh].astype(np.int64)
        kpos = self.planner.plan_appends(rows)
        if kpos is None:
            self.blowup = self._rebuild(alloc, defer_blowup=self.defer_blowup)
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

    def drain(self, sssp, edges, pend, *, bucket_width):
        return ell_drain(sssp, self.state.nbr_idx, self.state.nbr_w, pend,
                         bucket_width=bucket_width, use_kernel=self.use_kernel)

    def restore(self, alloc):
        self.planner = EllPlanner(self.n, block_rows=self.cfg.ell_block_rows,
                                  init_k=self.cfg.ell_init_k)
        self._rebuild(alloc)

    def layout_counters(self):
        return {"rebuilds": self.planner.rebuilds}

    def invariants(self):
        return ell_invariants(self.state)


# ----------------------------------------------------------- sharded side --
@register_sharded
class ShardedEllpack(ShardedBackend):
    """One window-local EllPlanner per partition and one ELL block per
    partition (vertex ``v`` of partition ``p`` is row ``v - p*npp`` of
    block ``p``).  K is synchronized at rebuild time (the max of the
    partitions' doubling policies), so every block has one shape, and any
    partition's overflow rebuilds all of them from the per-partition
    mirrors — the reference's coupled rebuild."""

    name = "ellpack"

    def __init__(self, cfg, ds, allocs, *, use_kernel=False):
        super().__init__(cfg, ds, allocs, use_kernel=use_kernel)
        self._minor = LaneMinorOnce()
        self.planners = self._mk_planners()
        self.rows_pp = self.planners[0].rows
        self.states = [EllState.from_host(*pl.empty_host(), dev)
                       for pl, dev in zip(self.planners, ds.devices)]

    def _mk_planners(self) -> list[EllPlanner]:
        return [EllPlanner(self.npp, block_rows=self.cfg.ell_block_rows,
                           init_k=self.cfg.ell_init_k, row0=p * self.npp)
                for p in range(self.P)]

    def _dev(self, p: int, *arrays: np.ndarray) -> list[torch.Tensor]:
        return [torch.as_tensor(a).to(self.ds.devices[p]) for a in arrays]

    def stage_adds(self, plans):
        app, upd = [], []
        for p, plan in plans:
            fresh = plan.fresh
            rows = plan.dst[fresh].astype(np.int64)
            kpos = self.planners[p].plan_appends(rows)
            if kpos is None:
                self._rebuild_all()   # the mirrors already hold this batch
                return
            row0 = p * self.npp
            if len(rows):
                app.append((p, (rows - row0).astype(np.int32), kpos,
                            plan.src[fresh], plan.w[fresh]))
            if not fresh.all():
                u = ~fresh
                upd.append((p, (plan.dst[u] - row0).astype(np.int32),
                            plan.src[u], plan.w[u]))
        for p, *arrays in app:
            ell_append(self.states[p], *self._dev(p, *ingest.pad_pow2(
                *arrays)))
        for p, *arrays in upd:
            ell_update_min(self.states[p], *self._dev(p, *ingest.pad_pow2(
                *arrays)))

    def shard_del_patch(self, p, dst, src):
        ell_delete(self.states[p], *self._dev(
            p, (dst - p * self.npp).astype(np.int32), src))

    def _rebuild_all(self) -> None:
        coo = [a.active_coo() for a in self.allocs]
        k = max(pl.required_k(c[1]) for pl, c in zip(self.planners, coo))
        self.states = [
            EllState.from_host(*pl.rebuild_host(*c, k=k), dev)
            for pl, c, dev in zip(self.planners, coo, self.ds.devices)]

    def restore(self):
        self.planners = self._mk_planners()
        self._rebuild_all()

    def shard_wave(self, p, pool):
        """K1 (or its plain version) on partition ``p``'s block: one launch
        per partition and wave, for every lane of ``[S, N]`` offers (K1's
        lane form, on one lane-minor copy of the offers a device and mesh
        wave)."""
        st, npp = self.states[p], self.npp
        fn = ellpack_relax if self.use_kernel else ellpack_relax_ref
        minor = self._minor if self.use_kernel else (lambda offers: None)

        def wave(offers):
            best, arg = fn(offers, st.nbr_idx, st.nbr_w,
                           offers_minor=minor(offers))
            return best[..., :npp], arg[..., :npp]

        return wave

    def invariants(self):
        got = [ell_invariants(st) for st in self.states]
        return {k: all(g[k] for g in got) for k in got[0]}
