"""Sliced hybrid backend: per-slice-K ELL + hub overflow COO behind the
RelaxBackend protocol (torch rendering of ``repro.core.backends.sliced``,
single-device side).

Rows are bucketed into degree slices with per-slice pow2 K (capped at a hub
threshold), flattened into one 1-D cell buffer, plus a device COO *overflow*
segment holding hub rows' surplus in-edges.  Maintenance mirrors the dense
ELL backend cell for cell (idempotent appends, device-side match+tombstone
DEL/min-update probing both lanes, per-slice width doubling plus overflow
doubling at mirror rebuilds).

A wave is the ELL lane (``sliced_gather_min``: K1 once per equal-width run
of slices), the overflow lane (``overflow_min``: a scatter-min) and their
combine (``combine_lanes``: the smallest-src-id rule across both lanes;
the three live in ``kernels/relax/ref.py``, K2's plain version) —
or, with ``use_fused``, the whole wave in kernel K2 (``kernels/relax/
fused.py``).  Both are bit-identical to the reference's waves.  Every
epoch takes one tree or a lane stack ([S, N], the reference's
``sliced_*_batched``): a lane stack's wave is one K2 launch, or one K1
launch per width run, for all S lanes.

The patch ops update the layout IN PLACE and tolerate pad_pow2-repeated
entries (every scatter that could meet a repeat with a different value is a
max/min-reduce).  The reference finds a deleted edge's overflow entry with a
dense (batch x capacity) match matrix, which eager torch would materialise
(10^12 cells at a 2^17 DEL batch over a 2^23 lane); here the live entries'
``(dst << 32) | src`` keys are sorted once per patch and searched.

Sharded side (``ShardedSliced``): one window-local planner and one hybrid
layout per partition, widths synchronized across partitions; its wave is
the reference's unfused one — K1 once per width run of the partition's
slices, then ``overflow_min`` and ``combine_lanes`` (the reference's
sharded wave does not take K2).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import buckets
from repro_torch.core import delete as del_mod
from repro_torch.core import ingest, relax
from repro_torch.core.backends.base import (RelaxBackend, ShardedBackend,
                                            rank_within_rows, register,
                                            register_sharded)
from repro_torch.core.relax import RelaxStats, converged_loop
from repro_torch.core.state import INF, SSSPState
from repro_torch.graphs import csr as csr_mod
from repro_torch.kernels.relax.fused import ChunkTable, fused_sliced_relax
from repro_torch.kernels.relax.ref import (combine_lanes, ellpack_relax_ref,
                                           overflow_min, sliced_gather_min)
from repro_torch.kernels.relax.relax import (LaneMinorOnce, ellpack_relax,
                                             lane_minor)

_next_pow2 = csr_mod.next_pow2


@dataclasses.dataclass
class SlicedEllState:
    """Device-resident hybrid sliced-ELL + overflow-COO view of the edge set.

    Row r's cells occupy ``[base[r], base[r] + rowk[r])`` of the flat buffer
    (``flat_idx``, ``flat_w``); ``fill`` is each row's occupancy high-water
    mark.  Hub rows keep their surplus in-edges in the overflow segment
    ``(osrc, odst, ow)``; empty/tombstoned entries carry w=+inf.
    ``widths`` / ``slice_rows`` are the geometry the buffer was laid out
    by, and ``table`` is kernel K2's chunk table of that geometry with its
    sizes (``fused.ChunkTable``), made with ``base`` and ``rowk`` once per
    layout where K2 runs (None elsewhere), so a wave does no host work or
    copy for it; K2's wrapper takes all of it from here.
    """

    flat_idx: torch.Tensor  # i32[L] in-neighbor ids (0 where empty/tombstone)
    flat_w: torch.Tensor    # f32[L] weights (+inf where empty/tombstone)
    fill: torch.Tensor      # i32[R]
    base: torch.Tensor      # i32[R] flat offset of each row's first cell
    rowk: torch.Tensor      # i32[R] each row's slice width
    osrc: torch.Tensor      # i32[C] overflow in-neighbor ids
    odst: torch.Tensor      # i32[C] overflow destination rows
    ow: torch.Tensor        # f32[C] overflow weights (+inf empty/tombstone)
    widths: tuple[int, ...]  # per-slice widths of the flat buffer
    slice_rows: int
    table: ChunkTable | None  # K2's chunk table of (widths, slice_rows)

    @staticmethod
    def from_host(planner: "SlicedEllPlanner", arrays,
                  device: torch.device | str, *,
                  with_blocks: bool = True) -> "SlicedEllState":
        """``arrays`` = (flat_idx, flat_w, fill, osrc, odst, ow) as the
        planner's ``empty_host`` / ``rebuild_host`` return them;
        ``with_blocks=False`` leaves out K2's chunk table, for a state K2
        never reads.  Raises ``ValueError`` where the arrays are not of the
        planner's current geometry (arrays of an earlier layout)."""
        if (len(arrays[1]) != planner.cells
                or len(arrays[2]) != planner.rows):
            raise ValueError(
                f"SlicedEllState.from_host: arrays of {len(arrays[1])} cells "
                f"and {len(arrays[2])} rows for a layout of {planner.cells} "
                f"cells and {planner.rows} rows")
        fi, fw, fill, osrc, odst, ow = (torch.tensor(a, device=device)
                                        for a in arrays)
        widths = tuple(planner.widths)
        return SlicedEllState(
            flat_idx=fi, flat_w=fw, fill=fill,
            base=torch.tensor(planner.base.astype(np.int32), device=device),
            rowk=torch.tensor(planner.rowk, device=device),
            osrc=osrc, odst=odst, ow=ow, widths=widths,
            slice_rows=planner.sr,
            table=(ChunkTable.build(widths, planner.sr, device)
                   if with_blocks else None))


# --------------------------------------------------------------- patch ops --
def sliced_append(st: SlicedEllState, pos: torch.Tensor, rows: torch.Tensor,
                  kpos: torch.Tensor, src: torch.Tensor,
                  w: torch.Tensor) -> SlicedEllState:
    """Write fresh edges into planner-assigned flat cells, in place
    (pad_pow2 repeats carry the same values, so the assignments are
    idempotent; the fill marks take a max-reduce)."""
    p = pos.long()
    st.flat_idx[p] = src
    st.flat_w[p] = w
    st.fill.scatter_reduce_(0, rows.long(), kpos + 1, "amax")
    return st


def sliced_spill(st: SlicedEllState, opos: torch.Tensor, src: torch.Tensor,
                 rows: torch.Tensor, w: torch.Tensor) -> SlicedEllState:
    """Append hub-surplus edges into planner-assigned overflow entries, in
    place (idempotent, as ``sliced_append``)."""
    p = opos.long()
    st.osrc[p] = src
    st.odst[p] = rows
    st.ow[p] = w
    return st


def _sliced_match(st: SlicedEllState, rows: torch.Tensor, src: torch.Tensor,
                  width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Locate each (src -> rows) edge's live ELL cell: (flat_pos, found).
    A ``width``-wide window per row, masked to the row's slice width; live
    edges are unique per (row, src), so at most one cell matches, and an
    unmatched row gives its window's first cell (``jnp.argmax``'s 0)."""
    r = rows.long()
    k = torch.arange(width, device=r.device)
    pos = (st.base[r][:, None] + k).clamp(0, st.flat_w.shape[0] - 1)
    hit = ((k < st.rowk[r][:, None]) & (st.flat_idx[pos] == src[:, None])
           & torch.isfinite(st.flat_w[pos]))
    sel = pos.gather(1, hit.to(torch.int32).argmax(dim=1, keepdim=True))
    return sel[:, 0], hit.any(dim=1)


def _overflow_match(st: SlicedEllState, rows: torch.Tensor,
                    src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Locate each (src -> rows) edge's live overflow entry: (opos, found),
    opos 0 where unmatched (the reference's ``argmax`` over its match
    matrix).  Live entries are unique per (dst, src), so a sorted-key search
    finds the same entry the match matrix does."""
    live = torch.isfinite(st.ow)
    keys = torch.where(live, (st.odst.long() << 32) | st.osrc.long(), -1)
    skeys, perm = torch.sort(keys)
    want = (rows.long() << 32) | src.long()
    at = torch.searchsorted(skeys, want).clamp(max=skeys.shape[0] - 1)
    found = skeys[at] == want
    return torch.where(found, perm[at], 0), found


def sliced_delete(st: SlicedEllState, rows: torch.Tensor, src: torch.Tensor,
                  *, width: int) -> SlicedEllState:
    """Tombstone deleted edges (w := +inf) wherever they live — ELL cell or
    overflow entry — in place.  Unmatched or padded entries scatter -inf
    under a max-reduce, a no-op, so both scatters are order-free."""
    sel, found = _sliced_match(st, rows, src, width)
    opos, ofound = _overflow_match(st, rows, src)
    st.flat_w.scatter_reduce_(0, sel, torch.where(found, INF, -INF), "amax")
    st.ow.scatter_reduce_(0, opos, torch.where(ofound, INF, -INF), "amax")
    return st


def sliced_update_min(st: SlicedEllState, rows: torch.Tensor,
                      src: torch.Tensor, w: torch.Tensor, *,
                      width: int) -> SlicedEllState:
    """Weight-decrease of existing edges (on_duplicate="min"): device-side
    match + min-reduce in both lanes (+inf = no-op when unmatched)."""
    sel, found = _sliced_match(st, rows, src, width)
    opos, ofound = _overflow_match(st, rows, src)
    st.flat_w.scatter_reduce_(0, sel, torch.where(found, w, INF), "amin")
    st.ow.scatter_reduce_(0, opos, torch.where(ofound, w, INF), "amin")
    return st


def sliced_invariants(st: SlicedEllState, *, width: int) -> dict[str, bool]:
    """Occupancy invariants over the flat buffer (mirrors
    ``ellpack.ell_invariants``): cells between a row's fill mark and its
    slice width must be empty, and fill must stay within the width."""
    k = torch.arange(width, device=st.fill.device)[None, :]
    pos = (st.base[:, None] + k).clamp(0, st.flat_w.shape[0] - 1)
    beyond = (k < st.rowk[:, None]) & (k >= st.fill[:, None])
    return {
        "beyond_fill_empty": bool(torch.where(
            beyond, torch.isinf(st.flat_w[pos]), True).all()),
        "fill_in_range": bool(((st.fill >= 0)
                               & (st.fill <= st.rowk)).all()),
    }


# ------------------------------------------------------------------- waves --
def sliced_relax_wave(dist: torch.Tensor, parent: torch.Tensor,
                      st: SlicedEllState, *, num_vertices: int,
                      frontier: torch.Tensor | None = None,
                      use_kernel: bool = False, use_fused: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One hybrid relaxation wave (frontier-masked when given) of one tree
    or of a lane stack.  ``use_fused`` routes the whole wave through K2's
    wrapper (the CUDA kernel on CUDA tensors, whatever ``use_kernel`` says,
    as the reference always takes its Pallas kernel there); otherwise the
    ELL lane runs K1 when ``use_kernel``.  Returns (dist', parent',
    improved)."""
    n = dist.shape[-1]
    if use_fused:
        act = (torch.ones_like(dist, dtype=torch.bool) if frontier is None
               else frontier.expand(dist.shape).contiguous())
        comb, new_parent = fused_sliced_relax(dist, act, st)
        comb, new_parent = comb[..., :n], new_parent[..., :n]
    else:
        offers = dist if frontier is None else torch.where(frontier, dist, INF)
        # K1's lane form reads the lanes' offers lane-minor: one copy a
        # wave for every width run
        minor = (lane_minor(offers) if use_kernel and offers.dim() == 2
                 else None)
        best, arg = sliced_gather_min(
            offers, st.flat_idx, st.flat_w, widths=st.widths,
            slice_rows=st.slice_rows,
            relax=ellpack_relax if use_kernel else ellpack_relax_ref,
            offers_minor=minor)
        obest, oarg = overflow_min(offers, st.osrc, st.odst, st.ow,
                                   num_vertices)
        comb, new_parent = combine_lanes(best[..., :n], arg[..., :n], obest,
                                         oarg)
    improved = comb < dist
    return (torch.where(improved, comb, dist),
            torch.where(improved, new_parent, parent), improved)


# ------------------------------------------------------------------ epochs --
def sliced_relax_until_converged(sssp: SSSPState, st: SlicedEllState,
                                 frontier: torch.Tensor, *,
                                 num_vertices: int, max_rounds: int = 0,
                                 use_kernel: bool = False,
                                 use_fused: bool = False
                                 ) -> tuple[SSSPState, RelaxStats]:
    """Sliced rendering of relax.relax_until_converged: frontier-masked
    hybrid waves to fixpoint, or for at most ``max_rounds`` waves when that
    is positive.  Same candidate sets, same tie-break => bit-identical
    results and stats."""

    def wave(dist, parent, frontier):
        return sliced_relax_wave(
            dist, parent, st, num_vertices=num_vertices, frontier=frontier,
            use_kernel=use_kernel, use_fused=use_fused)

    dist, parent, rounds, msgs = converged_loop(
        sssp.dist, sssp.parent, frontier, wave, max_rounds=max_rounds)
    return (SSSPState(dist=dist, parent=parent, source=sssp.source),
            RelaxStats(rounds=rounds, messages=msgs))


def sliced_pull(dist: torch.Tensor, parent: torch.Tensor, st: SlicedEllState,
                aff: torch.Tensor, **kw
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bulk pull as one unmasked hybrid wave, improvements applied to
    affected rows only (``ellpack.ell_pull``'s pattern), so hub rows also
    pull through the overflow lane."""
    dist_p, parent_p, improved = sliced_relax_wave(dist, parent, st, **kw)
    improved = improved & aff
    return (torch.where(improved, dist_p, dist),
            torch.where(improved, parent_p, parent), improved)


def sliced_invalidate_and_recompute(
    sssp: SSSPState, st: SlicedEllState, seed: torch.Tensor, *,
    num_vertices: int, use_doubling: bool = True, use_kernel: bool = False,
    use_fused: bool = False,
) -> tuple[SSSPState, del_mod.DeleteStats]:
    """Deletion epoch on the hybrid layout — the dense-ELL deletion epoch's
    structure (shared invalidation, the bulk pull as one unmasked wave
    applied to affected rows only)."""
    any_seed = relax.host_flags(seed)
    if not np.any(any_seed):
        return sssp, del_mod.empty_delete_stats(seed)
    aff, inv_rounds, dist, parent = del_mod.invalidate(
        sssp, seed, use_doubling=use_doubling, gate=any_seed)
    kw = dict(num_vertices=num_vertices, use_kernel=use_kernel,
              use_fused=use_fused)
    dist, parent, improved = sliced_pull(dist, parent, st, aff, **kw)
    state, stats = sliced_relax_until_converged(
        SSSPState(dist=dist, parent=parent, source=sssp.source), st,
        improved, **kw)
    return state, del_mod.recompute_stats(aff, inv_rounds, improved, stats,
                                          any_seed)


def sliced_drain(sssp: SSSPState, st: SlicedEllState,
                 pend: buckets.PendingState, *, num_vertices: int,
                 bucket_width: float, use_kernel: bool = False,
                 use_fused: bool = False
                 ) -> tuple[SSSPState, buckets.PendingState, RelaxStats]:
    """Bucketed drain on the hybrid layout — the deletion epoch's pull
    pattern, so the drain's wave sequence and stats match the segment and
    dense-ELL drains'."""
    kw = dict(num_vertices=num_vertices, use_kernel=use_kernel,
              use_fused=use_fused)

    def wave(dist, parent, active):
        return sliced_relax_wave(dist, parent, st, frontier=active, **kw)

    def pull_wave(dist, parent, aff):
        return sliced_pull(dist, parent, st, aff, **kw)

    dist, parent, stats = buckets.run_drain(
        sssp.dist, sssp.parent, pend, bucket_width=bucket_width,
        wave=wave, pull_wave=pull_wave)
    return (*buckets.drained(sssp, pend, dist, parent), stats)


# the reference's vmapped lane-stack entry points: the epochs above take
# [S, N] lanes themselves
sliced_relax_batched = sliced_relax_until_converged
sliced_delete_batched = sliced_invalidate_and_recompute
sliced_drain_batched = sliced_drain


# ------------------------------------------------------------ host planner --
class SlicedPlan(NamedTuple):
    """One ADD batch's placement: ELL cells + overflow spills (numpy)."""

    pos: np.ndarray    # i32[e] flat ELL cell positions (base[row] + kpos)
    rows: np.ndarray   # i32[e]
    kpos: np.ndarray   # i32[e]
    src: np.ndarray    # i32[e]
    w: np.ndarray      # f32[e]
    opos: np.ndarray   # i32[s] overflow entry positions
    osrc: np.ndarray   # i32[s]
    orows: np.ndarray  # i32[s]
    ow: np.ndarray     # f32[s]


class SlicedEllPlanner:
    """Host control plane for the hybrid layout (numpy copy of the
    reference's): assigns ELL cells and overflow entries, detects per-slice
    / overflow exhaustion, and rebuilds from the host COO mirror with
    monotone per-slice capacity doubling (each slice's width doubles
    independently, capped at ``hub_k``; the overflow capacity doubles when
    the live surplus outgrows it).  A row whose fill reaches ``hub_k`` is a
    hub: its further in-edges spill to the overflow segment.

    ``row0`` makes the planner window-local: it takes *global* destination
    ids for the vertex window ``[row0, row0 + num_vertices)`` and emits
    positions and rows in its own local space."""

    def __init__(self, num_vertices: int, *, slice_rows: int = 256,
                 hub_k: int = 32, init_k: int = 2, row0: int = 0):
        self.n = num_vertices
        self.row0 = row0
        self.sr = min(_next_pow2(max(slice_rows, 1)),
                      _next_pow2(max(num_vertices, 1)))
        self.rows = -(-num_vertices // self.sr) * self.sr
        self.n_slices = self.rows // self.sr
        self.hub_k = _next_pow2(max(hub_k, 1))
        init_k = min(_next_pow2(max(init_k, 1)), self.hub_k)
        self.widths = [init_k] * self.n_slices
        self.fill = np.zeros(self.rows, np.int32)
        self.ocap = 8
        self.ofill = 0
        self.rebuilds = 0
        self.spills = 0
        self._recompute_geometry()

    def _recompute_geometry(self) -> None:
        _, self.rowk, self.base, self.cells = csr_mod.sliced_geometry(
            self.widths, self.sr)

    @property
    def max_width(self) -> int:
        return max(self.widths)

    def empty_host(self):
        return (np.zeros(self.cells, np.int32),
                np.full(self.cells, INF, np.float32),
                np.zeros(self.rows, np.int32),
                np.zeros(self.ocap, np.int32),
                np.zeros(self.ocap, np.int32),
                np.full(self.ocap, INF, np.float32))

    def plan_appends(self, rows: np.ndarray, src: np.ndarray,
                     w: np.ndarray) -> SlicedPlan | None:
        """Assign each fresh edge an ELL cell past its row's fill mark, or
        an overflow entry once the row is at the hub threshold.  Returns
        None when a sub-threshold row outgrows its slice width or the
        overflow segment is full — the caller must rebuild instead."""
        m = len(rows)
        z32 = np.empty(0, np.int32)
        zf = np.empty(0, np.float32)
        if m == 0:
            return SlicedPlan(z32, z32, z32, z32, zf, z32, z32, z32, zf)
        rows = np.asarray(rows, np.int64) - self.row0
        kcand = self.fill[rows] + rank_within_rows(rows)
        to_ell = kcand < self.rowk[rows]
        over = ~to_ell
        # overflow is only legal past the hub threshold; a sub-threshold row
        # outgrowing its slice width means the slice must double -> rebuild
        if bool((over & (self.rowk[rows] < self.hub_k)).any()):
            return None
        n_spill = int(over.sum())
        if self.ofill + n_spill > self.ocap:
            return None
        erows = rows[to_ell]
        ekpos = kcand[to_ell].astype(np.int32)
        np.maximum.at(self.fill, erows, ekpos + 1)
        sp_rank = np.cumsum(over) - 1
        opos = (self.ofill + sp_rank[over]).astype(np.int32)
        self.ofill += n_spill
        self.spills += n_spill
        return SlicedPlan(
            pos=(self.base[erows] + ekpos).astype(np.int32),
            rows=erows.astype(np.int32), kpos=ekpos,
            src=np.asarray(src)[to_ell], w=np.asarray(w)[to_ell],
            opos=opos, osrc=np.asarray(src)[over],
            orows=rows[over].astype(np.int32), ow=np.asarray(w)[over])

    def required_geometry(self, dst: np.ndarray) -> tuple[list[int], int]:
        """(widths, overflow capacity) the doubling policy wants for a live
        edge set."""
        deg = np.zeros(self.rows, np.int64)
        if len(dst):
            deg[:self.n] = np.bincount(
                np.asarray(dst, np.int64) - self.row0, minlength=self.n)
        capped = np.minimum(deg, self.hub_k)
        slice_max = capped.reshape(self.n_slices, self.sr).max(axis=1)
        widths = [
            max(cur, min(self.hub_k, _next_pow2(max(2 * int(mx), 1))))
            for cur, mx in zip(self.widths, slice_max)]
        surplus = int((deg - capped).sum())
        ocap = max(self.ocap, _next_pow2(max(2 * surplus, 8)))
        return widths, ocap

    def rebuild_host(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray):
        """Rebuild from the live COO edge set (host mirror): tombstones
        compact away, each slice's width grows to the next pow2 of 2x its
        capped max in-degree (monotone, <= hub_k), and the overflow capacity
        doubles past the live surplus.  Returns (flat_idx, flat_w, fill,
        osrc, odst, ow)."""
        self.widths, self.ocap = self.required_geometry(dst)
        flat_idx, flat_w, fill, _, osrc, odst, ow, n_over = \
            csr_mod.sliced_ell_from_coo(
                self.n, src, dst, w, slice_rows=self.sr, hub_k=self.hub_k,
                n_rows=self.rows, widths=self.widths,
                overflow_capacity=self.ocap, row0=self.row0)
        self.fill = fill
        self.ofill = n_over
        self.rebuilds += 1
        self._recompute_geometry()
        return flat_idx, flat_w, fill, osrc, odst, ow


# ----------------------------------------------------------------- backend --
@register
class SlicedBackend(RelaxBackend):
    """RelaxBackend over the hybrid layout: SlicedEllPlanner host control
    plane, dual-lane in-place patch ops, hybrid epoch waves (K1 per run of
    slices, or K2 for the whole wave with ``use_fused``: the engine's
    resolved ``sliced_fused``), coupled per-slice / overflow rebuilds from
    the mirror."""

    name = "sliced"

    def __init__(self, cfg, num_vertices, *, use_kernel=False,
                 use_fused=False, device="cpu"):
        super().__init__(cfg, num_vertices, use_kernel=use_kernel,
                         device=device)
        self.use_fused = use_fused
        self.planner = self._mk_planner()
        self.state = SlicedEllState.from_host(
            self.planner, self.planner.empty_host(), self.device,
            with_blocks=use_fused)

    def _mk_planner(self) -> SlicedEllPlanner:
        return SlicedEllPlanner(
            self.n, slice_rows=self.cfg.sliced_slice_rows,
            hub_k=self.cfg.sliced_hub_k, init_k=self.cfg.sliced_init_k)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _rebuild(self, alloc) -> None:
        self.state = SlicedEllState.from_host(
            self.planner, self.planner.rebuild_host(*alloc.active_coo()),
            self.device, with_blocks=self.use_fused)

    def apply_adds(self, plan, alloc):
        """Fresh edges get planner-assigned ELL cells or — for rows at the
        hub threshold — overflow entries; weight-decreases resolve their
        cell/entry on device.  Slice-width or overflow exhaustion triggers
        a full rebuild from the host COO mirror (which already contains this
        batch, so no patch follows)."""
        fresh = plan.fresh
        sp = self.planner.plan_appends(
            plan.dst[fresh].astype(np.int64), plan.src[fresh], plan.w[fresh])
        if sp is None:
            self._rebuild(alloc)
            return
        if len(sp.pos):
            sliced_append(self.state, *map(self._dev, ingest.pad_pow2(
                sp.pos, sp.rows, sp.kpos, sp.src, sp.w)))
        if len(sp.opos):
            sliced_spill(self.state, *map(self._dev, ingest.pad_pow2(
                sp.opos, sp.osrc, sp.orows, sp.ow)))
        if not fresh.all():
            upd = ~fresh
            sliced_update_min(self.state, *map(self._dev, ingest.pad_pow2(
                plan.dst[upd], plan.src[upd], plan.w[upd])),
                width=self.planner.max_width)

    def apply_dels(self, rows, src):
        sliced_delete(self.state, self._dev(rows), self._dev(src),
                      width=self.planner.max_width)

    def _epoch_kw(self) -> dict:
        return dict(num_vertices=self.n, use_kernel=self.use_kernel,
                    use_fused=self.use_fused)

    def relax(self, sssp, edges, frontier):
        return sliced_relax_until_converged(sssp, self.state, frontier,
                                            **self._epoch_kw())

    def delete(self, sssp, edges, seed):
        return sliced_invalidate_and_recompute(
            sssp, self.state, seed, use_doubling=self.cfg.use_doubling,
            **self._epoch_kw())

    def drain(self, sssp, edges, pend, *, bucket_width):
        return sliced_drain(sssp, self.state, pend, bucket_width=bucket_width,
                            **self._epoch_kw())

    def restore(self, alloc):
        self.planner = self._mk_planner()
        self._rebuild(alloc)

    def layout_counters(self):
        return {"rebuilds": self.planner.rebuilds,
                "overflow_hits": self.planner.spills}

    def invariants(self):
        return sliced_invariants(self.state, width=self.planner.max_width)


# ----------------------------------------------------------- sharded side --
@register_sharded
class ShardedSliced(ShardedBackend):
    """One window-local SlicedEllPlanner per partition and one hybrid
    layout per partition on its device (rows, flat cells and overflow
    entries in the partition's local space).  Per-slice widths and the
    overflow capacity are synchronized at rebuild time (elementwise max of
    the partitions' policies), so every partition shares one geometry, and
    any partition's exhaustion rebuilds all of them from the mirrors."""

    name = "sliced"

    def __init__(self, cfg, ds, allocs, *, use_kernel=False):
        super().__init__(cfg, ds, allocs, use_kernel=use_kernel)
        self._minor = LaneMinorOnce()
        self.planners = self._mk_planners()
        self.states = [
            SlicedEllState.from_host(pl, pl.empty_host(), dev,
                                     with_blocks=False)
            for pl, dev in zip(self.planners, ds.devices)]

    def _mk_planners(self) -> list[SlicedEllPlanner]:
        return [SlicedEllPlanner(
            self.npp, slice_rows=self.cfg.sliced_slice_rows,
            hub_k=self.cfg.sliced_hub_k, init_k=self.cfg.sliced_init_k,
            row0=p * self.npp) for p in range(self.P)]

    @property
    def widths(self) -> list[int]:
        return self.planners[0].widths    # synchronized across partitions

    def _dev(self, p: int, *arrays: np.ndarray) -> list[torch.Tensor]:
        return [torch.as_tensor(a).to(self.ds.devices[p]) for a in arrays]

    def stage_adds(self, plans):
        app, spill, upd = [], [], []
        for p, plan in plans:
            fresh = plan.fresh
            sp = self.planners[p].plan_appends(
                plan.dst[fresh].astype(np.int64), plan.src[fresh],
                plan.w[fresh])
            if sp is None:
                self._rebuild_all()   # the mirrors already hold this batch
                return
            if len(sp.pos):
                app.append((p, sp.pos, sp.rows, sp.kpos, sp.src, sp.w))
            if len(sp.opos):
                spill.append((p, sp.opos, sp.osrc, sp.orows, sp.ow))
            if not fresh.all():
                u = ~fresh
                upd.append((p, (plan.dst[u] - p * self.npp).astype(np.int32),
                            plan.src[u], plan.w[u]))
        for p, *arrays in app:
            sliced_append(self.states[p], *self._dev(p, *ingest.pad_pow2(
                *arrays)))
        for p, *arrays in spill:
            sliced_spill(self.states[p], *self._dev(p, *ingest.pad_pow2(
                *arrays)))
        for p, *arrays in upd:
            sliced_update_min(self.states[p], *self._dev(
                p, *ingest.pad_pow2(*arrays)),
                width=self.planners[p].max_width)

    def shard_del_patch(self, p, dst, src):
        sliced_delete(self.states[p], *self._dev(
            p, (dst - p * self.npp).astype(np.int32), src),
            width=self.planners[p].max_width)

    def _rebuild_all(self) -> None:
        coo = [a.active_coo() for a in self.allocs]
        want_w, want_ocap = list(self.widths), self.planners[0].ocap
        for pl, c in zip(self.planners, coo):
            w_p, ocap_p = pl.required_geometry(c[1])
            want_w = [max(a, b) for a, b in zip(want_w, w_p)]
            want_ocap = max(want_ocap, ocap_p)
        for pl in self.planners:
            pl.widths, pl.ocap = list(want_w), want_ocap
        self.states = [
            SlicedEllState.from_host(pl, pl.rebuild_host(*c), dev,
                                     with_blocks=False)
            for pl, c, dev in zip(self.planners, coo, self.ds.devices)]

    def restore(self):
        self.planners = self._mk_planners()
        self._rebuild_all()

    def shard_wave(self, p, pool):
        """Partition ``p``'s unfused hybrid wave: K1 (or its plain version)
        once per width run of its slices, the overflow lane, the combine;
        ``[S, N]`` offers take K1's lane form once per width run, on one
        lane-minor copy of the offers a device and mesh wave."""
        st, npp = self.states[p], self.npp
        orow = st.odst.clamp(0, npp - 1)
        fn = ellpack_relax if self.use_kernel else ellpack_relax_ref
        minor = self._minor if self.use_kernel else (lambda offers: None)

        def wave(offers):
            best, arg = sliced_gather_min(
                offers, st.flat_idx, st.flat_w, widths=st.widths,
                slice_rows=st.slice_rows, relax=fn,
                offers_minor=minor(offers))
            obest, oarg = overflow_min(offers, st.osrc, orow, st.ow, npp)
            return combine_lanes(best[..., :npp], arg[..., :npp], obest,
                                 oarg)

        return wave

    def invariants(self):
        got = [sliced_invariants(st, width=pl.max_width)
               for st, pl in zip(self.states, self.planners)]
        return {k: all(g[k] for g in got) for k in got[0]}
