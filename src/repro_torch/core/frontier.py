"""Frontier-compacted sparse epochs — pay for the affected region, not the
graph (torch rendering of ``repro.core.frontier``, single-device side).

A dense wave dispatches over all N vertices and all E edge slots with a
boolean [N] frontier mask gating the gather, so a 3-edge ADD on a 2^20 graph
pays a whole-graph wave.  ``frontier_mode="sparse"|"auto"`` selects this
path instead:

  * ``compact_mask`` — cumsum + searchsorted compaction of the [N] frontier
    (each lane's of an [S, N] one) into a bounded ascending, -1-padded
    worklist plus the exact count;
  * a **capacity ladder** (``capacity_ladder``, ``edge_budget``) — each wave
    compacts once at the top rung and runs the smallest rung whose vertex
    count, ELL-cell total and live hub-overflow count all fit its budgets,
    else the exact dense ``relax_round`` over the pool;
  * ``OutAdjacency`` — the backend-independent OUT-adjacency sidecar: a
    ``SlicedEllPlanner`` with src/dst roles swapped, so a worklist vertex's
    row lists its out-neighbours;
  * ``sparse_push_wave`` — the gathered-edges wave over the worklist's OUT
    rows, relaxed by kernel K3 (``frontier_kernel=True``) or its plain
    version; on [S, N] lanes one rectangular [S, E] edge list relaxed by
    K3's lane form in one call;
  * the sparse relax and delete epochs, mirroring the dense ones' loops,
    and the bucketed drain (``sparse_drain``: the segment pull, then each
    bucket's waves through the ladder); each also returns its summed
    per-wave occupancy (the ``frontier_occupancy`` obs counter; i64[S] for
    lanes), the ladder's count, which the host reads anyway to pick the
    rung.  Each takes one tree ([N]) or a lane stack ([S, N], the batched
    engine's ``sources=``), as the dense epochs do; the reference's
    ``sparse_*_batched`` (``jax.vmap`` of the single epochs) are these
    same functions here;
  * ``wrap_shard_wave``, the sharded engine's sparse waves: each
    partition's live-offer edges compacted and scatter-min'd (no K3), the
    backend's own wave where a partition's count exceeds the cap.

The sparse wave's candidates are exactly the live out-edges of frontier
vertices — the set the dense wave's ``active & frontier[src]`` mask selects
— and the loops carry the same [N] mask, so (dist, parent, rounds,
messages) are bit-identical to the dense path, whatever rung runs.

The reference picks the rung on the device with nested ``lax.cond``; eager
torch has no device branch, so ``ladder_wave`` reads (count, ELL cells,
overflow entries) back in ONE host sync per wave and branches on the host —
all S lanes' counts in that one read, as one [3, S] tensor.  With
``converged_loop``'s ``any(frontier)`` read, a sparse wave costs two host
syncs, whatever S is.  Lanes share the rung: every rung gives the same
bits, and under the reference's vmap ``lax.cond`` runs both branches
anyway, so the wave takes the smallest rung every lane fits (one [S, E]
edge list) and the dense wave for all lanes when any lane misses the top.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import buckets
from repro_torch.core import delete as del_mod
from repro_torch.core import ingest, relax
from repro_torch.core.backends.base import FRONTIER_MODES  # noqa: F401
from repro_torch.core.backends.sliced import (SlicedEllPlanner,
                                              SlicedEllState, sliced_append,
                                              sliced_delete, sliced_spill,
                                              sliced_update_min)
from repro_torch.core.relax import RelaxStats, converged_loop
from repro_torch.core.state import INF, EdgePool, SSSPState
from repro_torch.graphs import csr as csr_mod
from repro_torch.kernels.relax.gather import (
    gathered_rows_relax, gathered_rows_relax_lanes,
    gathered_rows_relax_lanes_ref, gathered_rows_relax_ref)

# ----------------------------------------------------- compaction primitive --
def _slots(start: int, cap: int, like: torch.Tensor) -> torch.Tensor:
    """i32 ``start, ..., start + cap - 1`` for each lane of ``like`` (one
    row a lane: batched ``searchsorted`` wants one per sorted row)."""
    return torch.arange(start, start + cap, dtype=torch.int32,
                        device=like.device).expand(
                            *like.shape[:-1], cap).contiguous()


def _lane_cumsum(x: torch.Tensor) -> torch.Tensor:
    """i32 inclusive prefix sums of [N] or [S, N] integers or bools along
    the last axis, lane by lane: ONE scan over all S·N entries, each lane's
    total before it subtracted.  torch's scan along the last axis of a few
    long rows is slow on the card (a ladder wave's three scans took 2.1 ms
    at S = 4, N = 2^20 on an H100, one lane's 0.016 ms), so the lanes share
    one flat scan."""
    flat = torch.cumsum(x.reshape(-1), 0, dtype=torch.int32)
    if x.dim() == 1:
        return flat
    cs = flat.view(x.shape)
    before = torch.zeros_like(cs[:, -1])
    before[1:] = cs[:-1, -1]
    return cs - before[:, None]


def compact_mask(mask: torch.Tensor, *, cap: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact a bool[N] mask into an ascending i32[cap] vertex worklist:
    the i-th set vertex (1-based) is the first index whose inclusive prefix
    count reaches i (``searchsorted``, left side).  Returns (worklist,
    count): -1-padded, ``count`` the EXACT occupancy ``sum(mask)`` (when it
    exceeds ``cap`` the worklist is truncated and the caller goes dense).
    An [S, N] mask gives [S, cap] worklists and [S] counts, lane by lane."""
    cs = _lane_cumsum(mask)
    count = cs[..., -1]
    slots = _slots(1, cap, mask)
    wl = torch.searchsorted(cs, slots, out_int32=True)
    return torch.where(slots <= count[..., None], wl, -1), count


def worklist_to_mask(wl: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """Inverse of ``compact_mask`` for in-capacity masks (-1 padding
    ignored; [S, cap] worklists give [S, N] masks)."""
    return relax.mark_vertices(wl.clamp(0, num_vertices - 1), wl >= 0,
                               num_vertices)


def capacity_ladder(num_vertices: int, cap: int = 0) -> tuple[int, ...]:
    """Worklist capacity rungs (ascending).  ``cap=0`` derives the top rung
    as N/64 (>= 256, pow2-rounded); a small first rung keeps the common
    few-vertex waves cheap while the top rung absorbs moderate cascades
    before the dense fallback."""
    if cap <= 0:
        cap = max(256, csr_mod.next_pow2(max(num_vertices, 1)) // 64)
    cap = min(csr_mod.next_pow2(cap), csr_mod.next_pow2(max(num_vertices, 1)))
    low = max(256, cap // 16)
    return (low, cap) if low < cap else (cap,)


def edge_budget(cap: int) -> int:
    """Per-rung edge/overflow capacity: 8 out-edges per worklist slot."""
    return 8 * cap


# ---------------------------------------------------- OUT-adjacency sidecar --
class OutAdjacency:
    """Backend-independent OUT-adjacency sidecar for the sparse push waves.

    A ``SlicedEllPlanner`` with the roles swapped: planner *rows* are edge
    SOURCES and the cells hold destination ids.  High-out-degree hubs spill
    to the overflow lane, where ``osrc`` holds the *destination* (the
    scatter target) and ``odst`` the *source row* (the frontier filter).
    Per-row slices (``slice_rows=1``) and a high hub threshold, as the
    reference: every wave pays O(overflow capacity) for the lane, so spills
    must stay rare.  A derived view, rebuilt from the allocator's host
    mirror on exhaustion or restore (never serialized)."""

    def __init__(self, num_vertices: int, device: torch.device | str, *,
                 slice_rows: int = 1, hub_k: int = 1024, init_k: int = 2):
        self.n = num_vertices
        self.device = torch.device(device)
        self._knobs = dict(slice_rows=slice_rows, hub_k=hub_k, init_k=init_k)
        self.planner = SlicedEllPlanner(num_vertices, **self._knobs)
        self.state = SlicedEllState.from_host(
            self.planner, self.planner.empty_host(), self.device,
            with_blocks=False)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _rebuild(self, alloc) -> None:
        src, dst, w = alloc.active_coo()
        self.state = SlicedEllState.from_host(
            self.planner, self.planner.rebuild_host(dst, src, w),  # swapped
            self.device, with_blocks=False)

    def apply_adds(self, plan, alloc) -> None:
        fresh = plan.fresh
        sp = self.planner.plan_appends(
            plan.src[fresh].astype(np.int64), plan.dst[fresh], plan.w[fresh])
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
                plan.src[upd], plan.dst[upd], plan.w[upd])),
                width=self.planner.max_width)

    def apply_dels(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Tombstone deleted (padded) edges; rows are the edge SOURCES."""
        sliced_delete(self.state, self._dev(src), self._dev(dst),
                      width=self.planner.max_width)

    def restore(self, alloc) -> None:
        self.planner = SlicedEllPlanner(self.n, **self._knobs)
        self._rebuild(alloc)


# ------------------------------------------------------------- sparse waves --
def sparse_push_wave(dist: torch.Tensor, parent: torch.Tensor,
                     wl: torch.Tensor, ecs: torch.Tensor, ocs: torch.Tensor,
                     st: SlicedEllState, *, ecap: int, ocap: int,
                     num_vertices: int, use_kernel: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One gathered-edges relaxation wave over the worklist's OUT rows.

    Each of the ``ecap`` edge slots binary-searches the worklist's inclusive
    degree cumsum ``ecs`` for its (row, cell), so the candidate list covers
    exactly the worklist rows' occupied cells; the frontier-live overflow
    entries are compacted the same way through ``ocs`` into ``ocap`` slots.
    Both lanes concatenate into ONE edge list relaxed by K3 (``use_kernel``)
    or its plain version.  For [S, N] trees (``wl``, ``ecs``, ``ocs`` one
    row a lane) each lane searches its own row, and the [S, ecap + ocap]
    edge list goes to K3's lane form in one call.  The caller
    (``ladder_wave``) guarantees both budgets fit every lane."""
    c = wl.shape[-1]
    valid = wl >= 0
    rows = wl.clamp(0, st.fill.shape[0] - 1)
    rk = torch.where(valid, st.fill[rows], 0)
    excl = ecs - rk                               # exclusive degree prefix
    j = _slots(0, ecap, wl)
    r = torch.searchsorted(ecs, j, right=True).clamp(0, c - 1)
    evalid = j < ecs[..., -1:]
    kk = j - excl.gather(-1, r)
    src = rows.gather(-1, r)
    pos = (st.base[src] + kk).clamp(0, st.flat_w.shape[0] - 1)
    e_src, e_nbr, e_w, e_val = src, st.flat_idx[pos], st.flat_w[pos], evalid
    if ocap and st.ow.shape[0]:
        # overflow lane (osrc = destination / scatter target, odst = source
        # row under the sidecar's swapped roles); ocs already folds in the
        # frontier filter, so the selected entries are live by construction
        oslots = _slots(1, ocap, wl)
        osel = torch.searchsorted(ocs, oslots).clamp(0, st.ow.shape[0] - 1)
        e_src = torch.cat([e_src, st.odst[osel]], -1)
        e_nbr = torch.cat([e_nbr, st.osrc[osel]], -1)
        e_w = torch.cat([e_w, st.ow[osel]], -1)
        e_val = torch.cat([e_val, oslots <= ocs[..., -1:]], -1)
    if wl.dim() == 1:
        fn = gathered_rows_relax if use_kernel else gathered_rows_relax_ref
    else:
        fn = (gathered_rows_relax_lanes if use_kernel
              else gathered_rows_relax_lanes_ref)
    best, arg = fn(dist.gather(-1, e_src.long()), e_src, e_nbr, e_w, e_val,
                   num_rows=num_vertices)
    improved = best < dist
    return (torch.where(improved, best, dist),
            torch.where(improved, arg, parent), improved)


def ladder_wave(dist: torch.Tensor, parent: torch.Tensor,
                frontier: torch.Tensor, st: SlicedEllState, edges: EdgePool,
                *, caps: tuple[int, ...], num_vertices: int,
                use_kernel: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           int | np.ndarray]:
    """One wave through the capacity ladder: compact once at the top rung,
    run the smallest rung whose vertex count, ELL cell total AND live
    hub-overflow count all fit its budgets, else the exact dense
    ``relax_round`` over the pool.  The three counts come back to the host
    in one read (a [3, S] tensor for [S, N] lanes, which take the smallest
    rung every lane fits, else the dense wave together).  All branches are
    bit-identical: the rung is a cost choice.  Returns (dist, parent,
    improved, the frontier's count: i64, or i64[S] for lanes)."""
    wl, count = compact_mask(frontier, cap=caps[-1])
    rows = wl.clamp(0, st.fill.shape[0] - 1)
    ecs = _lane_cumsum(torch.where(wl >= 0, st.fill[rows], 0))
    ocs = _lane_cumsum(frontier[..., st.odst] & (st.ow < INF))
    count_h, etotal, ocnt = np.asarray(torch.stack(
        [count, ecs[..., -1], ocs[..., -1]]).tolist())
    for c in caps:
        eb = edge_budget(c)
        if np.all((count_h <= c) & (etotal <= eb) & (ocnt <= eb)):
            return (*sparse_push_wave(
                dist, parent, wl[..., :c], ecs[..., :c].contiguous(), ocs,
                st, ecap=eb, ocap=eb, num_vertices=num_vertices,
                use_kernel=use_kernel), count_h)
    return (*relax.relax_round(dist, parent, edges, frontier,
                               num_vertices=num_vertices), count_h)


def _ladder(st: SlicedEllState, edges: EdgePool, *, caps: tuple[int, ...],
            num_vertices: int, use_kernel: bool
            ) -> tuple[relax.Wave, list]:
    """A ladder wave for the converged / drain loops, and the list each
    wave's occupancy count is appended to (the epoch's occupancy is its
    sum, ``_occupancy``; a lane whose loop has finished has an empty
    frontier and adds 0)."""
    counts: list = []

    def wave(dist, parent, frontier):
        dist, parent, improved, count = ladder_wave(
            dist, parent, frontier, st, edges, caps=caps,
            num_vertices=num_vertices, use_kernel=use_kernel)
        counts.append(count)
        return dist, parent, improved

    return wave, counts


def _occupancy(counts: list, like: torch.Tensor) -> int | np.ndarray:
    """The waves' summed counts: i64, or i64[S] for ``like``'s lanes."""
    return sum(counts, relax.no_rounds(like))


# ------------------------------------------------------------ sparse epochs --
def sparse_relax_until_converged(
    sssp: SSSPState, edges: EdgePool, st: SlicedEllState,
    frontier: torch.Tensor, *, num_vertices: int, caps: tuple[int, ...],
    max_rounds: int = 0, use_kernel: bool = False,
) -> tuple[SSSPState, RelaxStats, int | np.ndarray]:
    """Sparse rendering of ``relax.relax_until_converged``: the same
    converged-loop driver and mask carry ([N], or [S, N] lanes from an [N]
    ADD frontier they share), each wave through the capacity ladder, for at
    most ``max_rounds`` waves when that is positive.  Also returns the
    summed per-wave occupancy (per lane) of the waves that ran."""
    wave, counts = _ladder(st, edges, caps=caps, num_vertices=num_vertices,
                           use_kernel=use_kernel)
    dist, parent, rounds, msgs = converged_loop(
        sssp.dist, sssp.parent, frontier, wave, max_rounds=max_rounds)
    return (SSSPState(dist=dist, parent=parent, source=sssp.source),
            RelaxStats(rounds=rounds, messages=msgs),
            _occupancy(counts, dist))


def sparse_invalidate_and_recompute(
    sssp: SSSPState, edges: EdgePool, st: SlicedEllState,
    seed: torch.Tensor, *, num_vertices: int, caps: tuple[int, ...],
    use_doubling: bool = True, use_kernel: bool = False,
) -> tuple[SSSPState, del_mod.DeleteStats, int | np.ndarray]:
    """Sparse deletion epoch — ``delete.invalidate_and_recompute``'s
    structure (same marking, same gating of a lane with no seed, same dense
    bulk pull over the pool's in-edges, which the OUT sidecar cannot serve
    and which runs once per epoch); only the push recompute waves run
    through the ladder, whose summed occupancy comes back third."""
    any_seed = relax.host_flags(seed)
    if not np.any(any_seed):
        return sssp, del_mod.empty_delete_stats(seed), relax.no_rounds(seed)
    aff, inv_rounds, dist, parent = del_mod.invalidate(
        sssp, seed, use_doubling=use_doubling, gate=any_seed)
    dist, parent, improved = del_mod.pull_once(dist, parent, edges, aff,
                                               num_vertices)
    state, stats, occ = sparse_relax_until_converged(
        SSSPState(dist=dist, parent=parent, source=sssp.source), edges, st,
        improved, num_vertices=num_vertices, caps=caps,
        use_kernel=use_kernel)
    return state, del_mod.recompute_stats(aff, inv_rounds, improved, stats,
                                          any_seed), occ


def sparse_drain(sssp: SSSPState, edges: EdgePool, st: SlicedEllState,
                 pend: buckets.PendingState, *, num_vertices: int,
                 caps: tuple[int, ...], bucket_width: float,
                 use_kernel: bool = False
                 ) -> tuple[SSSPState, buckets.PendingState, RelaxStats,
                            int | np.ndarray]:
    """Sparse bucketed drain: ``buckets.run_drain`` with each bucket's
    active mask compacted through the ladder.  The pull is
    ``delete.pull_once`` (segment-style, the dense pool's in-edges), as in
    ``segment_drain``, so the wave sequence and stats match by
    construction.  Also returns the summed occupancy of the bucket waves
    (the pull is not one)."""
    wave, counts = _ladder(st, edges, caps=caps, num_vertices=num_vertices,
                           use_kernel=use_kernel)

    def pull_wave(dist, parent, aff):
        return del_mod.pull_once(dist, parent, edges, aff, num_vertices)

    dist, parent, stats = buckets.run_drain(
        sssp.dist, sssp.parent, pend, bucket_width=bucket_width,
        wave=wave, pull_wave=pull_wave)
    return (*buckets.drained(sssp, pend, dist, parent), stats,
            _occupancy(counts, dist))


# the reference's vmapped lane-stack entry points: the epochs above take
# [S, N] lanes themselves
sparse_relax_batched = sparse_relax_until_converged
sparse_delete_batched = sparse_invalidate_and_recompute
sparse_drain_batched = sparse_drain


# ------------------------------------------------------------- sharded wave --
def wrap_shard_wave(waves, pools, npp: int, cap: int):
    """The sharded engine's sparse mesh wave: per-partition edge-worklist
    compaction around the backend's waves (``waves[p]``, one per
    partition).

    The epochs patch every partition's COO pool slice (``pools[p]``) for
    EVERY backend, so a partition whose live-offer edges number at most
    ``cap`` evaluates the segment-style wave over just those edges,
    whatever layout its dense wave uses — the same candidate multiset and
    tie rule, so bit-identical.  ``offers`` already carry the frontier
    masking, so membership is ``active & isfinite(offers[src])``; unmasked
    pull waves overflow the cap and take the dense wave.  The reference
    branches on the device (``lax.cond``, both branches under its lane
    ``vmap``); here the counts of every partition (and lane, for ``[S, N]``
    offers: one ``[P, S]`` tensor) are read back in ONE host sync per wave
    and each (partition, lane) branches on the host — a sparse wave's
    second read, as the single-device sparse wave reads its ladder's
    counts.  A partition's over-cap lanes share one dense wave (K1's lane
    form on the ELL layouts); its other lanes compact one by one."""

    def compact(e, o, c, cnt, p):
        slots = torch.arange(1, cnt + 1, dtype=torch.int32, device=o.device)
        at = torch.searchsorted(c, slots).clamp(max=len(c) - 1)
        cs, cd, cw = e.src[at], e.dst[at], e.w[at]
        cand = o[cs] + cw
        dl = (cd - p * npp).clamp(0, npp - 1).long()
        best = relax.segment_min(cand, dl, npp, INF)
        hit = (cand == best[dl]) & (cand < INF)
        return best, relax.segment_min(torch.where(hit, cs, relax.BIG), dl,
                                       npp, relax.BIG)

    def wave(offers):
        lives = [e.active & torch.isfinite(o[..., e.src])
                 for e, o in zip(pools, offers)]
        ecs = [torch.cumsum(m.to(torch.int32), -1, dtype=torch.int32)
               for m in lives]
        dev0 = offers[0].device
        counts = relax.host(torch.stack([c[..., -1].to(dev0) for c in ecs]))
        out = []
        for p, (e, o, c, cnt) in enumerate(zip(pools, offers, ecs, counts)):
            if o.dim() == 1:
                out.append(waves[p](o) if cnt > cap
                           else compact(e, o, c, int(cnt), p))
                continue
            dense = np.nonzero(cnt > cap)[0]
            if len(dense) == len(cnt):
                out.append(waves[p](o))
                continue
            best = torch.empty((len(cnt), npp), dtype=torch.float32,
                               device=o.device)
            arg = torch.empty((len(cnt), npp), dtype=torch.int32,
                              device=o.device)
            if len(dense):
                rows = torch.as_tensor(dense).to(o.device)
                best[rows], arg[rows] = waves[p](o[rows])
            for i in np.nonzero(cnt <= cap)[0]:
                best[i], arg[i] = compact(e, o[i], c[i], int(cnt[i]), p)
            out.append((best, arg))
        return out

    return wave
