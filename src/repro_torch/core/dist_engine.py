"""ShardedSSSPDelEngine — the fully dynamic engine over a vertex-partitioned
mesh (torch rendering of ``repro.core.dist_engine``).

The same ``EventLog`` stream that drives ``SSSPDelEngine`` drives P
partitions here, each with its own vertex window, edge pool and layout:

  * **Ownership**: vertices are range-partitioned over the mesh (``npp``
    per partition); an edge lives with the owner of its **dst**, so the
    per-round scatter-min is partition-local (paper §3).
  * **Control plane**: one host-side slot allocator per partition plans
    where each topology event lands in its owner's ``Epp``-slot pool, and
    the sharded backend (``core/backends``) keeps one window-local layout
    planner per partition.
  * **Data plane**: each batch patches the owners' pools and layout blocks
    (exact local indices, routed on the host), then runs the relaxation or
    deletion epoch from the batch — frontier = tails of inserted edges,
    seeds = heads of deleted tree edges — through ``DistributedSSSP``'s
    allgather or delta exchange, with the backend's wave (K1 once per
    partition and wave on the ELL layouts).
  * **Host reads**: every wave reads ONE small tensor for all P partitions
    (``DistributedSSSP._go``); rounds are host integers and messages a
    device scalar, as in the port's single-device engine.
  * **Lanes** (``sources=(s0, ...)``, the reference's ``_build_epochs_ms``):
    S trees as ``[S, npp]`` state per partition over the one shared pool
    and layout.  Each batch patches the pools and layouts ONCE; an ADD's
    tails are every lane's frontier; a deletion seeds each lane from its
    own tree, and a lane without a seed is left out of the marking;
    "never invalidate the source" holds per lane.  The bodies are
    ``DistributedSSSP``'s own, lane-generic: each round still reads one
    small tensor for all lanes and partitions (the ``[S]`` flags), so
    P = 8 reads what P = 1 reads, and rounds and messages are ``[S]``
    counters that freeze per lane as the reference's vmapped loops do.
    K1 runs its lane form once per partition and wave.

Equivalence contract (as the reference's): with ``exchange="allgather"``
the engine is bit-identical in ``(dist, parent)``, rounds and messages to
``SSSPDelEngine`` with the same backend, for any partition count; the
``"delta"`` exchange reaches the same ``(dist, parent)`` with its own round
and message counts, which equal the reference sharded engine's.

Edge-balanced placement: pass the ``(perm, inv, npp)`` triple from
``graphs.partition.edge_balanced_relabeling`` (built for this mesh's
partition count) as ``relabel`` — events are permuted on ingest and results
un-permuted at query.

Departures from the reference's rendering, with the same results:
  * the reference routes foreign batch entries through a sacrificial pool
    slot inside its jitted epochs (``masked_write``); here the host routes
    each partition's slots and writes exact indices, so the pools equal
    the reference's slot for slot;
  * the reference's loops run on device with no host read; the port reads
    once per wave for all partitions;
  * a mesh's devices may repeat (several partitions on one card), and one
    controller drives every partition — no ``torch.distributed``.

Checkpoint/restore uses the reference's schema (pool arrays in
partition-major slot order from the host mirrors, padded dist / parent,
``[S, N]`` and an ``[S]`` source for lanes), so either package restores
the other's; layouts are rebuilt from the mirrors on restore, never
serialized.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backends as bk_mod
from repro_torch.core import events as ev
from repro_torch.core import frontier as frontier_mod
from repro_torch.core import ingest, relax
from repro_torch.core.distributed import (DistConfig, DistributedSSSP,
                                          inactive_dst_layout, mesh_wave,
                                          per_partition_occupancy)
from repro_torch.core.engine import resolve_kernel
from repro_torch.core.state import INF, NO_PARENT
from repro_torch.core.stream import StreamEngineBase
from repro_torch.launch.mesh import Mesh, make_mesh, visible_devices
from repro_torch.obs import WatchdogConfig

__all__ = ["EXCHANGES", "ShardedEngineConfig", "ShardedSSSPDelEngine"]

EXCHANGES = ("allgather", "delta")


@dataclasses.dataclass
class ShardedEngineConfig:
    num_vertices: int        # logical |V| (pre-padding, pre-relabel)
    edges_per_part: int      # static per-partition edge-pool capacity (Epp)
    source: int
    exchange: str = "allgather"   # or "delta"
    delta_cap: int = 4096    # per-part (idx,val) slots for "delta" exchange
    use_doubling: bool = True     # False = the paper's wave-by-wave flood
    batch_deletions: bool = False
    on_duplicate: str = "ignore"  # or "min" (weight decreases)
    # relaxation backend and its knobs: EngineConfig's fields and defaults
    relax_backend: str = "segment"
    ell_block_rows: int = 256
    ell_init_k: int = 8
    ell_use_kernel: bool | None = None  # None = kernel K1 iff on CUDA
    sliced_slice_rows: int = 256
    sliced_hub_k: int = 32
    sliced_init_k: int = 2
    wave_schedule: str = "rounds"   # or "buckets"
    bucket_width: float | str = 1.0
    # "sparse" compacts each partition's live-offer edges inside the wave
    # (the backend's own wave is the fallback); "auto" routes dense here,
    # as in the reference
    frontier_mode: str = "dense"
    frontier_cap: int = 0    # per-partition edge-worklist cap; 0 = Epp/64
    sources: tuple[int, ...] | None = None   # None = single-source
    observability: bool = False
    obs_flight_capacity: int = 128
    obs_watchdog: WatchdogConfig | None = None
    alloc_impl: str = "columnar"
    device: str = "cuda"      # the mesh's device type

    def __post_init__(self):
        bk_mod.validate_backend_config(self)
        ingest.allocator_cls(self.alloc_impl)  # raises on unknown impl
        if self.exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {self.exchange!r}; valid: "
                             f"{EXCHANGES}")
        if self.obs_flight_capacity < 1:
            raise ValueError(f"obs_flight_capacity must be >= 1; got "
                             f"{self.obs_flight_capacity}")
        if self.sources is not None:
            self.sources = tuple(int(s) for s in self.sources)
            bad = [s for s in self.sources
                   if not 0 <= s < self.num_vertices]
            if not self.sources or bad:
                raise ValueError(
                    f"sources must be non-empty vertex ids in "
                    f"[0, {self.num_vertices}); got {self.sources}")
        dev = torch.device(self.device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be CUDA or CPU; got {self.device!r}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ShardedEngineConfig(device='cuda'): CUDA is not available; "
                "pass device='cpu' to run the plain torch path on the CPU")


class ShardedSSSPDelEngine(StreamEngineBase):
    """Host orchestrator over the partitions of a ``Mesh``.

    ``mesh=None`` flattens every visible device of the config's device type
    onto one "graph" axis; any explicit mesh works — all its axes are
    flattened into the vertex partition — and its devices must be of the
    config's type (a list that repeats one device stacks partitions on
    it)."""

    def __init__(self, cfg: ShardedEngineConfig, mesh: Mesh | None = None,
                 relabel: tuple[np.ndarray, np.ndarray, int] | None = None):
        kind = torch.device(cfg.device).type
        if mesh is None:
            avail = visible_devices(kind)
            mesh = make_mesh((len(avail),), ("graph",), devices=avail)
        bad = [d for d in mesh.devices if d.type != kind]
        if bad:
            raise ValueError(f"mesh devices {bad} are not of the config's "
                             f"device type {kind!r}")
        super().__init__(mesh.devices[0], cfg.sources,
                         observability=cfg.observability,
                         flight_capacity=cfg.obs_flight_capacity,
                         watchdog=cfg.obs_watchdog)
        self.cfg = cfg
        self.mesh = mesh
        P_ = mesh.size
        if relabel is not None:
            perm, inv, npp_r = relabel
            self.perm = np.asarray(perm, np.int32)
            self.inv = np.asarray(inv, np.int32)
            if len(self.perm) != cfg.num_vertices:
                raise ValueError("relabel: perm must cover |V|")
            if npp_r * P_ != len(self.inv):
                raise ValueError(
                    f"relabeling was built for "
                    f"{len(self.inv) // max(npp_r, 1)} partitions "
                    f"(npp={npp_r}); this mesh flattens to P={P_} — "
                    f"rebuild with edge_balanced_relabeling(n, dst, P)")
            n_pad = len(self.inv)
        else:
            self.perm = self.inv = None
            n_pad = P_ * (-(-cfg.num_vertices // P_))
        self.ds = DistributedSSSP(mesh, DistConfig(
            num_vertices=n_pad, edges_per_part=cfg.edges_per_part,
            mesh_axes=tuple(mesh.axis_names), exchange=cfg.exchange,
            delta_cap=cfg.delta_cap))
        self.P, self.npp, self.epp = self.ds.P, self.ds.npp, cfg.edges_per_part
        # the padded / relabeled source id, or a tuple of them for lanes
        pad = (lambda s: int(s if self.perm is None else self.perm[s]))
        self._source_pad = (pad(cfg.source) if self.sources is None
                            else tuple(pad(s) for s in self.sources))
        # control plane: one planner per partition, local Epp-slot pools
        self.allocs = [ingest.make_allocator(cfg.edges_per_part,
                                             cfg.on_duplicate,
                                             cfg.alloc_impl)
                       for _ in range(self.P)]
        self.bk = bk_mod.make_sharded_backend(
            cfg.relax_backend, cfg, self.ds, self.allocs,
            use_kernel=resolve_kernel(cfg.ell_use_kernel, mesh.devices[0]))
        if self.sources is None:
            self.dist, self.parent = self.ds.init_vertex_arrays(
                self._source_pad)
        else:
            self.dist, self.parent = self.ds.init_vertex_arrays_ms(
                self._source_pad)
        # each partition's "never invalidate the source" mask (per lane)
        src = torch.tensor(self._source_pad, dtype=torch.int32)
        self._not_src = [ids != src.to(ids.device)[..., None]
                         for ids in self.ds.local_ids]
        self.pools = self.ds.put_edges(
            np.zeros(self.P * self.epp, np.int32),
            inactive_dst_layout(self.P, self.npp, self.epp),
            np.zeros(self.P * self.epp, np.float32),
            np.zeros(self.P * self.epp, np.bool_))
        # sparse waves: a per-partition edge-worklist cap
        self._fcap = 0
        if cfg.frontier_mode == "sparse":
            self._fcap = frontier_mod.capacity_ladder(
                cfg.edges_per_part, cfg.frontier_cap)[-1]
        # bucket_width="auto" cache: (width, live-edge estimate at it)
        self._bw_cache: tuple[float, int] | None = None
        self.bucketed = cfg.wave_schedule == "buckets"
        self._zero_pend = [torch.zeros(d.shape, dtype=torch.bool,
                                       device=d.device) for d in self.dist]
        self._push = self._pull = self._zero_pend
        # touched-vertex attribution baseline: dist at the last metrics
        # readout (the tensors are replaced, never written in place)
        self._obs_dist_mark = list(self.dist) if self.obs.enabled else None

    # ------------------------------------------------------------- helpers
    def _wave(self):
        """The mesh wave over the current layouts (sparse-wrapped under
        ``frontier_mode="sparse"``)."""
        waves = [self.bk.shard_wave(p, e) for p, e in enumerate(self.pools)]
        if self._fcap:
            return frontier_mod.wrap_shard_wave(waves, self.pools, self.npp,
                                                self._fcap)
        return mesh_wave(waves)

    def _dev(self, p: int, *arrays: np.ndarray) -> list[torch.Tensor]:
        return [torch.as_tensor(a).to(self.ds.devices[p]) for a in arrays]

    def _fold(self, rounds, messages: torch.Tensor) -> None:
        """Fold one epoch's rounds (host; per lane for lanes) and messages
        (device); with obs on, the cumulative counters are recorded and
        their consecutive differences become the waves- and
        messages-per-epoch histogram samples at flush (the reference's
        ``_fold_epoch_obs``)."""
        self._rounds = self._rounds + rounds
        self._dev_messages = self._dev_messages + messages
        if self.obs.enabled:
            self.obs.hist_cumulative("hist_waves_per_epoch", self._rounds)
            self.obs.hist_cumulative("hist_messages_per_epoch",
                                     self._dev_messages)

    def _owners(self, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        owner = np.asarray(dst, np.int64) // self.npp
        return owner, np.unique(owner)

    def _bucket_width(self) -> float:
        """``bucket_width="auto"`` resolved on the host from the
        per-partition mirrors, with the single-device engine's policy."""
        if self.cfg.bucket_width != "auto":
            return self.cfg.bucket_width
        live_est = max(1, self.n_adds - self.n_dels)
        if self._bw_cache is not None:
            width, at = self._bw_cache
            if at / 2 <= live_est <= at * 2:
                return width
        w = np.concatenate([a.active_coo()[2] for a in self.allocs])
        if len(w) == 0:
            width = 1.0
        else:
            med = max(float(np.percentile(w, 50.0)), 1e-6)
            width = float(2.0 ** np.round(np.log2(med)))
        self._bw_cache = (width, live_est)
        return width

    def _obs_pre_snapshot(self) -> None:
        """Touched-vertex attribution: vertices whose dist changed since
        the last metrics readout, a [P] per-partition vector ([S] per lane
        for lanes; one compare per readout, never per epoch)."""
        mark = self._obs_dist_mark
        if mark is not None:
            upd = per_partition_occupancy(
                [d != m for d, m in zip(self.dist, mark)], self.ds.dev0)
            if self.sources is None:
                self.obs.counters.add("updates_per_part", upd,
                                      dim="partition")
            else:
                self.obs.counters.add("updates_per_lane", upd, dim="lane")
        self._obs_dist_mark = list(self.dist)

    # ------------------------------------------------------------------ adds
    def _ingest_adds(self, batch: ev.EventBatch) -> None:
        src, dst, w = batch.src, batch.dst, batch.w
        if self.perm is not None:
            src, dst = self.perm[src], self.perm[dst]
        owner, parts = self._owners(dst)
        plans = []
        for p in parts:
            sel = owner == p
            plan = self.allocs[p].plan_adds(src[sel], dst[sel], w[sel])
            if len(plan.slots):
                plans.append((int(p), plan))
        if not plans:
            return
        n_acc = sum(len(plan.slots) for _, plan in plans)
        with self.obs.epoch("add_epoch", events=n_acc):
            self.bk.stage_adds(plans)  # layout patches (or coupled rebuild)
            self.obs.note_layout(self.bk.layout_counters())
            tails = np.unique(np.concatenate([pl.src for _, pl in plans]))
            if self.obs.enabled:
                self._obs_adds(plans, tails)
            for p, plan in plans:
                ingest.apply_adds(self.pools[p], *self._dev(
                    p, *ingest.pad_pow2(plan.slots, plan.src, plan.dst,
                                        plan.w)))
            # frontier = tails of the inserted edges (paper Listing 3), each
            # partition its own window, the same for every lane
            mask = np.zeros(self.P * self.npp, np.bool_)
            mask[tails] = True
            frontier = [f.expand(d.shape) for f, d in
                        zip(self.ds.shard(mask), self.dist)]
            if self.bucketed:
                # deferred settle: enqueue the reachable tails, no waves
                self._push = [q | (f & torch.isfinite(d)) for q, f, d in
                              zip(self._push, frontier, self.dist)]
            else:
                self.dist, self.parent, rounds, msgs = self.ds._relax_body(
                    self.dist, self.parent, frontier, self._wave())
                self._fold(rounds, msgs)
            self.n_adds += n_acc
            self.n_epochs += 1

    def _obs_adds(self, plans, tails: np.ndarray) -> None:
        """Host-planned ADD figures: frontier (distinct tails), its
        histogram sample and per-partition split, adds per partition."""
        nf = len(tails)
        self.obs.counters.inc("frontier", nf)
        self.obs.hist_host("hist_frontier_occupancy", nf)
        self.obs.counters.inc(
            "frontier_per_part",
            np.bincount(tails.astype(np.int64) // self.npp,
                        minlength=self.P).astype(np.int64), dim="partition")
        per_part = np.zeros(self.P, np.int64)
        for p, plan in plans:
            per_part[p] = len(plan.slots)
        self.obs.counters.inc("adds_per_part", per_part, dim="partition")
        if self.obs.watchdog is not None:
            self.obs.watchdog.observe("add_epoch", 0.0, {"frontier": nf})

    # ------------------------------------------------------------------ dels
    def _ingest_dels(self, batch: ev.EventBatch) -> None:
        for gsrc, gdst in self._deletion_groups(batch):
            if self.perm is not None:
                gsrc, gdst = self.perm[gsrc], self.perm[gdst]
            owner, owners = self._owners(gdst)
            parts = []
            for p in owners:
                sel = owner == p
                slots, psrc, pdst = self.allocs[p].plan_dels(gsrc[sel],
                                                             gdst[sel])
                if len(slots):
                    parts.append((int(p), slots, psrc, pdst))
            if not parts:
                continue
            n_del = sum(len(s) for _, s, _, _ in parts)
            with self.obs.epoch("del_epoch", events=n_del):
                if self.obs.enabled:
                    per_part = np.zeros(self.P, np.int64)
                    for p, s, _, _ in parts:
                        per_part[p] = len(s)
                    self.obs.counters.inc("dels_per_part", per_part,
                                          dim="partition")
                self._del_epoch(parts)
                self.n_dels += n_del
                self.n_epochs += 1

    def _del_epoch(self, parts) -> None:
        """One deletion epoch: seed from the PRE-deletion tree (Listing 4:
        only tree edges seed; each lane its own tree), deactivate the slots
        and tombstone the layouts once, then — in the lanes where any
        partition has a seed — invalidate the subtrees and recompute
        (rounds schedule) or defer the recompute into the pending masks
        (buckets).  Stats as the reference's, gated per lane."""
        seed = list(self._zero_pend)
        for p, *batch in parts:
            slots, psrc, pdst = ingest.pad_pow2(*batch)
            s, d = self._dev(p, psrc, (pdst - p * self.npp).astype(np.int32))
            seed[p] = relax.mark_vertices(
                d, self.parent[p][..., d.long()] == s, self.npp)
            ingest.apply_dels(self.pools[p], *self._dev(p, slots))
            self.bk.shard_del_patch(p, pdst, psrc)
        flood_delta = (not self.cfg.use_doubling
                       and self.cfg.exchange == "delta")
        any_seed, overflow = self.ds._go(seed, flood_delta)
        zero = torch.zeros(self.dist[0].shape[:-1], dtype=torch.int64,
                           device=self.ds.dev0)
        if not np.any(any_seed):
            self._fold(relax.no_rounds(self.dist[0]), zero)
            return
        if self.cfg.use_doubling:
            aff, inv_rounds = self.ds._invalidate_doubling(self.parent, seed,
                                                           any_seed)
        elif flood_delta:
            aff, inv_rounds = self.ds._invalidate_delta(self.parent, seed,
                                                        overflow, any_seed)
        else:
            aff, inv_rounds = self.ds._invalidate_flood_dense(
                self.parent, seed, any_seed)
        # never invalidate the source (parity with the single-device engine)
        aff = [a & m for a, m in zip(aff, self._not_src)]
        affected = self.ds.psum([a.sum(-1) for a in aff])
        dist = [torch.where(a, INF, d) for a, d in zip(aff, self.dist)]
        parent = [torch.where(a, NO_PARENT, q)
                  for a, q in zip(aff, self.parent)]
        if self.bucketed:
            # invalidated vertices stop offering; they re-enter via the
            # drain's pull
            self.dist, self.parent = dist, parent
            self._push = [q & torch.isfinite(d)
                          for q, d in zip(self._push, dist)]
            self._pull = [q | a for q, a in zip(self._pull, aff)]
            self._fold(inv_rounds, affected)
            return
        if self.cfg.exchange == "delta":
            dist, parent, rec_rounds, rec_msgs = self.ds._recompute_delta(
                dist, parent, aff, self.pools, self._wave())
        else:
            dist, parent, rec_rounds, rec_msgs = \
                self.ds._recompute_pull_push(dist, parent, aff, self._wave())
        self.dist, self.parent = dist, parent
        # a lane without a seed counts no round (its pull is not a round)
        self._fold((inv_rounds + rec_rounds) * any_seed, rec_msgs + affected)

    # ----------------------------------------------------------------- query
    def drain(self) -> None:
        """Settle the bucketed schedule's pending work (no-op under the
        rounds schedule); the single-device ``SSSPDelEngine.drain``'s
        contract."""
        if not self.bucketed:
            return
        if self.obs.enabled:
            # bucket occupancy at drain entry: [P] per-partition counts ([S]
            # per-lane totals for lanes), accumulated on the device
            dev0 = self.ds.dev0
            occ_dim = "partition" if self.sources is None else "lane"
            self.obs.counters.add("pending_push", per_partition_occupancy(
                self._push, dev0), dim=occ_dim)
            self.obs.counters.add("pending_pull", per_partition_occupancy(
                self._pull, dev0), dim=occ_dim)
        with self.obs.epoch("drain"):
            self.dist, self.parent, rounds, msgs = self.ds._drain_body(
                self.dist, self.parent, self._push, self._pull, self._wave(),
                self._bucket_width())
            self._push = self._pull = self._zero_pend
            self._fold(rounds, msgs)
            if self.obs.enabled:
                self.obs.counters.inc("drain_waves", rounds)

    def _snapshot(self, lane: int | None) -> tuple[np.ndarray, np.ndarray]:
        """Drain, read back (one copy each; a routed lane query copies
        only that lane), un-permute and drop padding."""
        self.drain()
        d, p = ((self.dist, self.parent) if lane is None else
                ([t[lane] for t in self.dist], [t[lane] for t in self.parent]))
        dist, parent = self.ds.to_host(d), self.ds.to_host(p)
        if self.perm is not None:
            dist = dist[..., self.perm]
            pp = parent[..., self.perm]
            parent = np.where(pp >= 0, self.inv[np.clip(pp, 0, None)],
                              NO_PARENT).astype(np.int32)
        else:
            n = self.cfg.num_vertices
            dist, parent = dist[..., :n], parent[..., :n]
        return dist, parent

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self) -> dict[str, np.ndarray]:
        """The reference's schema: pool arrays in partition-major slot order
        (from the host mirrors) plus the padded dist / parent; drained
        first.  Layouts are rebuilt on restore, never serialized."""
        with self.obs.epoch("checkpoint"):
            self.drain()
            return {
                "src": np.concatenate([a.msrc for a in self.allocs]),
                "dst": np.concatenate([a.mdst for a in self.allocs]),
                "w": np.concatenate([a.mw for a in self.allocs]),
                "active": np.concatenate([a.mactive for a in self.allocs]),
                "dist": self.ds.to_host(self.dist),
                "parent": self.ds.to_host(self.parent),
                "source": np.asarray(self._source_pad),
                "cursor": np.asarray(0),
            }

    def restore(self, ckpt: dict[str, np.ndarray]) -> None:
        """Crash-restart from a ``checkpoint()`` of an engine (of either
        package) with the same config, partition count and relabeling:
        rebuilds the per-partition planners from the pool slices, copies
        the arrays to the partitions' devices and rebuilds the layouts."""
        src_ck = np.atleast_1d(np.asarray(ckpt["source"])).tolist()
        src_now = np.atleast_1d(np.asarray(self._source_pad)).tolist()
        if src_ck != src_now:
            raise ValueError(f"checkpoint source {src_ck} != {src_now}")
        if np.asarray(ckpt["dist"]).shape[-1] != self.P * self.npp:
            raise ValueError(
                f"checkpoint has {np.asarray(ckpt['dist']).shape[-1]} vertex "
                f"rows; this engine pads to {self.P * self.npp} — same P "
                f"required")
        if len(ckpt["src"]) != self.P * self.epp:
            raise ValueError(
                f"checkpoint has {len(ckpt['src'])} pool slots; this engine "
                f"expects {self.P * self.epp} — same edges_per_part "
                f"required")
        epp = self.epp
        alloc_cls = ingest.allocator_cls(self.cfg.alloc_impl)
        self.allocs = [
            alloc_cls.from_pool(
                epp, self.cfg.on_duplicate,
                *(np.asarray(ckpt[k])[p * epp:(p + 1) * epp]
                  for k in ("src", "dst", "w", "active")))
            for p in range(self.P)]
        # inactive slots keep the padding-row invariant of the local
        # segment ids (inactive_dst_layout)
        active = np.asarray(ckpt["active"], np.bool_)
        dst = np.where(active, ckpt["dst"],
                       inactive_dst_layout(self.P, self.npp, epp))
        self.pools = self.ds.put_edges(ckpt["src"], dst, ckpt["w"], active)
        self.dist = self.ds.shard(np.asarray(ckpt["dist"], np.float32))
        self.parent = self.ds.shard(np.asarray(ckpt["parent"], np.int32))
        self.bk.allocs = self.allocs
        self.bk.restore()
        # the restore's layout rebuild is a real rebuild event
        self.obs.note_layout(self.bk.layout_counters())
        # checkpoints are taken after a drain, so nothing was pending
        self._push = self._pull = self._zero_pend

    # ------------------------------------------------------------ diagnostics
    def partition_fill(self) -> np.ndarray:
        """Live edges per partition, from the host mirrors (no device read)."""
        return np.array([int(a.mactive.sum()) for a in self.allocs])
