"""SSSPDelEngine — the paper's runtime loop (paper §4.1) as a host
orchestrator over device epochs; torch rendering of ``repro.core.engine``.

Behaviour (as the reference):
  * runs of consecutive ADD events are ingested as one batch and drained by
    monotone relaxation;
  * every DEL event triggers the stop-the-world sequence: apply the single
    deletion, invalidation + recomputation, converge
    (``batch_deletions=True`` coalesces a run of DELs into one epoch);
  * QUERY markers snapshot (dist, parent).

Switches: ``use_doubling`` (pointer-doubling invalidation, default; False =
the paper's flood), ``on_duplicate``, ``alloc_impl``, and
  * ``relax_backend`` — "segment", "ellpack" (dense ELL), "sliced" (hub-aware
    hybrid: per-slice-width ELL + overflow COO lane) or "auto" (dense ELL
    that swaps to sliced when a rebuild reports hub blowup);
    ``ell_use_kernel`` runs the ELL waves in kernel K1 and
    ``sliced_fused`` every sliced wave in kernel K2;
  * ``frontier_mode`` — "dense", "sparse" (every push epoch through the
    compacted worklist and the capacity ladder, core/frontier.py) or "auto"
    (ADD epochs sparse when the host-known frontier fits the top rung;
    deletions stay dense); ``frontier_kernel`` runs those waves in kernel
    K3;
  * ``wave_schedule`` — "rounds" settles every epoch to fixpoint;
    "buckets" (core/buckets.py) defers convergence into a pending set that
    ``drain()`` settles bucket by bucket at query / checkpoint time, with
    ``bucket_width`` a float, ``inf`` (one bucket) or "auto" (a
    pow2-quantized median of the live weights);
  * ``sources=(s0, s1, ...)`` — batched multi-source serving: stacked
    ``[S, N]`` trees, one per source, over ONE shared layout; every epoch
    runs on the whole stack (K1 and K2 serve all S lanes in one launch per
    wave) and each lane is bit-identical to a single-source engine of its
    source (``source`` is ignored when ``sources`` is set).
The three kernel switches default to None: the kernel iff the device is
CUDA, the plain torch version on the CPU (the reference's defaults there).
An explicit True or False holds on either device; a kernel switch on a CPU
engine still takes the plain version, since the wrappers launch only for
CUDA tensors.
``observability=True`` turns on the telemetry layer (``repro_torch.obs``,
DESIGN.md §10): a span and a flight-recorder record per dispatched epoch
(``obs_flight_capacity`` records kept), counters, histograms and an
optional stall watchdog (``obs_watchdog``), read out by
``metrics_snapshot()``.  It changes no route and no result, and adds no
host read to ingest or drains.
``device`` defaults to "cuda" and raises when CUDA is unavailable — there
is no silent CPU fallback; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backends as bk_mod
from repro_torch.core import buckets
from repro_torch.core import delete as del_mod
from repro_torch.core import events as ev
from repro_torch.core import frontier as frontier_mod
from repro_torch.core import ingest, relax
from repro_torch.core.backends import RELAX_BACKENDS
from repro_torch.core.state import EdgePool, GraphState, SSSPState
from repro_torch.core.stream import QueryResult, StreamEngineBase
from repro_torch.obs import WatchdogConfig

__all__ = ["EngineConfig", "QueryResult", "SSSPDelEngine", "RELAX_BACKENDS"]


@dataclasses.dataclass
class EngineConfig:
    num_vertices: int
    edge_capacity: int
    source: int
    use_doubling: bool = True
    batch_deletions: bool = False
    on_duplicate: str = "ignore"
    relax_backend: str = "segment"
    ell_block_rows: int = 256   # ELL row padding (rebuilds pad to this)
    ell_init_k: int = 8         # initial ELL width; doubles on overflow
    ell_use_kernel: bool | None = None  # None = kernel K1 iff device is CUDA
    # "sliced" backend knobs
    sliced_slice_rows: int = 256  # rows per degree slice (per-slice K)
    sliced_hub_k: int = 32        # hub threshold: rows past it spill to COO
    sliced_init_k: int = 2        # initial per-slice width; doubles at rebuild
    sliced_fused: bool | None = None  # None = kernel K2 iff device is CUDA
    wave_schedule: str = "rounds"   # or "buckets" (core/buckets.py)
    # delta; inf = one bucket (plain converge); "auto" = a pow2-quantized
    # median of the live pool weights, resolved at drain time
    bucket_width: float | str = 1.0
    frontier_mode: str = "dense"
    frontier_cap: int = 0           # top ladder rung; 0 = derive (~N/64)
    frontier_kernel: bool | None = None  # None = K3 iff device is CUDA
    sources: tuple[int, ...] | None = None   # None = single-source
    # telemetry (repro_torch.obs): counters, spans, histograms, flight
    # recorder; a WatchdogConfig arms the stall watchdog (only with
    # observability=True)
    observability: bool = False
    obs_flight_capacity: int = 128
    obs_watchdog: WatchdogConfig | None = None
    alloc_impl: str = "columnar"
    device: str = "cuda"

    def __post_init__(self):
        bk_mod.validate_backend_config(self)
        ingest.allocator_cls(self.alloc_impl)  # raises on unknown impl
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
            raise ValueError(f"device must be CUDA or CPU; got {self.device!r}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "EngineConfig(device='cuda'): CUDA is not available; pass "
                "device='cpu' to run the plain torch path on the CPU")


def resolve_kernel(flag: bool | None, device: torch.device) -> bool:
    """A kernel switch as the engine runs it: None = the kernel iff
    ``device`` is CUDA; True or False as given."""
    return device.type == "cuda" if flag is None else flag


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place device updates cannot alias."""
    return t.detach().to("cpu", copy=True).numpy()


class SSSPDelEngine(StreamEngineBase):
    """Host orchestrator; layout-specific work lives behind ``self.backend``."""

    def __init__(self, cfg: EngineConfig):
        self.device = torch.device(cfg.device)
        super().__init__(self.device, cfg.sources,
                         observability=cfg.observability,
                         flight_capacity=cfg.obs_flight_capacity,
                         watchdog=cfg.obs_watchdog)
        self.cfg = cfg
        self.alloc = ingest.make_allocator(cfg.edge_capacity,
                                           cfg.on_duplicate, cfg.alloc_impl)
        self.state = GraphState.init(cfg.num_vertices, cfg.edge_capacity,
                                     cfg.source, self.device)
        if self.sources is not None:
            # stacked [S, N] trees over the single shared edge pool
            self.state.sssp = SSSPState.init_batched(
                cfg.num_vertices, self.sources, self.device)
        # the kernel switches, resolved once; cfg keeps what the caller set,
        # so validate_backend_config still sees an unset knob as unset
        self._use_kernel = resolve_kernel(cfg.ell_use_kernel, self.device)
        self._use_fused = resolve_kernel(cfg.sliced_fused, self.device)
        self._frontier_kernel = resolve_kernel(cfg.frontier_kernel,
                                               self.device)
        # "auto" starts on the dense ELL layout and falls back to sliced when
        # a rebuild reports hub blowup (backends/base.py ELL_BLOWUP_RATIO)
        self._auto = cfg.relax_backend == bk_mod.AUTO_BACKEND
        self.backend_name = "ellpack" if self._auto else cfg.relax_backend
        self.backend = self._make_backend(
            **({"defer_blowup": True} if self._auto else {}))
        # frontier-compacted sparse path: OUT-adjacency sidecar + capacity
        # ladder, maintained whenever the mode can route sparse
        self._sparse = cfg.frontier_mode != "dense"
        if self._sparse:
            self._out = frontier_mod.OutAdjacency(cfg.num_vertices,
                                                  self.device)
            self._caps = frontier_mod.capacity_ladder(cfg.num_vertices,
                                                      cfg.frontier_cap)
        self.bucketed = cfg.wave_schedule == "buckets"
        self._pend = self._empty_pending()
        # host-side upper bound on pending-push occupancy (the "auto" drain
        # routing signal; reset per drain, pinned to N by a deletion, whose
        # affected set is unknown host-side)
        self._pend_bound = 0
        # bucket_width="auto" resolution cache: (resolved width, live-edge
        # estimate at resolution) — re-resolved when the pool doubles/halves
        self._bw_cache: tuple[float, int] | None = None

    def _empty_pending(self) -> buckets.PendingState:
        return buckets.empty_pending(
            self.cfg.num_vertices,
            None if self.sources is None else len(self.sources), self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _make_backend(self, **options) -> bk_mod.RelaxBackend:
        """Backend ``self.backend_name`` with the resolved kernel switches
        (``use_fused`` is the sliced layout's own)."""
        if self.backend_name == "sliced":
            options["use_fused"] = self._use_fused
        return bk_mod.make_backend(self.backend_name, self.cfg,
                                   use_kernel=self._use_kernel,
                                   device=self.device, **options)

    def _route_sparse(self, occupancy_bound: int) -> bool:
        """Host-only routing: "sparse" always takes the compacted path (the
        ladder's dense rung bounds blowup); "auto" takes it only when the
        host-known occupancy bound fits the top rung."""
        if not self._sparse:
            return False
        if self.cfg.frontier_mode == "sparse":
            return True
        return occupancy_bound <= self._caps[-1]

    def _fold_occupancy(self, occ) -> None:
        """Fold a sparse epoch's summed per-wave occupancy (a host int, or
        per lane) into the ``frontier_occupancy`` counter."""
        if self.obs.enabled:
            self.obs.counters.inc("frontier_occupancy", int(np.sum(occ)))

    def _bucket_width(self) -> float:
        """Resolve ``bucket_width="auto"`` host-side, as the reference does:
        the pow2-quantized median of the live pool weights, re-resolved only
        when the live-edge estimate doubles or halves."""
        if self.cfg.bucket_width != "auto":
            return self.cfg.bucket_width
        live_est = max(1, self.n_adds - self.n_dels)
        if self._bw_cache is not None:
            width, at = self._bw_cache
            if at / 2 <= live_est <= at * 2:
                return width
        w = self.alloc.active_coo()[2]
        if len(w) == 0:
            width = 1.0
        else:
            med = max(float(np.percentile(w, 50.0)), 1e-6)
            width = float(2.0 ** np.round(np.log2(med)))
        self._bw_cache = (width, live_est)
        return width

    def _fallback_to_sliced(self) -> None:
        """relax_backend="auto": the dense-ELL rebuild just reported hub
        blowup — swap to the sliced layout, rebuilt from the pool mirror
        exactly as a restore would."""
        self._auto = False
        self.backend_name = "sliced"
        self.backend = self._make_backend()
        self.backend.restore(self.alloc)

    # ------------------------------------------------------------------ adds
    def _ingest_adds(self, batch: ev.EventBatch) -> None:
        with self.obs.phase("plan_adds"):
            plan = self.alloc.plan_adds(batch.src, batch.dst, batch.w)
        if len(plan.slots) == 0:
            return
        with self.obs.epoch("add_epoch", events=len(plan.slots)):
            self._add_epoch(plan)

    def _add_epoch(self, plan: ingest.PlannedAdds) -> None:
        """One dispatched ADD epoch (one span, one flight record)."""
        with self.obs.phase("apply_adds"):
            ingest.apply_adds(self.state.edges, *map(
                self._dev, ingest.pad_pow2(plan.slots, plan.src, plan.dst,
                                           plan.w)))
            # Frontier = tails of the inserted edges (paper Listing 3: the
            # tail offers its distance to the head).
            frontier = relax.frontier_from_vertices(self._dev(plan.src),
                                                    self.cfg.num_vertices)
            self.backend.apply_adds(plan, self.alloc)
            if self._sparse:
                self._out.apply_adds(plan, self.alloc)
            if self._auto and self.backend.blowup:
                self._fallback_to_sliced()
        self.obs.note_layout(self.backend.layout_counters())
        tails = len(np.unique(plan.src))
        if self.obs.enabled:
            # the frontier = distinct inserted tails, known to the host plan
            # already: one occupancy-histogram sample per ADD epoch
            self.obs.counters.inc("frontier", tails)
            self.obs.hist_host("hist_frontier_occupancy", tails)
            if self.obs.watchdog is not None:
                self.obs.watchdog.observe("add_epoch", 0.0,
                                          {"frontier": tails})
        if self.bucketed:
            # deferred settle: record the push obligation and return — the
            # drain delivers the offers bucket by bucket
            self._pend = buckets.enqueue_push(self._pend, frontier,
                                              self.state.sssp.dist)
            self._pend_bound += tails
        else:
            if self._route_sparse(tails):
                sparse = frontier_mod.sparse_relax_until_converged
                self.state.sssp, stats, occ = sparse(
                    self.state.sssp, self.state.edges, self._out.state,
                    frontier, num_vertices=self.cfg.num_vertices,
                    caps=self._caps, use_kernel=self._frontier_kernel)
                self._fold_occupancy(occ)
            else:
                relax_fn = (self.backend.relax if self.sources is None
                            else self.backend.relax_batched)
                self.state.sssp, stats = relax_fn(
                    self.state.sssp, self.state.edges, frontier)
            self._accumulate_relax(stats)
        self.n_adds += len(plan.slots)
        self.n_epochs += 1

    # ------------------------------------------------------------------ dels
    def _ingest_dels(self, batch: ev.EventBatch) -> None:
        for gsrc, gdst in self._deletion_groups(batch):
            with self.obs.phase("plan_dels"):
                slots, psrc, pdst = self.alloc.plan_dels(gsrc, gdst)
            if len(slots) == 0:
                continue
            with self.obs.epoch("del_epoch", events=len(slots)):
                slots_p, psrc_p, pdst_p = ingest.pad_pow2(slots, psrc, pdst)
                if self._sparse:
                    with self.obs.phase("apply_dels"):
                        self._out.apply_dels(psrc_p, pdst_p)
                if self.bucketed:
                    self._lazy_del(slots_p, psrc_p, pdst_p)
                else:
                    self._eager_del(slots_p, psrc_p, pdst_p)
                self.n_dels += len(slots)
                self.n_epochs += 1

    def _lazy_del(self, slots_p: np.ndarray, psrc_p: np.ndarray,
                  pdst_p: np.ndarray) -> None:
        """Bucketed deletion: deactivate + seed + mark + invalidate, the
        recomputation deferred to the drain: ``buckets.lazy_delete``'s two
        steps, its deactivation under the ``apply_dels`` phase."""
        with self.obs.phase("apply_dels"):
            self.backend.apply_dels(pdst_p, psrc_p)
            ingest.apply_dels(self.state.edges, self._dev(slots_p))
        # the affected subtree's size is device-only knowledge; pin the
        # pending bound to N so the "auto" drain routes dense
        self._pend_bound = self.cfg.num_vertices
        self.state.sssp, self._pend, dstats = buckets.lazy_invalidate(
            self.state.sssp, self._pend, self._dev(psrc_p),
            self._dev(pdst_p), num_vertices=self.cfg.num_vertices,
            use_doubling=self.cfg.use_doubling)
        self._accumulate_delete(dstats)

    def _eager_del(self, slots_p: np.ndarray, psrc_p: np.ndarray,
                   pdst_p: np.ndarray) -> None:
        """Rounds deletion: seed from the *pre-deletion* tree (per lane on a
        batched engine), deactivate, invalidate and recompute."""
        with self.obs.phase("apply_dels"):
            seed = del_mod.deletion_seed_for_edges(
                self.state.sssp, self._dev(psrc_p), self._dev(pdst_p),
                self.cfg.num_vertices)
            ingest.apply_dels(self.state.edges, self._dev(slots_p))
            self.backend.apply_dels(pdst_p, psrc_p)
        # the affected region's size is device-only knowledge, so only
        # "sparse" routes deletions sparse; "auto" keeps them dense
        if self.cfg.frontier_mode == "sparse":
            sparse = frontier_mod.sparse_invalidate_and_recompute
            self.state.sssp, dstats, occ = sparse(
                self.state.sssp, self.state.edges, self._out.state, seed,
                num_vertices=self.cfg.num_vertices, caps=self._caps,
                use_doubling=self.cfg.use_doubling,
                use_kernel=self._frontier_kernel)
            self._fold_occupancy(occ)
        else:
            delete_fn = (self.backend.delete if self.sources is None
                         else self.backend.delete_batched)
            self.state.sssp, dstats = delete_fn(
                self.state.sssp, self.state.edges, seed)
        self._accumulate_delete(dstats)

    # ----------------------------------------------------------------- query
    def drain(self) -> None:
        """Settle the bucketed schedule's pending work (no-op under the
        rounds schedule; with nothing pending it costs the pull check and
        one loop check).  Public so callers can force a converged tree
        without a query's readback."""
        if not self.bucketed:
            return
        if self.obs.enabled:
            # pending occupancy at drain entry: device sums the registry
            # folds lazily ([S] per lane on a batched engine)
            occ_push, occ_pull = buckets.pending_occupancy(self._pend)
            occ_dim = None if self.sources is None else "lane"
            self.obs.counters.add("pending_push", occ_push, dim=occ_dim)
            self.obs.counters.add("pending_pull", occ_pull, dim=occ_dim)
        with self.obs.epoch("drain"):
            bw = self._bucket_width()
            if self._route_sparse(self._pend_bound):
                sssp, self._pend, stats, occ = frontier_mod.sparse_drain(
                    self.state.sssp, self.state.edges, self._out.state,
                    self._pend, num_vertices=self.cfg.num_vertices,
                    caps=self._caps, bucket_width=bw,
                    use_kernel=self._frontier_kernel)
                self._fold_occupancy(occ)
            else:
                drain_fn = (self.backend.drain if self.sources is None
                            else self.backend.drain_batched)
                sssp, self._pend, stats = drain_fn(
                    self.state.sssp, self.state.edges, self._pend,
                    bucket_width=bw)
            self._pend_bound = 0
            self.state.sssp = sssp
            self._accumulate_relax(stats)
            if self.obs.enabled:
                # the waves this drain spent (host rounds)
                self.obs.counters.inc("drain_waves", stats.rounds)

    def _snapshot(self, lane: int | None) -> tuple[np.ndarray, np.ndarray]:
        """Drain, then read back; a routed lane query transfers only that
        source's [N] pair."""
        self.drain()
        s = self.state.sssp
        if lane is None:
            return _host(s.dist), _host(s.parent)
        return _host(s.dist[lane]), _host(s.parent[lane])

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self) -> dict[str, np.ndarray]:
        """O(N+E) snapshot with the reference engine's keys and dtypes, so
        either package restores the other's (a batched engine's holds [S, N]
        dist/parent and an [S] source).  It drains first: a checkpoint
        captures a converged tree.  Backend layout state is NOT serialized —
        it is a derived view, rebuilt from the pool."""
        with self.obs.epoch("checkpoint"):
            self.drain()
            e, s = self.state.edges, self.state.sssp
            return {
                "src": _host(e.src), "dst": _host(e.dst), "w": _host(e.w),
                "active": _host(e.active), "dist": _host(s.dist),
                "parent": _host(s.parent), "source": _host(s.source),
                "cursor": _host(self.state.cursor),
            }

    def restore(self, ckpt: dict[str, np.ndarray]) -> None:
        """Load a checkpoint (this engine's or the reference engine's): the
        arrays are copied to the device, then the host planner state (slot
        map + mirror) and the backend layout are rebuilt from the pool."""
        def dev(key):
            return torch.tensor(np.asarray(ckpt[key]), device=self.device)

        self.state = GraphState(
            edges=EdgePool(dev("src"), dev("dst"), dev("w"), dev("active")),
            sssp=SSSPState(dev("dist"), dev("parent"), dev("source")),
            cursor=dev("cursor"),
        )
        self.alloc = ingest.allocator_cls(self.cfg.alloc_impl).from_pool(
            self.cfg.edge_capacity, self.cfg.on_duplicate,
            ckpt["src"], ckpt["dst"], ckpt["w"], ckpt["active"])
        self.backend.restore(self.alloc)
        if self._sparse:
            self._out.restore(self.alloc)
        # the restore's layout rebuild is a real rebuild event
        self.obs.note_layout(self.backend.layout_counters())
        # checkpoints are taken after a drain, so nothing was pending
        self._pend = self._empty_pending()
        self._pend_bound = 0
