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
    K3.
The three kernel switches default to None: the kernel iff the device is
CUDA, the plain torch version on the CPU (the reference's defaults there).
An explicit True or False holds on either device; a kernel switch on a CPU
engine still takes the plain version, since the wrappers launch only for
CUDA tensors.
``device`` defaults to "cuda" and raises when CUDA is unavailable — there
is no silent CPU fallback; tests pass ``device="cpu"``.  Options of the
reference that later slices port (multi-source ``sources``, the bucketed
schedule, observability) raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backends as bk_mod
from repro_torch.core import delete as del_mod
from repro_torch.core import events as ev
from repro_torch.core import frontier as frontier_mod
from repro_torch.core import ingest, relax
from repro_torch.core.state import EdgePool, GraphState, SSSPState
from repro_torch.core.stream import QueryResult, StreamEngineBase

__all__ = ["EngineConfig", "QueryResult", "SSSPDelEngine"]


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
    wave_schedule: str = "rounds"
    frontier_mode: str = "dense"
    frontier_cap: int = 0           # top ladder rung; 0 = derive (~N/64)
    frontier_kernel: bool | None = None  # None = K3 iff device is CUDA
    sources: tuple[int, ...] | None = None
    observability: bool = False
    alloc_impl: str = "columnar"
    device: str = "cuda"

    def __post_init__(self):
        bk_mod.validate_backend_config(self)
        ingest.allocator_cls(self.alloc_impl)  # raises on unknown impl
        for knob, off in (("sources", None), ("observability", False)):
            if getattr(self, knob) != off:
                raise ValueError(f"{knob}={getattr(self, knob)!r} is not yet "
                                 f"ported to repro_torch")
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
        super().__init__(self.device)
        self.cfg = cfg
        self.alloc = ingest.make_allocator(cfg.edge_capacity,
                                           cfg.on_duplicate, cfg.alloc_impl)
        self.state = GraphState.init(cfg.num_vertices, cfg.edge_capacity,
                                     cfg.source, self.device)
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
        plan = self.alloc.plan_adds(batch.src, batch.dst, batch.w)
        if len(plan.slots) == 0:
            return
        ingest.apply_adds(self.state.edges, *map(self._dev, ingest.pad_pow2(
            plan.slots, plan.src, plan.dst, plan.w)))
        # Frontier = tails of the inserted edges (paper Listing 3: the tail
        # offers its distance to the head).
        frontier = relax.frontier_from_vertices(self._dev(plan.src),
                                                self.cfg.num_vertices)
        self.backend.apply_adds(plan, self.alloc)
        if self._sparse:
            self._out.apply_adds(plan, self.alloc)
        if self._auto and self.backend.blowup:
            self._fallback_to_sliced()
        if self._route_sparse(len(np.unique(plan.src))):
            self.state.sssp, stats = frontier_mod.sparse_relax_until_converged(
                self.state.sssp, self.state.edges, self._out.state, frontier,
                num_vertices=self.cfg.num_vertices, caps=self._caps,
                use_kernel=self._frontier_kernel)
        else:
            self.state.sssp, stats = self.backend.relax(
                self.state.sssp, self.state.edges, frontier)
        self._accumulate_relax(stats)
        self.n_adds += len(plan.slots)
        self.n_epochs += 1

    # ------------------------------------------------------------------ dels
    def _ingest_dels(self, batch: ev.EventBatch) -> None:
        for gsrc, gdst in self._deletion_groups(batch):
            slots, psrc, pdst = self.alloc.plan_dels(gsrc, gdst)
            if len(slots) == 0:
                continue
            slots_p, psrc_p, pdst_p = ingest.pad_pow2(slots, psrc, pdst)
            if self._sparse:
                self._out.apply_dels(psrc_p, pdst_p)
            # Seed from the *pre-deletion* tree, then deactivate.
            seed = del_mod.deletion_seed_for_edges(
                self.state.sssp, self._dev(psrc_p), self._dev(pdst_p),
                self.cfg.num_vertices)
            ingest.apply_dels(self.state.edges, self._dev(slots_p))
            self.backend.apply_dels(pdst_p, psrc_p)
            # the affected region's size is device-only knowledge, so only
            # "sparse" routes deletions sparse; "auto" keeps them dense
            if self.cfg.frontier_mode == "sparse":
                self.state.sssp, dstats = \
                    frontier_mod.sparse_invalidate_and_recompute(
                        self.state.sssp, self.state.edges, self._out.state,
                        seed, num_vertices=self.cfg.num_vertices,
                        caps=self._caps, use_doubling=self.cfg.use_doubling,
                        use_kernel=self._frontier_kernel)
            else:
                self.state.sssp, dstats = self.backend.delete(
                    self.state.sssp, self.state.edges, seed)
            self._accumulate_delete(dstats)
            self.n_dels += len(slots)
            self.n_epochs += 1

    # ----------------------------------------------------------------- query
    def _snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        s = self.state.sssp
        return _host(s.dist), _host(s.parent)

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self) -> dict[str, np.ndarray]:
        """O(N+E) snapshot with the reference engine's keys and dtypes, so
        either package restores the other's.  Backend layout state is NOT
        serialized — it is a derived view, rebuilt from the pool."""
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
