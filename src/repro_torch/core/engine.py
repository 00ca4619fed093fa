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
the paper's flood), ``relax_backend`` ("segment" or "ellpack"),
``on_duplicate``, ``alloc_impl``.  ``device`` defaults to "cuda" and raises
when CUDA is unavailable — there is no silent CPU fallback; tests pass
``device="cpu"``.  ``ell_use_kernel=None`` runs kernel K1 iff the device
is CUDA.  Options of the reference that later slices port (multi-source
``sources``, the bucketed schedule, sparse frontiers, the sliced and auto
backends, observability) raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backends as bk_mod
from repro_torch.core import delete as del_mod
from repro_torch.core import events as ev
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
    wave_schedule: str = "rounds"
    frontier_mode: str = "dense"
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
        use_kernel = (self.device.type == "cuda" if cfg.ell_use_kernel is None
                      else cfg.ell_use_kernel)
        self.backend = bk_mod.make_backend(cfg.relax_backend, cfg,
                                           use_kernel=use_kernel,
                                           device=self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

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
            # Seed from the *pre-deletion* tree, then deactivate.
            seed = del_mod.deletion_seed_for_edges(
                self.state.sssp, self._dev(psrc_p), self._dev(pdst_p),
                self.cfg.num_vertices)
            ingest.apply_dels(self.state.edges, self._dev(slots_p))
            self.backend.apply_dels(pdst_p, psrc_p)
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
