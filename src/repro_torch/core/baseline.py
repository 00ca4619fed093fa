"""Baselines from the paper's evaluation (torch rendering of
``repro.core.baseline``).

* ``ReMoBaseline`` (paper §5.2): keeps only the topology as the stream
  arrives; on every query it *cold-starts* the increment-only ReMo
  relaxation from scratch on the current snapshot ("temporarily pause
  ingestion, run ReMo SSSP on the current graph snapshot, collect results
  after convergence").

* ``BatchedBSPEngine`` (paper §5.6, GraphBolt's processing model): updates
  are applied in fixed-size batches and the solution is reconverged only
  at batch boundaries, from the previous snapshot's state — on this
  package's own engine, so the comparison isolates the processing model.

* ``StaticSolver`` (paper §5.2 / Table 2, the Galois analogue): a one-shot
  CSR-by-dst build ("conversion") + a static solve.

None of them runs a kernel: their waves are ``relax.relax_round``'s
segment-min over the COO pool, as in the reference.  Each takes
``device=`` (default "cuda"; tests pass "cpu"), and syncs the device
where the reference blocks on its arrays, so their timings cover the
device work.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core import ingest, relax
from repro_torch.core.engine import EngineConfig, SSSPDelEngine
from repro_torch.core.state import EdgePool, SSSPState
from repro_torch.core.stream import QueryResult

__all__ = ["BatchedBSPEngine", "ReMoBaseline", "StaticSolveReport",
           "StaticSolver"]


def _device(device: str) -> torch.device:
    """The baselines' device: CUDA or CPU, CUDA only when available (no
    silent fallback)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be CUDA or CPU; got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r}: CUDA is not available; pass "
                           f"device='cpu' to run on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _from_scratch(num_vertices: int, source: int, edges: EdgePool,
                  dev: torch.device, tie_perm: torch.Tensor | None = None):
    """ReMo from a cold start: the source's frontier relaxed to fixpoint
    over ``edges``; returns (dist, parent) on the host and the stats."""
    sssp = SSSPState.init(num_vertices, source, dev)
    frontier = relax.frontier_from_vertices(
        torch.tensor([source], dtype=torch.int32, device=dev), num_vertices)
    sssp, stats = relax.relax_until_converged(
        sssp, edges, frontier, num_vertices=num_vertices, tie_perm=tie_perm)
    return sssp.dist.cpu().numpy(), sssp.parent.cpu().numpy(), stats


class ReMoBaseline:
    """Topology-only ingestion; ReMo-from-scratch on every query.

    ``randomize_ties=True`` draws a fresh tie-break permutation per query
    (``np.random.default_rng(seed)``, the reference's draws) — the BSP
    stand-in for the async runtime's run-to-run arbitrariness among equally
    valid shortest-path trees (the paper's Fig. 4 stability comparison).
    Distances are unaffected; only the parent among equal-cost
    predecessors varies.
    """

    def __init__(self, num_vertices: int, edge_capacity: int, source: int,
                 randomize_ties: bool = False, seed: int = 0,
                 device: str = "cuda"):
        self.device = _device(device)
        self.num_vertices = num_vertices
        self.source = source
        self.alloc = ingest.SlotAllocator(edge_capacity)
        self.edges = EdgePool.empty(edge_capacity, self.device)
        self._last_parent: np.ndarray | None = None
        self.randomize_ties = randomize_ties
        self._rng = np.random.default_rng(seed)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def ingest_log(self, log: ev.EventLog) -> list[QueryResult]:
        results = []
        for batch in log.runs():
            if batch.kind == ev.ADD:
                plan = self.alloc.plan_adds(batch.src, batch.dst, batch.w)
                if len(plan.slots):
                    ingest.apply_adds(self.edges, *map(self._dev, (
                        plan.slots, plan.src, plan.dst, plan.w)))
            elif batch.kind == ev.DEL:
                slots, _, _ = self.alloc.plan_dels(batch.src, batch.dst)
                if len(slots):
                    ingest.apply_dels(self.edges, self._dev(slots))
            else:
                results.append(self.query())
        return results

    def query(self) -> QueryResult:
        t0 = time.perf_counter()
        tie_perm = None
        if self.randomize_ties:
            tie_perm = self._dev(
                self._rng.permutation(self.num_vertices).astype(np.int32))
        dist, parent, stats = _from_scratch(
            self.num_vertices, self.source, self.edges, self.device,
            tie_perm)
        dt = time.perf_counter() - t0
        return QueryResult(dist=dist, parent=parent, latency_s=dt,
                           epoch_stats={"rounds": int(stats.rounds),
                                        "messages": int(stats.messages)})

    def stability_vs_prev(self, parent: np.ndarray) -> float:
        """Paper §5.4: the fraction of vertices whose predecessor is
        unchanged since the previous call (over vertices with one in
        both)."""
        if self._last_parent is None:
            self._last_parent = parent.copy()
            return 1.0
        prev = self._last_parent
        both = (prev >= 0) & (parent >= 0)
        frac = float(np.mean(prev[both] == parent[both])) if both.any() \
            else 1.0
        self._last_parent = parent.copy()
        return frac


class BatchedBSPEngine:
    """GraphBolt-style batch processing model on this package's engine
    (paper §5.6).

    Events accumulate on the host; at each batch boundary the whole batch
    is applied and the tree reconverged from the *previous* snapshot's
    state (incremental like GraphBolt, but only at batch granularity).
    Deletions force the same invalidate + recompute as the main engine,
    only at the boundary — queries between boundaries must wait (the
    latency the paper's Figure 6 measures).
    """

    def __init__(self, num_vertices: int, edge_capacity: int, source: int,
                 batch_size: int, device: str = "cuda"):
        self.inner = SSSPDelEngine(EngineConfig(
            num_vertices=num_vertices, edge_capacity=edge_capacity,
            source=source, batch_deletions=True, device=device))
        self.batch_size = batch_size
        self._pending: list[ev.EventLog] = []
        self._pending_n = 0

    def push(self, log: ev.EventLog) -> None:
        self._pending.append(log)
        self._pending_n += len(log)

    def _flush(self) -> float:
        merged = ev.EventLog.concatenate(self._pending)
        self._pending, self._pending_n = [], 0
        t0 = time.perf_counter()
        self.inner.ingest_log(merged)
        _sync(self.inner.device)
        return time.perf_counter() - t0

    def maybe_flush(self) -> float | None:
        """If a full batch accumulated, apply + reconverge; returns the
        latency (seconds)."""
        if self._pending_n < self.batch_size:
            return None
        return self._flush()

    def force_flush(self) -> float:
        return self._flush() if self._pending else 0.0


@dataclasses.dataclass
class StaticSolveReport:
    convert_s: float   # event log -> CSR ("Conv" column of Table 2)
    solve_s: float     # static SSSP solve ("SP" column)
    dist: np.ndarray
    parent: np.ndarray


class StaticSolver:
    """Static CSR Bellman-Ford / frontier solver — the Galois analogue.

    ``convert``: a one-shot CSR-by-dst build from the final event log (the
    cost Table 2 charges to Galois's event-log -> CSR conversion), frozen
    on the device.  ``solve``: frontier-masked relaxation to fixpoint on
    the static arrays.
    """

    def __init__(self, num_vertices: int, device: str = "cuda"):
        self.device = _device(device)
        self.num_vertices = num_vertices
        self.edges: EdgePool | None = None

    def convert(self, log: ev.EventLog) -> float:
        t0 = time.perf_counter()
        # apply adds / dels in order on the host, then freeze to the device
        alive: dict[tuple[int, int], float] = {}
        for k, u, v, w in zip(log.kind.tolist(), log.src.tolist(),
                              log.dst.tolist(), log.w.tolist()):
            if k == ev.ADD:
                alive.setdefault((u, v), w)
            elif k == ev.DEL:
                alive.pop((u, v), None)
        n = len(alive)
        src = np.fromiter((k[0] for k in alive), np.int32, n)
        dst = np.fromiter((k[1] for k in alive), np.int32, n)
        w = np.fromiter(alive.values(), np.float32, n)
        order = np.argsort(dst, kind="stable")   # CSR-by-dst layout
        dev = self.device
        self.edges = EdgePool(
            src=torch.as_tensor(src[order]).to(dev),
            dst=torch.as_tensor(dst[order]).to(dev),
            w=torch.as_tensor(w[order]).to(dev),
            active=torch.ones(n, dtype=torch.bool, device=dev))
        _sync(dev)
        return time.perf_counter() - t0

    def solve(self, source: int) -> StaticSolveReport:
        if self.edges is None:
            raise RuntimeError("StaticSolver.solve: convert() first")
        t0 = time.perf_counter()
        dist, parent, _ = _from_scratch(self.num_vertices, source,
                                        self.edges, self.device)
        dt = time.perf_counter() - t0
        return StaticSolveReport(convert_s=0.0, solve_s=dt, dist=dist,
                                 parent=parent)
