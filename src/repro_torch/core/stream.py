"""Event-stream plumbing for the dynamic engine (torch rendering of
``repro.core.stream``, single-source, observability left out).

Everything that is *stream* logic rather than *epoch* logic lives here:

  * the driver loop (``ingest_log``) that coalesces the log into runs and
    dispatches ADD/DEL batches and QUERY markers;
  * the ``QueryResult`` record returned at every QUERY marker, with its
    wall-clock ``latency_s`` timed around the ``_snapshot`` readback;
  * the round/message counters: rounds are host integers (the eager wave
    loops already read each wave's condition back), messages accumulate in
    a device scalar read back only by ``n_messages`` / ``query()``;
  * the paper's §5.4 predecessor-stability metric.

Subclasses implement ``_ingest_adds`` / ``_ingest_dels`` / ``_snapshot``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core import events as ev


@dataclasses.dataclass
class QueryResult:
    dist: np.ndarray      # f32[N]
    parent: np.ndarray    # i32[N]
    latency_s: float      # wall-clock snapshot latency (timed in query())
    epoch_stats: dict[str, Any]
    source: int | None = None


class StreamEngineBase:
    """Host-side driver over device epochs; subclasses own the state."""

    def __init__(self, device: torch.device) -> None:
        self.n_epochs = 0
        self.n_adds = 0
        self.n_dels = 0
        self.n_rounds = 0
        self._dev_messages = torch.zeros((), dtype=torch.int64, device=device)
        self._last_parent: np.ndarray | None = None

    @property
    def n_messages(self) -> int:
        return int(self._dev_messages)

    def _stream_stats(self) -> dict[str, Any]:
        return {
            "epochs": self.n_epochs, "rounds": self.n_rounds,
            "messages": self.n_messages, "adds": self.n_adds,
            "dels": self.n_dels,
        }

    def _accumulate_relax(self, stats) -> None:
        """Fold one relaxation epoch's ``RelaxStats`` (no host sync)."""
        self.n_rounds += stats.rounds
        self._dev_messages += stats.messages

    def _accumulate_delete(self, dstats) -> None:
        """Fold one deletion epoch's ``DeleteStats``; ``affected`` counts as
        messages (the SetToInfinity deliveries), as in the reference."""
        self.n_rounds += dstats.invalidation_rounds + dstats.recompute_rounds
        self._dev_messages += dstats.recompute_messages + dstats.affected

    def _deletion_groups(self, batch: ev.EventBatch
                         ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Paper-faithful: one stop-the-world epoch PER deletion;
        ``batch_deletions=True`` coalesces the whole run into one epoch
        (union of affected subtrees)."""
        if self.cfg.batch_deletions:
            return [(batch.src, batch.dst)]
        return [(batch.src[i:i + 1], batch.dst[i:i + 1])
                for i in range(len(batch.src))]

    def _ingest_adds(self, batch: ev.EventBatch) -> None:
        raise NotImplementedError

    def _ingest_dels(self, batch: ev.EventBatch) -> None:
        raise NotImplementedError

    def _snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """Device->host readback of (dist, parent)."""
        raise NotImplementedError

    def query(self, source: int | None = None) -> QueryResult:
        """State collection (paper §3): every batch already ran to
        convergence, so the query cost is the device->host readback — timed
        here as the result latency.  ``source`` may name the engine's own
        source (or be None)."""
        if source is not None and int(source) != int(self.cfg.source):
            raise ValueError(f"source {source} is not served by this engine "
                             f"(source={self.cfg.source})")
        t0 = time.perf_counter()
        dist, parent = self._snapshot()
        dt = time.perf_counter() - t0
        return QueryResult(dist=dist, parent=parent, latency_s=dt,
                           epoch_stats=self._stream_stats(),
                           source=None if source is None else int(source))

    def ingest_log(self, log: "ev.EventLog | Iterable[ev.EventLog]",
                   on_query: Callable[[QueryResult], None] | None = None
                   ) -> list[QueryResult]:
        """Drive the engine over an event log (or an iterable of log chunks,
        ingested in order); returns the query results.  Any object with the
        ``EventLog.runs()`` interface is a log — the reference package's
        logs included."""
        chunks = [log] if hasattr(log, "runs") else log
        results: list[QueryResult] = []
        for chunk in chunks:
            for batch in chunk.runs():
                if batch.kind == ev.ADD:
                    self._ingest_adds(batch)
                elif batch.kind == ev.DEL:
                    self._ingest_dels(batch)
                else:
                    res = self.query()
                    results.append(res)
                    if on_query is not None:
                        on_query(res)
        return results

    def stability_vs_prev(self, parent: np.ndarray) -> float:
        """Paper §5.4: fraction of vertices whose predecessor is unchanged
        since the previous call (over vertices present in both results; the
        first call scores 1.0)."""
        prev, self._last_parent = self._last_parent, parent.copy()
        if prev is None or prev.shape != parent.shape:
            return 1.0
        both = (prev >= 0) & (parent >= 0)
        return float(np.mean(prev[both] == parent[both])) if both.any() else 1.0
