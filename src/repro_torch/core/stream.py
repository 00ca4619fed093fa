"""Event-stream plumbing for the dynamic engine (torch rendering of
``repro.core.stream``).

Everything that is *stream* logic rather than *epoch* logic lives here:

  * the driver loop (``ingest_log``) that coalesces the log into runs and
    dispatches ADD/DEL batches and QUERY markers;
  * the ``QueryResult`` record returned at every QUERY marker, with its
    wall-clock ``latency_s`` timed around the ``_snapshot`` readback;
  * multi-source lane routing: an engine built with ``sources=(s0, s1,
    ...)`` keeps stacked ``[S, N]`` trees; ``query(source=s)`` reads back
    ONE lane, ``query()`` the whole stack, and QUERY markers carry their
    requested source;
  * the round/message counters: rounds are host integers (the eager wave
    loops already read each wave's condition back), messages accumulate in
    a device scalar read back only by ``n_messages`` / ``query()``; on a
    batched engine both are per-lane ``[S]`` vectors;
  * the paper's §5.4 predecessor-stability metric, scoped per source;
  * the observability hooks (DESIGN.md §10, ``repro_torch.obs``): the
    waves- and messages-per-epoch histogram samples folded with the epoch
    stats, the ``query`` span with its latency histogram (and per-lane rows
    on a batched engine), ``metrics_snapshot()`` and
    ``dump_flight_recorder()``.  Rounds are host samples, messages device
    ones; both go through the same ``hist_*`` names.

Subclasses implement ``_ingest_adds`` / ``_ingest_dels`` / ``_snapshot``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.obs import EngineObs, WatchdogConfig
from repro_torch.obs import hist as hist_mod


@dataclasses.dataclass
class QueryResult:
    dist: np.ndarray      # f32[N] (lane or single-source) or f32[S, N]
    parent: np.ndarray    # i32 of the same shape
    latency_s: float      # wall-clock snapshot latency (timed in query())
    epoch_stats: dict[str, Any]
    source: int | None = None   # the lane's source for a routed query


class StreamEngineBase:
    """Host-side driver over device epochs; subclasses own the state."""

    def __init__(self, device: torch.device,
                 sources: tuple[int, ...] | None = None, *,
                 observability: bool = False, flight_capacity: int = 128,
                 watchdog: WatchdogConfig | None = None) -> None:
        # counter registry + span tracer + flight recorder + optional stall
        # watchdog; every hook no-ops when disabled
        self.obs = EngineObs(enabled=observability,
                             flight_capacity=flight_capacity,
                             watchdog=watchdog)
        # batched multi-source mode: ``sources`` is the tuple of maintained
        # sources (None = single-source); ``_lane_of`` routes a query's
        # source to its row of the stacked [S, N] state
        self.sources = tuple(int(s) for s in sources) if sources else None
        self._lane_of: dict[int, int] = {}
        lanes: tuple[int, ...] = ()
        if self.sources is not None:
            if len(set(self.sources)) != len(self.sources):
                raise ValueError(f"duplicate sources: {self.sources}")
            self._lane_of = {s: i for i, s in enumerate(self.sources)}
            lanes = (len(self.sources),)
        self.n_epochs = 0
        self.n_adds = 0
        self.n_dels = 0
        self._rounds = np.zeros(lanes, np.int64) if lanes else 0
        self._dev_messages = torch.zeros(lanes, dtype=torch.int64,
                                         device=device)
        # previous parent snapshot per stability scope (None = full state,
        # a source id = that routed lane)
        self._last_parent: dict[int | None, np.ndarray] = {}

    @property
    def n_rounds(self) -> int | np.ndarray:
        """BSP rounds so far — an int, or i64[S] per source when batched."""
        r = self._rounds
        return r if isinstance(r, int) else r.copy()

    @property
    def n_messages(self) -> int | np.ndarray:
        m = self._dev_messages
        # a copy: on the CPU, .numpy() would alias the live counter
        return int(m) if m.dim() == 0 else m.to("cpu", copy=True).numpy()

    def _stream_stats(self) -> dict[str, Any]:
        return {
            "epochs": self.n_epochs, "rounds": self.n_rounds,
            "messages": self.n_messages, "adds": self.n_adds,
            "dels": self.n_dels,
        }

    def _accumulate(self, rounds, messages: torch.Tensor) -> None:
        """Fold one epoch's rounds (host) and messages (device) — no host
        read; with obs on, one sample each for the waves- and
        messages-per-epoch histograms (§10.6), a list append."""
        self._rounds = self._rounds + rounds
        self._dev_messages += messages
        if self.obs.enabled:
            self.obs.hist_device("hist_waves_per_epoch", rounds)
            self.obs.hist_device("hist_messages_per_epoch", messages)

    def _accumulate_relax(self, stats) -> None:
        """Fold one relaxation epoch's ``RelaxStats``."""
        self._accumulate(stats.rounds, stats.messages)

    def _accumulate_delete(self, dstats) -> None:
        """Fold one deletion epoch's ``DeleteStats``; ``affected`` counts as
        messages (the SetToInfinity deliveries), as in the reference."""
        self._accumulate(dstats.invalidation_rounds + dstats.recompute_rounds,
                         dstats.recompute_messages + dstats.affected)

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

    def _snapshot(self, lane: int | None) -> tuple[np.ndarray, np.ndarray]:
        """Device->host readback of (dist, parent) — one lane of the
        stacked state when ``lane`` is given, everything otherwise."""
        raise NotImplementedError

    def _obs_pre_snapshot(self) -> None:
        """Engine-specific lazy folds just before the registry snapshot
        (``metrics_snapshot`` only) — the sharded engine's per-partition
        touched-vertex attribution: per readout, never per epoch."""

    def serves(self, source: int) -> bool:
        """Whether a routed ``query(source=...)`` would be answered from a
        dedicated lane/tree of this engine."""
        if self.sources is not None:
            return source in self._lane_of
        return int(source) == int(self.cfg.source)

    def route_of(self, query_source: int) -> int | None:
        """The stream-marker routing policy: a marker's source routes to
        its lane on a batched engine that serves it; everything else
        (``-1``, unserved sources, single-source engines) reads the full
        state."""
        if (query_source >= 0 and self.sources is not None
                and self.serves(query_source)):
            return query_source
        return None

    def lane_of(self, source: int) -> int:
        """Row of the stacked [S, N] state serving ``source``."""
        if self.sources is None:
            raise ValueError("lane_of() on a single-source engine; construct "
                             "with sources=(...) for batched serving")
        if source not in self._lane_of:
            raise ValueError(f"source {source} is not served by this engine "
                             f"(sources={self.sources})")
        return self._lane_of[source]

    def query(self, source: int | None = None) -> QueryResult:
        """State collection (paper §3): the device->host readback of a
        converged tree (a bucketed engine drains first) — timed here as the
        result latency.  ``source`` routes the query to one maintained tree
        of a batched engine (only that lane is read back); a single-source
        engine accepts its own source or None."""
        lane: int | None = None
        if source is not None:
            if self.sources is not None:
                lane = self.lane_of(int(source))
            elif int(source) != int(self.cfg.source):
                raise ValueError(
                    f"source {source} is not served by this engine "
                    f"(source={self.cfg.source})")
        t0 = time.perf_counter()
        # the query span nests the drain span a bucketed _snapshot opens
        with self.obs.epoch("query", lane=lane):
            dist, parent = self._snapshot(lane)
        dt = time.perf_counter() - t0
        if self.obs.enabled:
            # result-latency histogram in microseconds (§10.6): its sample
            # count equals the ``queries`` counter by construction
            us = dt * 1e6
            self.obs.hist_host("hist_latency_us", us)
            if lane is not None:
                # per-lane attribution (§10.5): a routed query tallies its
                # lane and folds the sample into an [S, B] per-lane row
                S = len(self.sources)
                one = np.zeros(S, np.int64)
                one[lane] = 1
                self.obs.counters.inc("queries_per_lane", one, dim="lane")
                row = np.zeros((S, hist_mod.NUM_BUCKETS), np.int64)
                row[lane, hist_mod.bucket_index_np(us)] = 1
                self.obs.counters.inc("hist_latency_us_per_lane", row,
                                      dim="lane")
        return QueryResult(dist=dist, parent=parent, latency_s=dt,
                           epoch_stats=self._stream_stats(),
                           source=None if source is None else int(source))

    def ingest_log(self, log: "ev.EventLog | Iterable[ev.EventLog]",
                   on_query: Callable[[QueryResult], None] | None = None
                   ) -> list[QueryResult]:
        """Drive the engine over an event log (or an iterable of log chunks,
        ingested in order); returns the query results.  Any object with the
        ``EventLog.runs()`` interface is a log — the reference package's
        logs included.  QUERY markers carrying a source are routed to that
        lane on a batched engine (``route_of``)."""
        chunks = [log] if hasattr(log, "runs") else log
        results: list[QueryResult] = []
        with self.obs.phase("ingest_log"):
            for chunk in chunks:
                for batch in chunk.runs():
                    if batch.kind == ev.ADD:
                        self._ingest_adds(batch)
                    elif batch.kind == ev.DEL:
                        self._ingest_dels(batch)
                    else:
                        res = self.query(
                            source=self.route_of(batch.query_source))
                        results.append(res)
                        if on_query is not None:
                            on_query(res)
        return results

    def metrics_snapshot(self) -> dict[str, Any]:
        """One-stop observable state (DESIGN.md §10): the stream counters,
        rounds (host) and messages (read from the same device counter as
        ``n_messages``), the counter registry's snapshot (its one
        device->host copy), histogram summaries and dimension attribution
        derived from that same snapshot, span counts and flight-recorder
        occupancy.  ``phases`` (port-only) holds the tracer's per-name span
        totals (``SpanTracer.phase_table``).  An armed watchdog reviews the
        snapshot for divergence; its findings land in the *next* snapshot's
        counters (§10.8)."""
        if self.obs.enabled:
            self._obs_pre_snapshot()
            self.obs.flush_histograms()
        counters = self.obs.counters.snapshot()
        snap = {
            "epochs": self.n_epochs, "adds": self.n_adds,
            "dels": self.n_dels, "rounds": self.n_rounds,
            "messages": self.n_messages,
            "counters": counters,
            "histograms": hist_mod.summarize(counters),
            "attribution": self.obs.counters.attribution(counters),
            "spans": self.obs.tracer.span_counts(),
            # port-only: per-name totals of the spans (phases and epochs)
            "phases": self.obs.tracer.phase_table(),
            "flight": {"records": self.obs.recorder.total,
                       "capacity": self.obs.recorder.capacity},
        }
        if self.obs.watchdog is not None:
            self.obs.watchdog.review(counters)
        return snap

    def dump_flight_recorder(self, file=None) -> str:
        """Postmortem: write the flight-recorder ring (most recent epoch
        records) as JSONL to ``file`` (default stderr) and return it."""
        return self.obs.recorder.dump(
            file=file, header=f"flight recorder "
            f"({self.obs.recorder.total} records total)")

    def stability_vs_prev(self, parent: np.ndarray,
                          source: int | None = None) -> float:
        """Paper §5.4: fraction of vertices whose predecessor is unchanged
        since the previous call (over vertices present in both results).
        ``source`` scopes the comparison: pass ``QueryResult.source`` so a
        routed lane's snapshot is only compared against the SAME lane's
        previous one (the first observation of each scope scores 1.0)."""
        key = None if source is None else int(source)
        prev = self._last_parent.get(key)
        self._last_parent[key] = parent.copy()
        if prev is None or prev.shape != parent.shape:
            return 1.0
        both = (prev >= 0) & (parent >= 0)
        return float(np.mean(prev[both] == parent[both])) if both.any() else 1.0
