"""Trace replayer: drive the port's engine from a recorded trace and
measure the paper's serving metrics along the way (DESIGN.md §8); torch
rendering of ``repro.serving.replay``.

Deterministic by construction — the trace fixes the event order, the
engines' epochs are deterministic, so two replays of the same trace on
equivalently configured engines produce bit-identical results
(tests/test_torch_replay.py).

Query routing: a QUERY row carrying source ``s`` is answered from lane
``s`` of a batched multi-source engine (only that lane's [N] snapshot is
read back).  On a single-source engine the trace's query sources select
nothing — the engine serves its one tree — which is exactly what the
sequential-baseline comparison in the ``serving`` bench section needs.

``pace=True`` honors the trace's inter-event gaps (sleeping until each
batch's first timestamp) to model offered load instead of max-speed
replay; throughput then reflects the trace's rate, not the engine's.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np

from repro_torch.core import events as ev
from repro_torch.core.stream import QueryResult, StreamEngineBase
from repro_torch.obs import hist as hist_mod
from repro_torch.serving.metrics import (ServingReport, churn, hist_merge,
                                         hist_percentile, percentiles)
from repro_torch.serving.trace import ServingTrace, TraceReader


def _engine_label(engine: StreamEngineBase) -> str:
    kind = ("sharded" if type(engine).__name__.startswith("Sharded")
            else "single")
    return f"{kind}/{getattr(engine.cfg, 'relax_backend', '?')}"


def replay_trace(engine: StreamEngineBase,
                 trace: ServingTrace | TraceReader, *,
                 pace: bool = False,
                 on_query: Callable[[QueryResult], None] | None = None
                 ) -> ServingReport:
    """Replay ``trace`` through ``engine``; returns the ``ServingReport``.

    ``trace`` may be an in-memory ``ServingTrace`` or a streaming
    ``TraceReader`` (serving/trace.py): the replay loop consumes one chunk
    at a time, so peak host memory is O(chunk) + the engine's own state,
    never O(stream).  A run of consecutive ADDs (or DELs) that straddles a
    chunk boundary ingests as two batches — the converged (dist, parent)
    is identical (insertion is order-free, deletions are per-event unless
    ``batch_deletions``), only epoch counters may differ from a monolithic
    replay.

    Latency comes from each ``QueryResult.latency_s`` (the snapshot
    readback timed in ``StreamEngineBase.query``; a bucketed engine's drain
    runs inside it).  Throughput is host wall-clock time; the eager wave
    loops read each wave's flags back and every query copies its tree to
    the host, so little device work can outlast it.  Churn compares each
    query's (dist, parent) against the PREVIOUS snapshot of the same scope
    — per lane for routed queries, the full stack otherwise — so the first
    observation of a scope contributes no churn sample.  Throughput is
    topology events over the whole replay wall-clock.
    """
    chunks = (trace.chunks() if isinstance(trace, TraceReader)
              else iter((trace,)))
    latencies: list[float] = []
    churns: list[dict[str, float]] = []
    prev: dict[object, tuple] = {}
    # per-tenant latency histograms (§10.6 log2 buckets, microseconds) +
    # each scope's exact first-query (cold) latency — the cold/warm split
    lat_hists: dict[object, np.ndarray] = {}
    cold_s: dict[object, float] = {}
    n_queries = 0
    n_events = 0
    n_topo = 0
    t_first: float | None = None
    t0 = time.perf_counter()
    for piece in chunks:
        if len(piece) == 0:
            continue
        if t_first is None:
            t_first = float(piece.t[0])
        n_events += len(piece)
        n_topo += piece.n_topology
        log = piece.to_log()
        cursor = 0
        for batch in log.runs():
            if pace:
                lag = float(piece.t[cursor] - t_first) \
                    - (time.perf_counter() - t0)
                if lag > 0:
                    time.sleep(lag)
            if batch.kind == ev.ADD:
                engine._ingest_adds(batch)
                cursor += len(batch)
            elif batch.kind == ev.DEL:
                engine._ingest_dels(batch)
                cursor += len(batch)
            else:
                res = engine.query(
                    source=engine.route_of(batch.query_source))
                n_queries += 1
                cursor += 1
                latencies.append(res.latency_s)
                key = res.source if res.source is not None else "*"
                if key not in lat_hists:
                    lat_hists[key] = hist_mod.zeros_np()
                    cold_s[key] = res.latency_s
                hist_mod.fold_np(lat_hists[key], res.latency_s * 1e6)
                if key in prev:
                    pd, pp = prev[key]
                    churns.append(churn(pd, pp, res.dist, res.parent))
                prev[key] = (res.dist, res.parent)
                if on_query is not None:
                    on_query(res)
    wall = time.perf_counter() - t0
    mean = (lambda k: (sum(c[k] for c in churns) / len(churns))
            if churns else 0.0)
    # per-tenant p50/p95/p99 from the per-source histograms (estimates in
    # ms), plus each tenant's exact cold (first-query) latency
    per_source = {
        key: {
            "queries": int(h.sum()),
            "cold_ms": cold_s[key] * 1e3,
            "p50_ms": hist_percentile(h, 50) / 1e3,
            "p95_ms": hist_percentile(h, 95) / 1e3,
            "p99_ms": hist_percentile(h, 99) / 1e3,
        }
        for key, h in lat_hists.items()}
    # cold/warm split: the warm histogram is the merged per-tenant pool
    # minus each tenant's cold sample (histograms are additive, so the
    # subtraction is exact at bucket granularity); cold percentiles come
    # from the exact first-query latencies
    cold_warm = None
    if lat_hists:
        pooled = hist_merge(*lat_hists.values())
        cold_hist = hist_merge(*(hist_mod.one_hot_np(v * 1e6)
                                 for v in cold_s.values()))
        warm_hist = pooled - cold_hist
        cold_vals = list(cold_s.values())
        cold_warm = {
            "cold_queries": float(cold_hist.sum()),
            "warm_queries": float(warm_hist.sum()),
            "cold_p50_ms": percentiles(cold_vals)["p50"] * 1e3,
            "cold_p99_ms": percentiles(cold_vals)["p99"] * 1e3,
            "warm_p50_ms": hist_percentile(warm_hist, 50) / 1e3,
            "warm_p99_ms": hist_percentile(warm_hist, 99) / 1e3,
        }
    return ServingReport(
        engine=_engine_label(engine),
        n_sources=len(engine.sources) if engine.sources else 1,
        events=n_events,
        topology_events=n_topo,
        queries=n_queries,
        wall_s=wall,
        events_per_s=n_topo / max(wall, 1e-9),
        latency_s=percentiles(latencies),
        churn_mean={"dist": mean("dist"), "parent": mean("parent"),
                    "any": mean("any")},
        latencies=latencies,
        churns=churns,
        # the engine's own telemetry (DESIGN.md §10) — rounds/messages plus
        # the obs counter/span snapshot when observability is enabled
        engine_metrics=engine.metrics_snapshot(),
        per_source=per_source or None,
        cold_warm=cold_warm,
    )
