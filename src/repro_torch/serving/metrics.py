"""Serving metrics (DESIGN.md §8): the paper's three serving qualities —
result latency, solution stability, event throughput — as one
machine-readable ``ServingReport`` computed during trace replay; copied
from ``repro.serving.metrics``.

Definitions (matching the paper's evaluation; see DESIGN.md §8.3):

  * **result latency** — the wall-clock cost of answering one QUERY: the
    device->host snapshot readback timed inside ``StreamEngineBase.query``
    (epochs are enforced per batch, so no residual convergence is ever
    folded in).  Reported as p50/p95/p99 over the replay's queries.
  * **solution stability** — per-epoch churn between consecutive results
    *of the same source*: the fraction of vertices whose dist changed
    (``churn_dist``), whose parent changed (``churn_parent``), or either
    (``churn``).  Low churn = stable trees, the paper's §5.4 quality
    (``1 - churn_parent`` is the predecessor-overlap stability figure).
  * **throughput** — sustained topology events (ADD+DEL) per second over
    the whole replay wall-clock.

The histogram merge/estimate helpers (``hist_merge``/``hist_percentile``)
are re-exported from the telemetry layer's ``obs/hist.py``
(DESIGN.md §10.6) — the replayer's per-tenant and cold/warm figures are
computed from the same log2 buckets the engines accumulate on device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.obs.hist import merge as hist_merge
from repro_torch.obs.hist import percentile as hist_percentile


def pctile(xs, q) -> float:
    """Percentile with the edge-case conventions every caller shares:
    empty input -> NaN (never raises), a single sample is every percentile
    of itself, and any input shape is accepted — generators and other
    len()-less iterables are materialized, scalars wrap, [S, N] stacks
    flatten."""
    if not hasattr(xs, "__len__") and not isinstance(xs, np.ndarray):
        xs = list(xs) if np.iterable(xs) else [xs]
    arr = np.asarray(xs, np.float64).reshape(-1)
    return float(np.percentile(arr, q)) if arr.size else float("nan")


def percentiles(xs, qs=(50, 95, 99)) -> dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` over ``xs``."""
    return {f"p{q:g}": pctile(xs, q) for q in qs}


def churn(prev_dist: np.ndarray, prev_parent: np.ndarray,
          dist: np.ndarray, parent: np.ndarray) -> dict[str, float]:
    """Fraction of vertices whose dist / parent / either changed between
    two snapshots of the same source's tree (shape-agnostic: a stacked
    [S, N] pair scores all lanes at once).  ``inf == inf`` counts as
    unchanged (numpy equality), so unreached-and-still-unreached vertices
    are stable."""
    d_ch = dist != prev_dist
    p_ch = parent != prev_parent
    return {
        "dist": float(np.mean(d_ch)),
        "parent": float(np.mean(p_ch)),
        "any": float(np.mean(d_ch | p_ch)),
    }


@dataclasses.dataclass
class ServingReport:
    """Aggregate serving metrics for one trace replay (DESIGN.md §8.3).

    ``latencies`` / ``churns`` keep the per-query series for callers that
    want distributions; ``to_record()`` flattens the aggregates into the
    BENCH_sssp.json record shape."""

    engine: str               # e.g. "single/segment" or "sharded/sliced"
    n_sources: int
    events: int               # total trace events (topology + queries)
    topology_events: int
    queries: int
    wall_s: float
    events_per_s: float       # sustained topology-event throughput
    latency_s: dict[str, float]          # p50/p95/p99 (seconds)
    churn_mean: dict[str, float]         # dist/parent/any means
    latencies: list[float] = dataclasses.field(default_factory=list,
                                               repr=False)
    churns: list[dict[str, float]] = dataclasses.field(default_factory=list,
                                                       repr=False)
    # the engine's metrics_snapshot() at replay end (DESIGN.md §10):
    # epochs/rounds/messages plus the obs counter registry and span counts
    engine_metrics: dict[str, Any] | None = dataclasses.field(default=None,
                                                              repr=False)
    # per-source (per-tenant) latency: {source_key: {"queries", "cold_ms",
    # "p50_ms", "p95_ms", "p99_ms"}} — percentile estimates from the §10.6
    # log2 histogram each tenant's queries fold into during replay; the
    # key "*" covers unrouted full-state queries
    per_source: dict[Any, dict[str, float]] | None = dataclasses.field(
        default=None, repr=False)
    # cold-vs-warm admission split: each scope's FIRST query is cold (the
    # tree has never been read back for that tenant), the rest are warm —
    # the ROADMAP's cold-vs-warm admission latency figure
    cold_warm: dict[str, float] | None = None

    @property
    def stability_parent(self) -> float:
        """Paper §5.4 figure: mean predecessor overlap between consecutive
        results (1 - mean parent churn)."""
        return 1.0 - self.churn_mean["parent"]

    def summary(self) -> str:
        """Human-readable report (the examples' replay output)."""
        return "\n".join([
            f"replayed {self.events} events ({self.topology_events} "
            f"topology, {self.queries} queries) as {self.engine} "
            f"x{self.n_sources} source(s)",
            f"latency p50/p95/p99: "
            f"{self.latency_s['p50'] * 1e3:.3f}/"
            f"{self.latency_s['p95'] * 1e3:.3f}/"
            f"{self.latency_s['p99'] * 1e3:.3f} ms",
            f"stability (1 - parent churn): {self.stability_parent:.4f}",
            f"throughput: {self.events_per_s:.0f} events/s",
        ] + ([
            f"cold/warm queries: {int(self.cold_warm['cold_queries'])}/"
            f"{int(self.cold_warm['warm_queries'])}, warm p50/p99 ~ "
            f"{self.cold_warm['warm_p50_ms']:.3f}/"
            f"{self.cold_warm['warm_p99_ms']:.3f} ms"
        ] if self.cold_warm else []))

    def to_record(self) -> dict[str, Any]:
        rec = {
            "engine": self.engine,
            "n_sources": self.n_sources,
            "events": self.events,
            "topology_events": self.topology_events,
            "queries": self.queries,
            "wall_s": round(self.wall_s, 4),
            "events_per_s": round(self.events_per_s, 1),
            "latency_p50_ms": round(self.latency_s["p50"] * 1e3, 4),
            "latency_p95_ms": round(self.latency_s["p95"] * 1e3, 4),
            "latency_p99_ms": round(self.latency_s["p99"] * 1e3, 4),
            "churn_dist_mean": round(self.churn_mean["dist"], 6),
            "churn_parent_mean": round(self.churn_mean["parent"], 6),
            "churn_mean": round(self.churn_mean["any"], 6),
            "stability_parent": round(self.stability_parent, 6),
        }
        if self.engine_metrics is not None:
            # flatten the two algorithmic figures the bench records track;
            # [S] per-lane vectors stringify via the sink's default=str
            rec["rounds"] = self.engine_metrics.get("rounds")
            rec["messages"] = self.engine_metrics.get("messages")
        if self.cold_warm is not None:
            rec["cold_queries"] = int(self.cold_warm["cold_queries"])
            rec["warm_queries"] = int(self.cold_warm["warm_queries"])
            rec["latency_cold_p50_ms"] = round(
                self.cold_warm["cold_p50_ms"], 4)
            rec["latency_warm_p50_ms"] = round(
                self.cold_warm["warm_p50_ms"], 4)
            rec["latency_warm_p99_ms"] = round(
                self.cold_warm["warm_p99_ms"], 4)
        return rec
