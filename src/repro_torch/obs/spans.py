"""Span tracer (DESIGN.md §10.2): monotonic host-side spans over the
engine's epoch dispatches, exportable as Chrome trace-event JSON (loads
directly in Perfetto / chrome://tracing) and as JSONL; torch rendering of
``repro.obs.spans``.

A span wraps one host-side dispatch region — add/del epoch, drain,
checkpoint, query — with ``time.perf_counter_ns`` stamps; each span also
opens a ``torch.profiler.record_function`` range (the reference opens a
``jax.profiler.TraceAnnotation``), so the same names land in
``torch.profiler`` traces beside the kernels.  A range costs microseconds
of host time, so spans stay at epoch granularity: one per dispatched
epoch, never one per wave.
Instant events mark point occurrences (layout rebuilds).  Nothing here
touches device values: the tracer is pure host bookkeeping, so it obeys
no host read of its own (the device work inside a span stays async; the
span measures dispatch wall time, which is the quantity the ingest loop
actually spends).
"""
from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Iterator

from torch.profiler import record_function

__all__ = ["Span", "SpanTracer", "load_chrome_trace", "span_counts_of"]


@dataclasses.dataclass
class Span:
    name: str
    t0_ns: int      # perf_counter_ns at entry (exit for instants)
    dur_ns: int     # 0 for instant events
    depth: int      # nesting depth at entry (0 = top-level)
    phase: str      # "X" complete span | "i" instant
    args: dict[str, Any] = dataclasses.field(default_factory=dict)


class SpanTracer:
    def __init__(self, enabled: bool = True, annotate: bool | None = None):
        """``annotate=False`` keeps the spans out of ``torch.profiler``
        traces (no ``record_function`` range); None or True opens one a
        span."""
        self.enabled = enabled
        self._annotate = annotate is None or bool(annotate)
        self._base_ns = time.perf_counter_ns()
        self._depth = 0
        self.spans: list[Span] = []   # completion order

    @contextmanager
    def span(self, name: str, **args) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        depth = self._depth
        self._depth += 1
        t0 = time.perf_counter_ns()
        try:
            with (record_function(name) if self._annotate
                  else nullcontext()):
                yield
        finally:
            self._depth = depth
            self.spans.append(Span(name, t0, time.perf_counter_ns() - t0,
                                   depth, "X", args))

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self.spans.append(Span(name, time.perf_counter_ns(), 0,
                               self._depth, "i", args))

    # --------------------------------------------------------------- readout
    def span_counts(self) -> dict[str, int]:
        """Completed spans + instants by name (the figure the acceptance
        check matches against the engine's epoch/drain/rebuild counters)."""
        counts: dict[str, int] = {}
        for s in self.spans:
            counts[s.name] = counts.get(s.name, 0) + 1
        return counts

    # --------------------------------------------------------------- exports
    def to_chrome(self) -> dict[str, Any]:
        """Chrome trace-event JSON object ({"traceEvents": [...]}, ts/dur
        in microseconds) — loads as-is in Perfetto."""
        events = []
        for s in self.spans:
            e: dict[str, Any] = {
                "name": s.name, "cat": "engine", "ph": s.phase,
                "ts": (s.t0_ns - self._base_ns) / 1e3,
                "pid": 0, "tid": 0,
                "args": {"depth": s.depth, **s.args},
            }
            if s.phase == "X":
                e["dur"] = s.dur_ns / 1e3
            else:
                e["s"] = "t"
            events.append(e)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def jsonl_lines(self) -> list[str]:
        return [json.dumps({
            "name": s.name, "ph": s.phase, "depth": s.depth,
            "ts_us": (s.t0_ns - self._base_ns) / 1e3,
            "dur_us": s.dur_ns / 1e3, **({"args": s.args} if s.args else {}),
        }) for s in self.spans]

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.jsonl_lines()) + "\n")


def load_chrome_trace(path: str) -> list[dict[str, Any]]:
    """Load a Chrome trace-event file back to its event list (round-trip
    validation for ``save_chrome`` outputs)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path} is not a Chrome trace-event file "
                         f"(no 'traceEvents' key)")
    return doc["traceEvents"]


def span_counts_of(events: list[dict[str, Any]]) -> dict[str, int]:
    """Event counts by name over a loaded Chrome trace (complete spans and
    instants; metadata events are ignored)."""
    counts: dict[str, int] = {}
    for e in events:
        if e.get("ph") in ("X", "i"):
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts
