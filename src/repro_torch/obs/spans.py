"""Span tracer (DESIGN.md §10.2): monotonic host-side spans over the
engine's epoch dispatches, exportable as Chrome trace-event JSON (loads
directly in Perfetto / chrome://tracing) and as JSONL; torch rendering of
``repro.obs.spans``.

A span wraps one host-side dispatch region — add/del epoch, drain,
checkpoint, query — with ``time.perf_counter_ns`` stamps; each such span
also opens a ``torch.profiler.record_function`` range (the reference
opens a ``jax.profiler.TraceAnnotation``), so the same names land in
``torch.profiler`` traces beside the kernels.  A range costs microseconds
of host time, so spans stay at epoch granularity: never one per wave.
Instant events mark point occurrences (layout rebuilds).  Nothing here
touches device values: the tracer is pure host bookkeeping, so it obeys
no host read of its own (the device work inside a span stays async; the
span measures dispatch wall time, which is the quantity the ingest loop
actually spends).

Two categories.  ``engine`` spans are the reference's: ``span_counts``,
``span_counts_of`` and the engine's parity surface count them alone.
``phase`` spans (port-only) split an epoch into its host phases — the
slot allocator's plans, the layout patches, the marking and wave loops —
open no ``record_function`` range (a dozen a batch), and carry counts in
their ``args``: ``reads`` (the host reads made while
the span was the innermost open one, ``read``), ``read_wait_ns`` (the host
time blocked in them) and, on loops, ``iterations``.  Every complete span
records the same counts and its self time (its time less its child
spans'), so ``phase_table`` folds any run of spans into per-name totals;
a read made under an epoch but outside every phase span counts on the
epoch.

The clock: ``perf_counter_ns`` stamps, with the offset to the Unix-epoch
nanoseconds that ``torch.profiler`` stamps (``time.time_ns() -
time.perf_counter_ns()``, the tightest of five back-to-back pairs),
sampled when the tracer is made and again at every readout;
``to_unix_ns`` maps a stamp with the newest sample, and ``save_chrome``
writes it into the trace's metadata so both traces open together.
"""
from __future__ import annotations

import dataclasses
import json
import time
from contextlib import AbstractContextManager, nullcontext
from typing import Any, Iterable

from torch.profiler import record_function

__all__ = ["Span", "SpanTracer", "load_chrome_trace", "phase_table",
           "span_counts_of", "unix_offset_ns"]

ENGINE, PHASE = "engine", "phase"
NULL = nullcontext()   # the shared context of every disabled span


@dataclasses.dataclass
class Span:
    name: str
    t0_ns: int      # perf_counter_ns at entry (exit for instants)
    dur_ns: int     # 0 for instant events
    depth: int      # nesting depth at entry (0 = top-level)
    phase: str      # "X" complete span | "i" instant
    args: dict[str, Any] = dataclasses.field(default_factory=dict)
    cat: str = ENGINE
    self_ns: int = 0        # dur_ns less the child spans' dur_ns
    reads: int = 0          # host reads while innermost
    read_wait_ns: int = 0   # host time blocked in them
    iterations: int | None = None   # loop passes (loop spans only)


class _OpenSpan:
    """One open complete span: its running counts (``read`` and the
    loops update them) and the context that closes it into a ``Span``.  A
    plain class, not a generator: a span is opened a dozen times a batch."""
    __slots__ = ("_tracer", "name", "cat", "args", "t0", "depth",
                 "child_ns", "reads", "read_wait_ns", "iterations", "_range")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: dict[str, Any]):
        self._tracer, self.name, self.cat, self.args = tracer, name, cat, args
        self.child_ns = self.reads = self.read_wait_ns = 0
        self.iterations: int | None = None

    def __enter__(self) -> "_OpenSpan":
        tr = self._tracer
        self.depth = len(tr._open)
        tr._open.append(self)
        self.t0 = time.perf_counter_ns()
        # engine spans only: a range costs ~10 us of host, and the phase
        # spans reach the profiler's clock through the Unix offset instead
        self._range = (record_function(self.name)
                       if tr._annotate and self.cat == ENGINE else None)
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        dur = time.perf_counter_ns() - self.t0
        tr = self._tracer
        tr._open.pop()
        if tr._open:
            tr._open[-1].child_ns += dur
        args = self.args
        if self.cat == PHASE:
            args = {**args, "reads": self.reads,
                    "read_wait_ns": self.read_wait_ns}
            if self.iterations is not None:
                args["iterations"] = self.iterations
        tr.spans.append(Span(
            self.name, self.t0, dur, self.depth, "X", args, self.cat,
            dur - self.child_ns, self.reads, self.read_wait_ns,
            self.iterations))
        return False


def unix_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the tightest of
    five back-to-back pairs (the Unix stamp bracketed by two counter
    stamps; their midpoint is taken)."""
    best_gap, best = None, 0
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best_gap is None or b - a < best_gap:
            best_gap, best = b - a, u - (a + b) // 2
    return best


class SpanTracer:
    def __init__(self, enabled: bool = True, annotate: bool | None = None):
        """``annotate=False`` keeps the spans out of ``torch.profiler``
        traces (no ``record_function`` range); None or True opens one a
        span."""
        self.enabled = enabled
        self._annotate = annotate is None or bool(annotate)
        self._base_ns = time.perf_counter_ns()
        # (perf_counter_ns at the sample, Unix offset): creation, then
        # one a readout
        self.offsets: list[tuple[int, int]] = []
        self.sample_clock()
        self._open: list[_OpenSpan] = []
        self.spans: list[Span] = []   # completion order

    def span(self, name: str, *, cat: str = ENGINE,
             **args) -> AbstractContextManager:
        """A complete span; its context yields the open span, whose
        ``iterations`` a loop sets (None, from the shared null context,
        when disabled)."""
        return _OpenSpan(self, name, cat, args) if self.enabled else NULL

    def read(self, wait_ns: int) -> None:
        """Count one host read, blocked ``wait_ns``, on the innermost open
        span."""
        if self._open:
            frame = self._open[-1]
            frame.reads += 1
            frame.read_wait_ns += wait_ns

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self.spans.append(Span(name, time.perf_counter_ns(), 0,
                               len(self._open), "i", args))

    # ----------------------------------------------------------------- clock
    def sample_clock(self) -> int:
        """Sample the Unix offset now; returns it."""
        off = unix_offset_ns()
        self.offsets.append((time.perf_counter_ns(), off))
        return off

    def to_unix_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` stamp on the Unix-epoch clock (the
        newest offset sample)."""
        return t_ns + self.offsets[-1][1]

    # --------------------------------------------------------------- readout
    def span_counts(self) -> dict[str, int]:
        """Completed ``engine`` spans + instants by name (the figure the
        acceptance check matches against the engine's epoch/drain/rebuild
        counters)."""
        counts: dict[str, int] = {}
        for s in self.spans:
            if s.cat == ENGINE:
                counts[s.name] = counts.get(s.name, 0) + 1
        return counts

    def phase_table(self) -> dict[str, dict[str, int]]:
        """``phase_table`` of every span so far (a readout: samples the
        clock)."""
        self.sample_clock()
        return phase_table(self.spans)

    # --------------------------------------------------------------- exports
    def to_chrome(self) -> dict[str, Any]:
        """Chrome trace-event JSON object ({"traceEvents": [...]}, ts/dur
        in microseconds from the tracer's creation) — loads as-is in
        Perfetto.  ``baseTimeNanoseconds`` (``torch.profiler``'s key) and
        ``metadata`` place ts 0 on the Unix-epoch clock."""
        off = self.sample_clock()
        events = []
        for s in self.spans:
            e: dict[str, Any] = {
                "name": s.name, "cat": s.cat, "ph": s.phase,
                "ts": (s.t0_ns - self._base_ns) / 1e3,
                "pid": 0, "tid": 0,
                "args": {"depth": s.depth, **s.args},
            }
            if s.phase == "X":
                e["dur"] = s.dur_ns / 1e3
            else:
                e["s"] = "t"
            events.append(e)
        base = self._base_ns + off
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": base,
                "metadata": {"clock": "perf_counter_ns",
                             "unix_offset_ns": off, "base_unix_ns": base}}

    def save_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def jsonl_lines(self, cat: str | None = None) -> list[str]:
        """One JSON line a span (``cat`` given: that category's only);
        phase lines carry ``"cat": "phase"``."""
        self.sample_clock()
        return [json.dumps({
            "name": s.name, "ph": s.phase, "depth": s.depth,
            "ts_us": (s.t0_ns - self._base_ns) / 1e3,
            "dur_us": s.dur_ns / 1e3,
            **({"cat": s.cat} if s.cat != ENGINE else {}),
            **({"args": s.args} if s.args else {}),
        }) for s in self.spans if cat is None or s.cat == cat]

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.jsonl_lines()) + "\n")


def phase_table(spans: Iterable[Span]) -> dict[str, dict[str, int]]:
    """Per-name totals of complete spans, both categories: ``{name:
    {count, ns, self_ns, reads, read_wait_ns, iterations}}`` (host
    integers; ``iterations`` 0 where the span is no loop)."""
    out: dict[str, dict[str, int]] = {}
    for s in spans:
        if s.phase != "X":
            continue
        row = out.get(s.name)
        if row is None:
            row = out[s.name] = dict(count=0, ns=0, self_ns=0, reads=0,
                                     read_wait_ns=0, iterations=0)
        row["count"] += 1
        row["ns"] += s.dur_ns
        row["self_ns"] += s.self_ns
        row["reads"] += s.reads
        row["read_wait_ns"] += s.read_wait_ns
        row["iterations"] += s.iterations or 0
    return out


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
    instants of the ``engine`` category; metadata events and ``phase``
    spans are ignored)."""
    counts: dict[str, int] = {}
    for e in events:
        if e.get("ph") in ("X", "i") and e.get("cat", ENGINE) == ENGINE:
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts
