"""Engine observability layer (DESIGN.md §10): device-side counter
registry, span tracing with Perfetto export, and a per-epoch flight
recorder, reached through ``StreamEngineBase``; torch rendering of
``repro.obs``.

``EngineObs`` bundles the three pieces behind one facade the engines
drive:

  * ``with obs.epoch(kind, **attrs):`` wraps one dispatched epoch — it
    opens a tracer span (plus a torch.profiler record_function), bumps
    the matching host counter (``add_epoch`` -> ``add_epochs``), appends
    a flight-recorder record with the dispatch wall time, and on an
    escaping exception dumps the flight recorder ONCE before re-raising.
  * ``obs.note_layout(totals)`` diffs the backend's monotone layout
    totals (``RelaxBackend.layout_counters()``: rebuilds, overflow-lane
    hits) against the last observation, folding the deltas into counters
    and emitting one ``rebuild`` instant event per rebuild — so the span
    stream and the counter registry can never disagree (they are derived
    from the same deltas).  Totals may reset when the "auto" backend
    swaps layouts; negative deltas clamp to zero.
  * ``obs.counters`` / ``obs.tracer`` / ``obs.recorder`` for direct use
    (device-value accumulation, instants, extra records).
  * ``obs.hist_device(name, value)`` / ``obs.hist_cumulative(name, value)``
    / ``obs.hist_host(name, value)`` record histogram samples (§10.6).
    The device variants are ZERO-dispatch on the hot path: they append
    the value (a per-epoch sample, or the engine's cumulative counter
    whose consecutive diffs are the samples) to a host-side list;
    ``flush_histograms()`` — called by ``metrics_snapshot()`` —
    materializes each list in a few stacked one-hot folds that ride the
    registry's lazy ``+`` and its single ``snapshot()`` copy.  The port's
    round counts are host integers (its eager wave loops read each wave's
    condition back), so a ``hist_device`` sample may be a host int or
    numpy array as well as a tensor: those fold on the host at flush, under
    the same ``hist_*`` name.  Host samples (query latency) fold as numpy
    vectors immediately.
  * an optional :class:`~repro_torch.obs.watchdog.Watchdog` (§10.8) armed
    around every ``epoch()`` region: stalls fire a structured warning +
    the one-shot dump from a sampler thread, slow-epoch/frontier
    thresholds are checked synchronously after each epoch.
  * ``with obs.phase(name):`` opens a ``phase`` span (``spans.py``) inside
    an epoch or around ``ingest_log``'s host work.  The loops of
    ``core/relax.py``, ``core/delete.py`` and ``core/buckets.py`` reach the
    running epoch's ``EngineObs`` through the module slot ``ACTIVE`` (set
    by ``epoch()`` on entry, restored on exit) with the module-level
    ``phase(name)``, and ``relax.host`` counts each read and its wait on
    that engine's tracer (``SpanTracer.read``).  The slot is one per
    process: an epoch of a disabled engine run inside an enabled engine's
    epoch counts on the enabled one.  ``metrics_snapshot()["phases"]`` is
    the tracer's ``phase_table()``, outside the reference's surface.

Disabled (the default) every hook no-ops: ``epoch()`` and ``phase()``
return one shared null context, and a loop's read costs one ``is None``
test.  Enabled, the hooks add no host read to ingest or drains: the only
read points are ``snapshot()`` (one device->host copy) and ``query()``.
The reference gates instrumented ingest at >= 0.95x uninstrumented
(§10.4); the port has no gate yet.
"""
from __future__ import annotations

import os
import sys
import time
from contextlib import AbstractContextManager, contextmanager
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.obs import hist as hist_mod
from repro_torch.obs.counters import CounterRegistry
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.spans import (ENGINE, NULL, PHASE, Span, SpanTracer,
                                   load_chrome_trace, span_counts_of)
from repro_torch.obs.watchdog import Watchdog, WatchdogConfig

__all__ = [
    "CounterRegistry", "EngineObs", "FlightRecorder", "Span", "SpanTracer",
    "Watchdog", "WatchdogConfig", "load_chrome_trace", "out_path_or_exit",
    "phase", "span_counts_of", "write_log_jsonl",
]

# the EngineObs of the innermost running enabled epoch (None outside every
# one): the wave and marking loops find their engine's tracer here, so no
# backend signature carries it
ACTIVE: "EngineObs | None" = None


def phase(name: str) -> AbstractContextManager:
    """A ``phase`` span of the running epoch's engine, or the shared null
    context outside every enabled epoch; yields the span's frame (None
    when off), whose ``iterations`` a loop sets."""
    obs = ACTIVE
    return NULL if obs is None else obs.phase(name)


# span kind -> counter name: every epoch span bumps its counter from the
# SAME code path, which is what makes span counts and counters bit-consistent
_PLURAL = {
    "add_epoch": "add_epochs",
    "del_epoch": "del_epochs",
    "drain": "drains",
    "query": "queries",
    "checkpoint": "checkpoints",
}


class EngineObs:
    def __init__(self, enabled: bool = False, flight_capacity: int = 128,
                 watchdog: WatchdogConfig | None = None):
        self.enabled = bool(enabled)
        self.counters = CounterRegistry(self.enabled)
        self.tracer = SpanTracer(self.enabled)
        self.recorder = FlightRecorder(flight_capacity)
        self.watchdog = (Watchdog(watchdog, self)
                         if (self.enabled and watchdog is not None) else None)
        self._layout_last: dict[str, int] = {}
        # pending histogram samples (§10.6): plain host lists of tensors
        # and host numbers — appending costs no device dispatch and no
        # read; materialized by flush_histograms() at snapshot time
        self._hist_samples: dict[str, list] = {}
        self._hist_cum: dict[str, list] = {}
        self._hist_base: dict[str, Any] = {}
        self._dumped = False

    def epoch(self, kind: str, **attrs) -> AbstractContextManager:
        """The context of one dispatched epoch (the shared null context
        when disabled)."""
        return self._epoch(kind, **attrs) if self.enabled else NULL

    def phase(self, name: str) -> AbstractContextManager:
        """A ``phase`` span (the shared null context when disabled)."""
        return self.tracer.span(name, cat=PHASE) if self.enabled else NULL

    @contextmanager
    def _epoch(self, kind: str, **attrs) -> Iterator[None]:
        global ACTIVE
        wd = self.watchdog
        t0 = time.perf_counter()
        if wd is not None:
            wd.arm(kind)
        outer, ACTIVE = ACTIVE, self
        try:
            with self.tracer.span(kind, **attrs):
                yield
        except BaseException as exc:
            self.recorder.record(kind, error=repr(exc), **attrs)
            self.dump_on_error(exc)
            raise
        finally:
            ACTIVE = outer
            if wd is not None:
                wd.disarm()
        wall = time.perf_counter() - t0
        self.counters.inc(_PLURAL.get(kind, kind + "s"))
        self.recorder.record(kind, wall_ms=round(wall * 1e3, 3), **attrs)
        # per-kind dispatch wall-time histogram (§10.6): sample count per
        # kind equals the kind's counter by construction
        self.hist_host(f"hist_{kind}_wall_us", wall * 1e6)
        if wd is not None:
            wd.observe(kind, wall, attrs)

    # ------------------------------------------------------------- histograms
    def hist_device(self, name: str, value) -> None:
        """Record one histogram sample (scalar, or [S] vector -> S samples;
        a tensor, or a host int / numpy array) for counter ``name`` — a
        host-side list append and nothing else: no dispatch, no read
        (§10.6/§10.4); the one-hot folds happen in flush_histograms()."""
        if self.enabled:
            self._hist_samples.setdefault(name, []).append(value)

    def hist_cumulative(self, name: str, value) -> None:
        """Record the engine's CUMULATIVE device counter after an epoch;
        consecutive diffs of the recorded series are the per-epoch samples
        (materialized at flush).  For engines whose epochs return updated
        cumulative counters rather than per-epoch stats — appending the
        returned array reference costs nothing."""
        if self.enabled:
            self._hist_cum.setdefault(name, []).append(value)

    def flush_histograms(self) -> None:
        """Materialize the pending sample lists into ``hist_*`` counters:
        tensor samples in stacked one-hot folds (``torch.stack`` on their
        own device, in chunks of 512 so a long uninspected run cannot build
        an unboundedly wide stack), folded through the registry's lazy
        ``+``; host samples bucketed on the host.  No read here: the
        read-back stays ``snapshot()``'s single copy."""
        if not self.enabled or not (self._hist_samples or self._hist_cum):
            return
        for name, samples in self._hist_samples.items():
            dev = [s for s in samples if isinstance(s, torch.Tensor)]
            for i in range(0, len(dev), _CHUNK):
                self.counters.add(name, hist_mod.one_hot(
                    torch.stack(dev[i:i + _CHUNK])))
            host = [s for s in samples if not isinstance(s, torch.Tensor)]
            if host:
                self.counters.inc(name, _host_counts(host))
        self._hist_samples.clear()
        for name, series in self._hist_cum.items():
            if not series:
                continue
            base = self._hist_base.get(name)
            if base is None:
                base = torch.zeros_like(torch.as_tensor(series[0]))
            full = [base] + series
            for i in range(0, len(series), _CHUNK):
                seg = torch.stack([torch.as_tensor(s)
                                   for s in full[i:i + _CHUNK + 1]])
                self.counters.add(name, hist_mod.one_hot(seg[1:] - seg[:-1]))
            self._hist_base[name] = series[-1]
            series.clear()

    def hist_host(self, name: str, value: float) -> None:
        """Fold one host-born histogram sample (e.g. wall-clock latency in
        microseconds) into counter ``name`` as a numpy one-hot vector."""
        if self.enabled:
            self.counters.inc(name, hist_mod.one_hot_np(value))

    def note_layout(self, totals: dict[str, int]) -> None:
        """Fold the backend's monotone layout totals (rebuilds,
        overflow_hits, ...) into counters by delta; one ``rebuild``
        instant event per rebuild delta."""
        if not self.enabled:
            return
        for name, total in totals.items():
            delta = max(0, int(total) - self._layout_last.get(name, 0))
            self._layout_last[name] = int(total)
            if delta == 0:
                continue
            self.counters.inc(name, delta)
            if name == "rebuilds":
                for _ in range(delta):
                    self.tracer.instant("rebuild")

    def dump_on_error(self, exc: BaseException) -> None:
        """One-shot flight-recorder postmortem (nested epochs dump once)."""
        if self._dumped:
            return
        self._dumped = True
        self.recorder.dump(
            header=f"flight recorder postmortem "
                   f"({self.recorder.total} records total): {exc!r}")


_CHUNK = 512   # samples per stacked one-hot fold


def _host_counts(samples: list) -> np.ndarray:
    """Count vector of host samples (ints or numpy arrays, one sample per
    element), bucketed by the host twin ``bucket_index_np``."""
    flat = np.concatenate([np.ravel(s) for s in samples])
    return np.bincount([hist_mod.bucket_index_np(v) for v in flat],
                       minlength=hist_mod.NUM_BUCKETS).astype(np.int64)


# ----------------------------------------------------------- CLI plumbing --
def out_path_or_exit(path: str) -> str:
    """Validate a --trace-out / --log-json destination up front: a missing
    parent directory exits 2 (usage error) before any engine work runs."""
    parent = os.path.dirname(os.path.abspath(path))
    if not os.path.isdir(parent):
        print(f"error: output parent directory does not exist: {parent}",
              file=sys.stderr)
        raise SystemExit(2)
    return path


def _jsonable(v: Any) -> Any:
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().tolist()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def write_log_jsonl(engine, path: str) -> None:
    """JSONL export (--log-json): every ``engine`` span line, as the
    reference writes them, followed by one final ``metrics_snapshot`` line
    (whose ``phases`` key holds the phase spans' totals) — the
    machine-readable twin of --trace-out."""
    import json
    lines = engine.obs.tracer.jsonl_lines(ENGINE)
    lines.append(json.dumps(
        {"kind": "metrics_snapshot", **_jsonable(engine.metrics_snapshot())}))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
