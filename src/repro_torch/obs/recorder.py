"""Flight recorder (DESIGN.md §10.3): a bounded ring buffer of recent
epoch records for postmortems (copied from ``repro.obs.recorder``).

Every dispatched epoch appends one small host-side dict (kind, wall
time, batch size, whatever the engine attaches); the deque drops the
oldest record past ``capacity`` so a long replay keeps O(capacity)
memory.  On an exception escaping an instrumented epoch the engine dumps
the ring (``EngineObs``), answering "what was the engine doing right
before it died" without any always-on logging.
"""
from __future__ import annotations

import collections
import json
import sys
import time
from typing import Any, TextIO

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError(f"flight recorder capacity must be >= 1; "
                             f"got {capacity}")
        self._buf: collections.deque[dict[str, Any]] = \
            collections.deque(maxlen=capacity)
        self.total = 0   # records ever written (seq of the next record)

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def record(self, kind: str, **fields) -> dict[str, Any]:
        rec = {"seq": self.total, "kind": kind,
               "t_s": round(time.perf_counter(), 6), **fields}
        self._buf.append(rec)
        self.total += 1
        return rec

    def records(self) -> list[dict[str, Any]]:
        """Oldest-to-newest surviving records (at most ``capacity``)."""
        return list(self._buf)

    def dump(self, file: TextIO | None = None, header: str = "") -> str:
        """Write the ring as one JSONL block (postmortem output; defaults
        to stderr) and return it."""
        lines = [json.dumps(r, default=str) for r in self._buf]
        text = "\n".join(([f"# {header}"] if header else []) + lines)
        print(text, file=file or sys.stderr)
        return text
