"""Topology event stream types (paper §3, "Topology Event Ingestion").

A verbatim copy of ``repro.core.events`` (numpy only): the port imports
nothing of the JAX package, and logs built by either module are the same
arrays.

Events are produced host-side (file replay, generators, sliding-window
deletion model) as numpy struct-of-arrays batches and consumed by the engine.

Event kinds::

    ADD    — edge insertion (u, v, w)
    DEL    — edge deletion  (u, v)
    QUERY  — state-collection marker (paper: on-demand query in the stream)

The stream has no lookahead; the engine is free to coalesce *consecutive*
events of the same kind into one device batch (the paper's runtime similarly
drains its topology buffer before algorithmic messages).

QUERY events carry the *query source* in their ``src`` column (``-1`` = the
engine's default / every maintained source) — the serving layer's
multi-source streams (repro/serving/, DESIGN.md §8) route each query to one
of the batched trees this way.  Single-source streams leave it at ``-1`` and
nothing changes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

ADD = 0
DEL = 1
QUERY = 2


@dataclasses.dataclass(frozen=True)
class EventBatch:
    """A run of same-kind events (host-side, numpy)."""

    kind: int
    src: np.ndarray  # i64[n]  (QUERY: singleton query source; -1 = default)
    dst: np.ndarray  # i64[n]
    w: np.ndarray    # f32[n]  (DEL/QUERY: ignored)

    def __len__(self) -> int:
        return 0 if self.kind == QUERY else len(self.src)

    @property
    def query_source(self) -> int:
        """The QUERY marker's requested source (``-1`` = default)."""
        assert self.kind == QUERY
        return int(self.src[0]) if len(self.src) else -1


@dataclasses.dataclass(frozen=True)
class EventLog:
    """Flat event log: kind[i] in {ADD, DEL, QUERY}."""

    kind: np.ndarray  # u8[n]
    src: np.ndarray   # i64[n]
    dst: np.ndarray   # i64[n]
    w: np.ndarray     # f32[n]

    def __len__(self) -> int:
        return len(self.kind)

    def __getitem__(self, sl) -> "EventLog":
        return EventLog(self.kind[sl], self.src[sl], self.dst[sl], self.w[sl])

    def runs(self) -> Iterator[EventBatch]:
        """Coalesce consecutive same-kind events into batches.

        QUERY markers are always emitted as singleton batches (each is a
        distinct state-collection point) carrying their query-source row.
        """
        n = len(self)
        if n == 0:
            return
        kinds = self.kind
        # boundaries where the kind changes, plus around every QUERY
        change = np.nonzero(np.diff(kinds) != 0)[0] + 1
        bounds = np.concatenate([[0], change, [n]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            k = int(kinds[a])
            if k == QUERY:
                for i in range(a, b):
                    yield EventBatch(QUERY, self.src[i:i + 1],
                                     self.dst[i:i + 1], self.w[i:i + 1])
            else:
                yield EventBatch(k, self.src[a:b], self.dst[a:b], self.w[a:b])

    @staticmethod
    def concatenate(logs: list["EventLog"]) -> "EventLog":
        return EventLog(
            np.concatenate([l.kind for l in logs]),
            np.concatenate([l.src for l in logs]),
            np.concatenate([l.dst for l in logs]),
            np.concatenate([l.w for l in logs]),
        )


def adds(src, dst, w) -> EventLog:
    src = np.asarray(src, np.int64)
    return EventLog(np.full(len(src), ADD, np.uint8), src,
                    np.asarray(dst, np.int64), np.asarray(w, np.float32))


def dels(src, dst) -> EventLog:
    src = np.asarray(src, np.int64)
    return EventLog(np.full(len(src), DEL, np.uint8), src,
                    np.asarray(dst, np.int64), np.zeros(len(src), np.float32))


def query_marker(source: int = -1) -> EventLog:
    """QUERY marker; ``source`` routes the query to one maintained tree of a
    batched multi-source engine (``-1`` = default/every source)."""
    return EventLog(np.array([QUERY], np.uint8),
                    np.array([source], np.int64),
                    np.array([-1], np.int64), np.array([0.0], np.float32))


def interleave_queries(log: EventLog, every: int) -> EventLog:
    """Insert a QUERY marker after every ``every`` topology events
    (paper §5.3: query interval as a fraction of the window size)."""
    out: list[EventLog] = []
    n = len(log)
    for a in range(0, n, every):
        out.append(log[a:min(a + every, n)])
        out.append(query_marker())
    return EventLog.concatenate(out) if out else log
