"""Workload traces: a compact on-disk event stream with per-event
timestamps and per-query sources (DESIGN.md §8.2); copied from
``repro.serving.trace`` onto the port's ``core/events.py``.  The format is
the reference's: each package reads the files the other writes.

This is the replay-an-update-trace methodology of Hanauer et al.'s fully
dynamic experimental studies (PAPERS.md): record a mixed ADD/DEL/QUERY
stream once, then replay it deterministically against any engine
configuration so latency/stability/throughput comparisons share the exact
same workload.

Format (version 1) — a compressed ``.npz`` container written through an
explicit file handle (so the path is stored verbatim, no ``.npz`` suffix
magic) with struct-of-arrays columns:

    magic    "sssp-del-trace"         (format tag)
    version  1
    kind     u8[n]   events.ADD / DEL / QUERY
    src      i64[n]  ADD/DEL tail; QUERY rows carry the query source
                     (-1 = default / every maintained source)
    dst      i64[n]  ADD/DEL head (-1 on QUERY rows)
    w        f32[n]  ADD weight (0 on DEL/QUERY rows)
    t        f64[n]  nondecreasing seconds since trace start

``ServingTrace.to_log()`` lowers a trace to the engines' ``EventLog`` (the
query-source column rides along — events.py QUERY markers carry it);
``from_log`` lifts a generated log into a trace with synthetic timestamps.
``TraceRecorder`` stamps live events with a monotonic clock.

Format (version 2) — the chunked container for paper-scale streams
(DESIGN.md §11): the same five columns, split into fixed-size chunks stored
as separate npz members (``kind_00000000``, ``src_00000000``, ...) plus a
``chunk_sizes`` index.  npz members decompress lazily, so ``open_trace`` /
``TraceReader.chunks()`` stream the file with O(chunk) peak host memory —
replaying a 10M-event trace never materializes 10M-row columns.  Version-1
files still load (and read as a single chunk).
"""
from __future__ import annotations

import dataclasses
import time
import zipfile

import numpy as np

from repro_torch.core import events as ev

TRACE_MAGIC = "sssp-del-trace"
TRACE_VERSION = 2
_COLUMNS = ("kind", "src", "dst", "w", "t")
_DTYPES = (np.uint8, np.int64, np.int64, np.float32, np.float64)


class TraceFormatError(ValueError):
    """The file exists but is not a (compatible) serving trace."""


@dataclasses.dataclass(frozen=True)
class ServingTrace:
    """In-memory trace: an EventLog plus timestamps (struct of arrays)."""

    kind: np.ndarray  # u8[n]
    src: np.ndarray   # i64[n]
    dst: np.ndarray   # i64[n]
    w: np.ndarray     # f32[n]
    t: np.ndarray     # f64[n], nondecreasing, seconds from trace start

    def __post_init__(self):
        n = len(self.kind)
        for c in _COLUMNS[1:]:
            if len(getattr(self, c)) != n:
                raise TraceFormatError(
                    f"column {c!r} has {len(getattr(self, c))} rows, "
                    f"kind has {n}")

    def __len__(self) -> int:
        return len(self.kind)

    @property
    def n_topology(self) -> int:
        return int(np.sum(self.kind != ev.QUERY))

    @property
    def n_queries(self) -> int:
        return int(np.sum(self.kind == ev.QUERY))

    def query_sources(self) -> np.ndarray:
        """The query-source column of the QUERY rows (-1 = default)."""
        return self.src[self.kind == ev.QUERY]

    def duration_s(self) -> float:
        return float(self.t[-1] - self.t[0]) if len(self) else 0.0

    # ------------------------------------------------------------ conversion
    def to_log(self) -> ev.EventLog:
        return ev.EventLog(self.kind.astype(np.uint8),
                           self.src.astype(np.int64),
                           self.dst.astype(np.int64),
                           self.w.astype(np.float32))

    @staticmethod
    def from_log(log: ev.EventLog, *, t: np.ndarray | None = None,
                 events_per_s: float = 1e6) -> "ServingTrace":
        """Lift an EventLog into a trace.  Without explicit timestamps a
        synthetic uniform ramp at ``events_per_s`` is used — monotone and
        deterministic, so record->replay round-trips are reproducible."""
        if t is None:
            t = np.arange(len(log), dtype=np.float64) / float(events_per_s)
        t = np.asarray(t, np.float64)
        return ServingTrace(np.asarray(log.kind, np.uint8),
                            np.asarray(log.src, np.int64),
                            np.asarray(log.dst, np.int64),
                            np.asarray(log.w, np.float32), t)

    # ----------------------------------------------------------------- chunks
    def iter_chunks(self, events_per_chunk: int):
        """Yield this trace as consecutive slices of ≤ ``events_per_chunk``
        rows (views, no copies) — the in-memory side of the chunked path."""
        if events_per_chunk < 1:
            raise ValueError(f"events_per_chunk must be >= 1; got "
                             f"{events_per_chunk}")
        for lo in range(0, len(self), events_per_chunk):
            hi = lo + events_per_chunk
            yield ServingTrace(self.kind[lo:hi], self.src[lo:hi],
                               self.dst[lo:hi], self.w[lo:hi], self.t[lo:hi])

    # ------------------------------------------------------------------ disk
    def save(self, path: str, *, chunk_events: int | None = None) -> None:
        """Write version 1 (monolithic columns) by default; passing
        ``chunk_events`` writes the version-2 chunked container, which
        ``open_trace`` can later replay with O(chunk) peak memory."""
        if chunk_events is not None:
            with ChunkedTraceWriter(path) as wr:
                for piece in self.iter_chunks(chunk_events):
                    wr.append(piece)
            return
        with open(path, "wb") as f:
            np.savez_compressed(
                f, magic=np.asarray(TRACE_MAGIC),
                version=np.asarray(1),
                kind=self.kind.astype(np.uint8),
                src=self.src.astype(np.int64),
                dst=self.dst.astype(np.int64),
                w=self.w.astype(np.float32),
                t=self.t.astype(np.float64))

    @staticmethod
    def load(path: str) -> "ServingTrace":
        """Load and validate a trace (either version, fully materialized).
        Raises ``FileNotFoundError`` for a missing path and
        ``TraceFormatError`` for anything that is not a compatible trace
        (CLI entry points map both to exit code 2).  For O(chunk)-memory
        streaming of version-2 files use ``open_trace`` instead."""
        with open_trace(path) as r:
            pieces = list(r.chunks())
        if not pieces:
            z8, z64 = np.empty(0, np.uint8), np.empty(0, np.int64)
            return ServingTrace(z8, z64, z64.copy(),
                                np.empty(0, np.float32),
                                np.empty(0, np.float64))
        if len(pieces) == 1:
            return pieces[0]
        return ServingTrace(*(np.concatenate([getattr(p, c) for p in pieces])
                              for c in _COLUMNS))


class ChunkedTraceWriter:
    """Incremental version-2 trace writer: append ``ServingTrace`` pieces
    one at a time; nothing but the current piece is ever resident, so a
    stream synthesizer can emit a 10M-event trace in O(chunk) memory.

    Members are standard ``.npy`` entries in a deflated zip — byte-level
    compatible with ``np.savez_compressed`` / ``np.load``.
    """

    def __init__(self, path: str):
        self._zf = zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED)
        self._sizes: list[int] = []
        self._closed = False

    def _member(self, name: str, arr: np.ndarray) -> None:
        import io

        from numpy.lib import format as npf
        buf = io.BytesIO()
        # note: np.ascontiguousarray would promote the 0-d magic/version
        # members to 1-d, which np.savez does not do
        npf.write_array(buf, np.asarray(arr), allow_pickle=False)
        self._zf.writestr(name + ".npy", buf.getvalue())

    def append(self, piece: ServingTrace) -> None:
        assert not self._closed, "writer already closed"
        i = len(self._sizes)
        for col, dt in zip(_COLUMNS, _DTYPES):
            self._member(f"{col}_{i:08d}", getattr(piece, col).astype(dt))
        self._sizes.append(len(piece))

    def close(self) -> None:
        if self._closed:
            return
        self._member("magic", np.asarray(TRACE_MAGIC))
        self._member("version", np.asarray(TRACE_VERSION))
        self._member("chunk_sizes", np.asarray(self._sizes, np.int64))
        self._zf.close()
        self._closed = True

    def __enter__(self) -> "ChunkedTraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TraceReader:
    """Streaming handle over an on-disk trace: ``chunks()`` yields
    ``ServingTrace`` pieces, decompressing one chunk's members at a time
    (npz entries load lazily), so replay memory is O(chunk) not O(stream).

    Version-1 files read as a single chunk — correct, but without the
    memory bound; write with ``save(chunk_events=...)`` to get it.
    """

    def __init__(self, path: str):
        self.path = path
        try:
            self._z = np.load(path, allow_pickle=False)
        except (zipfile.BadZipFile, ValueError, OSError) as e:
            # np.load raises plain ValueError for non-npz bytes
            if isinstance(e, FileNotFoundError):
                raise
            raise TraceFormatError(f"{path}: not a readable trace "
                                   f"({e})") from e
        try:
            files = set(self._z.files)
            if "magic" not in files or str(self._z["magic"]) != TRACE_MAGIC:
                raise TraceFormatError(f"{path}: not a {TRACE_MAGIC} file")
            self.version = int(self._z["version"])
            if self.version > TRACE_VERSION:
                raise TraceFormatError(
                    f"{path}: trace version {self.version} is newer than "
                    f"supported {TRACE_VERSION}")
            if self.version == 1:
                missing = [c for c in _COLUMNS if c not in files]
                if missing:
                    raise TraceFormatError(
                        f"{path}: missing column(s) {missing}")
                self.chunk_sizes = None  # length known only after reading
            else:
                if "chunk_sizes" not in files:
                    raise TraceFormatError(f"{path}: missing chunk_sizes")
                self.chunk_sizes = self._z["chunk_sizes"].astype(np.int64)
                missing = [f"{c}_{i:08d}"
                           for i in range(len(self.chunk_sizes))
                           for c in _COLUMNS
                           if f"{c}_{i:08d}" not in files]
                if missing:
                    raise TraceFormatError(
                        f"{path}: missing chunk member(s) {missing[:4]}")
        except Exception:
            self._z.close()
            raise

    @property
    def n_chunks(self) -> int:
        return 1 if self.chunk_sizes is None else len(self.chunk_sizes)

    def chunks(self):
        """Yield the trace as ``ServingTrace`` pieces, in stream order."""
        if self.chunk_sizes is None:
            yield ServingTrace(*(self._z[c] for c in _COLUMNS))
            return
        for i in range(len(self.chunk_sizes)):
            yield ServingTrace(*(self._z[f"{c}_{i:08d}"] for c in _COLUMNS))

    def close(self) -> None:
        self._z.close()

    def __enter__(self) -> "TraceReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_trace(path: str) -> TraceReader:
    """Open a trace for chunked streaming (see ``TraceReader``)."""
    return TraceReader(path)


def load_trace_or_exit(path: str) -> ServingTrace:
    """CLI loader shared by the examples: exit code 2 on unknown or
    incompatible trace paths — the same contract as benchmarks/run.py's
    unknown ``--only`` sections."""
    import sys

    try:
        return ServingTrace.load(path)
    except (FileNotFoundError, TraceFormatError) as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)


class TraceRecorder:
    """Accumulates a timestamped event stream (DESIGN.md §8.2).

    Live events are stamped with a monotonic clock relative to the first
    recorded event; ``extend_from_log`` bulk-appends a pre-built EventLog
    with synthetic (or caller-supplied) timestamps.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0: float | None = None
        self._kind: list[int] = []
        self._src: list[int] = []
        self._dst: list[int] = []
        self._w: list[float] = []
        self._t: list[float] = []

    def __len__(self) -> int:
        return len(self._kind)

    def _stamp(self) -> float:
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        # never step backwards: mixing live stamps with a synthetic
        # ``extend_from_log`` ramp must keep the trace monotone
        return max(now - self._t0, self._t[-1] if self._t else 0.0)

    def _push(self, kind: int, src: int, dst: int, w: float) -> None:
        self._kind.append(kind)
        self._src.append(int(src))
        self._dst.append(int(dst))
        self._w.append(float(w))
        self._t.append(self._stamp())

    def add(self, u: int, v: int, w: float) -> None:
        self._push(ev.ADD, u, v, w)

    def delete(self, u: int, v: int) -> None:
        self._push(ev.DEL, u, v, 0.0)

    def query(self, source: int = -1) -> None:
        self._push(ev.QUERY, source, -1, 0.0)

    def extend_from_log(self, log: ev.EventLog,
                        t: np.ndarray | None = None,
                        events_per_s: float = 1e6) -> None:
        """Append a whole EventLog; timestamps default to a uniform ramp
        continuing from the last recorded stamp."""
        base = self._t[-1] if self._t else 0.0
        if t is None:
            t = base + (np.arange(1, len(log) + 1, dtype=np.float64)
                        / float(events_per_s))
        if self._t0 is None:
            self._t0 = self._clock()
        self._kind.extend(int(k) for k in log.kind)
        self._src.extend(int(s) for s in log.src)
        self._dst.extend(int(d) for d in log.dst)
        self._w.extend(float(x) for x in log.w)
        self._t.extend(float(x) for x in t)

    def trace(self) -> ServingTrace:
        return ServingTrace(np.asarray(self._kind, np.uint8),
                            np.asarray(self._src, np.int64),
                            np.asarray(self._dst, np.int64),
                            np.asarray(self._w, np.float32),
                            np.asarray(self._t, np.float64))
