"""Real-dataset loader, offline part: SNAP / Konect edge lists -> the
serving trace format (DESIGN.md §11.3); copied from
``repro.graphs.datasets`` without its download cache (``fetch_dataset``
and the named registry): the port reads local files only.

The paper evaluates on real-world graphs; Hanauer et al.'s dynamic studies
(PAPERS.md) build update streams from exactly these repositories.  This
module reads the common interchange format — whitespace/tab-separated
``u v [w ...]`` rows with ``#`` (SNAP) or ``%`` (Konect) comment lines,
optionally gzipped — and lowers it to a serving trace:

  1. parse the static edge list (ids may be arbitrary non-negative int64);
  2. compact ids to ``[0, n)`` deterministically (sorted unique order);
  3. synthesize the dynamic portion with the paper's sliding-window model
     (graphs/window.py): edge arrival order is the temporal order, a
     seeded rng decides which edges die when they exit the window — fully
     deterministic for a given (file, window, delta, seed).

Rows with fewer than two columns are malformed (``DatasetFormatError``);
a third numeric column is the weight (Konect weighted/TSV), further
columns (e.g. Konect timestamps) are ignored.  Unweighted rows get
deterministic synthetic weights in [0.5, 1.5).  The same file gives the
same trace as the reference's loader.
"""
from __future__ import annotations

import gzip
import sys

import numpy as np

from repro_torch.graphs import window as window_mod
from repro_torch.serving.trace import ServingTrace

_COMMENT = ("#", "%")
_PARSE_BLOCK = 1 << 20  # lines per parse block (bounds Python-object churn)


class DatasetFormatError(ValueError):
    """The file exists but is not a parseable edge list."""


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def parse_edge_list(path: str, *, weight_seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a SNAP/Konect edge list into (src i64, dst i64, w f32) with
    the file's raw vertex ids.  Raises ``FileNotFoundError`` for a missing
    path and ``DatasetFormatError`` for malformed content."""
    srcs: list[np.ndarray] = []
    dsts: list[np.ndarray] = []
    ws: list[np.ndarray] = []
    n_unweighted = 0
    with _open_text(path) as f:
        block_u: list[int] = []
        block_v: list[int] = []
        block_w: list[float] = []

        def flush():
            nonlocal block_u, block_v, block_w
            if block_u:
                srcs.append(np.asarray(block_u, np.int64))
                dsts.append(np.asarray(block_v, np.int64))
                ws.append(np.asarray(block_w, np.float32))
                block_u, block_v, block_w = [], [], []

        for lineno, line in enumerate(f, 1):
            s = line.strip()
            if not s or s.startswith(_COMMENT):
                continue
            cols = s.split()
            if len(cols) < 2:
                raise DatasetFormatError(
                    f"{path}:{lineno}: expected 'u v [w]' columns, got "
                    f"{s!r}")
            try:
                u, v = int(cols[0]), int(cols[1])
                w = float(cols[2]) if len(cols) > 2 else -1.0
            except ValueError as e:
                raise DatasetFormatError(
                    f"{path}:{lineno}: non-numeric edge row {s!r}") from e
            if w < 0:
                # missing or non-positive weight -> synthesize below
                w = -1.0
                n_unweighted += 1
            block_u.append(u)
            block_v.append(v)
            block_w.append(w)
            if len(block_u) >= _PARSE_BLOCK:
                flush()
        flush()
    if not srcs:
        raise DatasetFormatError(f"{path}: no edge rows found")
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    w = np.concatenate(ws)
    if n_unweighted:
        # deterministic synthetic weights (seeded, index-addressed) for
        # unweighted datasets — the paper's instances are weighted
        rng = np.random.default_rng(weight_seed)
        synth = rng.uniform(0.5, 1.5, len(w)).astype(np.float32)
        w = np.where(w < 0, synth, w)
    if src.min() < 0 or dst.min() < 0:
        raise DatasetFormatError(f"{path}: negative vertex ids")
    return src, dst, w.astype(np.float32)


def compact_ids(src: np.ndarray, dst: np.ndarray
                ) -> tuple[int, np.ndarray, np.ndarray]:
    """Relabel raw ids to [0, n) in sorted-unique order (deterministic for
    a given edge set, independent of row order)."""
    ids = np.unique(np.concatenate([src, dst]))
    return (len(ids), np.searchsorted(ids, src).astype(np.int64),
            np.searchsorted(ids, dst).astype(np.int64))


def dataset_to_trace(path: str, *, window_frac: float = 0.25,
                     delta: float = 0.3, seed: int = 0,
                     query_every: int = 0, events_per_s: float = 1e6
                     ) -> tuple[int, ServingTrace]:
    """Load an edge list and synthesize the dynamic trace; returns
    ``(num_vertices, trace)``.  ``window_frac`` is the sliding-window size
    as a fraction of the edge count; ``delta`` the deletion probability
    for edges falling out of the window (paper §5.1.3)."""
    if not 0.0 < window_frac <= 1.0:
        raise ValueError(f"window_frac must be in (0, 1]; got {window_frac}")
    src, dst, w = parse_edge_list(path, weight_seed=seed)
    n, src, dst = compact_ids(src, dst)
    log = window_mod.sliding_window_stream(
        src, dst, w, window=max(1, int(len(src) * window_frac)),
        delta=delta, seed=seed, query_every=query_every)
    return n, ServingTrace.from_log(log, events_per_s=events_per_s)


def load_dataset_or_exit(path: str, **kw) -> tuple[int, ServingTrace]:
    """CLI wrapper: exit code 2 on missing or malformed dataset paths —
    the same contract as serving.trace.load_trace_or_exit.  Only local
    files: a url exits 2 as well."""
    try:
        if "://" in path:
            raise FileNotFoundError(
                f"{path}: only local edge-list files are read")
        return dataset_to_trace(path, **kw)
    except (FileNotFoundError, DatasetFormatError) as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)
