"""Real-dataset loader: SNAP / Konect edge lists -> the serving trace
format (DESIGN.md §11.3); copied from ``repro.graphs.datasets``, the
verified download cache included.

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
     deterministic for a given (file, window, delta, seed);
  4. write a version-2 chunked trace replayable at O(chunk) host memory.

Rows with fewer than two columns are malformed (``DatasetFormatError``);
a third numeric column is the weight (Konect weighted/TSV), further
columns (e.g. Konect timestamps) are ignored.  Unweighted rows get
deterministic synthetic weights in [0.5, 1.5).  The same file gives the
same trace as the reference's loader.

Named datasets (``DATASETS``) and urls go through a sha256-verified cache
shared with the reference (the same ``REPRO_DATASET_CACHE`` variable and
default directory); ``file://`` urls need no network.

CLI (bad paths, urls that cannot be read and checksum mismatches exit 2,
matching the examples' convention):

    PYTHONPATH=src python -m repro_torch.graphs.datasets IN OUT.npz \
        [--window-frac 0.25] [--delta 0.3] [--seed 0] \
        [--query-every 0] [--chunk-events 65536]
"""
from __future__ import annotations

import gzip
import hashlib
import os
import sys
import urllib.error
import urllib.request

import numpy as np

from repro_torch.graphs import window as window_mod
from repro_torch.serving.trace import ServingTrace

_COMMENT = ("#", "%")
_PARSE_BLOCK = 1 << 20  # lines per parse block (bounds Python-object churn)

# Known dataset registry: name -> (url, sha256-or-None).  A None digest is
# trust-on-first-use: the first fetch records the digest in a ``.sha256``
# sidecar next to the cached file and every later use verifies against it,
# so a silent corruption or an upstream content swap fails loudly.
DATASETS: dict[str, tuple[str, str | None]] = {
    # the paper's real graphs (SNAP)
    "soc-livejournal1": (
        "https://snap.stanford.edu/data/soc-LiveJournal1.txt.gz", None),
    "roadnet-ca": (
        "https://snap.stanford.edu/data/roadNet-CA.txt.gz", None),
}

_CHUNK = 1 << 20


class DatasetFormatError(ValueError):
    """The file exists but is not a parseable edge list."""


class ChecksumError(ValueError):
    """A cached or downloaded dataset failed sha256 verification."""


def dataset_cache_dir() -> str:
    """The on-disk download cache root; ``REPRO_DATASET_CACHE`` overrides
    the default ``~/.cache/repro/datasets`` (the reference's, so one
    verified cache serves both packages)."""
    return os.environ.get(
        "REPRO_DATASET_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro", "datasets"))


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(_CHUNK), b""):
            h.update(block)
    return h.hexdigest()


def fetch_dataset(name_or_url: str, *, sha256: str | None = None,
                  cache_dir: str | None = None) -> str:
    """Return a local path to the (cached) dataset, downloading on miss.

    ``name_or_url`` is either a ``DATASETS`` registry key (its url + pinned
    digest are used) or a raw url (``file://`` works with no network).
    Verification order: an explicit ``sha256`` argument beats the registry
    pin beats the sidecar digest recorded at first fetch.  A mismatch
    raises ``ChecksumError`` and leaves the offending file in place for
    inspection; downloads land in a ``.part`` file renamed into place, so
    a crashed fetch never poisons the cache."""
    url, expected = name_or_url, sha256
    if name_or_url in DATASETS:
        url, pinned = DATASETS[name_or_url]
        expected = sha256 if sha256 is not None else pinned
    cache = cache_dir or dataset_cache_dir()
    os.makedirs(cache, exist_ok=True)
    fname = os.path.basename(url.rstrip("/")) or "dataset"
    path = os.path.join(cache, fname)
    sidecar = path + ".sha256"
    if not os.path.exists(path):
        tmp = path + ".part"
        with urllib.request.urlopen(url) as r, open(tmp, "wb") as out:
            for block in iter(lambda: r.read(_CHUNK), b""):
                out.write(block)
        os.replace(tmp, path)
    digest = _sha256_file(path)
    if expected is None and os.path.exists(sidecar):
        with open(sidecar) as f:
            expected = f.read().strip() or None
    if expected is not None and digest != expected:
        raise ChecksumError(
            f"{path}: sha256 mismatch — expected {expected}, got {digest} "
            f"(delete the cached file to re-fetch)")
    if not os.path.exists(sidecar):
        with open(sidecar, "w") as f:
            f.write(digest + "\n")
    return path


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


def load_named_dataset(name_or_url: str, *, sha256: str | None = None,
                       cache_dir: str | None = None, **kw
                       ) -> tuple[int, ServingTrace]:
    """``fetch_dataset`` + ``dataset_to_trace`` in one call."""
    path = fetch_dataset(name_or_url, sha256=sha256, cache_dir=cache_dir)
    return dataset_to_trace(path, **kw)


def load_dataset_or_exit(path: str, **kw) -> tuple[int, ServingTrace]:
    """CLI wrapper: exit code 2 on missing or malformed dataset paths —
    the same contract as serving.trace.load_trace_or_exit.  Registry names
    and raw urls fetch through the verified cache first."""
    try:
        if path in DATASETS or "://" in path:
            return load_named_dataset(path, **kw)
        return dataset_to_trace(path, **kw)
    except (FileNotFoundError, DatasetFormatError, ChecksumError,
            urllib.error.URLError) as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.graphs.datasets",
        description="SNAP/Konect edge list -> chunked serving trace")
    ap.add_argument("edge_list", help="input edge list (.gz ok)")
    ap.add_argument("out", help="output trace path (npz container)")
    ap.add_argument("--window-frac", type=float, default=0.25)
    ap.add_argument("--delta", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--query-every", type=int, default=0)
    ap.add_argument("--chunk-events", type=int, default=65536,
                    help="events per chunk in the version-2 container")
    args = ap.parse_args(argv)
    n, trace = load_dataset_or_exit(
        args.edge_list, window_frac=args.window_frac, delta=args.delta,
        seed=args.seed, query_every=args.query_every)
    trace.save(args.out, chunk_events=args.chunk_events)
    stats = window_mod.stream_stats(trace.to_log())
    print(f"{args.edge_list}: n={n} -> {args.out} "
          f"(adds={stats['adds']} dels={stats['dels']} "
          f"queries={stats['queries']}, chunks of {args.chunk_events})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
