"""Fixed-bucket log2 histograms for the telemetry layer (DESIGN.md §10.6);
torch rendering of ``repro.obs.hist`` (the host half is a copy).

The counter registry (§10.1) already gives us lazily-``+``-folded device
values read back in ONE ``snapshot()`` device->host copy.  Histograms reuse
that machinery verbatim: a histogram is just a counter whose value is an [B]
(or [S, B] per-lane) count vector, and a sample is a one-hot vector added
with the same lazy ``+`` fold.  Nothing here ever reads a device value —
the §2.4 no-host-sync discipline holds by construction.

Bucketing is fixed log2: bucket 0 holds samples < 1, bucket ``i`` (for
``1 <= i < B-1``) holds ``[2^(i-1), 2^i)``, and the last bucket is
open-ended.  With ``NUM_BUCKETS = 24`` the top finite edge is 2^22 ≈ 4.2M,
which covers microsecond latencies up to ~4 s, wave counts, message
volumes, and frontier sizes at paper scale without configuration.

Percentiles are *estimates*: cumulative counts locate the bucket, then we
interpolate linearly inside its ``[lo, hi)`` span.  That is the standard
Prometheus ``histogram_quantile`` semantics, and with log2 buckets the
relative error is bounded by 2x — good enough to rank tails, which is all
a fixed-bucket histogram promises.

Host-side twins (``one_hot_np``/in-place ``fold_np``) exist for samples
that are born on the host (query wall-clock latency); host and device
counts for the same registry name merge transparently in ``snapshot()``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Mapping

import numpy as np
import torch

NUM_BUCKETS = 24

# registry-name prefix marking a counter as a histogram count vector;
# summarize()/the exporters key off it
HIST_PREFIX = "hist_"


# ---------------------------------------------------------------------------
# bucket geometry (host; pure python — shared by estimates and exporters)

def bucket_lo(i: int) -> float:
    """Inclusive lower bound of bucket ``i``."""
    return 0.0 if i == 0 else float(2 ** (i - 1))


def bucket_hi(i: int, num_buckets: int = NUM_BUCKETS) -> float:
    """Exclusive upper bound of bucket ``i`` (inf for the last bucket)."""
    return math.inf if i >= num_buckets - 1 else float(2 ** i)


def edges(num_buckets: int = NUM_BUCKETS) -> list[float]:
    """Upper bucket edges, Prometheus ``le`` style (last is +inf)."""
    return [bucket_hi(i, num_buckets) for i in range(num_buckets)]


# ---------------------------------------------------------------------------
# sampling — device

def bucket_index(value) -> torch.Tensor:
    """Device bucket index of ``value`` (a tensor of any numeric dtype, or
    anything ``torch.as_tensor`` takes), computed exactly from each
    sample's binary exponent: for ``v >= 1`` written ``m * 2**e`` with
    ``m`` in [0.5, 1), ``floor(log2(v)) + 1 == e``.  Integers and halves
    are widened to f64 (exact), f32 and f64 keep their own precision.
    Everything below 1, NaN included, lands in bucket 0; +inf in the last.

    The reference takes an f32 ``log2`` instead, and XLA's rendering of it
    misplaces some powers of two and their neighbours (8192 and 32768 go
    one bucket low, 2^21 - 1 and 2^22 - 1 one bucket high, on XLA:CPU);
    here every sample lands where ``bucket_index_np`` puts it."""
    v = torch.as_tensor(value)
    if v.dtype not in (torch.float32, torch.float64):
        v = v.to(torch.float64)
    _, exp = torch.frexp(v)
    idx = torch.where(v >= 1.0, exp.to(torch.int64), 0)
    idx = torch.where(v == math.inf, NUM_BUCKETS - 1, idx)
    return idx.clamp(0, NUM_BUCKETS - 1)


def one_hot(value, num_buckets: int = NUM_BUCKETS) -> torch.Tensor:
    """Device count vector (i64[B]) of a sample.  A scalar ``value`` yields
    one sample; a tensor of any shape yields one sample per element, all
    counted into the same [B] vector — the batched engines' [S] stats and
    a stack of pending samples fold straight in."""
    idx = bucket_index(value).reshape(-1).clamp(max=num_buckets - 1)
    # index_add_, not bincount: bincount sizes its output from the
    # largest index, which is a device->host read on the card
    return torch.zeros(num_buckets, dtype=torch.int64,
                       device=idx.device).index_add_(0, idx,
                                                     torch.ones_like(idx))


# ---------------------------------------------------------------------------
# sampling — host

def bucket_index_np(value: float) -> int:
    """Host twin of :func:`bucket_index` for a python/numpy scalar."""
    v = float(value)
    if not v >= 1.0:  # also catches nan
        return 0
    return min(int(math.floor(math.log2(v))) + 1, NUM_BUCKETS - 1)


def one_hot_np(value: float, num_buckets: int = NUM_BUCKETS) -> np.ndarray:
    """Host one-hot count vector (int64) for one sample."""
    counts = np.zeros(num_buckets, np.int64)
    counts[bucket_index_np(value)] = 1
    return counts


def zeros_np(num_buckets: int = NUM_BUCKETS) -> np.ndarray:
    return np.zeros(num_buckets, np.int64)


def fold_np(counts: np.ndarray, value: float) -> None:
    """In-place host fold of one sample (the serving replayer's per-source
    accumulators use this to avoid a fresh one-hot alloc per query)."""
    counts[bucket_index_np(value)] += 1


# ---------------------------------------------------------------------------
# reading — merge / totals / percentile estimates

def merge(*counts: Iterable) -> np.ndarray:
    """Elementwise sum of count vectors (host).  Merging is exact — counts
    are additive — which is why the sharded engine can fold per-partition
    and the serving layer can pool per-source histograms losslessly."""
    acc = None
    for c in counts:
        a = np.asarray(c, np.int64)
        acc = a.copy() if acc is None else acc + a
    if acc is None:
        return zeros_np()
    return acc


def total(counts) -> int:
    """Number of samples in a count vector (or all rows of an [S, B])."""
    return int(np.sum(np.asarray(counts)))


def percentile(counts, q: float) -> float:
    """Estimated q-th percentile (0..100) of a 1-D count vector.  Empty
    histogram -> nan.  Linear interpolation inside the located bucket; the
    open-ended last bucket reports its lower bound (no upper edge to
    interpolate toward)."""
    c = np.asarray(counts, np.float64).reshape(-1)
    n = c.sum()
    if n <= 0:
        return float("nan")
    target = n * (q / 100.0)
    cum = 0.0
    for i, ci in enumerate(c):
        if ci <= 0:
            continue
        if cum + ci >= target:
            lo, hi = bucket_lo(i), bucket_hi(i, c.size)
            if not math.isfinite(hi):
                return lo
            frac = (target - cum) / ci
            return lo + frac * (hi - lo)
        cum += ci
    return bucket_lo(int(np.nonzero(c)[0][-1]))


def summary(counts) -> Dict[str, Any]:
    """Count + p50/p95/p99 estimates for one count vector.  2-D [S, B]
    per-lane histograms report per-row percentile lists plus the pooled
    estimate of the merged rows."""
    a = np.asarray(counts)
    if a.ndim == 2:
        pooled = a.sum(axis=0)
        return {
            "counts": a.tolist(),
            "count": total(a),
            "p50": percentile(pooled, 50.0),
            "p95": percentile(pooled, 95.0),
            "p99": percentile(pooled, 99.0),
            "per_row_p50": [percentile(row, 50.0) for row in a],
            "per_row_p99": [percentile(row, 99.0) for row in a],
        }
    return {
        "counts": a.reshape(-1).tolist(),
        "count": total(a),
        "p50": percentile(a, 50.0),
        "p95": percentile(a, 95.0),
        "p99": percentile(a, 99.0),
    }


def summarize(counters: Mapping[str, Any],
              prefix: str = HIST_PREFIX) -> Dict[str, Dict[str, Any]]:
    """Extract every ``hist_*`` counter from a registry snapshot into
    ``{name-without-prefix: summary}``.  Non-array values under the prefix
    are ignored (defensive: a scalar named ``hist_...`` is not a
    histogram)."""
    out: Dict[str, Dict[str, Any]] = {}
    for key, value in counters.items():
        if not key.startswith(prefix):
            continue
        a = np.asarray(value)
        if a.ndim == 0:
            continue
        out[key[len(prefix):]] = summary(a)
    return out
