"""Metrics export: Prometheus text, streaming JSONL, live HTTP (§10.7);
copied from ``repro.obs.export``.  The metric names and the text format
are the reference's, so either package's parser reads the other's text.

One uniform surface for everything the telemetry layer knows how to
read: a ``metrics_snapshot()`` dict (flat counters + histograms +
attribution, see ``StreamEngineBase.metrics_snapshot``) renders to

  * **Prometheus text exposition** — scalars as counters, dimension-tagged
    vectors as labeled series (``{partition="3"}`` / ``{lane="1"}``), and
    ``hist_*`` count vectors as native Prometheus histograms (cumulative
    ``_bucket{le=...}`` series ending in ``+Inf``, plus ``_count``).
  * **streaming JSONL** — one self-describing JSON object per dump
    (monotonic ``seq``, wall-clock ``t_s``, the snapshot), append-only so
    a long-running serve can be tailed.
  * an optional **stdlib ``http.server`` endpoint** serving ``/metrics``
    (Prometheus text) and ``/metrics.json`` for live scraping — a daemon
    thread, port 0 picks a free port, nothing to install.

Everything is pull-from-snapshot: exporting calls ``snapshot_fn`` which
calls ``metrics_snapshot()`` which performs the counters' single
device->host copy.  Export frequency therefore *is* the read-back
frequency — scraping every 15 s costs one copy every 15 s and nothing in
between.

``parse_prometheus_text`` is the inverse of the text renderer for the
round-trip tests; it is deliberately small (gauge/counter samples with
optional labels), not a general OpenMetrics parser.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Tuple

import numpy as np

from repro_torch.obs import hist as hist_mod

__all__ = [
    "JsonlMetricsWriter",
    "MetricsServer",
    "parse_prometheus_text",
    "prometheus_lines",
    "prometheus_text",
    "write_prometheus",
]

# snapshot keys whose values are scalar metrics at the top level
_TOP_SCALARS = ("epochs", "adds", "dels", "rounds", "messages")


def _fmt(v: float) -> str:
    """Prometheus sample value: integers stay integral, inf -> +Inf."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def _san(name: str) -> str:
    """Metric-name-safe identifier."""
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def prometheus_lines(snapshot: Mapping[str, Any],
                     prefix: str = "repro_") -> list[str]:
    """Render a ``metrics_snapshot()`` dict to Prometheus text lines."""
    lines: list[str] = []
    dims: Dict[str, str] = {}
    for dim, named in (snapshot.get("attribution") or {}).items():
        for name in named:
            dims[name] = dim

    def emit(name: str, kind: str, samples: Iterable[Tuple[str, float]],
             help_: str = "") -> None:
        full = prefix + _san(name)
        if help_:
            lines.append(f"# HELP {full} {help_}")
        lines.append(f"# TYPE {full} {kind}")
        for labels, value in samples:
            lines.append(f"{full}{labels} {_fmt(value)}")

    for key in _TOP_SCALARS:
        if key in snapshot and np.ndim(snapshot[key]) == 0:
            emit(key, "counter", [("", float(snapshot[key]))])

    for name, value in sorted((snapshot.get("counters") or {}).items()):
        a = np.asarray(value)
        if name.startswith(hist_mod.HIST_PREFIX) and a.ndim >= 1:
            counts = a.sum(axis=0) if a.ndim == 2 else a
            base = _san(name)
            full = prefix + base
            lines.append(f"# TYPE {full} histogram")
            cum = 0
            for i, ci in enumerate(np.asarray(counts).reshape(-1)):
                cum += int(ci)
                le = _fmt(hist_mod.bucket_hi(i, int(np.size(counts))))
                lines.append(f'{full}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{full}_count {cum}")
            continue
        if a.ndim == 0:
            emit(name, "counter", [("", float(a))])
        else:
            dim = dims.get(name, "index")
            if a.ndim == 1:
                emit(name, "counter",
                     [(f'{{{_san(dim)}="{i}"}}', float(v))
                      for i, v in enumerate(a)])
            # 2-D non-histogram vectors have no natural label scheme; the
            # JSONL export carries them verbatim instead

    spans = snapshot.get("spans") or {}
    for name, count in sorted(spans.items()):
        emit(f"span_{name}_total", "counter", [("", float(count))])

    for hname, summ in sorted((snapshot.get("histograms") or {}).items()):
        for q in ("p50", "p95", "p99"):
            if q in summ:
                emit(f"{hname}_{q}", "gauge", [("", float(summ[q]))])
    return lines


def prometheus_text(snapshot: Mapping[str, Any],
                    prefix: str = "repro_") -> str:
    return "\n".join(prometheus_lines(snapshot, prefix)) + "\n"


def write_prometheus(path: str, snapshot: Mapping[str, Any],
                     prefix: str = "repro_") -> None:
    with open(path, "w") as fh:
        fh.write(prometheus_text(snapshot, prefix))


def parse_prometheus_text(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str],
                                                             ...], float]]:
    """Parse exposition text back into ``{metric: {labelset: value}}``
    where ``labelset`` is a sorted tuple of (label, value) pairs (empty
    tuple for unlabeled samples).  The round-trip oracle for the renderer
    above."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            label_body = rest.rstrip("}")
            labels = []
            for item in label_body.split(","):
                if not item:
                    continue
                k, _, v = item.partition("=")
                labels.append((k.strip(), v.strip().strip('"')))
            key = tuple(sorted(labels))
        else:
            name, key = name_part, ()
        value_part = value_part.strip()
        if value_part == "+Inf":
            value = math.inf
        elif value_part == "-Inf":
            value = -math.inf
        else:
            value = float(value_part)
        out.setdefault(name, {})[key] = value
    return out


class JsonlMetricsWriter:
    """Append-only JSONL metrics stream: one JSON object per ``dump()``
    with a monotonic ``seq`` and wall-clock ``t_s``.  ``snapshot_fn`` is
    typically ``engine.metrics_snapshot`` — each dump is one read-back."""

    def __init__(self, path: str, snapshot_fn: Callable[[], Mapping[str, Any]]):
        self.path = path
        self.snapshot_fn = snapshot_fn
        self.seq = 0

    def dump(self) -> dict:
        from repro_torch.obs import _jsonable
        rec = {"seq": self.seq, "t_s": time.time(),
               "metrics": _jsonable(dict(self.snapshot_fn()))}
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        self.seq += 1
        return rec


class MetricsServer:
    """Live scrape endpoint on stdlib ``http.server``: ``GET /metrics``
    returns Prometheus text, ``GET /metrics.json`` the JSON snapshot.
    Runs in a daemon thread; ``port=0`` binds a free port (read it back
    from ``.port``).  Intended for examples and long-running serves — the
    snapshot is taken per request, so an idle server costs nothing."""

    def __init__(self, snapshot_fn: Callable[[], Mapping[str, Any]],
                 host: str = "127.0.0.1", port: int = 0,
                 prefix: str = "repro_"):
        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                try:
                    if self.path in ("/metrics", "/"):
                        body = prometheus_text(outer.snapshot_fn(),
                                               outer.prefix).encode()
                        ctype = "text/plain; version=0.0.4"
                    elif self.path == "/metrics.json":
                        from repro_torch.obs import _jsonable
                        body = json.dumps(
                            _jsonable(dict(outer.snapshot_fn()))).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as exc:  # pragma: no cover - defensive
                    self.send_error(500, repr(exc))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self.snapshot_fn = snapshot_fn
        self.prefix = prefix
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro_torch-obs-metrics",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)
