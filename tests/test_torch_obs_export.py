"""The port's metrics export (``repro_torch.obs.export``) — the
single-engine half of tests/test_obs_export.py, plus the two packages
reading each other's text.

The round-trip contract: everything the renderer emits parses back
bit-equal through ``parse_prometheus_text`` — scalar counters, the lane
attribution vectors, native histogram ``_bucket`` series (cumulative,
ending in ``+Inf``) whose final count equals the engine's flat counter,
and the p50/p95/p99 gauges.  The Prometheus text of a port engine and of
the JAX engine on the same stream parse to the same series (the clocked
ones — wall times, latencies — by name only), each package's parser
reading the other's text.  The HTTP server is exercised over a socket on
localhost with stdlib urllib only.

Inputs are made from seeds with numpy.  Tolerance: 0.
"""
import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.graphs import generators, window
from repro.obs import export as jexport
from repro_torch import EngineConfig, SSSPDelEngine
from repro_torch.obs import hist
from repro_torch.obs.export import (JsonlMetricsWriter, MetricsServer, _fmt,
                                    parse_prometheus_text, prometheus_text,
                                    write_prometheus)

SOURCES = (0, 5, 9)


def _stream():
    n, src, dst, w = generators.erdos_renyi(64, 256, seed=9)
    log = window.sliding_window_stream(src, dst, w, window=128, delta=0.5,
                                       seed=9, query_every=128)
    return n, len(src) + 64, log


def _engine(jax=False, **kw):
    n, cap, log = _stream()
    eng = (JaxEngine(JaxConfig(n, cap, 0, observability=True, **kw)) if jax
           else SSSPDelEngine(EngineConfig(n, cap, 0, observability=True,
                                           device="cpu", **kw)))
    eng.ingest_log(log)
    eng.query()
    if kw.get("sources"):
        for s in (SOURCES[0], SOURCES[2], SOURCES[2]):
            eng.query(source=s)
    return eng


def test_prometheus_text_round_trips_scalars_and_histograms():
    eng = _engine()
    snap = eng.metrics_snapshot()
    parsed = parse_prometheus_text(prometheus_text(snap))
    for key in ("epochs", "rounds", "messages"):
        assert parsed[f"repro_{key}"][()] == float(snap[key])
    for name, value in snap["counters"].items():
        if np.ndim(value) == 0:
            assert parsed[f"repro_{name}"][()] == float(value)
    ct = snap["counters"]
    buckets = parsed["repro_hist_latency_us_bucket"]
    les = sorted(float(k[0][1]) if k[0][1] != "+Inf" else math.inf
                 for k in buckets)
    assert len(les) == hist.NUM_BUCKETS and les[-1] == math.inf
    cums = [v for _, v in sorted(
        buckets.items(),
        key=lambda kv: float(kv[0][0][1]) if kv[0][0][1] != "+Inf"
        else math.inf)]
    assert cums == sorted(cums)
    assert parsed["repro_hist_latency_us_count"][()] == float(ct["queries"])
    assert parsed["repro_hist_messages_per_epoch_count"][()] == float(
        ct["add_epochs"] + ct["del_epochs"])
    assert "repro_latency_us_p50" in parsed


def test_prometheus_labels_carry_lane_attribution():
    eng = _engine(sources=SOURCES)
    snap = eng.metrics_snapshot()
    parsed = parse_prometheus_text(prometheus_text(snap))
    series = parsed["repro_queries_per_lane"]
    assert set(series) == {(("lane", str(i)),) for i in range(len(SOURCES))}
    assert sum(series.values()) == 3.0
    # the [S, B] per-lane latency rows render as one pooled histogram
    assert parsed["repro_hist_latency_us_per_lane_count"][()] == 3.0


def _unclocked(parsed: dict) -> dict:
    """The parsed series whose values are not clock readings."""
    clocked = ("latency_us", "wall_us")
    return {k: v for k, v in parsed.items()
            if not any(c in k for c in clocked)}


@pytest.mark.parametrize("kw", [dict(), dict(sources=SOURCES),
                                dict(wave_schedule="buckets",
                                     relax_backend="ellpack", ell_init_k=2)],
                         ids=["single", "lanes", "buckets-ellpack"])
def test_port_and_reference_texts_parse_alike_both_ways(kw):
    """Each package's parser reads the other's text; both texts carry the
    same metric names, and every series that is not a clock reading has
    the same labels and values."""
    texts = [prometheus_text(_engine(jax=j, **kw).metrics_snapshot())
             for j in (False, True)]
    port_text, jax_text = texts
    for parse in (parse_prometheus_text, jexport.parse_prometheus_text):
        got, want = parse(port_text), parse(jax_text)
        assert got.keys() == want.keys()
        assert _unclocked(got) == _unclocked(want)
    assert parse_prometheus_text(jax_text) == \
        jexport.parse_prometheus_text(jax_text)
    assert jexport.parse_prometheus_text(port_text) == \
        parse_prometheus_text(port_text)


def test_prometheus_inf_nan_formatting():
    assert _fmt(math.inf) == "+Inf" and _fmt(-math.inf) == "-Inf"
    assert _fmt(float("nan")) == "NaN"
    assert _fmt(3.0) == "3" and _fmt(2.5) == "2.5"
    t = parse_prometheus_text('m_bucket{le="+Inf"} 4\nm2 NaN\n')
    assert t["m_bucket"][(("le", "+Inf"),)] == 4.0
    assert math.isnan(t["m2"][()])


def test_write_prometheus_file(tmp_path):
    eng = _engine()
    path = str(tmp_path / "metrics.prom")
    write_prometheus(path, eng.metrics_snapshot())
    parsed = parse_prometheus_text(open(path).read())
    assert parsed["repro_epochs"][()] == float(eng.n_epochs)


def test_jsonl_writer_appends_sequenced_snapshots(tmp_path):
    eng = _engine()
    path = str(tmp_path / "metrics.jsonl")
    wr = JsonlMetricsWriter(path, eng.metrics_snapshot)
    wr.dump()
    eng.query()
    wr.dump()
    lines = [json.loads(ln) for ln in open(path)]
    assert [ln["seq"] for ln in lines] == [0, 1]
    q0 = lines[0]["metrics"]["counters"]["queries"]
    q1 = lines[1]["metrics"]["counters"]["queries"]
    assert q1 == q0 + 1
    assert lines[1]["metrics"]["histograms"]["latency_us"]["count"] == q1


def test_metrics_server_serves_text_and_json():
    eng = _engine()
    srv = MetricsServer(eng.metrics_snapshot, port=0)
    try:
        body = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        parsed = parse_prometheus_text(body)
        assert parsed["repro_epochs"][()] == float(eng.n_epochs)
        jurl = srv.url.rsplit("/", 1)[0] + "/metrics.json"
        js = json.loads(
            urllib.request.urlopen(jurl, timeout=10).read().decode())
        assert js["counters"]["queries"] == parsed["repro_queries"][()]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                srv.url.rsplit("/", 1)[0] + "/nope", timeout=10)
    finally:
        srv.close()
