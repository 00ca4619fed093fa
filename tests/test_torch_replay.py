"""The port's serving layer (``repro_torch.serving``) and offline dataset
loader against the JAX package's — the single-host parts of
tests/test_serving.py (trace record/replay, the report's metrics, the
load-error contract, the example's exit codes), plus the two packages
sharing trace files and datasets.

  * Trace files cross in both directions: the JAX package's writer (v1
    monolithic and v2 chunked) is read by the port, the port's by the JAX
    package, column for column.
  * ``replay_trace`` on the port's engine gives the JAX replayer's
    ``ServingReport`` on the same trace, except for what is a clock
    reading (wall time, events/s, latencies): event and query counts,
    every churn sample, per-source query counts, the cold/warm query
    split, rounds and messages, and with observability on the engine's
    flat counters and span counts.
  * A chunked replay (``open_trace``) equals the in-memory one in dist and
    parent at every query; the epoch counters are compared only between
    replays of the same chunking (a run of ADDs split at a chunk boundary
    ingests as two epochs).
  * ``parse_edge_list`` / ``compact_ids`` / ``dataset_to_trace`` equal the
    reference's on local SNAP / Konect files.

The JAX engines run ``sliced_fused=False`` and ``frontier_kernel=False``.
Inputs are made from seeds with numpy.  Tolerance: 0.
"""
import gzip
import math
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.graphs import datasets as jdatasets
from repro.graphs import generators, window
from repro.serving import replay_trace as jax_replay
from repro.serving import trace as jtrace
from repro_torch import EngineConfig, SSSPDelEngine
from repro_torch.core import events as ev
from repro_torch.graphs import datasets
from repro_torch.serving import (ServingTrace, TraceFormatError,
                                 TraceRecorder, churn, load_trace_or_exit,
                                 open_trace, pctile, percentiles,
                                 replay_trace)

ROOT = Path(__file__).resolve().parents[1]
SOURCES = (3, 17, 40)
CLOCKED = ("latency_us", "wall_us")


def _stream(seed: int, *, n=72, m=320, delta=0.5):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    log = window.sliding_window_stream(src, dst, w, window=m // 3,
                                       delta=delta, seed=seed,
                                       query_every=m // 2)
    return n, len(src) + 64, log


def _multi_source_trace(log, sources, n_points=5):
    rec = TraceRecorder()
    step = max(1, len(log) // n_points)
    for a in range(0, len(log), step):
        rec.extend_from_log(log[a:a + step])
        for s in sources:
            rec.query(source=s)
    return rec.trace()


def _port(n, cap, **kw):
    return SSSPDelEngine(EngineConfig(n, cap, SOURCES[0], device="cpu",
                                      **kw))


def _replay(replay, eng, trace, **kw):
    """Replay and keep every query's (dist, parent)."""
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # ELL blowup
        rep = replay(eng, trace, on_query=lambda r: seen.append(
            (r.dist.copy(), r.parent.copy())), **kw)
    return rep, seen


def _assert_reports_match(got, want):
    """Two ServingReports of one trace: equal except for clock readings."""
    for k in ("engine", "n_sources", "events", "topology_events", "queries",
              "churn_mean", "churns"):
        assert getattr(got, k) == getattr(want, k), k
    assert len(got.latencies) == len(want.latencies) == got.queries
    assert {k: v["queries"] for k, v in got.per_source.items()} == \
        {k: v["queries"] for k, v in want.per_source.items()}
    for k in ("cold_queries", "warm_queries"):
        assert got.cold_warm[k] == want.cold_warm[k]
    gm, wm = got.engine_metrics, want.engine_metrics
    for k in ("epochs", "adds", "dels", "rounds", "messages", "spans"):
        np.testing.assert_array_equal(np.asarray(gm[k]), np.asarray(wm[k]),
                                      err_msg=k)
    assert gm["counters"].keys() == wm["counters"].keys()
    for k, v in gm["counters"].items():
        if any(c in k for c in CLOCKED):
            assert np.sum(v) == np.sum(wm["counters"][k]), k
        else:
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(wm["counters"][k]),
                                          err_msg=k)
    rec, jrec = got.to_record(), want.to_record()
    assert rec.keys() == jrec.keys()


# ------------------------------------------------------------ trace files --
@pytest.mark.parametrize("chunk_events", [None, 97],
                         ids=["v1", "v2-chunked"])
def test_trace_files_cross_between_packages(tmp_path, chunk_events):
    """A file written by either package loads in the other with every
    column equal, and streams in the same chunks."""
    n, cap, log = _stream(seed=19)
    trace = _multi_source_trace(log, SOURCES)
    jt = jtrace.ServingTrace(*(getattr(trace, c) for c in
                               ("kind", "src", "dst", "w", "t")))
    mine, theirs = str(tmp_path / "port.trace"), str(tmp_path / "jax.trace")
    trace.save(mine, chunk_events=chunk_events)
    jt.save(theirs, chunk_events=chunk_events)
    for path in (mine, theirs):
        a, b = ServingTrace.load(path), jtrace.ServingTrace.load(path)
        for col in ("kind", "src", "dst", "w", "t"):
            np.testing.assert_array_equal(getattr(a, col), getattr(trace, col))
            np.testing.assert_array_equal(getattr(b, col), getattr(trace, col))
        with open_trace(path) as r, jtrace.open_trace(path) as jr:
            sizes = [len(p) for p in r.chunks()]
            assert sizes == [len(p) for p in jr.chunks()]
            assert r.version == jr.version == (1 if chunk_events is None
                                               else 2)
        if chunk_events:
            assert len(sizes) == math.ceil(len(trace) / chunk_events)


@pytest.mark.parametrize("writer,chunk_events", [
    ("jax", None), ("jax", 97), ("port", 97)],
    ids=["jax-v1", "jax-v2", "port-v2"])
@pytest.mark.parametrize("backend,kw", [
    ("segment", dict(sources=SOURCES)),
    ("ellpack", dict(ell_init_k=2, observability=True)),
    ("sliced", dict(sliced_slice_rows=32, sliced_hub_k=4, sliced_init_k=1,
                    sources=SOURCES, wave_schedule="buckets",
                    bucket_width=0.7, observability=True)),
    ("segment", dict(frontier_mode="sparse", frontier_cap=32,
                     observability=True))],
    ids=["segment-lanes", "ellpack-obs", "sliced-lanes-buckets-obs",
         "sparse-obs"])
def test_replay_report_matches_reference(tmp_path, writer, chunk_events,
                                         backend, kw):
    """The trace file one package wrote, replayed by the port's engine and
    by the JAX engine: the same answers at every query and the same
    report, bar the clocks."""
    n, cap, log = _stream(seed=19)
    trace = _multi_source_trace(log, SOURCES)
    path = str(tmp_path / "stream.trace")
    if writer == "port":
        trace.save(path, chunk_events=chunk_events)
    else:
        jtrace.ServingTrace(*(getattr(trace, c) for c in (
            "kind", "src", "dst", "w", "t"))).save(path,
                                                   chunk_events=chunk_events)
    got, seen = _replay(replay_trace, _port(n, cap, relax_backend=backend,
                                            **kw), ServingTrace.load(path))
    want, jseen = _replay(jax_replay, JaxEngine(JaxConfig(
        n, cap, SOURCES[0], relax_backend=backend, **kw)),
        jtrace.ServingTrace.load(path))
    assert len(seen) == len(jseen) == got.queries > 0
    for (d, p), (jd, jp) in zip(seen, jseen):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(p, jp)
    _assert_reports_match(got, want)
    assert got.engine == f"single/{backend}"


def test_chunked_replay_equals_in_memory_replay(tmp_path):
    """A v2 file streamed chunk by chunk (``open_trace``) answers every
    query as the in-memory trace does; two chunked replays agree on the
    epoch counters too; the final tree passes the oracle."""
    from repro_torch.core.oracle import check_tree
    n, cap, log = _stream(seed=23)
    trace = _multi_source_trace(log, (-1,), n_points=7)
    path = str(tmp_path / "stream.trace")
    trace.save(path, chunk_events=64)
    whole, ws = _replay(replay_trace, _port(n, cap), trace)
    reps = []
    for _ in range(2):
        eng = _port(n, cap, observability=True)
        with open_trace(path) as r:
            assert r.n_chunks > 2
            reps.append(_replay(replay_trace, eng, r))
    (chunked, cs), (again, _) = reps
    assert len(cs) == len(ws) == whole.queries == chunked.queries
    for (d, p), (wd, wp) in zip(cs, ws):
        np.testing.assert_array_equal(d, wd)
        np.testing.assert_array_equal(p, wp)
    assert chunked.events == whole.events == len(trace)
    assert chunked.engine_metrics["counters"]["add_epochs"] >= \
        whole.engine_metrics["epochs"] - whole.engine_metrics["dels"]
    for k in ("epochs", "rounds", "messages", "spans"):
        assert chunked.engine_metrics[k] == again.engine_metrics[k]
    src, dst, w = eng.alloc.active_coo()
    check_tree(n, src, dst, w, SOURCES[0], cs[-1][0], cs[-1][1])


def test_trace_record_replay_roundtrip_determinism(tmp_path):
    n, cap, log = _stream(seed=19)
    trace = _multi_source_trace(log, SOURCES)
    path = str(tmp_path / "stream.trace")
    trace.save(path)
    loaded = ServingTrace.load(path)
    assert loaded.n_queries == trace.n_queries
    qsrc = set(loaded.query_sources().tolist())
    assert set(SOURCES) <= qsrc <= set(SOURCES) | {-1}
    assert np.all(np.diff(loaded.t) >= 0)
    runs = [_replay(replay_trace, _port(n, cap, sources=SOURCES), loaded)
            for _ in range(2)]
    (rep1, s1), (rep2, s2) = runs
    for (d1, p1), (d2, p2) in zip(s1, s2):
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(p1, p2)
    assert rep1.queries == rep2.queries == loaded.n_queries
    assert rep1.topology_events == loaded.n_topology
    assert all(rep1.latency_s[k] > 0 for k in ("p50", "p95", "p99"))
    assert 0.0 <= rep1.churn_mean["any"] <= 1.0
    assert rep1.churn_mean == rep2.churn_mean
    assert rep1.events_per_s > 0
    rec = rep1.to_record()
    for key in ("events_per_s", "latency_p50_ms", "latency_p95_ms",
                "latency_p99_ms", "churn_mean", "stability_parent",
                "rounds", "messages"):
        assert key in rec


def test_report_per_source_latency_and_cold_warm_split():
    n, cap, log = _stream(seed=19)
    rep, _ = _replay(replay_trace, _port(n, cap, sources=SOURCES),
                     _multi_source_trace(log, SOURCES))
    ps = rep.per_source
    assert set(SOURCES) <= set(k for k in ps if k != "*")
    assert sum(e["queries"] for e in ps.values()) == rep.queries
    for entry in ps.values():
        assert entry["queries"] >= 1 and entry["cold_ms"] > 0
        assert entry["p50_ms"] <= entry["p95_ms"] <= entry["p99_ms"]
    cw = rep.cold_warm
    assert cw["cold_queries"] == len(ps)
    assert cw["cold_queries"] + cw["warm_queries"] == rep.queries
    assert "cold" in rep.summary() and "warm" in rep.summary()


def test_paced_replay_honours_the_trace_clock():
    """``pace=True`` sleeps to each batch's timestamp: the replay takes at
    least the trace's duration, with the same answers."""
    n, cap, log = _stream(seed=29)
    trace = ServingTrace.from_log(log, events_per_s=2000.0)
    fast, fs = _replay(replay_trace, _port(n, cap), trace)
    paced, ps = _replay(replay_trace, _port(n, cap), trace, pace=True)
    assert paced.wall_s >= trace.duration_s() - 1e-3
    for (d, p), (fd, fp) in zip(ps, fs):
        np.testing.assert_array_equal(d, fd)
        np.testing.assert_array_equal(p, fp)


def test_trace_load_error_contract(tmp_path, capsys):
    with pytest.raises(FileNotFoundError):
        ServingTrace.load(str(tmp_path / "missing.trace"))
    bad = tmp_path / "bad.trace"
    bad.write_bytes(b"not a trace at all")
    with pytest.raises(TraceFormatError):
        ServingTrace.load(str(bad))
    foreign = tmp_path / "foreign.npz"
    np.savez(foreign, a=np.arange(3))
    with pytest.raises(TraceFormatError):
        ServingTrace.load(str(foreign))
    for path in (str(tmp_path / "missing.trace"), str(bad)):
        with pytest.raises(SystemExit) as ei:
            load_trace_or_exit(path)
        assert ei.value.code == 2
    assert "error:" in capsys.readouterr().err


def test_churn_and_percentile_helpers():
    prev_d = np.array([1.0, np.inf, 3.0, 4.0], np.float32)
    prev_p = np.array([0, -1, 1, 2], np.int32)
    d = np.array([1.0, np.inf, 2.5, 4.0], np.float32)
    p = np.array([0, -1, 0, 2], np.int32)
    c = churn(prev_d, prev_p, d, p)
    assert c == {"dist": 0.25, "parent": 0.25, "any": 0.25}
    for empty in ([], np.array([]), np.zeros((0, 4)), iter(())):
        assert math.isnan(pctile(empty, 50))
    assert all(math.isnan(v) for v in percentiles([]).values())
    for q in (0, 50, 99, 100):
        assert pctile([7.5], q) == pctile(7.5, q) == 7.5
    assert pctile((x for x in (1.0, 2.0, 3.0)), 50) == 2.0
    assert pctile(np.array([[1.0, 2.0], [3.0, 4.0]]), 50) == 2.5
    assert percentiles([5.0]) == {"p50": 5.0, "p95": 5.0, "p99": 5.0}


# --------------------------------------------------------------- datasets --
def _write_edge_lists(tmp_path):
    rng = np.random.default_rng(5)
    u = rng.integers(10, 10_000, 300)
    v = rng.integers(10, 10_000, 300)
    snap = tmp_path / "snap.txt"
    snap.write_text("# SNAP header\n# FromNodeId\tToNodeId\n"
                    + "".join(f"{a}\t{b}\n" for a, b in zip(u, v)))
    gz = tmp_path / "snap.txt.gz"
    with gzip.open(gz, "wt") as f:
        f.write(snap.read_text())
    konect = tmp_path / "out.konect"
    w = rng.uniform(0.1, 3.0, 300)
    konect.write_text("% sym weighted\n"
                      + "".join(f"{a} {b} {x:.4f} 1234\n"
                                for a, b, x in zip(u, v, w)))
    return [snap, gz, konect]


def test_datasets_match_reference(tmp_path):
    for path in _write_edge_lists(tmp_path):
        got = datasets.parse_edge_list(str(path), weight_seed=3)
        want = jdatasets.parse_edge_list(str(path), weight_seed=3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        ids = datasets.compact_ids(got[0], got[1])
        assert ids[0] == jdatasets.compact_ids(want[0], want[1])[0]
        n, trace = datasets.dataset_to_trace(str(path), window_frac=0.4,
                                             delta=0.5, seed=2,
                                             query_every=50)
        jn, jt = jdatasets.dataset_to_trace(str(path), window_frac=0.4,
                                            delta=0.5, seed=2,
                                            query_every=50)
        assert n == jn and trace.n_queries == jt.n_queries > 0
        for col in ("kind", "src", "dst", "w", "t"):
            np.testing.assert_array_equal(getattr(trace, col),
                                          getattr(jt, col))


@pytest.mark.parametrize("n,m,n_hubs,seed", [(64, 640, 4, 7), (300, 2500, 3, 5)])
def test_power_law_hubs_matches_reference_in_hubs(n, m, n_hubs, seed):
    """The example's ``--power-law`` stream: the port's generator equals the
    reference's in-degree-hub orientation."""
    from repro_torch.graphs import generators as tgen
    got = tgen.power_law_hubs(n, m, n_hubs=n_hubs, seed=seed,
                              orientation="in")
    want = generators.power_law_hubs(n, m, n_hubs=n_hubs, seed=seed,
                                     orientation="in")
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def test_dataset_load_errors_exit_2(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2\n3\n")
    with pytest.raises(datasets.DatasetFormatError):
        datasets.parse_edge_list(str(bad))
    with pytest.raises(ValueError, match="window_frac"):
        datasets.dataset_to_trace(str(bad), window_frac=0.0)
    # a url goes through the verified cache: one that cannot be read (a
    # file:// url of a missing file; no network) exits 2 as well
    monkeypatch.setenv("REPRO_DATASET_CACHE", str(tmp_path / "cache"))
    for path in (str(tmp_path / "missing.txt"), str(bad),
                 (tmp_path / "gone.txt").as_uri()):
        with pytest.raises(SystemExit) as ei:
            datasets.load_dataset_or_exit(path)
        assert ei.value.code == 2
    assert "error:" in capsys.readouterr().err


# ---------------------------------------------------------------- example --
def _example(*args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(ROOT / "src")
                         + (":" + env["PYTHONPATH"]
                            if env.get("PYTHONPATH") else ""))
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_streaming_sssp.py"),
         *args], capture_output=True, text=True, env=env, timeout=timeout)


@pytest.mark.parametrize("flag", ["--trace-out", "--log-json",
                                  "--metrics-out", "--replay-trace",
                                  "--dataset"])
def test_example_exits_2_on_bad_paths(flag, tmp_path):
    """A missing output directory, trace or dataset exits 2 before any
    engine work (and without a card)."""
    proc = _example(flag, str(tmp_path / "missing_dir" / "out.json"))
    assert proc.returncode == 2, proc.stderr
    assert "error:" in proc.stderr


def test_example_reports_the_remo_baseline():
    """The generated-stream run prints the reference example's line: the
    engine's query p50 beside the ReMo-from-scratch baseline's and the
    speedup (on the CPU, a small RMAT stream)."""
    import re
    proc = _example("--device", "cpu", "--scale", "7")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = re.search(r"latency p50: ours ([\d.]+)ms \| ReMo-from-scratch "
                     r"([\d.]+)ms \| speedup ([\d.]+)x", proc.stdout)
    assert line, proc.stdout
    ours, base, speedup = map(float, line.groups())
    assert ours > 0 and base > 0
    assert speedup == pytest.approx(base / ours, rel=0.06, abs=0.06)
    assert re.search(r"^queries: [1-9]", proc.stdout, re.M)


def test_example_replays_a_reference_trace_with_artifacts(tmp_path):
    """The example replays a trace the JAX package wrote, on the CPU, and
    writes the Chrome trace, the JSONL log and the Prometheus text; the
    three agree."""
    from repro_torch.obs import load_chrome_trace, span_counts_of
    from repro_torch.obs.export import parse_prometheus_text
    import json
    n, cap, log = _stream(seed=37)
    path = str(tmp_path / "stream.trace")
    jtrace.ServingTrace.from_log(log).save(path, chunk_events=128)
    out = {k: str(tmp_path / k) for k in ("t.json", "l.jsonl", "m.prom")}
    proc = _example("--replay-trace", path, "--device", "cpu",
                    "--trace-out", out["t.json"], "--log-json",
                    out["l.jsonl"], "--metrics-out", out["m.prom"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "replayed" in proc.stdout and "single/segment" in proc.stdout
    counts = span_counts_of(load_chrome_trace(out["t.json"]))
    final = json.loads(Path(out["l.jsonl"]).read_text().splitlines()[-1])
    assert final["kind"] == "metrics_snapshot" and final["spans"] == counts
    assert final["counters"]["add_epochs"] == counts["add_epoch"] > 0
    parsed = parse_prometheus_text(Path(out["m.prom"]).read_text())
    assert parsed["repro_add_epochs"][()] == counts["add_epoch"]
    assert parsed["repro_hist_latency_us_count"][()] == \
        final["counters"]["queries"] == np.sum(log.kind == ev.QUERY)
