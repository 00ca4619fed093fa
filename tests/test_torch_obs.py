"""The port's telemetry layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``) — the single-engine halves of tests/test_obs.py,
tests/test_hist.py and tests/test_watchdog.py (their sharded, P=8 and
subprocess cases wait for the sharded engine).

  * units: the counter registry (device tensors folded lazily, host ints
    and numpy arrays, one device->host copy per snapshot), spans and their
    Chrome trace, the flight recorder, ``EngineObs`` and the watchdog;
  * the log2 histograms: geometry and estimates copied from the
    reference, and the device bucketing, which is exact here — equal to
    the host twin ``bucket_index_np`` everywhere, where the reference's
    XLA rendering is not (four values documented below);
  * engines: with ``observability=True`` on every backend (segment,
    ellpack, sliced, sliced on K2's plain version, auto) x schedule
    (rounds, buckets) x frontier (dense, sparse; auto on two), the port is
    bit-identical to its uninstrumented twin and to the JAX engine with
    observability on — dist, parent, rounds, messages — and its flat
    counters, span counts and histogram totals equal the reference's (the
    wall-time and latency histograms, whose samples are clocks, in totals
    only; every other histogram bucket for bucket);
  * per-lane snapshots of a ``sources=`` engine against the JAX batched
    engine's; host reads with observability on equal to those with it off,
    epoch by epoch (the counter of test_torch_serving.py);
  * the port-only phase spans: their nesting, their counts against the
    loops' passes and ``relax.host``'s calls, the phase table against the
    Chrome export, the active-engine slot and the tracer's Unix clock.

The JAX engines run ``sliced_fused=False`` and ``frontier_kernel=False``.
Inputs are made from seeds with numpy.  Tolerance: 0.
"""
import functools
import json
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.graphs import generators, window
from repro.obs import hist as jhist
from repro_torch import EngineConfig, SSSPDelEngine, make_engine
from repro_torch import obs as obs_mod
from repro_torch.core import buckets as buckets_mod
from repro_torch.core import delete as del_mod
from repro_torch.core import frontier as frontier_mod
from repro_torch.core import relax
from repro_torch.core.backends import ellpack as ell_mod
from repro_torch.core.backends import sliced as sliced_mod
from repro_torch.obs import (CounterRegistry, EngineObs, FlightRecorder,
                             SpanTracer, WatchdogConfig, load_chrome_trace,
                             out_path_or_exit, span_counts_of,
                             write_log_jsonl)
from repro_torch.obs import _jsonable
from repro_torch.obs import hist
from repro_torch.obs.export import prometheus_text
from repro_torch.obs.spans import phase_table, unix_offset_ns
from test_torch_serving import READS, _count_reads

SOURCES = (3, 17, 40)
BACKENDS = {
    "segment": ("segment", {}, {}),
    "ellpack": ("ellpack", dict(ell_init_k=2), {}),
    "sliced": ("sliced", dict(sliced_slice_rows=32, sliced_hub_k=4,
                              sliced_init_k=1), {}),
    "sliced-K2": ("sliced", dict(sliced_slice_rows=32, sliced_hub_k=4,
                                 sliced_init_k=1), dict(sliced_fused=True)),
    "auto": ("auto", dict(ell_init_k=1, sliced_slice_rows=32,
                          sliced_hub_k=4, sliced_init_k=4), {}),
}
# histograms whose samples are wall-clock times: totals compared only
CLOCKED = ("hist_latency_us", "_wall_us")


def _stream(seed=11, *, n=72, m=320, delta=0.5):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    log = window.sliding_window_stream(src, dst, w, window=m // 3,
                                       delta=delta, seed=seed,
                                       query_every=m // 2)
    return n, len(src) + 64, log


STREAM = _stream()


def _knobs(backend, mode, schedule):
    name, shared, port_only = BACKENDS[backend]
    kw = dict(relax_backend=name, **shared)
    if mode != "dense":
        kw.update(frontier_mode=mode, frontier_cap=32)
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=0.7)
    return kw, port_only


def _ingest(eng, log):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # ELL blowup
        out = eng.ingest_log(log)
        out.append(eng.query())
    return out


@functools.cache
def _jax_run(knobs: tuple):
    """The JAX engine with observability on: (results, snapshot)."""
    n, cap, log = STREAM
    eng = JaxEngine(JaxConfig(n, cap, 3, observability=True, **dict(knobs)))
    return _ingest(eng, log), eng.metrics_snapshot()


def _port(n, cap, **kw):
    return SSSPDelEngine(EngineConfig(n, cap, 3, device="cpu", **kw))


def _assert_counters_match(got: dict, want: dict):
    """Flat counters equal; histograms of clocked samples equal in total,
    every other histogram bucket for bucket."""
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k.startswith("hist_") and any(c in k for c in CLOCKED):
            assert g.shape == w.shape and g.sum() == w.sum(), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# ------------------------------------------------------- counter registry --
def test_counter_registry_device_and_host():
    reg = CounterRegistry(enabled=True)
    reg.add("frontier", torch.tensor(3, dtype=torch.int32))   # lazy
    reg.add("frontier", torch.tensor(4, dtype=torch.int32))
    reg.add("waves", torch.tensor([1, 2, 3]))                # [S] vector
    reg.add("waves", torch.tensor([1, 0, 1]))
    reg.peak("hw", torch.tensor(5))
    reg.peak("hw", torch.tensor(2))
    reg.peak("hw_np", np.array([1, 7]))                      # numpy peaks
    reg.peak("hw_np", np.array([4, 2]))
    reg.inc("epochs")                                        # host int
    reg.inc("epochs", 4)
    reg.inc("per_lane", np.array([1, 0]), dim="lane")        # host [S]
    reg.inc("per_lane", np.array([0, 2]))
    snap = reg.snapshot()
    assert snap["frontier"] == 7 and isinstance(snap["frontier"], int)
    np.testing.assert_array_equal(snap["waves"], [2, 2, 4])
    assert snap["hw"] == 5
    np.testing.assert_array_equal(snap["hw_np"], [4, 7])
    assert snap["epochs"] == 5
    np.testing.assert_array_equal(snap["per_lane"], [1, 2])
    assert reg.names() == sorted(["frontier", "waves", "hw", "hw_np",
                                  "epochs", "per_lane"])
    assert reg.dims() == {"per_lane": "lane"}
    assert set(reg.attribution(snap)["lane"]) == {"per_lane"}


def test_counter_registry_merges_host_and_device_same_name():
    reg = CounterRegistry(enabled=True)
    reg.inc("rebuilds", 2)
    reg.add("rebuilds", torch.tensor(3, dtype=torch.int32))
    reg.inc("rows", np.array([1, 1]))
    reg.add("rows", torch.tensor([2, 0]))
    snap = reg.snapshot()
    assert snap["rebuilds"] == 5
    np.testing.assert_array_equal(snap["rows"], [3, 1])


def test_counter_registry_disabled_noops():
    reg = CounterRegistry(enabled=False)
    reg.add("a", torch.tensor(1))
    reg.inc("b")
    reg.peak("c", np.array([9]))
    assert reg.snapshot() == {} and reg.names() == []


def _host_copies(monkeypatch):
    """Count calls that copy a tensor to the host (``to``/``cpu`` towards
    the CPU, ``item``, ``tolist``, the Python conversions)."""
    calls = []
    real_to = torch.Tensor.to

    def to(self, *a, **k):
        target = k.get("device", a[0] if a else None)
        if isinstance(target, (str, torch.device)) and \
                torch.device(target).type == "cpu":
            calls.append("to")
        return real_to(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "to", to)
    for meth in ("cpu", "item", "tolist", "__int__", "__float__",
                 "__bool__", "__index__", "__array__"):
        real = getattr(torch.Tensor, meth)

        def counted(self, *a, _real=real, _m=meth, **k):
            calls.append(_m)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, meth, counted)
    return calls


def test_snapshot_reads_device_counters_in_one_copy(monkeypatch):
    """Several device counters of mixed dtypes and shapes come back from
    one device->host copy, split and reshaped on the host; a floating
    counter widens the buffer to f64."""
    reg = CounterRegistry(enabled=True)
    reg.add("a", torch.tensor(3, dtype=torch.int32))
    reg.add("b", torch.tensor([1, 2, 3]))
    reg.add("h", hist.one_hot(torch.tensor([1.0, 900.0])))
    reg.add("rows", torch.arange(6).reshape(2, 3))
    calls = _host_copies(monkeypatch)
    snap = reg.snapshot()
    assert calls == ["to"]
    monkeypatch.undo()
    assert snap["a"] == 3
    np.testing.assert_array_equal(snap["b"], [1, 2, 3])
    np.testing.assert_array_equal(snap["rows"], np.arange(6).reshape(2, 3))
    assert snap["h"].sum() == 2 and snap["h"][10] == 1
    reg.add("f", torch.tensor(0.5))
    snap = reg.snapshot()
    assert snap["b"].dtype == np.float64 and snap["a"] == 3


def test_engine_snapshot_reads_counters_in_one_copy(monkeypatch):
    """``metrics_snapshot`` of a bucketed engine (device pending counts,
    message histograms): one copy for the registry, one for the message
    counter, nothing else."""
    n, cap, log = STREAM
    eng = _port(n, cap, observability=True, wave_schedule="buckets")
    _ingest(eng, log)
    calls = _host_copies(monkeypatch)
    snap = eng.metrics_snapshot()
    assert len(calls) == 2, calls
    monkeypatch.undo()
    assert snap["counters"]["pending_push"] > 0


# -------------------------------------------------------------- span tracer --
def test_span_nesting_roundtrips_through_chrome_trace(tmp_path):
    tr = SpanTracer(enabled=True)
    with tr.span("outer", events=2):
        with tr.span("inner"):
            pass
        tr.instant("rebuild")
        with tr.span("inner"):
            pass
    path = str(tmp_path / "trace.json")
    tr.save_chrome(path)
    events = load_chrome_trace(path)
    assert span_counts_of(events) == tr.span_counts() == \
        {"outer": 1, "inner": 2, "rebuild": 1}
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    outer, = by_name["outer"]
    assert outer["ph"] == "X" and outer["args"]["depth"] == 0
    assert outer["args"]["events"] == 2
    for inner in by_name["inner"]:
        assert inner["args"]["depth"] == 1
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    reb, = by_name["rebuild"]
    assert reb["ph"] == "i" and reb["s"] == "t" and "dur" not in reb
    assert outer["ts"] <= reb["ts"] <= outer["ts"] + outer["dur"]


def test_span_jsonl_and_load_errors(tmp_path):
    tr = SpanTracer(enabled=True)
    with tr.span("epoch", kindof="add"):
        tr.instant("mark")
    path = str(tmp_path / "spans.jsonl")
    tr.save_jsonl(path)
    lines = [json.loads(line) for line in
             Path(path).read_text().splitlines()]
    assert [ln["name"] for ln in lines] == ["mark", "epoch"]
    assert lines[1]["args"] == {"kindof": "add"}
    assert all(ln["dur_us"] >= 0 and ln["ts_us"] >= 0 for ln in lines)
    bad = tmp_path / "not_chrome.json"
    bad.write_text(json.dumps([1, 2, 3]))
    with pytest.raises(ValueError, match="traceEvents"):
        load_chrome_trace(str(bad))


def test_disabled_tracer_records_nothing():
    tr = SpanTracer(enabled=False)
    with tr.span("epoch"):
        tr.instant("mark")
    assert tr.spans == [] and tr.span_counts() == {}


def test_spans_land_in_torch_profiler_as_record_functions():
    """Each span opens a ``record_function`` range of its name, so the
    profiler's trace carries the epochs beside the kernels."""
    tr = SpanTracer(enabled=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tr.span("add_epoch"):
                torch.ones(4).sum()
    got = {e.key: e.count for e in prof.key_averages()}
    assert got.get("add_epoch") == 3


# ---------------------------------------------------------- flight recorder --
def test_flight_recorder_ring_wraps_at_capacity():
    fr = FlightRecorder(capacity=8)
    for i in range(20):
        fr.record("add_epoch", events=i)
    assert fr.total == 20 and fr.capacity == 8
    recs = fr.records()
    assert [r["seq"] for r in recs] == list(range(12, 20))
    assert recs[-1]["events"] == 19
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)


def test_flight_recorder_dump_format(capsys):
    fr = FlightRecorder(capacity=4)
    fr.record("drain", wall_ms=1.25)
    text = fr.dump(header="postmortem")
    err = capsys.readouterr().err
    assert text in err and err.startswith("# postmortem")
    assert json.loads(text.splitlines()[1])["kind"] == "drain"


# ---------------------------------------------------------------- EngineObs --
def test_engine_obs_epoch_dumps_flight_recorder_once(capsys):
    obs = EngineObs(enabled=True, flight_capacity=4)
    with obs.epoch("add_epoch", events=3):
        pass
    with pytest.raises(RuntimeError, match="boom"):
        with obs.epoch("del_epoch", events=1):
            raise RuntimeError("boom")
    err = capsys.readouterr().err
    assert "flight recorder" in err and "boom" in err
    snap = obs.counters.snapshot()
    assert snap["add_epochs"] == 1                       # failure not counted
    assert int(np.sum(snap["hist_add_epoch_wall_us"])) == 1
    assert set(snap) == {"add_epochs", "hist_add_epoch_wall_us"}
    assert obs.tracer.span_counts() == {"add_epoch": 1, "del_epoch": 1}
    assert [r["kind"] for r in obs.recorder.records()] == \
        ["add_epoch", "del_epoch"]
    assert obs.recorder.records()[-1]["error"].startswith("RuntimeError")
    with pytest.raises(RuntimeError):
        with obs.epoch("drain"):
            raise RuntimeError("again")
    assert "flight recorder" not in capsys.readouterr().err


def test_engine_obs_disabled_is_inert():
    obs = EngineObs(enabled=False)
    with obs.epoch("add_epoch"):
        pass
    obs.note_layout({"rebuilds": 3})
    obs.hist_device("hist_x", torch.tensor(3))
    obs.flush_histograms()
    assert obs.counters.snapshot() == {}
    assert obs.tracer.span_counts() == {}
    assert obs.recorder.total == 0


def test_note_layout_deltas_and_rebuild_instants():
    obs = EngineObs(enabled=True)
    obs.note_layout({"rebuilds": 2, "overflow_hits": 5})
    obs.note_layout({"rebuilds": 2, "overflow_hits": 9})
    obs.note_layout({"rebuilds": 3, "overflow_hits": 0})  # reset clamps to 0
    assert obs.counters.snapshot() == {"rebuilds": 3, "overflow_hits": 9}
    assert obs.tracer.span_counts() == {"rebuild": 3}


def test_hist_samples_fold_at_flush_in_chunks():
    """Tensor and host samples of one name merge; more than one chunk of
    512 tensor samples; a second flush folds nothing twice; the
    cumulative series folds its consecutive differences."""
    obs = EngineObs(enabled=True)
    for i in range(1100):
        obs.hist_device("hist_m", torch.tensor(i % 9))
    obs.hist_device("hist_m", 5)
    obs.hist_device("hist_m", np.array([0, 3000]))
    for total in (2, 5, 5, 30):
        obs.hist_cumulative("hist_c", torch.tensor([total, 2 * total]))
    obs.flush_histograms()
    obs.flush_histograms()
    snap = obs.counters.snapshot()
    want = hist.zeros_np()
    for v in [i % 9 for i in range(1100)] + [5, 0, 3000]:
        hist.fold_np(want, v)
    np.testing.assert_array_equal(snap["hist_m"], want)
    want = hist.zeros_np()
    for v in (2, 4, 3, 6, 0, 0, 25, 50):
        hist.fold_np(want, v)
    np.testing.assert_array_equal(snap["hist_c"], want)


# -------------------------------------------------------------- histograms --
def test_bucket_edges_are_log2():
    assert hist.bucket_lo(0) == 0.0 and hist.bucket_hi(0) == 1.0
    assert hist.bucket_lo(5) == 16.0 and hist.bucket_hi(5) == 32.0
    es = hist.edges()
    assert len(es) == hist.NUM_BUCKETS and es[-1] == float("inf")
    assert es == jhist.edges()


# 0, 0.3, 1, 2^k - 1, 2^k and 2^k + 1 for k <= 24
EDGE_VALUES = [0.0, 0.3, 1.0] + [float(v) for k in range(1, 25)
                                 for v in (2**k - 1, 2**k, 2**k + 1)]
# where the reference's f32 log2 bucketing, as XLA renders it, departs
# from its own host twin: 8192 and 32768 one bucket low, 2^21 - 1 and
# 2^22 - 1 one bucket high (XLA:CPU, jax 0.9)
XLA_EDGES = (8192.0, 32768.0, 2.0**21 - 1, 2.0**22 - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int64, torch.int32])
def test_device_bucketing_equals_host_twin(dtype):
    vals = [v for v in EDGE_VALUES
            if dtype.is_floating_point or float(v).is_integer()]
    t = torch.tensor(vals, dtype=torch.float64).to(dtype)
    got = hist.bucket_index(t).tolist()
    want = [hist.bucket_index_np(float(v)) for v in t.tolist()]
    assert got == want
    # the port's host twin is the reference's
    assert want == [jhist.bucket_index_np(float(v)) for v in t.tolist()]


def test_device_bucketing_nan_negative_inf():
    t = torch.tensor([float("nan"), -7.0, -float("inf"), float("inf"),
                      0.999, 1e30])
    assert hist.bucket_index(t).tolist() == [0, 0, 0, hist.NUM_BUCKETS - 1,
                                             0, hist.NUM_BUCKETS - 1]
    assert [hist.bucket_index_np(v) for v in (float("nan"), -7.0, 0.999,
                                              1e30)] == \
        [0, 0, 0, hist.NUM_BUCKETS - 1]


def test_bucketing_where_the_reference_departs():
    """The port lands on the host twin at the four values; the reference's
    device bucketing lands one bucket off there (documented, not
    required: another XLA may round its log2 otherwise)."""
    host = [hist.bucket_index_np(v) for v in XLA_EDGES]
    assert host == [14, 16, 21, 22]
    for dtype in (torch.float32, torch.float64, torch.int64):
        t = torch.tensor(XLA_EDGES, dtype=torch.float64).to(dtype)
        assert hist.bucket_index(t).tolist() == host
    ref = np.asarray(jhist.bucket_index(jnp.asarray(XLA_EDGES, jnp.float32)))
    assert np.all(np.abs(ref - np.asarray(host)) <= 1)


def test_one_hot_scalar_vector_and_stack():
    oh = hist.one_hot(torch.tensor(5.0))
    assert oh.dtype == torch.int64 and oh.sum() == 1
    assert oh[hist.bucket_index_np(5.0)] == 1
    ohv = hist.one_hot(torch.tensor([1.0, 1.5, 900.0]))
    assert ohv.sum() == 3 and ohv[1] == 2
    stack = hist.one_hot(torch.tensor([[1, 2], [3000, 8192]]))
    np.testing.assert_array_equal(
        stack.numpy(), sum(hist.one_hot_np(v) for v in (1, 2, 3000, 8192)))


def test_host_percentiles_and_summaries_match_reference():
    counts = hist.zeros_np()
    counts[1], counts[3], counts[10], counts[-1] = 90, 5, 4, 1
    for q in (1.0, 50.0, 95.0, 99.0, 100.0):
        assert hist.percentile(counts, q) == jhist.percentile(counts, q)
    rows = np.stack([hist.one_hot_np(1.5), hist.one_hot_np(600.0)])
    assert hist.summary(rows) == jhist.summary(rows)
    snap = {"hist_latency_us": hist.one_hot_np(3.0), "queries": 1,
            "hist_scalar_is_ignored": np.int64(7)}
    assert hist.summarize(snap) == jhist.summarize(snap)
    assert np.isnan(hist.percentile(hist.zeros_np(), 50.0))


# ---------------------------------------------------------------- engines --
CASES = [(b, f, s) for b in sorted(BACKENDS) for f in ("dense", "sparse")
         for s in ("rounds", "buckets")] + [
    ("segment", "auto", "rounds"), ("ellpack", "auto", "buckets")]


@pytest.mark.parametrize("backend,mode,schedule", CASES)
def test_obs_engine_bit_identical_and_counters_match_reference(
        backend, mode, schedule):
    """Observability is algorithmically free and reports what the
    reference reports: the instrumented engine equals its plain twin and
    the JAX engine (dist, parent, rounds, messages at every query); its
    flat counters, span counts and histograms equal the JAX engine's; and
    the views agree with each other (spans == counters, histogram totals
    == the counters they shadow)."""
    n, cap, log = STREAM
    kw, port_only = _knobs(backend, mode, schedule)
    plain = _port(n, cap, **kw, **port_only)
    inst = _port(n, cap, observability=True, **kw, **port_only)
    res_p, res_i = _ingest(plain, log), _ingest(inst, log)
    want, jsnap = _jax_run(tuple(sorted(kw.items())))
    assert len(res_i) == len(res_p) == len(want) > 1
    for a, b, c in zip(res_i, res_p, want):
        for x in (b, c):
            np.testing.assert_array_equal(a.dist, x.dist)
            np.testing.assert_array_equal(a.parent, x.parent)
            assert a.epoch_stats == x.epoch_stats
    snap = inst.metrics_snapshot()
    for k in ("epochs", "adds", "dels", "rounds", "messages"):
        assert snap[k] == jsnap[k], k
    assert snap["spans"] == jsnap["spans"]
    _assert_counters_match(snap["counters"], jsnap["counters"])
    assert snap["histograms"].keys() == jsnap["histograms"].keys()
    assert snap["flight"] == jsnap["flight"]

    sp, ct, h = snap["spans"], snap["counters"], snap["histograms"]
    assert sp["add_epoch"] == ct["add_epochs"] == h["frontier_occupancy"][
        "count"]
    assert sp["del_epoch"] == ct["del_epochs"]
    assert sp["add_epoch"] + sp["del_epoch"] == inst.n_epochs
    assert sp["query"] == ct["queries"] == len(res_i) == h["latency_us"][
        "count"]
    assert sp.get("rebuild", 0) == ct.get("rebuilds", 0)
    expected = (ct["del_epochs"] + ct["drains"] if schedule == "buckets"
                else ct["add_epochs"] + ct["del_epochs"])
    assert h["waves_per_epoch"]["count"] == expected
    assert h["messages_per_epoch"]["count"] == expected
    for kind, plural in (("add_epoch", "add_epochs"),
                         ("del_epoch", "del_epochs"), ("query", "queries")):
        assert h[f"{kind}_wall_us"]["count"] == ct[plural]
    if backend == "ellpack":
        assert ct["rebuilds"] == inst.backend.planner.rebuilds >= 1
    if backend.startswith("sliced"):
        assert ct["overflow_hits"] == inst.backend.planner.spills >= 1
    if backend == "auto":
        # the layout swapped, and the counters run on across it
        assert inst.backend_name == "sliced" and ct["rebuilds"] >= 2
    if mode == "sparse":
        assert ct["frontier_occupancy"] > 0
    if schedule == "buckets":
        assert sp["drain"] == ct["drains"] > 0 and ct["drain_waves"] > 0
    # a second snapshot re-reads the same counts (no double fold)
    again = inst.metrics_snapshot()
    assert again["histograms"]["waves_per_epoch"]["count"] == expected
    assert plain.metrics_snapshot()["counters"] == {}
    assert plain.metrics_snapshot()["spans"] == {}


@pytest.mark.parametrize("schedule", ["rounds", "buckets"])
def test_batched_obs_snapshot_is_per_lane(schedule):
    """A ``sources=`` engine: per-lane rounds and messages, routed queries
    tallied per lane with [S, B] latency rows, pending occupancy per lane
    under buckets — the JAX batched engine's counters, and a checkpoint
    span."""
    n, cap, log = STREAM
    kw = dict(sources=SOURCES)
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=0.7)
    engines = (_port(n, cap, observability=True, **kw),
               JaxEngine(JaxConfig(n, cap, 3, observability=True, **kw)))
    snaps = []
    for eng in engines:
        _ingest(eng, log)
        for s in (SOURCES[0], SOURCES[2], SOURCES[2]):
            eng.query(source=s)
        eng.checkpoint()
        snaps.append(eng.metrics_snapshot())
    got, want = snaps
    np.testing.assert_array_equal(got["rounds"], want["rounds"])
    np.testing.assert_array_equal(got["messages"], want["messages"])
    assert np.asarray(got["rounds"]).shape == (len(SOURCES),)
    assert got["spans"] == want["spans"]
    assert got["spans"]["checkpoint"] == got["counters"]["checkpoints"] == 1
    _assert_counters_match(got["counters"], want["counters"])
    rows = np.asarray(got["counters"]["hist_latency_us_per_lane"])
    assert rows.shape == (len(SOURCES), hist.NUM_BUCKETS)
    np.testing.assert_array_equal(rows.sum(1), [1, 0, 2])
    att = got["attribution"]["lane"]
    assert set(att) == set(want["attribution"]["lane"])
    assert int(np.sum(att["queries_per_lane"])) == int(rows.sum())
    if schedule == "buckets":
        assert np.asarray(att["pending_push"]).shape == (len(SOURCES),)


@pytest.mark.parametrize("sources", [None, SOURCES])
@pytest.mark.parametrize("mode,schedule", [
    ("dense", "rounds"), ("dense", "buckets"), ("sparse", "rounds"),
    ("sparse", "buckets")])
def test_obs_adds_no_host_read(monkeypatch, sources, mode, schedule):
    """With observability on, ingest and drains make exactly the reads they
    make with it off, epoch by epoch (the hooks append and fold lazily);
    the per-epoch tallies are the same too."""
    n, cap, log = STREAM
    kw, port_only = _knobs("sliced", mode, schedule)
    kw.update(sources=sources, batch_deletions=True)
    runs = []
    for obs in (False, True):
        eng = _port(n, cap, observability=obs, **kw, **port_only)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            runs.append(_count_reads(monkeypatch, eng, log))
    (off, off_counts), (on, on_counts) = runs
    assert on == off and sum(on) > 0
    assert on_counts == off_counts
    assert "numpy" in READS
    assert eng.metrics_snapshot()["counters"]["add_epochs"] > 0


def test_checkpoint_restore_counts_a_rebuild_and_flight_recorder():
    n, cap, log = STREAM
    eng = _port(n, cap, observability=True, obs_flight_capacity=6,
                relax_backend="ellpack", ell_init_k=2)
    _ingest(eng, log)
    before = eng.metrics_snapshot()["counters"]["rebuilds"]
    eng.restore(eng.checkpoint())
    snap = eng.metrics_snapshot()
    assert snap["counters"]["checkpoints"] == 1
    assert snap["spans"]["rebuild"] == snap["counters"]["rebuilds"] >= before
    text = eng.dump_flight_recorder()
    recs = [json.loads(line) for line in text.splitlines()
            if not line.startswith("#")]
    assert 0 < len(recs) <= 6
    assert {r["kind"] for r in recs} <= \
        {"add_epoch", "del_epoch", "drain", "query", "checkpoint"}
    with pytest.raises(ValueError, match="obs_flight_capacity"):
        EngineConfig(n, cap, 3, obs_flight_capacity=0, device="cpu")


def test_observability_is_accepted_by_make_engine():
    eng = make_engine(num_vertices=8, edge_capacity=8, device="cpu",
                      observability=True, obs_flight_capacity=4,
                      obs_watchdog=WatchdogConfig())
    assert eng.obs.enabled and eng.obs.recorder.capacity == 4
    assert eng.obs.watchdog is not None


def test_log_jsonl_ends_in_the_snapshot(tmp_path, capsys):
    n, cap, log = STREAM
    eng = _port(n, cap, observability=True)
    _ingest(eng, log)
    path = str(tmp_path / "spans.jsonl")
    write_log_jsonl(eng, path)
    lines = Path(path).read_text().splitlines()
    final = json.loads(lines[-1])
    assert final["kind"] == "metrics_snapshot"
    assert final["spans"] == eng.obs.tracer.span_counts()
    assert len(lines) == 1 + sum(final["spans"].values())
    assert out_path_or_exit(path) == path
    assert _jsonable({"a": torch.tensor([1, 2]), "b": np.int64(3),
                      "c": {"d": np.arange(2)}}) == \
        {"a": [1, 2], "b": 3, "c": {"d": [0, 1]}}
    with pytest.raises(SystemExit) as ei:
        out_path_or_exit(str(tmp_path / "no_such_dir" / "x.json"))
    assert ei.value.code == 2 and "error:" in capsys.readouterr().err


# ----------------------------------------------------------------- watchdog --
def _wd(cfg: WatchdogConfig) -> EngineObs:
    return EngineObs(enabled=True, watchdog=cfg)


def test_slow_epoch_and_frontier_thresholds(capsys):
    obs = _wd(WatchdogConfig(stall_timeout_s=0.0, max_epoch_wall_s=1e-9,
                             max_frontier=10))
    with obs.epoch("add_epoch"):
        pass
    assert "slow_epoch" in capsys.readouterr().err
    assert obs.watchdog.warnings == 1
    obs.watchdog.observe("add_epoch", 0.0, {"frontier": 5})
    assert obs.watchdog.warnings == 1
    obs.watchdog.observe("add_epoch", 0.0, {"frontier": 11})
    assert obs.watchdog.warnings == 2
    snap = obs.counters.snapshot()
    assert snap["watchdog_warnings"] == 2 and "watchdog_stalls" not in snap
    assert "watchdog" in [r["kind"] for r in obs.recorder.records()]


def test_stall_fires_once_and_dumps_recorder(capsys):
    obs = _wd(WatchdogConfig(stall_timeout_s=0.05, poll_interval_s=0.01))
    wd = obs.watchdog
    obs.recorder.record("add_epoch", wall_ms=1.0)
    wd.arm("add_epoch")
    try:
        deadline = time.perf_counter() + 5.0
        while wd.warnings == 0 and time.perf_counter() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)   # armed past several polls: one firing only
    finally:
        wd.disarm()
        wd.stop()
    assert wd.warnings == 1 and obs._dumped
    assert obs.counters.snapshot()["watchdog_stalls"] == 1
    err = capsys.readouterr().err
    assert "stall" in err and "flight recorder postmortem" in err
    assert "[repro_torch.obs.watchdog]" in err


def test_stall_in_engine_epoch_region(capsys):
    """Through a port engine: a slow layout patch inside the dispatched
    epoch trips the sampler while the engine thread is still inside
    ``obs.epoch``; the epoch completes."""
    n, src, dst, w = generators.erdos_renyi(48, 160, seed=5)
    eng = _port(n, len(src) + 32, observability=True,
                obs_watchdog=WatchdogConfig(stall_timeout_s=0.05,
                                            poll_interval_s=0.01))
    stage = eng.backend.apply_adds

    def slow_stage(*a, **kw):
        time.sleep(0.3)
        return stage(*a, **kw)

    eng.backend.apply_adds = slow_stage
    log = window.sliding_window_stream(src, dst, w, window=80, delta=0.5,
                                       seed=5)
    eng._ingest_adds(next(iter(log.runs())))
    eng.obs.watchdog.stop()
    snap = eng.metrics_snapshot()
    assert snap["counters"]["watchdog_stalls"] >= 1
    assert snap["counters"]["add_epochs"] == 1
    assert "flight recorder postmortem" in capsys.readouterr().err


def test_review_flags_wave_divergence_once(capsys):
    obs = _wd(WatchdogConfig(stall_timeout_s=0.0, max_drain_waves=64))
    counts = hist.zeros_np()
    counts[3] = 5
    obs.watchdog.review({"hist_waves_per_epoch": counts})
    obs.watchdog.review({})
    assert obs.watchdog.warnings == 0
    counts[8] = 1
    for _ in range(2):
        obs.watchdog.review({"hist_waves_per_epoch": counts})
    assert obs.watchdog.warnings == 1
    assert "wave_divergence" in capsys.readouterr().err


def test_default_watchdog_is_silent_on_healthy_run(capsys):
    n, cap, log = STREAM
    eng = _port(n, cap, observability=True, obs_watchdog=WatchdogConfig(),
                wave_schedule="buckets")
    _ingest(eng, log)
    snap = eng.metrics_snapshot()
    eng.obs.watchdog.stop()
    assert "watchdog_warnings" not in snap["counters"]
    assert eng.obs.watchdog.warnings == 0
    assert "[repro_torch.obs.watchdog]" not in capsys.readouterr().err
    off = _port(n, cap, obs_watchdog=WatchdogConfig())
    assert off.obs.watchdog is None          # obs disabled wins


def test_watchdog_stop_is_idempotent_and_joins_thread():
    obs = _wd(WatchdogConfig(stall_timeout_s=0.05, poll_interval_s=0.01))
    wd = obs.watchdog
    wd.arm("add_epoch")
    wd.disarm()
    assert wd._thread is not None
    wd.stop()
    assert wd._thread is None
    wd.stop()


# ------------------------------------------------------------- phase spans --
# each phase span's parent: the span open around it (None: top level)
PHASE_PARENTS = {
    "ingest_log": {None}, "plan_adds": {"ingest_log"},
    "plan_dels": {"ingest_log"}, "apply_adds": {"add_epoch"},
    "apply_dels": {"del_epoch"}, "mark": {"del_epoch", "drain"},
    "waves": {"add_epoch", "del_epoch", "drain"},
}
PHASE_CASES = [("segment", "dense", "rounds"),
               ("ellpack", "dense", "buckets"),
               ("sliced-K2", "dense", "rounds"),
               ("sliced", "sparse", "buckets"),
               ("auto", "sparse", "rounds")]


def _parents(spans) -> list:
    """(span, its parent's name) of every complete span, from the nesting
    of their intervals."""
    out, stack = [], []
    for s in sorted((s for s in spans if s.phase == "X"),
                    key=lambda s: (s.t0_ns, s.depth)):
        while stack and stack[-1].depth >= s.depth:
            stack.pop()
        out.append((s, stack[-1].name if stack else None))
        stack.append(s)
    return out


@pytest.mark.parametrize("sources", [None, SOURCES])
@pytest.mark.parametrize("backend,mode,schedule", PHASE_CASES)
def test_phase_spans_nest_under_their_epochs_and_change_nothing(
        backend, mode, schedule, sources):
    """Every phase span opens under the span the table names, carries its
    counts, and the instrumented engine stays bit-identical to its plain
    twin (dist, parent at every query; rounds, messages)."""
    n, cap, log = STREAM
    kw, port_only = _knobs(backend, mode, schedule)
    kw.update(sources=sources)
    plain = _port(n, cap, **kw, **port_only)
    inst = _port(n, cap, observability=True, **kw, **port_only)
    for a, b in zip(_ingest(inst, log), _ingest(plain, log), strict=True):
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        assert str(a.epoch_stats) == str(b.epoch_stats)
    np.testing.assert_array_equal(inst.n_rounds, plain.n_rounds)
    np.testing.assert_array_equal(inst.n_messages, plain.n_messages)
    seen = set()
    for span, parent in _parents(inst.obs.tracer.spans):
        if span.cat != "phase":
            assert "reads" not in span.args
            continue
        seen.add(span.name)
        assert parent in PHASE_PARENTS[span.name], (span.name, parent)
        assert span.args["reads"] == span.reads >= 0
        assert span.args["read_wait_ns"] == span.read_wait_ns >= 0
        loop = span.name in ("waves", "mark")
        assert ("iterations" in span.args) == loop
        assert span.self_ns <= span.dur_ns
    assert seen == set(PHASE_PARENTS)


def test_no_phase_span_opens_with_observability_off(monkeypatch):
    """Off, no span opens anywhere, the loops find no active engine, and
    the epoch and phase hooks hand out one shared null context."""
    def no_span(*a, **k):
        raise AssertionError("a span opened with observability off")

    monkeypatch.setattr(SpanTracer, "span", no_span)
    n, cap, log = STREAM
    eng = _port(n, cap, relax_backend="sliced", wave_schedule="buckets",
                **BACKENDS["sliced"][1])
    _ingest(eng, log)
    assert obs_mod.ACTIVE is None and eng.obs.tracer.spans == []
    assert eng.metrics_snapshot()["phases"] == {}
    off = EngineObs(enabled=False)
    assert off.epoch("add_epoch", events=1) is off.phase("waves") \
        is obs_mod.phase("mark") is EngineObs().epoch("drain")


@pytest.mark.parametrize("sources", [None, SOURCES])
@pytest.mark.parametrize("backend,mode,schedule", PHASE_CASES)
def test_phase_counts_equal_loop_passes_and_host_reads(
        monkeypatch, backend, mode, schedule, sources):
    """``waves`` iterations sum to the waves every loop driver runs,
    ``mark`` iterations to the marking steps, and the table's reads to the
    calls of ``relax.host`` (counted by wrapping each, here)."""
    calls = {"waves": 0, "mark": 0, "host": 0}

    def counted(fn, key):
        def inner(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return inner

    real_loop, real_drain = relax.converged_loop, buckets_mod.run_drain
    real_mark, real_host = del_mod._mark_loop, relax.host

    def loop(dist, parent, frontier, wave, **kw):
        return real_loop(dist, parent, frontier, counted(wave, "waves"), **kw)

    def drain(*a, wave, **kw):
        return real_drain(*a, wave=counted(wave, "waves"), **kw)

    def mark(step, aff, ptr, gate):
        return real_mark(counted(step, "mark"), aff, ptr, gate)

    for mod in (relax, frontier_mod, ell_mod, sliced_mod):
        monkeypatch.setattr(mod, "converged_loop", loop)
    monkeypatch.setattr(buckets_mod, "run_drain", drain)
    monkeypatch.setattr(del_mod, "_mark_loop", mark)
    monkeypatch.setattr(relax, "host", counted(real_host, "host"))
    n, cap, log = STREAM
    kw, port_only = _knobs(backend, mode, schedule)
    inst = _port(n, cap, observability=True, sources=sources, **kw,
                 **port_only)
    _ingest(inst, log)
    table = inst.metrics_snapshot()["phases"]
    assert table["waves"]["iterations"] == calls["waves"] > 0
    assert table["mark"]["iterations"] == calls["mark"] > 0
    assert sum(r["reads"] for r in table.values()) == calls["host"]
    assert table["waves"]["reads"] >= calls["waves"]
    assert all(r["read_wait_ns"] >= 0 for r in table.values())


def test_phase_table_agrees_with_the_chrome_export(tmp_path):
    """``metrics_snapshot()["phases"]`` and the Chrome trace's ``phase``
    events give the same counts, times and reads; the reference's span
    counts, the JSONL log and the Prometheus text leave the phases out."""
    n, cap, log = STREAM
    kw, port_only = _knobs("sliced", "dense", "buckets")
    eng = _port(n, cap, observability=True, **kw, **port_only)
    _ingest(eng, log)
    snap = eng.metrics_snapshot()
    path = str(tmp_path / "t.json")
    eng.obs.tracer.save_chrome(path)
    events = load_chrome_trace(path)
    got: dict = {}
    for e in events:
        if e["cat"] != "phase":
            continue
        row = got.setdefault(e["name"], dict(count=0, us=0.0, reads=0,
                                             read_wait_ns=0, iterations=0))
        row["count"] += 1
        row["us"] += e["dur"]
        for k in ("reads", "read_wait_ns", "iterations"):
            row[k] += e["args"].get(k, 0)
    assert set(got) == set(PHASE_PARENTS)
    for name, row in got.items():
        want = snap["phases"][name]
        assert row["count"] == want["count"]
        assert row["us"] * 1e3 == pytest.approx(want["ns"], abs=row["count"])
        for k in ("reads", "read_wait_ns", "iterations"):
            assert row[k] == want[k], (name, k)
    assert snap["spans"] == span_counts_of(events) == \
        eng.obs.tracer.span_counts()
    assert not set(PHASE_PARENTS) & set(snap["spans"])
    rest = {k: v for k, v in snap.items() if k != "phases"}
    assert prometheus_text(snap) == prometheus_text(rest)
    lines = [json.loads(x) for x in eng.obs.tracer.jsonl_lines()]
    assert sum(x.get("cat") == "phase" for x in lines) == \
        sum(r["count"] for r in got.values())
    assert len(eng.obs.tracer.jsonl_lines("engine")) == \
        sum(snap["spans"].values())


def test_spans_count_reads_and_self_time_on_the_innermost_span():
    """A read counts on the innermost open span, phase or epoch; a span's
    self time is its time less its children's; only phase spans carry the
    counts in their ``args``, and only loops ``iterations``."""
    tr = SpanTracer(enabled=True)
    with tr.span("add_epoch", events=3):
        tr.read(5)
        with tr.span("waves", cat="phase") as frame:
            tr.read(7)
            tr.read(3)
            frame.iterations = 2
        with tr.span("apply_adds", cat="phase"):
            pass
    waves, apply_, epoch = tr.spans     # completion order
    assert epoch.args == {"events": 3}
    assert (epoch.reads, epoch.read_wait_ns) == (1, 5)
    assert waves.args == {"reads": 2, "read_wait_ns": 10, "iterations": 2}
    assert apply_.args == {"reads": 0, "read_wait_ns": 0}
    assert epoch.self_ns == epoch.dur_ns - waves.dur_ns - apply_.dur_ns
    assert waves.self_ns == waves.dur_ns and waves.depth == 1
    assert tr.span_counts() == {"add_epoch": 1}
    table = phase_table(tr.spans)
    assert table["waves"] == dict(count=1, ns=waves.dur_ns,
                                  self_ns=waves.dur_ns, reads=2,
                                  read_wait_ns=10, iterations=2)
    assert table["add_epoch"]["iterations"] == 0
    tr.read(1)                 # outside every span: nowhere to count
    assert sum(r["reads"] for r in tr.phase_table().values()) == 3


def test_epoch_sets_and_restores_the_active_engine(capsys):
    """``epoch()`` points the loops at its engine and restores the outer
    one on exit, on an exception too; a read counts on the innermost
    engine's innermost span."""
    a, b = EngineObs(enabled=True), EngineObs(enabled=True)
    assert obs_mod.ACTIVE is None
    with a.epoch("add_epoch"):
        assert obs_mod.ACTIVE is a
        with b.epoch("del_epoch"):
            assert obs_mod.ACTIVE is b
            with obs_mod.phase("mark"):
                assert relax.host(torch.tensor(True)) is True
        assert obs_mod.ACTIVE is a
        relax.host_flags(torch.zeros(3, 4, dtype=torch.bool))
    assert obs_mod.ACTIVE is None
    assert b.tracer.phase_table()["mark"]["reads"] == 1
    assert a.tracer.phase_table()["add_epoch"]["reads"] == 1
    with pytest.raises(RuntimeError):
        with a.epoch("drain"):
            raise RuntimeError("boom")
    assert obs_mod.ACTIVE is None
    assert "boom" in capsys.readouterr().err


def test_to_unix_ns_round_trips_against_time_ns():
    """The tracer's Unix offset maps a ``perf_counter_ns`` stamp to within
    a millisecond of ``time.time_ns``, is sampled again at every readout,
    and places the Chrome trace's ts 0."""
    tr = SpanTracer(enabled=True)
    with tr.span("add_epoch"):
        pass
    a = time.perf_counter_ns()
    u = time.time_ns()
    b = time.perf_counter_ns()
    assert tr.to_unix_ns(a) - 10**6 <= u <= tr.to_unix_ns(b) + 10**6
    assert abs(unix_offset_ns() - tr.offsets[0][1]) < 10**6
    n = len(tr.offsets)
    tr.phase_table()
    tr.jsonl_lines()
    doc = tr.to_chrome()
    assert len(tr.offsets) == n + 3
    meta = doc["metadata"]
    assert meta["unix_offset_ns"] == tr.offsets[-1][1]
    assert doc["baseTimeNanoseconds"] == meta["base_unix_ns"] == \
        tr.to_unix_ns(tr._base_ns)
    ev, = doc["traceEvents"]
    assert ev["ts"] >= 0 and ev["cat"] == "engine"
