"""The port's sharded engine with ``sources=`` (``[S, N]`` lanes per
partition over one shared pool and layout) against the JAX sharded engine
with ``sources=`` (its ``_build_epochs_ms``) and the port's single-device
lane engine.

  * at P = 1 in process, against the JAX sharded engine: segment, ellpack
    and sliced x allgather and delta x dense and sparse frontier x rounds
    and buckets (every pair of those axes in some case), the paper's flood
    and per-event deletions too — dist, parent and the per-lane rounds and
    messages at every query;
  * against the port's single-device lane engine at P = 1, 2 and 8
    (allgather: stats too), relabeled and routed queries;
  * at P = 8 under ``"delta"`` against the JAX sharded engine run in a
    subprocess with 8 forced host devices — this file is its worker
    (``python tests/test_torch_dist_lanes.py OUT.npz``);
  * ``[S, N]`` checkpoints across the packages, both ways;
  * observability: ``metrics_snapshot()`` equal to the JAX sharded
    engine's at P = 1 (the ``[S]`` lane vectors included), and at P = 8
    summed; ``replay_trace`` reports equal to the JAX replayer's;
  * host reads: one per wave or marking round for all lanes and
    partitions — P = 8 reads what P = 1 reads, and under allgather what
    the single-device lane engine reads;
  * the factory's ``sources=`` + ``mesh=`` path and its ValueErrors
    against the reference's.

The stream is tests/test_serving.py's (ER, 72 vertices) with its tiny
layout knobs, made from seeds with numpy; the JAX runs are cached.
Tolerance: 0 — every array and counter equal.
"""
import functools
import os
import subprocess
import sys
import warnings

if __name__ == "__main__":   # the P = 8 worker: 8 host devices for jax
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402

from repro.core import factory as jfactory  # noqa: E402
from repro.core.dist_engine import (  # noqa: E402
    ShardedEngineConfig as JaxCfg, ShardedSSSPDelEngine as JaxSharded)
from repro.graphs import generators, window  # noqa: E402
from repro.launch.mesh import _mk  # noqa: E402
from repro.serving import replay as jreplay  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402

SOURCES = (3, 17, 40)
BACKEND_KW = {   # tests/test_serving.py's: rebuilds and hub spills run
    "segment": {},
    "ellpack": dict(ell_init_k=2),
    "sliced": dict(sliced_slice_rows=32, sliced_hub_k=4, sliced_init_k=1),
}
HERE = os.path.dirname(os.path.abspath(__file__))
P8_MESH = ((2, 2, 2), ("pod", "data", "model"))
P8_KNOBS = (("delta_cap", 4), ("exchange", "delta"), ("ell_init_k", 2),
            ("relax_backend", "ellpack"))


def _stream(seed=11, *, n=72, m=320, delta=0.5):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    log = window.sliding_window_stream(src, dst, w, window=m // 3,
                                       delta=delta, seed=seed,
                                       query_every=m // 2)
    return n, len(src) + 64, log, dst


STREAM = _stream()


def _ingest(eng, log):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # ELL blowup
        return eng.ingest_log(log) + [eng.query()]


@functools.cache
def _jax(knobs: tuple, observability=False):
    """The JAX sharded lane engine over STREAM (its one CPU device)."""
    n, cap, log, _ = STREAM
    eng = JaxSharded(JaxCfg(n, cap, SOURCES[0], sources=SOURCES,
                            observability=observability, **dict(knobs)))
    res = _ingest(eng, log)
    return res, (eng.metrics_snapshot() if observability else None)


def _mesh(P):
    from repro_torch.launch.mesh import make_mesh
    shape, axes = P8_MESH if P == "2x2x2" else ((P,), ("graph",))
    size = int(np.prod(shape))
    return make_mesh(shape, axes, devices=[torch.device("cpu")] * size)


def _port(P, stream=STREAM, relabel=None, **kw):
    from repro_torch.core.dist_engine import (ShardedEngineConfig,
                                              ShardedSSSPDelEngine)
    n, total, _, _ = stream
    mesh = _mesh(P)
    return ShardedSSSPDelEngine(ShardedEngineConfig(
        n, -(-total // mesh.size), SOURCES[0], sources=SOURCES,
        device="cpu", **kw), mesh=mesh, relabel=relabel)


def _single(**kw):
    from repro_torch import EngineConfig, SSSPDelEngine
    n, cap, _, _ = STREAM
    return SSSPDelEngine(EngineConfig(n, cap, SOURCES[0], sources=SOURCES,
                                      device="cpu", **kw))


def _same(got, want, *, stats=True):
    assert len(got) == len(want) > 2
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.dist, b.dist, err_msg=f"query {i}")
        np.testing.assert_array_equal(a.parent, b.parent,
                                      err_msg=f"query {i}")
        if stats:
            assert a.epoch_stats.keys() == b.epoch_stats.keys()
            for k in a.epoch_stats:
                np.testing.assert_array_equal(
                    a.epoch_stats[k], b.epoch_stats[k], err_msg=f"{i} {k}")


# ------------------------------------------------ against the JAX engine --
# every pair of (backend, exchange, frontier, schedule) values is in some
# case; the last two add the paper's flood and per-event deletions
CASES = [
    ("segment", "allgather", "dense", "rounds", {}),
    ("segment", "delta", "sparse", "buckets", {}),
    ("ellpack", "allgather", "sparse", "buckets", {}),
    ("ellpack", "delta", "dense", "rounds", dict(use_doubling=False)),
    ("sliced", "allgather", "dense", "buckets", dict(use_doubling=False)),
    ("sliced", "delta", "sparse", "rounds", {}),
    ("segment", "delta", "dense", "rounds",
     dict(use_doubling=False, batch_deletions=True)),
    ("ellpack", "allgather", "dense", "rounds", dict(batch_deletions=True)),
]


def _knobs(backend, exchange, frontier, schedule, extra):
    kw = dict(relax_backend=backend, exchange=exchange, **extra,
              **BACKEND_KW[backend])
    if exchange == "delta":
        kw["delta_cap"] = 4           # rounds overflow and stay sparse
    if frontier == "sparse":
        kw.update(frontier_mode="sparse", frontier_cap=24)
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=0.7)
    return kw


@pytest.mark.parametrize("backend,exchange,frontier,schedule,extra", CASES)
def test_lanes_match_jax_sharded_p1(backend, exchange, frontier, schedule,
                                    extra):
    """Each lane equals the JAX sharded lane engine's at every query: dist,
    parent and the per-lane rounds and messages."""
    kw = _knobs(backend, exchange, frontier, schedule, extra)
    want, _ = _jax(tuple(sorted(kw.items())))
    eng = _port(1, **kw)
    _same(_ingest(eng, STREAM[2]), want)
    assert all(eng.bk.invariants().values())


@pytest.mark.parametrize("P", [1, 2, 8])
@pytest.mark.parametrize("backend,schedule", [
    ("segment", "rounds"), ("ellpack", "rounds"), ("sliced", "rounds"),
    ("ellpack", "buckets")])
def test_lanes_match_single_device_lanes(backend, schedule, P):
    """Allgather: the sharded lane engine is bit-identical, per-lane
    counters included, to the single-device lane engine with the same
    backend at any partition count."""
    kw = dict(relax_backend=backend, batch_deletions=P == 2,
              **BACKEND_KW[backend])
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width="auto")
    _same(_ingest(_port("2x2x2" if P == 8 else P, **kw), STREAM[2]),
          _ingest(_single(**kw), STREAM[2]))


def test_sparse_lanes_take_both_branches(monkeypatch):
    """The sparse wave reads one ``[P, S]`` count tensor per wave; some
    (partition, lane) pairs compact and others take the dense wave, with
    the dense engine's results and stats."""
    from repro_torch.core import relax
    counts = []
    real = relax.host

    def spy(flags):
        got = real(flags)
        if flags.dim() == 2 and flags.dtype != torch.bool:
            counts.append(np.asarray(got))
        return got

    monkeypatch.setattr(relax, "host", spy)
    eng = _port(4, frontier_mode="sparse", frontier_cap=10)
    got = _ingest(eng, STREAM[2])
    monkeypatch.undo()
    _same(got, _ingest(_single(), STREAM[2]))
    counts = np.concatenate(counts)
    assert counts.shape[1] == len(SOURCES)
    assert (counts <= 10).any() and (counts > 10).any()


def test_relabeled_lanes_and_routed_queries():
    """Edge-balanced placement with lanes: the single-device lane engine's
    distances at every query; a routed query reads its lane alone."""
    from repro_torch.graphs import partition as part
    n, cap, log, dst = STREAM
    eng = _port(4, relabel=part.edge_balanced_relabeling(n, dst, 4))
    got = _ingest(eng, log)
    want = _ingest(_single(), log)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.dist, b.dist)
    for i, s in enumerate(SOURCES):
        r = eng.query(source=s)
        assert r.source == s and r.dist.shape == (n,)
        np.testing.assert_array_equal(r.dist, got[-1].dist[i])
        np.testing.assert_array_equal(r.parent, got[-1].parent[i])
    with pytest.raises(ValueError, match="not served"):
        eng.query(source=5)


# ------------------------------------------------------- P = 8 subprocess --
def _p8_worker(out: str) -> None:
    """Subprocess body: the JAX sharded lane engine at P = 8 on a (2, 2, 2)
    mesh of forced host devices, P8_KNOBS over STREAM; writes every
    query's dist, parent and per-lane stats."""
    assert len(jax.devices()) == 8, jax.devices()
    n, cap, log, _ = STREAM
    eng = JaxSharded(JaxCfg(n, cap, SOURCES[0], sources=SOURCES,
                            **dict(P8_KNOBS)), mesh=_mk(*P8_MESH))
    res = _ingest(eng, log)
    np.savez(out, dist=np.stack([r.dist for r in res]),
             parent=np.stack([r.parent for r in res]),
             rounds=np.stack([r.epoch_stats["rounds"] for r in res]),
             messages=np.stack([r.epoch_stats["messages"] for r in res]))


def test_delta_p8_matches_jax_sharded_p8_subprocess(tmp_path):
    """P = 8, delta exchange (a 4-slot buffer: lanes overflow apart): the
    port on a (2, 2, 2) mesh equals the JAX sharded lane engine on 8 forced
    host devices at every query, per-lane rounds and messages too."""
    out = tmp_path / "p8.npz"
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "..", "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    got = _ingest(_port("2x2x2", **dict(P8_KNOBS)), STREAM[2])
    assert len(got) == len(want["dist"]) > 2
    for key, col in (("dist", "dist"), ("parent", "parent")):
        np.testing.assert_array_equal(
            np.stack([getattr(r, col) for r in got]), want[key])
    for key in ("rounds", "messages"):
        np.testing.assert_array_equal(
            np.stack([r.epoch_stats[key] for r in got]), want[key])


# ------------------------------------------------------------ checkpoints --
@pytest.mark.parametrize("schedule", ["rounds", "buckets"])
def test_lane_checkpoints_cross_packages(schedule):
    """An ``[S, N]`` checkpoint taken mid-stream by either package's
    sharded lane engine restores into the other's, which finishes on the
    uninterrupted run's answers; the checkpoint arrays (an ``[S]`` source
    among them) are equal, dtypes too."""
    n, cap, log, _ = STREAM
    half = len(log) // 2
    kw = dict(relax_backend="sliced", **BACKEND_KW["sliced"])
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=1.0)
    want = _jax(tuple(sorted(kw.items())))[0][-1]
    mk = {"port": lambda: _port(1, **kw),
          "jax": lambda: JaxSharded(JaxCfg(n, cap, SOURCES[0],
                                           sources=SOURCES, **kw))}
    ckpts = {}
    for first, then in (("port", "jax"), ("jax", "port")):
        a = mk[first]()
        _ingest(a, log[:half])
        ckpts[first] = ck = a.checkpoint()
        b = mk[then]()
        b.restore(ck)
        got = _ingest(b, log[half:])[-1]
        np.testing.assert_array_equal(got.dist, want.dist)
        np.testing.assert_array_equal(got.parent, want.parent)
    assert ckpts["port"].keys() == ckpts["jax"].keys()
    assert np.asarray(ckpts["port"]["dist"]).shape == (len(SOURCES), n)
    for k in ckpts["port"]:
        np.testing.assert_array_equal(ckpts["port"][k], ckpts["jax"][k],
                                      err_msg=k)
        assert np.asarray(ckpts["port"][k]).dtype == \
            np.asarray(ckpts["jax"][k]).dtype, k
    with pytest.raises(ValueError, match="source"):
        _port(1, **kw).restore({**ckpts["port"], "source": np.arange(3)})


# ---------------------------------------------------------- observability --
@pytest.mark.parametrize("backend,schedule", [("ellpack", "rounds"),
                                              ("segment", "buckets")])
def test_lane_metrics_snapshot_matches_jax_sharded(backend, schedule):
    """Observability on: counters (the ``[S]`` lane vectors and ``[P]``
    partition vectors), histograms, span counts and the flight recorder
    equal to the JAX sharded lane engine's at P = 1; at P = 8 the
    per-partition vectors sum to the same totals and the lane vectors are
    equal."""
    from test_torch_obs import _assert_counters_match
    kw = dict(relax_backend=backend, **BACKEND_KW[backend])
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=0.7)
    want, jsnap = _jax(tuple(sorted(kw.items())), observability=True)
    eng = _port(1, observability=True, **kw)
    _same(_ingest(eng, STREAM[2]), want)
    snap = eng.metrics_snapshot()
    for k in ("epochs", "adds", "dels", "spans", "flight"):
        assert snap[k] == jsnap[k], k
    for k in ("rounds", "messages"):
        np.testing.assert_array_equal(snap[k], jsnap[k])
    _assert_counters_match(snap["counters"], jsnap["counters"])
    assert "updates_per_lane" in snap["counters"]
    assert snap["attribution"].keys() == jsnap["attribution"].keys()
    eng8 = _port(8, observability=True, **kw)
    _same(_ingest(eng8, STREAM[2]), want)
    c8 = eng8.metrics_snapshot()["counters"]
    for k, v in c8.items():
        if k.endswith("_per_part"):
            assert np.shape(v) == (8,)
            assert int(np.sum(v)) == int(np.sum(jsnap["counters"][k])), k
        elif k.endswith("_per_lane") or k.startswith("pending_"):
            np.testing.assert_array_equal(v, jsnap["counters"][k], err_msg=k)


def test_replay_report_matches_jax_replayer():
    """``replay_trace`` on the sharded lane engine (routed queries) equals
    the JAX replayer on the JAX sharded lane engine, bar the clocks; both
    label it ``sharded/<backend>``."""
    from repro_torch.serving import replay_trace
    from test_torch_replay import _assert_reports_match, _multi_source_trace
    n, cap, log, _ = STREAM
    trace = _multi_source_trace(log, SOURCES + (-1,))
    jt = jtrace.ServingTrace(*(getattr(trace, c) for c in
                               ("kind", "src", "dst", "w", "t")))
    kw = dict(relax_backend="ellpack", observability=True,
              **BACKEND_KW["ellpack"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = replay_trace(_port(1, **kw), trace)
        want = jreplay.replay_trace(
            JaxSharded(JaxCfg(n, cap, SOURCES[0], sources=SOURCES, **kw)),
            jt)
    assert got.engine == want.engine == "sharded/ellpack"
    _assert_reports_match(got, want)


# -------------------------------------------------------------- host reads --
def _reads(monkeypatch, eng):
    from test_torch_serving import _count_reads
    got, counts = _count_reads(monkeypatch, eng, STREAM[2],
                               lane_vectors=False)
    assert counts["any"] == counts["flags"] > 0
    return got


@pytest.mark.parametrize("exchange,schedule", [
    ("allgather", "rounds"), ("delta", "rounds"), ("allgather", "buckets"),
    ("delta", "buckets")])
def test_one_read_per_wave_for_all_lanes_and_partitions(monkeypatch,
                                                        exchange, schedule):
    """Every read goes through ``relax.host``: one small tensor for all
    lanes and partitions a wave or marking round.  P = 8 makes exactly the
    reads P = 1 makes, epoch by epoch (under ``"delta"`` with a buffer no
    partition overflows: an overflowing round offers a superset, which
    moves the round counts with P, in the reference too); under allgather
    both make the single-device lane engine's.  A 4-slot buffer, where
    lanes overflow apart, still reads only through ``relax.host``."""
    kw = dict(relax_backend="ellpack", wave_schedule=schedule,
              exchange=exchange, **BACKEND_KW["ellpack"])
    if schedule == "buckets":
        kw["bucket_width"] = 1.0
    runs = [_reads(monkeypatch, _port(P, delta_cap=128, **kw))
            for P in (1, 8)]
    assert runs[0] == runs[1]
    if exchange == "allgather":
        kw.pop("exchange")
        assert runs[0] == _reads(monkeypatch, _single(**kw))
    else:
        _reads(monkeypatch, _port(8, delta_cap=4, **kw))


# ---------------------------------------------------------------- factory --
def test_factory_builds_the_sharded_lane_engine():
    """``make_engine(sources=..., mesh=...)`` (or ``partitions=``) builds
    the sharded lane engine, as the reference's factory does."""
    from repro_torch import ShardedSSSPDelEngine, make_engine
    n, cap, log, _ = STREAM
    eng = make_engine(num_vertices=n, edge_capacity=cap, sources=SOURCES,
                      mesh=_mesh(4), device="cpu", relax_backend="ellpack",
                      **BACKEND_KW["ellpack"])
    assert isinstance(eng, ShardedSSSPDelEngine) and eng.P == 4
    assert eng.sources == SOURCES
    _same(_ingest(eng, log), _ingest(_single(relax_backend="ellpack",
                                             **BACKEND_KW["ellpack"]), log))
    one = make_engine(num_vertices=n, edge_capacity=cap, sources=SOURCES,
                      partitions=1, device="cpu")
    assert isinstance(one, ShardedSSSPDelEngine) and one.P == 1


@pytest.mark.parametrize("sources", [(), (8,), (-1, 2), (1, 1)])
def test_factory_lane_value_errors_match_reference(sources):
    """Empty, out-of-range and duplicate ``sources`` on the sharded path
    raise the reference's ValueErrors."""
    with pytest.raises(ValueError) as theirs:
        jfactory.make_engine(num_vertices=8, edge_capacity=16,
                             sources=sources, partitions=1)
    from repro_torch import make_engine
    with pytest.raises(ValueError) as mine:
        make_engine(num_vertices=8, edge_capacity=16, sources=sources,
                    partitions=1, device="cpu")
    assert str(mine.value) == str(theirs.value)


if __name__ == "__main__":
    _p8_worker(sys.argv[1])
