"""The port's sharded engine (``repro_torch.core.dist_engine``, single
source) against the JAX engines, on meshes of the CPU device repeated.

  * allgather exchange, segment / ellpack / sliced x ``batch_deletions`` x
    ``use_doubling`` at P = 1, 2 and 8 (half of the P = 8 cases on a
    (2, 2, 2) mesh): equal to the JAX single-device ``SSSPDelEngine`` with
    the same backend at every query in dist, parent and the epoch stats
    (rounds, messages, epochs, adds, dels); the sparse frontier too, with
    both of its branches taken;
  * (the delta exchange's engine tests are in test_torch_distributed.py,
    beside the exchange itself);
  * buckets: (dist, parent) equal to the single-device rounds engine at
    every query, stats equal to the JAX sharded bucketed engine at P = 1;
  * relabeling, checkpoints across the packages both ways (P = 1) and a
    restore into a fresh engine at P = 8, ``on_duplicate="min"``;
  * observability: counters (the ``[P]`` per-partition vectors included),
    histograms and span counts equal to the JAX sharded engine's at P = 1;
  * the factory's ValueErrors equal the reference's, and it builds the
    sharded engine (with lanes too: ``sources=``);
  * host reads: one read per wave for all partitions, as many at P = 8 as
    at P = 1;
  * the example ``examples/torch_sharded_streaming_sssp.py`` (``--device
    cpu``): its equivalence check passes, a bad trace path exits 2.

Streams are made from seeds with numpy (ER, 90-120 vertices).  Tolerance:
0 — every array and counter equal.
"""
import functools
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import factory as jfactory
from repro.core.dist_engine import ShardedEngineConfig as JaxShardedConfig
from repro.core.dist_engine import ShardedSSSPDelEngine as JaxSharded
from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.graphs import generators, window

SOURCE = 3
BACKENDS = ("segment", "ellpack", "sliced")
# tiny layout knobs so rebuilds and hub spills run under sharding too
BACKEND_KW = {
    "segment": {},
    "ellpack": dict(ell_init_k=2),
    "sliced": dict(sliced_slice_rows=8, sliced_hub_k=4, sliced_init_k=1),
}
P8_MESH = ((2, 2, 2), ("pod", "data", "model"))


def _stream(seed=31, *, n=90, m=520, delta=0.6):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    log = window.sliding_window_stream(src, dst, w, window=m // 3,
                                       delta=delta, seed=seed,
                                       query_every=m // 4)
    return n, len(src) + 64, log, dst


STREAM = _stream()


def _ingest(eng, log):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # ELL blowup
        return eng.ingest_log(log) + [eng.query()]


@functools.cache
def _jax_single(backend, **kw):
    n, cap, log, _ = STREAM
    eng = JaxEngine(JaxConfig(n, cap, SOURCE, relax_backend=backend,
                              **BACKEND_KW[backend], **kw))
    return _ingest(eng, log)


@functools.cache
def _jax_sharded(knobs: tuple, observability=False):
    n, cap, log, _ = STREAM
    eng = JaxSharded(JaxShardedConfig(n, cap, SOURCE,
                                      observability=observability,
                                      **dict(knobs)))
    res = _ingest(eng, log)
    return res, (eng.metrics_snapshot() if observability else None)


def _mesh(P):
    from repro_torch.launch.mesh import make_mesh
    shape, axes = P8_MESH if P == "2x2x2" else ((P,), ("graph",))
    size = int(np.prod(shape))
    return make_mesh(shape, axes, devices=[torch.device("cpu")] * size)


def _port(P, log_stream=STREAM, source=SOURCE, **kw):
    from repro_torch.core.dist_engine import (ShardedEngineConfig,
                                              ShardedSSSPDelEngine)
    n, total, _, _ = log_stream
    mesh = _mesh(P)
    return ShardedSSSPDelEngine(ShardedEngineConfig(
        n, -(-total // mesh.size), source, device="cpu", **kw), mesh=mesh)


def _same(got, want, *, stats=True):
    assert len(got) == len(want) > 2
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.dist, b.dist, err_msg=f"query {i}")
        np.testing.assert_array_equal(a.parent, b.parent,
                                      err_msg=f"query {i}")
        if stats:
            assert a.epoch_stats == b.epoch_stats, (i, a.epoch_stats,
                                                    b.epoch_stats)


# ------------------------------------------------------ allgather exchange --
@pytest.mark.parametrize("P", [1, 2, 8])
@pytest.mark.parametrize("use_doubling", [True, False])
@pytest.mark.parametrize("batch_deletions", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_allgather_matches_jax_single_device(backend, batch_deletions,
                                             use_doubling, P):
    """The equivalence contract across the partition and backend axes:
    bit-identical (dist, parent) and equal rounds / messages at every
    query; P = 8 runs on a (2, 2, 2) mesh when deletions are batched."""
    kw = dict(batch_deletions=batch_deletions, use_doubling=use_doubling)
    want = _jax_single(backend, **kw)
    mesh = "2x2x2" if (P == 8 and batch_deletions) else P
    eng = _port(mesh, relax_backend=backend, **kw, **BACKEND_KW[backend])
    _same(_ingest(eng, STREAM[2]), want)
    assert all(eng.bk.invariants().values())
    if backend != "segment":
        # the coupled rebuild ran, every planner in step
        assert len({pl.rebuilds for pl in eng.bk.planners}) == 1
        assert eng.bk.planners[0].rebuilds >= 1


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sparse_frontier_matches_and_takes_both_branches(backend, P,
                                                         monkeypatch):
    """``frontier_mode="sparse"`` with a small cap: every wave reads the P
    partitions' live-offer counts once; some partitions compact, others
    take the backend's own wave; the results and stats are the dense
    single-device engine's."""
    from repro_torch.core import relax
    cap = 24
    counts = []
    real = relax.host

    def spy(flags):
        got = real(flags)
        if flags.dim() == 1 and flags.dtype != torch.bool:
            counts.extend(np.atleast_1d(got).tolist())
        return got

    monkeypatch.setattr(relax, "host", spy)
    eng = _port(P, relax_backend=backend, frontier_mode="sparse",
                frontier_cap=cap, **BACKEND_KW[backend])
    got = _ingest(eng, STREAM[2])
    monkeypatch.undo()
    _same(got, _jax_single(backend))
    counts = np.asarray(counts)
    assert (counts <= cap).any() and (counts > cap).any()


# ------------------------------------------------------------------ buckets --
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("backend,width,exchange", [
    ("segment", 1.0, "allgather"), ("ellpack", 0.3, "allgather"),
    ("sliced", "auto", "delta"), ("segment", float("inf"), "delta")])
def test_buckets_match(backend, width, exchange, P):
    """Bucketed: (dist, parent) equal the single-device rounds engine at
    every query; at P = 1 the stats equal the JAX sharded bucketed
    engine's (its rounds and messages are the bucketed schedule's)."""
    knobs = dict(wave_schedule="buckets", bucket_width=width,
                 exchange=exchange, delta_cap=8, relax_backend=backend,
                 **BACKEND_KW[backend])
    got = _ingest(_port(P, **knobs), STREAM[2])
    _same(got, _jax_single(backend), stats=False)
    if P == 1:
        want, _ = _jax_sharded(tuple(sorted(knobs.items())))
        _same(got, want)


# ------------------------------------------- relabel, checkpoints, min-dup --
def test_edge_balanced_relabeling():
    """Edge-balanced placement: the same distances as the single-device
    engine, a valid tree, the pools carry every live edge; a relabeling
    built for another partition count raises."""
    from repro_torch.core.dist_engine import (ShardedEngineConfig,
                                              ShardedSSSPDelEngine)
    from repro_torch.core.oracle import check_tree
    from repro_torch.graphs import partition as part
    n, cap, log, dst = STREAM
    relabel = part.edge_balanced_relabeling(n, dst, 4)
    cfg = ShardedEngineConfig(n, cap, SOURCE, device="cpu")
    eng = ShardedSSSPDelEngine(cfg, mesh=_mesh(4), relabel=relabel)
    got = _ingest(eng, log)
    for a, b in zip(got, _jax_single("segment")):
        np.testing.assert_array_equal(a.dist, b.dist)
    live = [np.concatenate(x) for x in zip(*(a.active_coo()
                                             for a in eng.allocs))]
    check_tree(n, *(np.asarray(eng.inv)[x] if i < 2 else x
                    for i, x in enumerate(live)), SOURCE,
               got[-1].dist, got[-1].parent)
    fill = eng.partition_fill()
    assert fill.sum() == len(live[0]) and (fill > 0).all()
    with pytest.raises(ValueError, match="partitions"):
        ShardedSSSPDelEngine(cfg, mesh=_mesh(4),
                             relabel=part.edge_balanced_relabeling(n, dst, 8))


@pytest.mark.parametrize("backend", ["segment", "sliced"])
def test_checkpoints_cross_packages_at_p1(backend):
    """A checkpoint taken mid-stream by either package's sharded engine
    restores into the other's, which finishes on the uninterrupted run's
    answers (dist, parent); the checkpoint arrays are equal."""
    n, cap, log, _ = STREAM
    half = len(log) // 2
    kw = dict(relax_backend=backend, **BACKEND_KW[backend])
    want = _jax_single(backend)[-1]
    mk = {"port": lambda: _port(1, **kw),
          "jax": lambda: JaxSharded(JaxShardedConfig(n, cap, SOURCE, **kw))}
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
    for k in ckpts["port"]:
        np.testing.assert_array_equal(ckpts["port"][k], ckpts["jax"][k],
                                      err_msg=k)
        assert np.asarray(ckpts["port"][k]).dtype == \
            np.asarray(ckpts["jax"][k]).dtype, k


@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_restore_fresh_engine_p8(backend):
    """Crash-restart at P = 8: checkpoint after half the stream, restore
    into a FRESH engine (fresh planners, layouts rebuilt from the
    mirrors), finish — the uninterrupted run's answers at every query."""
    n, cap, log, _ = STREAM
    half = len(log) // 2
    kw = dict(relax_backend=backend, **BACKEND_KW[backend])
    eng = _port(8, **kw)
    first = eng.ingest_log(log[:half])
    ck = eng.checkpoint()
    del eng
    eng = _port(8, **kw)
    eng.restore(ck)
    _same(first + _ingest(eng, log[half:]), _jax_single(backend),
          stats=False)
    assert all(eng.bk.invariants().values())


@pytest.mark.parametrize("backend", ["ellpack", "sliced"])
def test_layouts_equal_jax_sharded_at_p1(backend):
    """After the stream, the port's partition block is the JAX sharded
    engine's layout array for array (P = 1: one block), and the planners
    rebuilt as often."""
    n, cap, log, _ = STREAM
    kw = dict(relax_backend=backend, **BACKEND_KW[backend])
    mine = _port(1, **kw)
    theirs = JaxSharded(JaxShardedConfig(n, cap, SOURCE, **kw))
    _ingest(mine, log)
    _ingest(theirs, log)
    st, jst = mine.bk.states[0], theirs.bk.state
    names = (("nbr_idx", "nbr_w", "fill") if backend == "ellpack" else
             ("flat_idx", "flat_w", "fill", "base", "rowk", "osrc", "odst",
              "ow"))
    for name in names:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    assert mine.bk.layout_counters() == theirs.bk.layout_counters()


@pytest.mark.parametrize("backend", BACKENDS)
def test_min_duplicate_policy(backend):
    """``on_duplicate="min"``: a weight decrease reaches the layouts of
    the owning partition; an increase is dropped."""
    res = {}
    for name, eng in (("single", JaxEngine(JaxConfig(8, 32, 0,
                                                     on_duplicate="min"))),
                      ("port", _port(4, (8, 32, None, None), source=0,
                                     on_duplicate="min",
                                     relax_backend=backend,
                                     **BACKEND_KW[backend]))):
        eng.ingest_log(jev.adds([0, 1, 0, 0, 6], [1, 2, 2, 1, 7],
                                [4.0, 1.0, 9.0, 2.0, 1.0]))
        eng.ingest_log(jev.adds([0, 2], [1, 6], [1.0, 0.5]))  # decrease
        eng.ingest_log(jev.adds([0], [2], [20.0]))  # increase is dropped
        res[name] = eng.query()
    _same([res["port"]] * 3, [res["single"]] * 3, stats=False)
    assert res["port"].dist[2] == pytest.approx(2.0)


# ------------------------------------------------------------ observability --
@pytest.mark.parametrize("backend,schedule", [
    ("segment", "rounds"), ("ellpack", "buckets"), ("sliced", "rounds"),
    ("sliced", "buckets")])
def test_obs_matches_jax_sharded_p1(backend, schedule):
    """Observability on: the same answers, and counters (per-partition
    ``[P]`` vectors included), histograms, span counts and the flight
    recorder equal to the JAX sharded engine's; at P = 8 the vectors sum
    to the same totals."""
    from test_torch_obs import _assert_counters_match
    knobs = dict(relax_backend=backend, **BACKEND_KW[backend])
    if schedule == "buckets":
        knobs.update(wave_schedule="buckets", bucket_width=0.7)
    want, jsnap = _jax_sharded(tuple(sorted(knobs.items())),
                               observability=True)
    eng = _port(1, observability=True, **knobs)
    _same(_ingest(eng, STREAM[2]), want)
    snap = eng.metrics_snapshot()
    for k in ("epochs", "adds", "dels", "rounds", "messages", "spans",
              "flight"):
        assert snap[k] == jsnap[k], k
    _assert_counters_match(snap["counters"], jsnap["counters"])
    assert snap["histograms"].keys() == jsnap["histograms"].keys()
    assert snap["attribution"].keys() == jsnap["attribution"].keys()
    eng8 = _port(8, observability=True, **knobs)
    _same(_ingest(eng8, STREAM[2]), want)
    snap8 = eng8.metrics_snapshot()
    # partitions' planners rebuild at their own fills: rebuild counts differ
    assert ({k: v for k, v in snap8["spans"].items() if k != "rebuild"}
            == {k: v for k, v in jsnap["spans"].items() if k != "rebuild"})
    for k, v in snap8["counters"].items():
        if k.endswith("_per_part") or k.startswith("pending_"):
            assert np.shape(v) == (8,)
            assert int(np.sum(v)) == int(np.sum(jsnap["counters"][k])), k
        elif not k.startswith(("hist_", "rebuilds", "overflow")):
            np.testing.assert_array_equal(v, jsnap["counters"][k], err_msg=k)


# ------------------------------------------------------------------ factory --
@pytest.mark.parametrize("kw", [
    dict(partitions=2), dict(partitions=0), dict(relabel=(0, 0, 1)),
    dict(partitions=1, relax_backend="auto"),
    dict(partitions=1, exchange="bogus"),
    dict(partitions=1, sliced_hub_k=8),
    dict(partitions=1, bogus=1),
])
def test_factory_value_errors_match_reference(kw):
    """The sharded factory path raises the reference's ValueErrors (the
    valid-knob list aside: the port's config adds ``device``)."""
    with pytest.raises(ValueError) as theirs:
        jfactory.make_engine(num_vertices=8, edge_capacity=16, **kw)
    from repro_torch import make_engine
    with pytest.raises(ValueError) as mine:
        make_engine(num_vertices=8, edge_capacity=16, device="cpu", **kw)
    head = lambda e: str(e.value).split("valid knobs")[0]  # noqa: E731
    assert head(mine) == head(theirs)


def test_factory_builds_the_sharded_engine():
    from repro_torch import ShardedSSSPDelEngine, make_engine
    eng = make_engine(num_vertices=90, edge_capacity=600, source=SOURCE,
                      mesh=_mesh(4), device="cpu", relax_backend="ellpack")
    assert isinstance(eng, ShardedSSSPDelEngine)
    assert (eng.P, eng.epp) == (4, 150)
    one = make_engine(num_vertices=90, edge_capacity=600, partitions=1,
                      device="cpu")
    assert isinstance(one, ShardedSSSPDelEngine) and one.P == 1
    lanes = make_engine(num_vertices=8, edge_capacity=16, partitions=1,
                        sources=(0, 1), device="cpu")
    assert isinstance(lanes, ShardedSSSPDelEngine)
    assert lanes.sources == (0, 1) and lanes.dist[0].shape == (2, 8)
    with pytest.raises(ValueError, match="device type"):
        from repro_torch.core.dist_engine import (ShardedEngineConfig,
                                                  ShardedSSSPDelEngine as E)
        from repro_torch.launch.mesh import Mesh
        E(ShardedEngineConfig(8, 8, 0, device="cpu"),
          mesh=Mesh({"graph": 1}, ("graph",), (torch.device("meta"),)))


# --------------------------------------------------------------- host reads --
def _reads(monkeypatch, eng, log):
    """Ingest ``log`` run by run (QUERY = ``drain()``), counting host reads
    of tensors and those through ``relax.host`` (one each, whatever it
    reads inside): ([reads per run], total, through relax.host)."""
    from test_torch_serving import _count_reads
    got, counts = _count_reads(monkeypatch, eng, log, lane_vectors=False)
    return got, counts["any"], counts["flags"]


@pytest.mark.parametrize("exchange,schedule", [
    ("allgather", "rounds"), ("delta", "rounds"), ("allgather", "buckets")])
def test_one_host_read_per_wave_for_all_partitions(monkeypatch, exchange,
                                                   schedule):
    """Every read goes through ``relax.host`` — one small tensor for all
    partitions — and P = 8 makes exactly the reads P = 1 makes, run by
    run.  Under the rounds schedule that is one read per wave plus one per
    epoch (its first loop check, or a deletion's seed check); the delta
    recompute counts no pull round, so a seeded deletion reads once more
    there."""
    knobs = dict(exchange=exchange, relax_backend="ellpack",
                 wave_schedule=schedule, **BACKEND_KW["ellpack"])
    if schedule == "buckets":
        knobs["bucket_width"] = 1.0
    runs = []
    for P in (1, 8):
        eng = _port(P, delta_cap=8, **knobs)
        got, total, flags = _reads(monkeypatch, eng, STREAM[2])
        assert total == flags > 0
        runs.append(got)
        if exchange == "allgather" and schedule == "rounds":
            assert total == eng.n_rounds + eng.n_epochs
        elif schedule == "rounds":
            assert eng.n_rounds + eng.n_epochs < total \
                <= eng.n_rounds + 2 * eng.n_epochs
    assert runs[0] == runs[1]


# ------------------------------------------------------------------ example --
EXAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "examples", "torch_sharded_streaming_sssp.py")


@pytest.mark.parametrize("args,code,says", [
    (["--partitions", "4", "--backend", "ellpack", "--exchange", "delta"],
     0, "single-device equivalence: OK (bit-identical dist, parent)"),
    (["--partitions", "2", "--replay-trace", "/nonexistent/x.trace"], 2,
     "error"),
])
def test_sharded_example_runs_on_cpu(args, code, says):
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(EXAMPLE), "..", "src")}
    out = subprocess.run([sys.executable, EXAMPLE, "--device", "cpu",
                          "--scale", "7", *args], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == code, out.stderr[-2000:]
    assert says in out.stdout + out.stderr
