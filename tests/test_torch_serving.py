"""Batched multi-source lanes of the port (``sources=(s0, ...)``: stacked
``[S, N]`` trees over one shared layout) against ``repro.core.engine``'s
batched engine — the single-host half of tests/test_serving.py (its
sharded and trace tests wait for the sharded engine and serving).

On a mixed ADD/DEL/QUERY stream, for the segment, dense-ELL, sliced (plain
and on K2's plain version) and ``auto`` backends, the dense, sparse and auto
frontiers, the rounds and bucketed schedules, and per-event and batched
deletions: every lane equals the JAX batched engine's lane and a port
single-source engine of its source — dist, parent and the per-lane round
and message counters — and a routed lane query returns exactly that lane.
Also: query routing and validation, stability scoped per source, a
batched checkpoint restored across the packages, ``invariants()`` after
every stream.

Not carried over: the reference's
``test_batched_ingest_never_reads_device_values``.  Its ``lax.while_loop``s
keep the ingest free of host reads; the port's eager loops read each
wave's flags back (``relax.host_flags``), so ingest does read.  In its
place, ``test_batched_ingest_reads_one_flag_vector_per_wave`` counts the
reads: every one is a single read of all S lanes' flags, so a batched
engine makes as many as the busiest of its lanes' single-source engines
needs in each epoch, never their sum; and
``test_batched_sparse_ingest_reads_lane_vectors`` those of the sparse
frontier, whose waves also read all lanes' ladder counts as one [3, S]
tensor.

The JAX engines run ``sliced_fused=False`` and ``frontier_kernel=False``.
Inputs are made from seeds with numpy.  Tolerance: 0.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.graphs import generators, window
from repro_torch import EngineConfig, SSSPDelEngine
from repro_torch.core import relax

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


def _stream(seed=11, *, n=72, m=320, delta=0.5):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    log = window.sliding_window_stream(src, dst, w, window=m // 3,
                                       delta=delta, seed=seed,
                                       query_every=m // 2)
    return n, len(src) + 64, log


STREAM = _stream()


def _ingest(eng, log):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # ELL blowup
        out = eng.ingest_log(log)
        out.append(eng.query())
    return out


def _port(backend, source, **extra):
    name, shared, port_only = BACKENDS[backend]
    n, cap, _ = STREAM
    return SSSPDelEngine(EngineConfig(n, cap, source, relax_backend=name,
                                      device="cpu", **shared, **port_only,
                                      **extra))


@functools.cache
def _jax_batched(name, knobs):
    n, cap, log = STREAM
    eng = JaxEngine(JaxConfig(n, cap, SOURCES[0], relax_backend=name,
                              sources=SOURCES, **dict(knobs)))
    return _ingest(eng, log), eng.n_rounds, eng.n_messages


@functools.cache
def _single(source, schedule, batch_deletions):
    """A single-source port engine's results.  One per (source, schedule,
    batch_deletions): single-source results are bit-identical across
    backends and frontier modes (test_torch_buckets.py and the earlier
    slices' tests hold each against the JAX engine), so the segment
    engine on the dense frontier stands for every configuration."""
    kw = dict(batch_deletions=batch_deletions)
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=0.7)
    return _ingest(_port("segment", source, **kw), STREAM[2])


def _lane_stats_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


# every backend under every frontier mode and schedule, but auto only on
# the dense frontier: its sparse waves are the other backends', and the
# JAX batched auto engine recompiles its vmapped epochs at every rebuild
CASES = [(b, f, s) for b in sorted(BACKENDS)
         for f in ("dense", "sparse", "auto")
         for s in ("rounds", "buckets") if b != "auto" or f == "dense"]


@pytest.mark.parametrize("backend,mode,schedule", CASES)
def test_batched_lanes_bit_identical(backend, mode, schedule):
    """Each lane == the JAX batched engine's lane == a port single-source
    engine of that source, per-lane counters included, at every query;
    routed lane queries read back exactly that lane.  Deletions are
    batched under rounds on the sparse frontier and under buckets on the
    others, per event on the rest."""
    bd = (mode == "sparse") == (schedule == "rounds")
    kw = dict(batch_deletions=bd)
    if mode != "dense":
        kw.update(frontier_mode=mode, frontier_cap=32)
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=0.7)
    bat = _port(backend, SOURCES[0], sources=SOURCES, **kw)
    got = _ingest(bat, STREAM[2])
    name, shared, _ = BACKENDS[backend]
    want, j_rounds, j_msgs = _jax_batched(
        name, tuple(sorted({**shared, **kw}.items())))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.dist.shape == (len(SOURCES), STREAM[0])
        np.testing.assert_array_equal(g.dist, w.dist)
        np.testing.assert_array_equal(g.parent, w.parent)
        _lane_stats_equal(g.epoch_stats, w.epoch_stats)
    np.testing.assert_array_equal(bat.n_rounds, j_rounds)
    np.testing.assert_array_equal(bat.n_messages, j_msgs)
    for i, s in enumerate(SOURCES):
        ref = _single(s, schedule, bd)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.dist[i], r.dist)
            np.testing.assert_array_equal(g.parent[i], r.parent)
            assert g.epoch_stats["rounds"][i] == r.epoch_stats["rounds"]
            assert g.epoch_stats["messages"][i] == r.epoch_stats["messages"]
        ql = bat.query(source=s)
        assert ql.source == s and ql.dist.shape == (STREAM[0],)
        np.testing.assert_array_equal(ql.dist, ref[-1].dist)
        np.testing.assert_array_equal(ql.parent, ref[-1].parent)
    inv = bat.backend.invariants()
    assert all(inv.values())
    if backend == "ellpack":
        assert bat.backend.planner.rebuilds >= 1
    if backend.startswith("sliced"):
        assert bat.backend.planner.spills >= 1


def test_batched_query_routing_and_validation():
    n, cap, log = STREAM
    bat = SSSPDelEngine(EngineConfig(n, cap, 3, sources=SOURCES,
                                     device="cpu"))
    bat.ingest_log(log)
    with pytest.raises(ValueError, match="not served"):
        bat.query(source=99)
    single = SSSPDelEngine(EngineConfig(n, cap, 3, device="cpu"))
    single.ingest_log(log)
    assert single.serves(3) and not single.serves(4)
    assert bat.serves(17) and not bat.serves(4)
    assert bat.lane_of(40) == 2 and bat.route_of(-1) is None
    with pytest.raises(ValueError, match="not served"):
        single.query(source=4)
    with pytest.raises(ValueError, match="single-source"):
        single.lane_of(3)
    # query markers carrying a served source route to its lane
    res = bat.ingest_log(jev.query_marker(source=SOURCES[1]))
    assert res[0].source == SOURCES[1] and res[0].dist.shape == (n,)
    # unserved/-1 markers read the full stack
    res = bat.ingest_log(jev.query_marker())
    assert res[0].source is None and res[0].dist.shape == (len(SOURCES), n)
    res = bat.ingest_log(jev.query_marker(source=4))
    assert res[0].source is None
    with pytest.raises(ValueError, match="duplicate"):
        SSSPDelEngine(EngineConfig(n, cap, 3, sources=(3, 3), device="cpu"))
    for bad in ((n + 5,), (), (-1, 2)):
        with pytest.raises(ValueError, match="sources"):
            EngineConfig(n, cap, 3, sources=bad, device="cpu")


READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
         "__float__", "__index__", "__array__")


def _count_reads(monkeypatch, eng, log, lane_vectors=True):
    """Ingest ``log`` epoch by epoch (a QUERY marker as a ``drain()``),
    counting host reads of tensors (the ``READS`` methods) and the reads
    made through ``relax.host``; a ``relax.host`` call counts as one read,
    whatever it calls inside, and with ``lane_vectors`` reads the flags of
    all the engine's lanes.  Returns ([reads per epoch], the two totals and
    the shapes of the tensors read outside ``relax.host``).  Also used by
    test_torch_obs.py: observability must add no read."""
    counts = {"any": 0, "flags": 0, "shapes": []}
    inside = [False]
    for meth in READS:
        real = getattr(torch.Tensor, meth)

        def counted(self, *a, _real=real, **k):
            if not inside[0]:
                counts["any"] += 1
                counts["shapes"].append(tuple(self.shape))
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, meth, counted)
    real_host = relax.host

    def host(flags):
        counts["flags"] += 1
        counts["any"] += 1
        if lane_vectors:
            assert flags.dim() == (0 if eng.sources is None else 1)
        inside[0] = True
        try:
            return real_host(flags)
        finally:
            inside[0] = False

    monkeypatch.setattr(relax, "host", host)
    per_epoch = []
    step = {jev.ADD: eng._ingest_adds, jev.DEL: eng._ingest_dels,
            jev.QUERY: lambda _: eng.drain()}
    for batch in log.runs():
        before = counts["any"]
        step[batch.kind](batch)
        per_epoch.append(counts["any"] - before)
    monkeypatch.undo()
    return per_epoch, counts


@pytest.mark.parametrize("schedule", ["rounds", "buckets"])
def test_batched_ingest_reads_one_flag_vector_per_wave(monkeypatch,
                                                       schedule):
    """Every host read during batched ingest and the bucketed drains is one
    ``relax.host`` read of all S lanes' flags (one per wave or mark round);
    each epoch makes at least as many reads as the busiest lane's
    single-source engine and at most as many as all of theirs together."""
    kw = dict(relax_backend="ellpack", ell_init_k=2, batch_deletions=True)
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=1.0)
    n, cap, log = STREAM
    bat = SSSPDelEngine(EngineConfig(n, cap, 3, sources=SOURCES,
                                     device="cpu", **kw))
    got, counts = _count_reads(monkeypatch, bat, log)
    assert counts["any"] == counts["flags"] == sum(got) > 0
    assert all(bat.backend.invariants().values())
    singles = []
    for s in SOURCES:
        one = SSSPDelEngine(EngineConfig(n, cap, s, device="cpu", **kw))
        singles.append(_count_reads(monkeypatch, one, log)[0])
    per_lane = np.asarray(singles)
    assert (np.asarray(got) >= per_lane.max(0)).all()
    assert (np.asarray(got) <= per_lane.sum(0)).all()
    assert sum(got) < per_lane.sum()


@pytest.mark.parametrize("schedule", ["rounds", "buckets"])
def test_batched_sparse_ingest_reads_lane_vectors(monkeypatch, schedule):
    """The sparse frontier on a batched engine: every ``relax.host`` read is
    one [S] flag vector and every other read is a ladder wave's one [3, S]
    read of all lanes' counts; each epoch makes at least as many reads as
    the busiest lane's single-source engine, and the stream fewer than all
    of theirs together.  A small cap sends some waves to the dense
    fallback, which reads the counts too."""
    kw = dict(relax_backend="segment", frontier_mode="sparse",
              frontier_cap=16, batch_deletions=True)
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=1.0)
    n, cap, log = STREAM
    bat = SSSPDelEngine(EngineConfig(n, cap, 3, sources=SOURCES,
                                     device="cpu", **kw))
    got, counts = _count_reads(monkeypatch, bat, log)
    assert counts["flags"] > 0 and counts["any"] > counts["flags"]
    assert counts["any"] == counts["flags"] + len(counts["shapes"])
    assert set(counts["shapes"]) == {(3, len(SOURCES))}
    singles = []
    for s in SOURCES:
        one = SSSPDelEngine(EngineConfig(n, cap, s, device="cpu", **kw))
        singles.append(_count_reads(monkeypatch, one, log)[0])
    per_lane = np.asarray(singles)
    assert (np.asarray(got) >= per_lane.max(0)).all()
    assert sum(got) < per_lane.sum()


def test_stability_scoped_per_source():
    """Routed lane snapshots from different sources are never compared with
    each other: alternating per-source queries with no topology change in
    between all score 1.0."""
    n, cap, log = STREAM
    eng = SSSPDelEngine(EngineConfig(n, cap, 3, sources=SOURCES,
                                     device="cpu"))
    eng.ingest_log(log[np.asarray(log.kind) != jev.QUERY])
    scores = []
    for _ in range(2):
        for s in SOURCES:
            r = eng.query(source=s)
            scores.append(eng.stability_vs_prev(r.parent, source=r.source))
    assert scores == [1.0] * len(scores)
    full = eng.query()
    assert eng.stability_vs_prev(full.parent) == 1.0
    assert eng.stability_vs_prev(full.parent) == 1.0


@pytest.mark.parametrize("schedule", ["rounds", "buckets"])
def test_batched_checkpoint_restores_across_packages(schedule):
    """A batched checkpoint holds [S, N] dist / parent and an [S] source
    (drained first under buckets); each package restores the other's
    mid-stream and finishes on the same trees."""
    n, cap, log = STREAM
    half = len(log) // 2
    kw = dict(sources=SOURCES)
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=1.0)
    full = JaxEngine(JaxConfig(n, cap, 3, **kw))
    want = _ingest(full, log)[-1]
    for first, then in (("port", "jax"), ("jax", "port")):
        mk = {"port": lambda: SSSPDelEngine(EngineConfig(n, cap, 3,
                                                         device="cpu", **kw)),
              "jax": lambda: JaxEngine(JaxConfig(n, cap, 3, **kw))}
        a = mk[first]()
        a.ingest_log(log[:half])
        snap = {k: np.asarray(v) for k, v in a.checkpoint().items()}
        assert snap["dist"].shape == (len(SOURCES), n)
        assert snap["source"].shape == (len(SOURCES),)
        b = mk[then]()
        b.restore(snap)
        b.ingest_log(log[half:])
        q = b.query()
        np.testing.assert_array_equal(q.dist, want.dist)
        np.testing.assert_array_equal(q.parent, want.parent)
        port = a if first == "port" else b
        assert port.backend.invariants() == {}   # the segment backend
