"""The bucketed (delta-stepping) schedule of the port (``core/buckets.py``,
``wave_schedule="buckets"``) against ``repro.core.engine`` with the same
schedule — the single-device half of tests/test_buckets.py (its sharded
tests wait for the sharded engine).

On an ER sliding-window ADD/DEL/QUERY stream, for the segment, dense-ELL,
sliced (plain and on K2's plain version through ``sliced_fused=True``) and
``auto`` backends, the dense, sparse and auto frontiers, and bucket widths
0.3, 1.0, inf and "auto": the port engine is bit-identical to the JAX
engine of the same config in ``dist``, ``parent``, ``n_rounds`` and
``n_messages`` at every query, its ``dist`` is bit-identical to the port's
own rounds engine, every drained tree passes the Dijkstra oracle, and the
backend's ``invariants()`` hold after the stream.  Also: checkpoints
across the packages (a checkpoint drains first), the ``bucket_width``
validation messages, and ``bucket_limit`` / ``bucket_active`` against the
reference's jitted ones (XLA multiplies by the width's f32 reciprocal).

The JAX engines run ``sliced_fused=False`` (the JAX fused kernel does not
run on the installed jax) and ``frontier_kernel=False``.  Inputs are made
from seeds with numpy.  Tolerance: 0 — every array and counter equal.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import buckets as jbuckets
from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.graphs import generators, window
from repro_torch import EngineConfig, SSSPDelEngine
from repro_torch.core import buckets, frontier
from repro_torch.core.oracle import check_tree

SOURCE = 3
INF = float("inf")
WIDTHS = [0.3, 1.0, INF, "auto"]
# port backend -> (relax_backend, knobs of both packages, port-only knobs);
# tiny layout knobs force rebuilds, hub spills and the auto fallback
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


def _stream(seed=41, *, n=90, m=520, delta=0.6, query_every=130):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    log = window.sliding_window_stream(src, dst, w, window=m // 3,
                                       delta=delta, seed=seed,
                                       query_every=query_every)
    return n, len(src) + 64, log


STREAM = _stream()


def _knobs(backend, **extra):
    name, shared, port_only = BACKENDS[backend]
    return name, {**shared, **extra}, port_only


def _run(eng, log, oracle=False):
    """Ingest ``log``; every query (and a final one) checked against the
    Dijkstra oracle on the live edges of that moment when ``oracle``."""
    n = eng.cfg.num_vertices

    def check(res):
        if oracle:
            check_tree(n, *eng.alloc.active_coo(), SOURCE, res.dist,
                       res.parent)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # ELL blowup
        out = eng.ingest_log(log, on_query=check)
        out.append(eng.query())
    check(out[-1])
    return out


@functools.cache
def _jax_run(name, knobs):
    n, cap, log = STREAM
    eng = JaxEngine(JaxConfig(n, cap, SOURCE, relax_backend=name,
                              **dict(knobs)))
    return _run(eng, log), eng.backend_name, {
        k: bool(v) for k, v in eng.backend.invariants().items()}


def _port(backend, **extra):
    name, knobs, port_only = _knobs(backend, **extra)
    n, cap, _ = STREAM
    return SSSPDelEngine(EngineConfig(n, cap, SOURCE, relax_backend=name,
                                      device="cpu", **knobs, **port_only))


def _jax(backend, **extra):
    name, knobs, _ = _knobs(backend, **extra)
    return _jax_run(name, tuple(sorted(knobs.items())))


def _assert_same(got, want, *, stats=True):
    assert len(got) == len(want) > 1
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.dist, w.dist, err_msg=f"query {i}")
        np.testing.assert_array_equal(g.parent, w.parent,
                                      err_msg=f"query {i}")
        if stats:
            assert g.epoch_stats == w.epoch_stats, i


@functools.cache
def _port_rounds(backend):
    return _run(_port(backend), STREAM[2])


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_bucketed_engine_bit_identical_to_reference(backend, width):
    """Every query: (dist, parent, rounds, messages) equal the JAX bucketed
    engine's; dist equals the port's rounds engine's; the oracle passes at
    every drain point; the layout invariants hold after the stream."""
    eng = _port(backend, wave_schedule="buckets", bucket_width=width)
    got = _run(eng, STREAM[2], oracle=True)
    want, jax_backend, jax_inv = _jax(backend, wave_schedule="buckets",
                                      bucket_width=width)
    _assert_same(got, want)
    assert eng.n_dels > 0 and eng.backend_name == jax_backend
    for g, r in zip(got, _port_rounds(backend)):
        np.testing.assert_array_equal(g.dist, r.dist)
    inv = eng.backend.invariants()
    assert inv == jax_inv and all(inv.values())
    if width == "auto":
        w = eng._bucket_width()
        assert w > 0 and float(np.log2(w)) == int(np.log2(w))


@pytest.mark.parametrize("width", [0.7, INF])
@pytest.mark.parametrize("mode", ["sparse", "auto"])
@pytest.mark.parametrize("backend", ["segment", "ellpack", "sliced"])
def test_bucketed_frontier_modes_bit_identical_to_reference(backend, mode,
                                                            width,
                                                            monkeypatch):
    """``frontier_mode`` sparse routes every drain through ``sparse_drain``
    (the segment pull, the waves through the capacity ladder); auto routes
    by the host-known pending bound, which a deletion pins to N."""
    calls = []
    real = frontier.sparse_drain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(frontier, "sparse_drain", spy)
    eng = _port(backend, wave_schedule="buckets", bucket_width=width,
                frontier_mode=mode, frontier_cap=32)
    got = _run(eng, STREAM[2], oracle=True)
    want, _, jax_inv = _jax(backend, wave_schedule="buckets",
                            bucket_width=width, frontier_mode=mode,
                            frontier_cap=32)
    _assert_same(got, want)
    assert eng.backend.invariants() == jax_inv
    if mode == "sparse":
        assert len(calls) >= len(got)


@pytest.mark.parametrize("backend", ["segment", "sliced"])
def test_bucketed_checkpoint_restore_across_packages(backend):
    """A checkpoint drains first; the port restores the JAX engine's and the
    JAX engine the port's, mid-stream, and both finish on the rounds
    schedule's exact tree with empty pending sets."""
    n, cap, log = STREAM
    half = len(log) // 2
    kw = dict(wave_schedule="buckets", bucket_width=1.0)
    name, knobs, port_only = _knobs(backend, **kw)
    want = _port_rounds(backend)[-1]
    for first, then in (("port", "jax"), ("jax", "port")):
        a = (_port(backend, **kw) if first == "port"
             else JaxEngine(JaxConfig(n, cap, SOURCE, relax_backend=name,
                                      **knobs)))
        a.ingest_log(log[:half])
        snap = {k: np.asarray(v) for k, v in a.checkpoint().items()}
        b = (_port(backend, **kw) if then == "port"
             else JaxEngine(JaxConfig(n, cap, SOURCE, relax_backend=name,
                                      **knobs)))
        b.restore(snap)
        assert not np.asarray(b._pend.push).any()
        b.ingest_log(log[half:])
        q = b.query()
        np.testing.assert_array_equal(q.dist, want.dist)
        np.testing.assert_array_equal(q.parent, want.parent)
        port = a if first == "port" else b
        assert all(bool(v) for v in port.backend.invariants().values())


@pytest.mark.parametrize("cfg", [
    dict(wave_schedule="buckets", bucket_width=0.0),
    dict(wave_schedule="buckets", bucket_width=-1.0),
    dict(wave_schedule="buckets", bucket_width=float("nan")),
    dict(wave_schedule="buckets", bucket_width="fast"),
    dict(wave_schedule="eager"),
    dict(bucket_width=2.0)], ids=["zero", "negative", "nan", "string",
                                  "schedule", "width-under-rounds"])
def test_bucket_width_validation_matches_reference(cfg):
    with pytest.raises(ValueError) as want:
        JaxConfig(8, 16, 0, **cfg)
    with pytest.raises(ValueError) as got:
        EngineConfig(8, 16, 0, device="cpu", **cfg)
    assert str(got.value) == str(want.value)
    assert "bucket_width" in str(got.value) or "wave_schedule" in str(
        got.value)


@pytest.mark.parametrize("width", [0.3, 0.7, 0.1, 1.0, 2.5, INF])
def test_bucket_limit_matches_jitted_reference(width):
    """The limit in f32, bit for bit, against the reference as its drains
    run it (jitted, the width static): XLA rewrites the division into a
    product with the f32 reciprocal, which differs from a division for
    widths such as 0.3 and 0.1."""
    rng = np.random.default_rng(7)
    step = width if width < INF else 1.0      # multiples of the width too
    cur = np.concatenate([rng.uniform(0, 60, 50_000),
                          rng.integers(0, 200, 20_000) * np.float32(step),
                          [0.0, INF]]).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jbuckets.bucket_limit, bucket_width=width))(jnp.asarray(cur)))
    got = buckets.bucket_limit(torch.from_numpy(cur), width).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("width", [0.3, 1.0, INF])
def test_bucket_active_per_lane_and_strict_progress(width):
    """Lanes get their own lowest bucket (the reference vmaps
    ``bucket_active``); a lane with nothing pending activates nothing; the
    minimum pending vertex stays active where the limit rounds down to it
    (2^25 + 1 is not an f32)."""
    rng = np.random.default_rng(5)
    dist = rng.uniform(0, 5, (4, 64)).astype(np.float32)
    dist[rng.random((4, 64)) < 0.2] = np.inf
    push = rng.random((4, 64)) < 0.5
    push[2] = False
    dist[3, 7], push[3, 7] = 2.0 ** 25, True
    dist[3, dist[3] < 2.0 ** 25] = np.inf
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        jbuckets.bucket_active, bucket_width=width)))(
            jnp.asarray(dist), jnp.asarray(push)))
    got = buckets.bucket_active(torch.from_numpy(dist),
                                torch.from_numpy(push), width).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[2].any() and got[3, 7]


def test_auto_backend_composes_with_buckets():
    """A hub stream under ``auto``: the dense ELL block falls back to sliced
    mid-stream and the bucketed drain lands on the rounds tree, equal to
    the JAX engine's."""
    rng = np.random.default_rng(13)
    n, m, hub_deg = 512, 220, 80
    hub = rng.integers(1, n, size=hub_deg)
    src = np.r_[hub, rng.integers(0, n, size=m - hub_deg)]
    dst = np.r_[np.zeros(hub_deg, np.int64),
                rng.integers(0, n, size=m - hub_deg)]
    keep = src != dst
    src, dst = src[keep].astype(np.int64), dst[keep].astype(np.int64)
    w = rng.uniform(0.1, 1.0, size=len(src)).astype(np.float32)
    from repro.core import events as jev
    log = jev.adds(src, dst, w)
    kw = dict(relax_backend="auto", ell_init_k=1, wave_schedule="buckets",
              bucket_width=1.0)
    jeng = JaxEngine(JaxConfig(n, len(src) + 64, 0, **kw))
    eng = SSSPDelEngine(EngineConfig(n, len(src) + 64, 0, device="cpu",
                                     **kw))
    ref = SSSPDelEngine(EngineConfig(n, len(src) + 64, 0, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for e in (jeng, eng, ref):
            e.ingest_log(log)
    q, jq, rq = eng.query(), jeng.query(), ref.query()
    _assert_same([q, q], [jq, jq])
    np.testing.assert_array_equal(q.dist, rq.dist)
    np.testing.assert_array_equal(q.parent, rq.parent)
    assert eng.backend_name == jeng.backend_name == "sliced"
    assert all(eng.backend.invariants().values())
