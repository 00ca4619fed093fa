"""The port's slice as a whole: ``repro_torch``'s ``SSSPDelEngine`` on the
CPU against ``repro.core.engine.SSSPDelEngine`` on the same ER
sliding-window ADD/DEL/QUERY streams (the shape of
test_backend_equiv.py's), for both ported backends, doubling and flood
invalidation, per-event and batched deletions, and ``on_duplicate="min"``;
plus carrying state across: a JAX checkpoint restored into the port.

Inputs are made from seeds with numpy (the reference's generators) and fed
to both engines.  Tolerance: 0 — ``dist``, ``parent``, ``n_rounds`` and
``n_messages`` (and the other stream counters) equal at every query; the
last query also passes the Dijkstra oracle (``check_tree``).
"""
import numpy as np
import pytest

from repro.core import events as jev
from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.core.state import validate_state as jax_validate_state
from repro.graphs import generators, window
from repro_torch import EngineConfig, SSSPDelEngine, make_engine
from repro_torch.core.oracle import check_tree
from repro_torch.core.state import validate_state

SOURCE = 3
# ell_init_k=2 forces the capacity-doubling rebuild path several times
BACKEND_KW = {"segment": {}, "ellpack": dict(ell_init_k=2)}


def _dynamic_stream(seed: int, *, n=90, m=520, delta=0.6):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    log = window.sliding_window_stream(src, dst, w, window=m // 3,
                                       delta=delta, seed=seed,
                                       query_every=m // 4)
    return n, len(src) + 64, log


def _engines(backend, n, cap, **kw):
    kw = {**BACKEND_KW[backend], **kw}
    return (JaxEngine(JaxConfig(n, cap, SOURCE, relax_backend=backend, **kw)),
            SSSPDelEngine(EngineConfig(n, cap, SOURCE, relax_backend=backend,
                                       device="cpu", **kw)))


def _assert_same_results(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.dist, w.dist)
        np.testing.assert_array_equal(g.parent, w.parent)
        assert g.dist.dtype == w.dist.dtype and g.parent.dtype == w.parent.dtype
        assert g.epoch_stats == w.epoch_stats


def _oracle(eng, n):
    q = eng.query()
    check_tree(n, *eng.alloc.active_coo(), SOURCE, q.dist, q.parent)


@pytest.mark.parametrize("batch_deletions", [False, True])
@pytest.mark.parametrize("use_doubling", [False, True])
@pytest.mark.parametrize("backend", ["segment", "ellpack"])
def test_port_bit_identical_to_reference(backend, use_doubling,
                                         batch_deletions):
    n, cap, log = _dynamic_stream(11 + 2 * use_doubling + batch_deletions)
    jax_eng, eng = _engines(backend, n, cap, use_doubling=use_doubling,
                            batch_deletions=batch_deletions)
    _assert_same_results(eng.ingest_log(log), jax_eng.ingest_log(log))
    assert (eng.n_rounds, eng.n_messages) == (jax_eng.n_rounds,
                                              jax_eng.n_messages)
    if backend == "ellpack":
        assert eng.backend.planner.rebuilds == jax_eng.backend.planner.rebuilds
        assert eng.backend.planner.rebuilds >= 1
        np.testing.assert_array_equal(eng.backend.state.nbr_w.numpy(),
                                      np.asarray(jax_eng.backend.state.nbr_w))
    _oracle(eng, n)


@pytest.mark.parametrize("backend", ["segment", "ellpack"])
def test_port_on_duplicate_min_matches_reference(backend):
    """Re-adds of live edges at lower weights are weight decreases (the
    ELL backend resolves them on device), higher ones are dropped."""
    n, cap, log = _dynamic_stream(5, delta=0.2)
    adds = log.kind == jev.ADD
    s, d, w = log.src[adds][:200], log.dst[adds][:200], log.w[adds][:200]
    rng = np.random.default_rng(5)
    scale = np.where(rng.random(len(w)) < 0.7, 0.5, 2.0).astype(np.float32)
    log = jev.EventLog.concatenate([
        log, jev.adds(s, d, w * scale), jev.query_marker(),
        jev.adds(s[::-1], d[::-1], w[::-1] * 0.25), jev.query_marker()])
    jax_eng, eng = _engines(backend, n, cap, on_duplicate="min")
    _assert_same_results(eng.ingest_log(log), jax_eng.ingest_log(log))
    _oracle(eng, n)


@pytest.mark.parametrize("backend", ["segment", "ellpack"])
def test_jax_checkpoint_restores_into_port(backend):
    """Carrying state across: the JAX engine's ``checkpoint()`` (numpy
    arrays) restores into the port mid-stream and into a fresh JAX engine;
    both then finish the stream bit-identically (the restored allocators
    rebuild the same free-stack order, so even the pool slots agree), and
    the port's own ``checkpoint()`` has the JAX engine's keys, dtypes and
    values."""
    n, cap, log = _dynamic_stream(7)
    cut = len(log) // 2
    jax_eng, _ = _engines(backend, n, cap, batch_deletions=True)
    jax_eng.ingest_log(log[:cut])
    ckpt = jax_eng.checkpoint()
    jax_eng, eng = _engines(backend, n, cap, batch_deletions=True)
    jax_eng.restore(ckpt)
    eng.restore(ckpt)
    _assert_same_results(eng.ingest_log(log[cut:]),
                         jax_eng.ingest_log(log[cut:]))
    mine, theirs = eng.checkpoint(), jax_eng.checkpoint()
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k])
    _oracle(eng, n)


def test_checkpoint_is_a_copy_and_round_trips():
    """The port updates its pools in place: a checkpoint taken earlier must
    not change, and restoring it rebuilds the same engine state."""
    n, cap, log = _dynamic_stream(9)
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=SOURCE,
                      relax_backend="ellpack", device="cpu")
    cut = len(log) // 2
    eng.ingest_log(log[:cut])
    ckpt = eng.checkpoint()
    frozen = {k: v.copy() for k, v in ckpt.items()}
    rest = eng.ingest_log(log[cut:])
    for k in ckpt:
        np.testing.assert_array_equal(ckpt[k], frozen[k])
    again = make_engine(num_vertices=n, edge_capacity=cap, source=SOURCE,
                        relax_backend="ellpack", device="cpu")
    again.restore(ckpt)
    for g, w in zip(again.ingest_log(log[cut:]), rest):
        np.testing.assert_array_equal(g.dist, w.dist)
        np.testing.assert_array_equal(g.parent, w.parent)


def test_validate_state_and_stability_match_reference():
    """The state invariant probes and the paper's §5.4 predecessor
    stability, query by query, equal the reference engine's."""
    n, cap, log = _dynamic_stream(13)
    jax_eng, eng = _engines("ellpack", n, cap, batch_deletions=True)
    got = eng.ingest_log(log)
    want = jax_eng.ingest_log(log)
    for g, w in zip(got, want):
        assert eng.stability_vs_prev(g.parent) == \
            jax_eng.stability_vs_prev(w.parent, source=w.source)
    mine = validate_state(eng.state, n)
    theirs = {k: bool(v) for k, v in
              jax_validate_state(jax_eng.state, n).items()}
    assert mine == theirs and all(mine.values())


@pytest.mark.parametrize("knobs", [
    dict(relax_backend="sliced"), dict(relax_backend="auto"),
    dict(wave_schedule="buckets"), dict(frontier_mode="sparse"),
    dict(frontier_mode="auto"), dict(sources=(0, 1)),
    dict(observability=True), dict(partitions=2)])
def test_later_slices_raise_not_yet_ported(knobs):
    with pytest.raises(ValueError, match="not yet ported"):
        make_engine(num_vertices=8, edge_capacity=8, device="cpu", **knobs)


@pytest.mark.parametrize("knobs", [
    dict(relax_backend="nope"), dict(ell_init_k=4), dict(bogus=1),
    dict(alloc_impl="btree")])
def test_bad_config_raises(knobs):
    with pytest.raises(ValueError):
        make_engine(num_vertices=8, edge_capacity=8, device="cpu", **knobs)
