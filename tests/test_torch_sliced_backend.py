"""Sliced hybrid backend of the port (core/backends/sliced.py) against
``repro.core.backends.sliced``: the copied rebuild placement
(``sliced_ell_from_coo``) and ``SlicedEllPlanner`` (positions, spills,
widths, rebuilds), the in-place patch ops on padded batches with repeated
and never-present entries, the hybrid epochs, and whole engines —
``relax_backend="sliced"`` (waves on K1 per run of slices, or on K2 with
``sliced_fused``) and ``"auto"`` (dense ELL falling back to sliced) — at
every query of an RMAT sliding-window stream with deletions, including a
JAX checkpoint restored into a port sliced engine; plus the knob
validation rules the two ELL layouts share.

Small shapes force every path: ``slice_rows`` 16/32 give several run
groups, ``hub_k`` 4 sends hub surplus to the overflow lane.  The JAX
engines run ``sliced_fused=False`` (the JAX fused kernel does not run on
the installed jax); the port's fused engines are held against them.
Inputs are made from seeds with numpy.  Tolerance: 0 — every array and
stat bit-identical.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import delete as jdel
from repro.core.backends import sliced as jsl
from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.core.state import SSSPState as JState
from repro.graphs import csr as jcsr
from repro.graphs import generators as jgen
from repro.graphs import window
from repro_torch import EngineConfig, make_engine
from repro_torch.core import delete, ingest
from repro_torch.core.backends import sliced as sl
from repro_torch.core.frontier import OutAdjacency
from repro_torch.core.oracle import check_tree
from repro_torch.core.state import SSSPState
from repro_torch.graphs import csr, generators

SOURCE = 3
KNOBS = dict(sliced_slice_rows=16, sliced_hub_k=4)
STATE_FIELDS = ("flat_idx", "flat_w", "fill", "base", "rowk", "osrc",
                "odst", "ow")


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _same_state(state, jstate):
    for f in STATE_FIELDS:
        got, want = getattr(state, f).numpy(), np.asarray(getattr(jstate, f))
        np.testing.assert_array_equal(got, want, err_msg=f)
        assert got.dtype == want.dtype, f


def test_rmat_matches_reference():
    for got, want in zip(generators.rmat(7, 4, seed=5),
                         jgen.rmat(7, 4, seed=5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slice_rows,hub_k,override", [
    (16, 4, False), (32, 4, True), (1, 1024, False), (64, 8, True)])
def test_sliced_ell_from_coo_matches_reference(slice_rows, hub_k, override):
    n, src, dst, w = jgen.rmat(8, 6, seed=slice_rows)
    kw = dict(slice_rows=slice_rows, hub_k=hub_k)
    if override:   # the planner's grown widths and overflow capacity
        _, _, _, widths, *_ = jcsr.sliced_ell_from_coo(n, src, dst, w, **kw)
        kw.update(widths=[min(2 * k, hub_k) for k in widths],
                  overflow_capacity=1 << 12)
    got = csr.sliced_ell_from_coo(n, src, dst, w, **kw)
    want = jcsr.sliced_ell_from_coo(n, src, dst, w, **kw)
    assert got[-1] == want[-1] > 0 or hub_k == 1024   # spills happened
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


@pytest.mark.parametrize("slice_rows,init_k", [(16, 1), (32, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_planner_and_patch_ops_track_reference(seed, slice_rows, init_k):
    """A randomized add / duplicate-min / delete sequence over a graph with
    in-degree hubs, through the planner (append, spill or rebuild) and the
    patch ops with pow2-padded batches: planner state and every device
    array equal the reference's after every batch."""
    n, cap, hub_k = 96, 1500, 4
    rng = np.random.default_rng(seed)
    alloc = ingest.make_allocator(cap, "min")
    kw = dict(slice_rows=slice_rows, hub_k=hub_k, init_k=init_k)
    pl, jpl = sl.SlicedEllPlanner(n, **kw), jsl.SlicedEllPlanner(n, **kw)
    state = sl.SlicedEllState.from_host(pl, pl.empty_host(), "cpu")
    jstate = jpl.empty_state()
    hubs = rng.choice(n, 3, replace=False)
    for _ in range(16):
        m = int(rng.integers(1, 40))
        dst = np.where(rng.random(m) < 0.5, rng.choice(hubs, m),
                       rng.integers(0, n, m))
        plan = alloc.plan_adds(rng.integers(0, n, m), dst,
                               rng.integers(1, 5, m).astype(np.float32))
        fresh = plan.fresh
        args = (plan.dst[fresh].astype(np.int64), plan.src[fresh],
                plan.w[fresh])
        sp, jsp = pl.plan_appends(*args), jpl.plan_appends(*args)
        assert (sp is None) == (jsp is None)
        if sp is None:
            state = sl.SlicedEllState.from_host(
                pl, pl.rebuild_host(*alloc.active_coo()), "cpu")
            jstate = jpl.rebuild(*alloc.active_coo())
        else:
            for got, want in zip(sp, jsp):
                np.testing.assert_array_equal(got, want)
            if len(sp.pos):
                batch = ingest.pad_pow2(sp.pos, sp.rows, sp.kpos, sp.src,
                                        sp.w)
                sl.sliced_append(state, *_t(*batch))
                jstate = jsl.sliced_append(jstate, *_j(*batch))
            if len(sp.opos):
                batch = ingest.pad_pow2(sp.opos, sp.osrc, sp.orows, sp.ow)
                sl.sliced_spill(state, *_t(*batch))
                jstate = jsl.sliced_spill(jstate, *_j(*batch))
            if not fresh.all():
                upd = ~fresh
                batch = ingest.pad_pow2(plan.dst[upd], plan.src[upd],
                                        plan.w[upd])
                sl.sliced_update_min(state, *_t(*batch),
                                     width=pl.max_width)
                jstate = jsl.sliced_update_min(jstate, *_j(*batch),
                                               width=jpl.max_width)
        np.testing.assert_array_equal(pl.fill, jpl.fill)
        assert (pl.widths, pl.ocap, pl.ofill, pl.rebuilds, pl.spills) == \
            (jpl.widths, jpl.ocap, jpl.ofill, jpl.rebuilds, jpl.spills)
        _same_state(state, jstate)

        d = int(rng.integers(1, 16))
        slots, psrc, pdst = alloc.plan_dels(rng.integers(0, n, d),
                                            rng.choice(hubs, d))
        if len(slots):
            # repeated pad entries + a never-present edge: both must no-op
            rows_p, src_p = ingest.pad_pow2(
                np.r_[pdst, hubs[0]].astype(np.int32),
                np.r_[psrc, n + 5].astype(np.int32))
            sl.sliced_delete(state, *_t(rows_p, src_p), width=pl.max_width)
            jstate = jsl.sliced_delete(jstate, *_j(rows_p, src_p),
                                       width=jpl.max_width)
            _same_state(state, jstate)
    assert pl.rebuilds >= 1 and pl.spills > 0, "rebuild/spill not exercised"


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_sliced_epochs_match_reference(use_kernel, use_fused):
    """Relax to fixpoint, then delete two tree edges (cells or overflow
    entries) and recompute, by doubling and by flood; on CPU tensors the
    kernel flags take the wrappers' plain versions."""
    n, src, dst, w = jgen.rmat(8, 6, seed=2)
    pl = sl.SlicedEllPlanner(n, slice_rows=16, hub_k=4)
    state = sl.SlicedEllState.from_host(pl, pl.rebuild_host(src, dst, w),
                                        "cpu")
    jpl = jsl.SlicedEllPlanner(n, slice_rows=16, hub_k=4)
    jstate = jpl.rebuild(src, dst, w)
    assert pl.widths == jpl.widths and pl.ofill > 0
    geo = dict(widths=tuple(pl.widths), slice_rows=pl.sr, num_vertices=n)
    assert (state.widths, state.slice_rows) == (geo["widths"], pl.sr)
    s, js = SSSPState.init(n, SOURCE, "cpu"), JState.init(n, SOURCE)
    f = np.zeros(n, bool)
    f[SOURCE] = True
    s, st = sl.sliced_relax_until_converged(
        s, state, *_t(f), use_kernel=use_kernel, use_fused=use_fused,
        num_vertices=n)
    js, jst = jsl.sliced_relax_until_converged(js, jstate, *_j(f), **geo)
    np.testing.assert_array_equal(s.dist.numpy(), np.asarray(js.dist))
    np.testing.assert_array_equal(s.parent.numpy(), np.asarray(js.parent))
    assert (st.rounds, int(st.messages)) == (int(jst.rounds),
                                             int(jst.messages))

    par = s.parent.numpy()
    kids = np.nonzero(par >= 0)[0][[0, -1]].astype(np.int32)
    srcs = par[kids].astype(np.int32)
    seed_t = delete.deletion_seed_for_edges(s, *_t(srcs, kids), n)
    jseed = jdel.deletion_seed_for_edges(js, *_j(srcs, kids), n)
    sl.sliced_delete(state, *_t(kids, srcs), width=pl.max_width)
    jstate = jsl.sliced_delete(jstate, *_j(kids, srcs), width=jpl.max_width)
    _same_state(state, jstate)
    for use_doubling in (False, True):
        s2, d2 = sl.sliced_invalidate_and_recompute(
            s, state, seed_t, use_doubling=use_doubling,
            use_kernel=use_kernel, use_fused=use_fused, num_vertices=n)
        js2, jd2 = jsl.sliced_invalidate_and_recompute(
            js, jstate, jseed, use_doubling=use_doubling, **geo)
        np.testing.assert_array_equal(s2.dist.numpy(), np.asarray(js2.dist))
        np.testing.assert_array_equal(s2.parent.numpy(),
                                      np.asarray(js2.parent))
        assert (d2.invalidation_rounds, d2.recompute_rounds) == (
            int(jd2.invalidation_rounds), int(jd2.recompute_rounds))
        assert int(d2.affected) == int(jd2.affected) > 0
        assert int(d2.recompute_messages) == int(jd2.recompute_messages)


# ------------------------------------------------------------------ engines --
def _stream():
    n, src, dst, w = jgen.rmat(8, 6, seed=3)
    m = len(src)
    log = window.sliding_window_stream(src, dst, w, window=m // 3,
                                       delta=0.4, seed=3, query_every=m // 4)
    return n, m + 64, log


@functools.cache
def _jax_run(backend: str, batch_deletions: bool, use_doubling: bool):
    """The JAX engine's results on the stream, once per configuration."""
    n, cap, log = _stream()
    eng = JaxEngine(JaxConfig(n, cap, SOURCE, relax_backend=backend,
                              batch_deletions=batch_deletions,
                              use_doubling=use_doubling, **KNOBS))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # auto's blowup
        res = eng.ingest_log(log)
    return res, eng.backend.planner.rebuilds, eng.backend.planner.spills


def _assert_same_results(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.dist, w.dist)
        np.testing.assert_array_equal(g.parent, w.parent)
        assert g.epoch_stats == w.epoch_stats


@pytest.mark.parametrize("backend,port_knobs,batch_deletions,use_doubling", [
    ("sliced", dict(), True, True),
    ("sliced", dict(sliced_fused=True), True, True),
    ("sliced", dict(ell_use_kernel=False), True, True),
    ("auto", dict(), True, True),
    ("auto", dict(sliced_fused=True), True, True),
    ("sliced", dict(sliced_fused=True), False, False),
])
def test_engine_bit_identical_to_reference(backend, port_knobs,
                                           batch_deletions, use_doubling):
    n, cap, log = _stream()
    want, rebuilds, spills = _jax_run(backend, batch_deletions, use_doubling)
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=SOURCE,
                      relax_backend=backend, batch_deletions=batch_deletions,
                      use_doubling=use_doubling, device="cpu", **KNOBS,
                      **port_knobs)
    _assert_same_results(eng.ingest_log(log), want)
    assert eng.backend_name == "sliced"      # auto fell back to sliced
    assert (eng.backend.planner.rebuilds, eng.backend.planner.spills) == \
        (rebuilds, spills)
    assert spills > 0
    q = eng.query()
    check_tree(n, *eng.alloc.active_coo(), SOURCE, q.dist, q.parent)


def test_auto_keeps_dense_ell_without_blowup():
    """A rebuild whose K*R cells stay within ELL_BLOWUP_RATIO x the live
    edges (a dense graph without hubs, added in one batch) keeps "auto" on
    the dense ELL block; it equals the segment engine."""
    from repro.core import events as jev
    n, src, dst, w = jgen.erdos_renyi(64, 1000, seed=1)
    log = jev.EventLog.concatenate([
        jev.adds(src, dst, w), jev.query_marker(),
        jev.dels(src[:100], dst[:100]), jev.query_marker()])
    runs = [make_engine(num_vertices=n, edge_capacity=len(src) + 8,
                        source=SOURCE, device="cpu", **kw)
            for kw in (dict(relax_backend="auto", ell_init_k=2), {})]
    _assert_same_results(*(eng.ingest_log(log) for eng in runs))
    auto = runs[0]
    assert auto.backend_name == "ellpack" and not auto.backend.blowup
    assert auto.backend.planner.rebuilds == 1


def test_on_duplicate_min_matches_reference():
    """Re-adds of live edges at lower weights are weight decreases, which
    the sliced backend resolves on device in both lanes."""
    from repro.core import events as jev
    n, cap, log = _stream()
    adds = log.kind == jev.ADD
    s, d, w = log.src[adds][:300], log.dst[adds][:300], log.w[adds][:300]
    rng = np.random.default_rng(5)
    scale = np.where(rng.random(len(w)) < 0.7, 0.5, 2.0).astype(np.float32)
    log = jev.EventLog.concatenate([
        log, jev.adds(s, d, w * scale), jev.query_marker(),
        jev.adds(s[::-1], d[::-1], w[::-1] * 0.25), jev.query_marker()])
    kw = dict(relax_backend="sliced", on_duplicate="min",
              batch_deletions=True, **KNOBS)
    jeng = JaxEngine(JaxConfig(n, cap, SOURCE, **kw))
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=SOURCE,
                      device="cpu", sliced_fused=True, **kw)
    _assert_same_results(eng.ingest_log(log), jeng.ingest_log(log))


def test_jax_checkpoint_restores_into_port_sliced_engine():
    """The JAX engine's checkpoint restores into a port sliced engine
    mid-stream (the layout rebuilds from the pool mirror); both finish the
    stream bit-identically with the same layout arrays."""
    n, cap, log = _stream()
    cut = len(log) // 2
    kw = dict(relax_backend="sliced", batch_deletions=True, **KNOBS)
    jeng = JaxEngine(JaxConfig(n, cap, SOURCE, **kw))
    jeng.ingest_log(log[:cut])
    ckpt = jeng.checkpoint()
    jeng = JaxEngine(JaxConfig(n, cap, SOURCE, **kw))
    jeng.restore(ckpt)
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=SOURCE,
                      device="cpu", sliced_fused=True, **kw)
    eng.restore(ckpt)
    _same_state(eng.backend.state, jeng.backend.state)
    _assert_same_results(eng.ingest_log(log[cut:]),
                         jeng.ingest_log(log[cut:]))
    _same_state(eng.backend.state, jeng.backend.state)


def test_knob_validation_matches_reference():
    """The reference's rules (test_backend_protocol.py): layout knobs apply
    only to their layout, ``ell_use_kernel`` is shared by both ELL
    layouts, and "auto" accepts both layouts' knobs."""
    with pytest.raises(ValueError, match="ell_init_k"):
        EngineConfig(16, 64, 0, ell_init_k=2, device="cpu")
    EngineConfig(16, 64, 0, relax_backend="ellpack", ell_init_k=2,
                 device="cpu")
    with pytest.raises(ValueError, match="ell_init_k"):
        EngineConfig(16, 64, 0, relax_backend="sliced", ell_init_k=2,
                     device="cpu")
    with pytest.raises(ValueError, match="ell_block_rows"):
        EngineConfig(16, 64, 0, relax_backend="sliced", ell_block_rows=64,
                     device="cpu")
    EngineConfig(16, 64, 0, relax_backend="ellpack", ell_use_kernel=False,
                 device="cpu")
    EngineConfig(16, 64, 0, relax_backend="sliced", ell_use_kernel=False,
                 device="cpu")
    with pytest.raises(ValueError, match="ell_use_kernel"):
        EngineConfig(16, 64, 0, ell_use_kernel=False, device="cpu")
    for knob in (dict(sliced_hub_k=8), dict(sliced_fused=True)):
        with pytest.raises(ValueError, match=next(iter(knob))):
            EngineConfig(16, 64, 0, relax_backend="ellpack", device="cpu",
                         **knob)
    EngineConfig(16, 64, 0, relax_backend="auto", ell_init_k=2,
                 sliced_hub_k=8, sliced_fused=True, ell_use_kernel=False,
                 device="cpu")


# ----------------------------------------------------------- kernel switches --
def test_kernel_switches_resolve_by_device():
    """None = the kernel iff the device is CUDA (no card needed to resolve
    for one); True and False hold on either device.  A CPU engine with the
    switches unset resolves them to False, as in the reference, routes that
    to the sliced backend, and leaves its config as the caller set it."""
    from repro_torch.core.engine import resolve_kernel
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_kernel(None, cuda) and not resolve_kernel(None, cpu)
    for flag in (True, False):
        assert resolve_kernel(flag, cuda) == resolve_kernel(flag, cpu) == flag
    eng = make_engine(num_vertices=64, edge_capacity=256, source=0,
                      relax_backend="sliced", frontier_mode="sparse",
                      device="cpu")
    assert (eng._use_kernel, eng._use_fused, eng._frontier_kernel) == \
        (False, False, False)
    assert not eng.backend.use_fused and not eng.backend.use_kernel
    assert (eng.cfg.ell_use_kernel, eng.cfg.sliced_fused,
            eng.cfg.frontier_kernel) == (None, None, None)
    eng = make_engine(num_vertices=64, edge_capacity=256, source=0,
                      relax_backend="auto", sliced_fused=True, device="cpu")
    eng._fallback_to_sliced()
    assert eng.backend.use_fused and eng.cfg.sliced_fused is True


@pytest.mark.parametrize("backend", ["segment", "ellpack", "sliced", "auto"])
def test_unset_sliced_fused_validates_as_unset(backend):
    """The unset switch, and False (the reference's default), is valid with
    every backend; True is a sliced knob that the dense-ELL and segment
    backends refuse."""
    EngineConfig(16, 64, 0, relax_backend=backend, device="cpu")
    EngineConfig(16, 64, 0, relax_backend=backend, sliced_fused=False,
                 device="cpu")
    if backend in ("segment", "ellpack"):
        with pytest.raises(ValueError, match="sliced_fused"):
            EngineConfig(16, 64, 0, relax_backend=backend, sliced_fused=True,
                         device="cpu")
    else:
        EngineConfig(16, 64, 0, relax_backend=backend, sliced_fused=True,
                     device="cpu")


def test_state_block_table_follows_the_layout():
    """``SlicedEllState.table`` is K2's chunk table of the planner's
    current widths with the layout's sizes, made with ``base``/``rowk`` at
    every (re)build of a state for K2 and held beside the state's own
    geometry, and not made for any other (the sparse frontier's sidecar,
    the unfused backend)."""
    from repro_torch.kernels.relax import fused
    n, src, dst, w = jgen.rmat(8, 6, seed=4)
    pl = sl.SlicedEllPlanner(n, slice_rows=16, hub_k=32)
    stale = pl.empty_host()
    for make in (pl.empty_host, lambda: pl.rebuild_host(src, dst, w),
                 lambda: pl.rebuild_host(src[::2], dst[::2], w[::2])):
        arrays = make()
        state = sl.SlicedEllState.from_host(pl, arrays, "cpu")
        np.testing.assert_array_equal(state.table.blocks.numpy(),
                                      fused.block_table(pl.widths, pl.sr))
        assert state.table.widths is state.widths == tuple(pl.widths)
        assert (state.table.cells, state.table.rows) == (
            state.flat_w.shape[0], state.fill.shape[0])
        np.testing.assert_array_equal(state.base.numpy(), pl.base)
        assert sl.SlicedEllState.from_host(
            pl, arrays, "cpu", with_blocks=False).table is None
    assert len(set(pl.widths)) > 1
    with pytest.raises(ValueError, match="geometry|cells"):
        sl.SlicedEllState.from_host(pl, stale, "cpu")   # an earlier layout
    cfg = EngineConfig(n, 64, 0, relax_backend="sliced", device="cpu",
                       sliced_slice_rows=16)
    for use_fused in (False, True):
        be = sl.SlicedBackend(cfg, n, use_fused=use_fused)
        assert (be.state.table is not None) == use_fused
    assert OutAdjacency(n, "cpu").state.table is None
