"""Dense-ELL backend of the port (core/backends/ellpack.py) against
``repro.core.backends.ellpack``: the copied ``EllPlanner`` (append cells,
fill marks, K and rebuild counts), the in-place patch ops ``ell_append`` /
``ell_delete`` / ``ell_update_min`` on padded batches with repeated entries,
the whole ``EllState`` arrays after every batch, and the ELL epochs
``ell_relax_until_converged`` / ``ell_invalidate_and_recompute``.

Inputs are made from seeds with numpy and fed to both packages.  Tolerance:
0 — every array and stat bit-identical.
"""
import tracemalloc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.backends import ellpack as jell
from repro.core.state import SSSPState as JState
from repro.core import delete as jdel
from repro_torch.core import delete, ingest
from repro_torch.core.backends import ellpack as ell
from repro_torch.core.state import SSSPState


def _same_ell(state, jstate):
    for f in ("nbr_idx", "nbr_w", "fill"):
        got, want = getattr(state, f).numpy(), np.asarray(getattr(jstate, f))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.filterwarnings("ignore:dense-ELL rebuild allocates")
@pytest.mark.parametrize("block_rows,init_k", [(256, 1), (16, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_planner_and_patch_ops_track_reference(seed, block_rows, init_k):
    """A randomized add / duplicate-min / delete sequence through the
    planner (append or rebuild) and the patch ops, with pow2-padded
    batches: planner state and the device block equal the reference's
    after every batch."""
    n, cap = 40, 600
    rng = np.random.default_rng(seed)
    alloc = ingest.make_allocator(cap, "min")
    pl = ell.EllPlanner(n, block_rows=block_rows, init_k=init_k)
    jpl = jell.EllPlanner(n, block_rows=block_rows, init_k=init_k)
    state = ell.EllState.from_host(*pl.empty_host(), "cpu")
    jstate = jpl.empty_state()
    assert (pl.rows, pl.k) == (jpl.rows, jpl.k)
    for _ in range(14):
        m = int(rng.integers(1, 30))
        plan = alloc.plan_adds(rng.integers(0, n, m), rng.integers(0, n, m),
                               rng.integers(1, 5, m).astype(np.float32))
        fresh = plan.fresh
        rows = plan.dst[fresh].astype(np.int64)
        kpos, jkpos = pl.plan_appends(rows), jpl.plan_appends(rows)
        assert (kpos is None) == (jkpos is None)
        if kpos is None:
            state = ell.EllState.from_host(
                *pl.rebuild_host(*alloc.active_coo()), "cpu")
            jstate = jpl.rebuild(*alloc.active_coo())
        else:
            np.testing.assert_array_equal(kpos, jkpos)
            if len(rows):
                batch = ingest.pad_pow2(rows.astype(np.int32), kpos,
                                        plan.src[fresh], plan.w[fresh])
                ell.ell_append(state, *_t(*batch))
                jstate = jell.ell_append(jstate, *_j(*batch))
            if not fresh.all():
                upd = ~fresh
                batch = ingest.pad_pow2(plan.dst[upd], plan.src[upd],
                                        plan.w[upd])
                ell.ell_update_min(state, *_t(*batch))
                jstate = jell.ell_update_min(jstate, *_j(*batch))
        np.testing.assert_array_equal(pl.fill, jpl.fill)
        assert (pl.k, pl.rebuilds) == (jpl.k, jpl.rebuilds)
        # the invariant plan_appends' overflow check rests on
        assert (pl.fill <= pl.k).all()
        _same_ell(state, jstate)

        d = int(rng.integers(1, 12))
        slots, psrc, pdst = alloc.plan_dels(rng.integers(0, n, d),
                                            rng.integers(0, n, d))
        if len(slots):
            # repeated pad entries + a never-present edge: both must no-op
            rows_p, src_p = ingest.pad_pow2(np.r_[pdst, 0].astype(np.int32),
                                            np.r_[psrc, n - 1].astype(np.int32))
            ell.ell_delete(state, *_t(rows_p, src_p))
            jstate = jell.ell_delete(jstate, *_j(rows_p, src_p))
            _same_ell(state, jstate)
    assert pl.rebuilds >= 1, "rebuild path not exercised"


def _planner_batches(case, n, k, rng):
    """Row batches (window-local ids) for one case of
    ``test_plan_appends_matches_reference``; the planner starts at K = k."""
    def rand(m):
        return rng.integers(0, n, m)
    r, r2 = 17, n - 3
    if case == "exact_k":          # r reaches K over two batches, r2 in one
        return [np.r_[rand(5), [r] * (k // 2)], np.r_[[r] * (k - k // 2),
                rand(7)], np.r_[rand(3), [r2] * k], rand(40)]
    if case == "k_plus_1":         # r at K, then one more: rebuild
        return [np.full(k, r), rand(9), np.r_[rand(2), r], np.full(k, r),
                rand(64)]
    if case == "many_into_one":    # 64 arcs into one row, twice
        return [np.r_[rand(3), [r] * 61], rand(20), np.full(64, r),
                np.full(64, r)]
    if case == "empty":
        return [rand(0), rand(12), rand(0), np.full(k, r), rand(0)]
    if case == "dense":            # more than n/2 rows: the dense count
        return [rng.permutation(n)[:n // 2 + 1], rand(30),
                np.r_[rng.permutation(n)[:n // 2], [r] * (k + 1)], rand(64)]
    raise ValueError(case)


@pytest.mark.filterwarnings("ignore:dense-ELL rebuild allocates")
@pytest.mark.parametrize("case,row0", [
    ("exact_k", 0), ("k_plus_1", 0), ("many_into_one", 0), ("empty", 0),
    ("dense", 0), ("k_plus_1", 3 << 16), ("dense", 5 << 16)])
def test_plan_appends_matches_reference(case, row0, monkeypatch):
    """The overflow check over a planner much larger than its batches:
    kpos or None, fill, K and rebuilds equal the reference's after every
    call (a None rebuilds both from the arcs so far).  A batch far smaller
    than the rows allocates nothing of the row count; a batch past n/2
    rows that overflows returns before the rank's sort, as the reference
    does.  ``row0 > 0`` is the window-local planner ``ShardedEllpack``
    builds."""
    n, k = 1 << 16, 4
    rng = np.random.default_rng(len(case) + row0)
    pl = ell.EllPlanner(n, block_rows=256, init_k=k, row0=row0)
    jpl = jell.EllPlanner(n, block_rows=256, init_k=k, row0=row0)
    sorts = []
    rank = ell.rank_within_rows
    monkeypatch.setattr(ell, "rank_within_rows",
                        lambda rows: sorts.append(len(rows)) or rank(rows))
    dst = np.empty(0, np.int64)
    outcomes = []
    for batch in _planner_batches(case, n, k, rng):
        rows = batch.astype(np.int64) + row0
        dst = np.r_[dst, rows]
        m, sorted_before = len(rows), len(sorts)
        tracemalloc.start()
        try:
            kpos = pl.plan_appends(rows)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        jkpos = jpl.plan_appends(rows)
        assert (kpos is None) == (jkpos is None)
        if kpos is None:
            if m > n // 2:
                assert len(sorts) == sorted_before, "sorted a dense overflow"
            src = np.arange(len(dst)) % n + row0
            w = np.ones(len(dst), np.float32)
            for a, b in zip(pl.rebuild_host(src, dst, w),
                            jpl.rebuild_host(src, dst, w)):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(kpos, jkpos)
            assert kpos.dtype == np.int32
        if 64 * m <= n:
            assert peak < n, f"{peak} B traced for {m} rows"
        np.testing.assert_array_equal(pl.fill, jpl.fill)
        assert (pl.k, pl.rebuilds) == (jpl.k, jpl.rebuilds)
        assert (pl.fill <= pl.k).all()
        outcomes.append(kpos is None)
    assert any(outcomes) == (case not in ("exact_k", "empty")), outcomes


def _block(seed, n=60, m=300):
    alloc = ingest.make_allocator(m + 8)
    rng = np.random.default_rng(seed)
    alloc.plan_adds(rng.integers(0, n, m), rng.integers(0, n, m),
                    rng.integers(1, 4, m).astype(np.float32))
    pl = ell.EllPlanner(n, block_rows=256, init_k=1)
    idx, w, _ = pl.rebuild_host(*alloc.active_coo())
    return n, idx, w


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_ell_epochs_match_reference(seed, use_kernel):
    n, idx, w = _block(seed)
    source = 4
    s, js = SSSPState.init(n, source, "cpu"), JState.init(n, source)
    f = np.zeros(n, bool)
    f[source] = True
    s, st = ell.ell_relax_until_converged(s, *_t(idx, w, f),
                                          use_kernel=use_kernel)
    js, jst = jell.ell_relax_until_converged(js, *_j(idx, w, f),
                                             num_vertices=n)
    np.testing.assert_array_equal(s.dist.numpy(), np.asarray(js.dist))
    np.testing.assert_array_equal(s.parent.numpy(), np.asarray(js.parent))
    assert st.rounds == int(jst.rounds)
    assert int(st.messages) == int(jst.messages)

    # delete two tree edges' cells (tombstones) and recompute
    par = s.parent.numpy()
    kids = np.nonzero(par >= 0)[0][:2].astype(np.int32)
    srcs = par[kids].astype(np.int32)
    seed_t = delete.deletion_seed_for_edges(s, *_t(srcs, kids), n)
    jseed = jdel.deletion_seed_for_edges(js, *_j(srcs, kids), n)
    state = ell.EllState(*_t(idx, w, np.zeros(len(idx), np.int32)))
    ell.ell_delete(state, *_t(kids, srcs))
    jstate = jell.ell_delete(jell.EllState(*_j(idx, w, np.zeros(len(idx),
                                                                np.int32))),
                             *_j(kids, srcs))
    _same_ell(state, jstate)
    for use_doubling in (False, True):
        s2, dst_ = ell.ell_invalidate_and_recompute(
            s, state.nbr_idx, state.nbr_w, seed_t,
            use_doubling=use_doubling, use_kernel=use_kernel)
        js2, jdst = jell.ell_invalidate_and_recompute(
            js, jstate.nbr_idx, jstate.nbr_w, jseed, num_vertices=n,
            use_doubling=use_doubling)
        np.testing.assert_array_equal(s2.dist.numpy(), np.asarray(js2.dist))
        np.testing.assert_array_equal(s2.parent.numpy(),
                                      np.asarray(js2.parent))
        assert (dst_.invalidation_rounds, dst_.recompute_rounds) == (
            int(jdst.invalidation_rounds), int(jdst.recompute_rounds))
        assert int(dst_.affected) == int(jdst.affected) > 0
        assert int(dst_.recompute_messages) == int(jdst.recompute_messages)
