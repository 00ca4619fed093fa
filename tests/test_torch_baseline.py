"""The paper's baselines in the port (``repro_torch.core.baseline``) against
``repro.core.baseline``, and the small leftovers that came with them:
``relax_round``'s ``tie_perm``, ``generators.grid2d`` and
``state.degree_histogram``.

  * ``ReMoBaseline``: dist, parent, rounds and messages at every query
    equal to the reference's, ties fixed and randomized with a seed (the
    same ``np.random.default_rng`` draws), and the same
    ``stability_vs_prev`` sequence;
  * ``BatchedBSPEngine``: flushes only at a full batch, and the tree after
    every flush equals the reference's;
  * ``StaticSolver``: ``convert`` builds the reference's CSR-by-dst pool and
    ``solve`` its tree;
  * ``relax_round`` / ``relax_until_converged`` with a ``tie_perm`` equal
    the JAX functions (and a lane stack equals its lanes one by one).

Inputs are made from seeds with numpy (a unit-weight lattice, where ties
are everywhere, and ER).  Tolerance: 0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import baseline as jbase
from repro.core import events as jev
from repro.core import relax as jrelax
from repro.core import state as jstate
from repro.graphs import generators as jgen
from repro.graphs import window
from repro_torch.core import baseline, relax, state
from repro_torch.graphs import generators


def _lattice_stream(seed=3, rows=9, cols=11):
    """A bidirectional unit-weight lattice as a sliding-window stream; the
    source (the lattice's centre) keeps out-edges throughout."""
    n, src, dst, w = jgen.grid2d(rows, cols)
    log = window.sliding_window_stream(src, dst, w, window=len(src) // 2,
                                       delta=0.3, seed=seed,
                                       query_every=len(src) // 5)
    return n, len(src) + 64, log, (rows // 2) * cols + cols // 2


LATTICE = _lattice_stream()


# ------------------------------------------------------------------- ReMo --
@pytest.mark.parametrize("randomize_ties", [False, True])
def test_remo_matches_reference(randomize_ties):
    """Query by query: the same tree and counters, and the same stability
    scores; randomized ties change some parents but no distance."""
    n, cap, log, source = LATTICE
    mine = baseline.ReMoBaseline(n, cap, source, randomize_ties=randomize_ties,
                                 seed=5, device="cpu")
    theirs = jbase.ReMoBaseline(n, cap, source,
                                randomize_ties=randomize_ties, seed=5)
    got, want = mine.ingest_log(log), theirs.ingest_log(log)
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        assert a.epoch_stats == b.epoch_stats
        assert mine.stability_vs_prev(a.parent) == \
            theirs.stability_vs_prev(b.parent)
    fixed = baseline.ReMoBaseline(n, cap, source, device="cpu").ingest_log(log)
    for a, b in zip(got, fixed):
        np.testing.assert_array_equal(a.dist, b.dist)
    if randomize_ties:
        assert any((a.parent != b.parent).any() for a, b in zip(got, fixed))


def test_remo_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        baseline.ReMoBaseline(8, 8, 0)


# ------------------------------------------------------------ batched BSP --
def test_batched_bsp_flushes_at_batch_boundaries():
    """Logs accumulate until ``batch_size`` events; each flush applies them
    and reconverges; the tree after every flush equals the reference's."""
    n, cap, log, source = LATTICE
    mine = baseline.BatchedBSPEngine(n, cap, source, batch_size=60,
                                     device="cpu")
    theirs = jbase.BatchedBSPEngine(n, cap, source, batch_size=60)
    topo = log[np.asarray(log.kind) != jev.QUERY]
    flushes = 0
    for a in range(0, len(topo), 25):
        for eng in (mine, theirs):
            eng.push(topo[a:a + 25])
        lat, jlat = mine.maybe_flush(), theirs.maybe_flush()
        assert (lat is None) == (jlat is None)
        if lat is not None:
            flushes += 1
            assert lat > 0
            np.testing.assert_array_equal(mine.inner.query().dist,
                                          theirs.inner.query().dist)
    assert flushes >= 3
    assert mine.force_flush() >= 0 and theirs.force_flush() >= 0
    assert mine.force_flush() == 0.0
    a, b = mine.inner.query(), theirs.inner.query()
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert a.epoch_stats == b.epoch_stats


# ----------------------------------------------------------- static solve --
def test_static_solver_matches_reference():
    n, src, dst, w = jgen.erdos_renyi(200, 1200, seed=9)
    log = window.sliding_window_stream(src, dst, w, window=600, delta=0.4,
                                       seed=9)
    mine, theirs = baseline.StaticSolver(n, device="cpu"), \
        jbase.StaticSolver(n)
    assert mine.convert(log) > 0 and theirs.convert(log) > 0
    for name in ("src", "dst", "w", "active"):
        np.testing.assert_array_equal(getattr(mine.edges, name).numpy(),
                                      np.asarray(getattr(theirs.edges, name)))
    a, b = mine.solve(7), theirs.solve(7)
    np.testing.assert_array_equal(a.dist, b.dist)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert a.solve_s > 0 and a.convert_s == 0.0
    with pytest.raises(RuntimeError, match="convert"):
        baseline.StaticSolver(n, device="cpu").solve(0)


# --------------------------------------------------------------- tie_perm --
@pytest.mark.parametrize("seed", [0, 1])
def test_relax_with_tie_perm_matches_jax(seed):
    """One round and the whole converge with a drawn permutation: the same
    (dist, parent) and counters as the JAX functions; without it the
    smallest-src rule; a lane stack equals its lanes one by one."""
    n, src, dst, w = jgen.grid2d(6, 7)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int32)
    pool = state.EdgePool(*(torch.from_numpy(np.asarray(a, t)) for a, t in (
        (src, np.int32), (dst, np.int32), (w, np.float32))),
        torch.ones(len(src), dtype=torch.bool))
    jpool = jstate.EdgePool(jnp.asarray(src, jnp.int32),
                            jnp.asarray(dst, jnp.int32),
                            jnp.asarray(w, jnp.float32),
                            jnp.ones(len(src), jnp.bool_))
    for tp in (None, perm):
        sssp = state.SSSPState.init(n, 0, "cpu")
        f = relax.frontier_from_vertices(torch.tensor([0]), n)
        t = None if tp is None else torch.from_numpy(tp)
        got, stats = relax.relax_until_converged(sssp, pool, f,
                                                 num_vertices=n, tie_perm=t)
        jf = jrelax.frontier_from_vertices(jnp.asarray([0]), n)
        want, jstats = jrelax.relax_until_converged(
            jstate.SSSPState.init(n, 0), jpool, jf, num_vertices=n,
            tie_perm=None if tp is None else jnp.asarray(tp))
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
        np.testing.assert_array_equal(got.parent.numpy(),
                                      np.asarray(want.parent))
        assert (stats.rounds, int(stats.messages)) == (int(jstats.rounds),
                                                       int(jstats.messages))
        d, p, imp = relax.relax_round(got.dist * 0 + 1, got.parent, pool,
                                      torch.ones(n, dtype=torch.bool),
                                      num_vertices=n, tie_perm=t)
        jd, jp, jimp, _ = jrelax.relax_round(
            jnp.ones(n, jnp.float32), jnp.asarray(got.parent.numpy()), jpool,
            jnp.ones(n, jnp.bool_), num_vertices=n,
            tie_perm=None if tp is None else jnp.asarray(tp))
        for x, y in ((d, jd), (p, jp), (imp, jimp)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    lanes = torch.stack([got.dist, torch.full_like(got.dist, 3.0)])
    par = torch.stack([got.parent, got.parent])
    fr = torch.ones((2, n), dtype=torch.bool)
    d2, p2, _ = relax.relax_round(lanes, par, pool, fr, num_vertices=n,
                                  tie_perm=t)
    for i in range(2):
        d1, p1, _ = relax.relax_round(lanes[i], par[i], pool, fr[i],
                                      num_vertices=n, tie_perm=t)
        assert torch.equal(d2[i], d1) and torch.equal(p2[i], p1)


# ------------------------------------------------------------ leftovers --
@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 6), (5, 1), (4, 7)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_grid2d_matches_reference(rows, cols, bidirectional):
    got = generators.grid2d(rows, cols, bidirectional=bidirectional,
                            weight=2.5)
    want = jgen.grid2d(rows, cols, bidirectional=bidirectional, weight=2.5)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_degree_histogram_matches_reference():
    n, src, dst, w = jgen.erdos_renyi(120, 900, seed=4)
    act = np.random.default_rng(4).random(len(src)) < 0.7
    pool = state.EdgePool(torch.from_numpy(src.astype(np.int32)),
                          torch.from_numpy(dst.astype(np.int32)),
                          torch.from_numpy(w), torch.from_numpy(act))
    jpool = jstate.EdgePool(jnp.asarray(src, jnp.int32),
                            jnp.asarray(dst, jnp.int32), jnp.asarray(w),
                            jnp.asarray(act))
    got = state.degree_histogram(pool, n)
    want = jstate.degree_histogram(jpool, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
