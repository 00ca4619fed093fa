"""Relaxation and deletion epochs of the port (core/relax.py,
core/delete.py) against ``repro.core.relax`` / ``repro.core.delete``:
``relax_until_converged``, ``frontier_from_vertices``,
``deletion_seed_for_edges``, the flood and doubling subtree markings, and
``invalidate_and_recompute`` with every stat.

Inputs are made from seeds with numpy and fed to both packages.  Tolerance:
0 — (dist, parent) bit-identical and every stat equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import delete as jdel
from repro.core import relax as jrelax
from repro.core.state import EdgePool as JPool, SSSPState as JState
from repro.graphs import generators
from repro_torch.core import delete, relax
from repro_torch.core.state import EdgePool, SSSPState

SOURCE = 2


def _graph(seed: int, n: int = 70, m: int = 400, *, ties: bool = False):
    """A pool with a few inactive slots; integer weights when ``ties``."""
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    if ties:
        w = np.random.default_rng(seed).integers(1, 3, len(w)).astype(
            np.float32)
    active = np.random.default_rng(seed + 1).random(len(src)) < 0.9
    arrs = (src.astype(np.int32), dst.astype(np.int32), w, active)
    return n, EdgePool(*map(torch.from_numpy, arrs)), JPool(
        *map(jnp.asarray, arrs))


def _init(n):
    s = SSSPState.init(n, SOURCE, "cpu")
    return s, JState.init(n, SOURCE)


def _same(state, jstate):
    np.testing.assert_array_equal(state.dist.numpy(), np.asarray(jstate.dist))
    np.testing.assert_array_equal(state.parent.numpy(),
                                  np.asarray(jstate.parent))


def _converged(n, pool, jpool):
    s, js = _init(n)
    f = torch.zeros(n, dtype=torch.bool)
    f[SOURCE] = True
    s, _ = relax.relax_until_converged(s, pool, f, num_vertices=n)
    js, _ = jrelax.relax_until_converged(js, jpool, jnp.asarray(f.numpy()),
                                         num_vertices=n)
    return s, js


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_relax_until_converged_matches_reference(seed, ties):
    n, pool, jpool = _graph(seed, ties=ties)
    s, js = _init(n)
    verts = np.array([SOURCE, -1, SOURCE, 5], np.int32)   # padded, repeated
    f = relax.frontier_from_vertices(torch.from_numpy(verts), n)
    jf = jrelax.frontier_from_vertices(jnp.asarray(verts), n)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    s, st = relax.relax_until_converged(s, pool, f, num_vertices=n)
    js, jst = jrelax.relax_until_converged(js, jpool, jf, num_vertices=n)
    _same(s, js)
    assert st.rounds == int(jst.rounds) > 0
    assert int(st.messages) == int(jst.messages)


def _tree_deletions(s, pool, rng, k):
    """k deleted tree edges (parent[dst] == src) plus one random live edge."""
    par = s.parent.numpy()
    src, dst = pool.src.numpy(), pool.dst.numpy()
    live = np.nonzero(pool.active.numpy())[0]
    tree = live[par[dst[live]] == src[live]]
    pick = np.concatenate([rng.choice(tree, k, replace=False),
                           rng.choice(live, 1)])
    return pick.astype(np.int32), src[pick], dst[pick]


@pytest.mark.parametrize("use_doubling", [False, True])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("seed", [0, 3])
def test_invalidate_and_recompute_matches_reference(seed, k, use_doubling):
    n, pool, jpool = _graph(seed, ties=bool(seed % 2))
    s, js = _converged(n, pool, jpool)
    slots, dsrc, ddst = _tree_deletions(s, pool, np.random.default_rng(seed),
                                        k)
    seed_t = delete.deletion_seed_for_edges(
        s, torch.from_numpy(dsrc), torch.from_numpy(ddst), n)
    jseed = jdel.deletion_seed_for_edges(js, jnp.asarray(dsrc),
                                         jnp.asarray(ddst), n)
    np.testing.assert_array_equal(seed_t.numpy(), np.asarray(jseed))
    assert seed_t.any()

    mark = delete.mark_subtree_doubling if use_doubling \
        else delete.mark_subtree_flood
    jmark = jdel.mark_subtree_doubling if use_doubling \
        else jdel.mark_subtree_flood
    aff, rounds = mark(s.parent, seed_t)
    jaff, jrounds = jmark(js.parent, jseed)
    np.testing.assert_array_equal(aff.numpy(), np.asarray(jaff))
    assert rounds == int(jrounds)

    pool.active[torch.from_numpy(slots).long()] = False
    jpool = JPool(jpool.src, jpool.dst, jpool.w,
                  jpool.active.at[jnp.asarray(slots)].set(False))
    s2, st = delete.invalidate_and_recompute(s, pool, seed_t, num_vertices=n,
                                             use_doubling=use_doubling)
    js2, jst = jdel.invalidate_and_recompute(js, jpool, jseed, num_vertices=n,
                                             use_doubling=use_doubling)
    _same(s2, js2)
    assert st.invalidation_rounds == int(jst.invalidation_rounds)
    assert st.recompute_rounds == int(jst.recompute_rounds)
    assert int(st.affected) == int(jst.affected) > 0
    assert int(st.recompute_messages) == int(jst.recompute_messages)


@pytest.mark.parametrize("use_doubling", [False, True])
def test_non_tree_deletion_is_a_no_op_with_zero_stats(use_doubling):
    """An all-false seed returns the state unchanged and zero stats — what
    the reference computes on device with every stat gated on any(seed)."""
    n, pool, jpool = _graph(4)
    s, js = _converged(n, pool, jpool)
    empty = torch.zeros(n, dtype=torch.bool)
    s2, st = delete.invalidate_and_recompute(s, pool, empty, num_vertices=n,
                                             use_doubling=use_doubling)
    js2, jst = jdel.invalidate_and_recompute(
        js, jpool, jnp.asarray(empty.numpy()), num_vertices=n,
        use_doubling=use_doubling)
    _same(s2, js2)
    assert (st.invalidation_rounds, st.recompute_rounds) == (
        int(jst.invalidation_rounds), int(jst.recompute_rounds)) == (0, 0)
    assert int(st.affected) == int(jst.affected) == 0
    assert int(st.recompute_messages) == int(jst.recompute_messages) == 0


def test_pull_once_matches_reference():
    n, pool, jpool = _graph(6, ties=True)
    s, js = _converged(n, pool, jpool)
    aff = np.random.default_rng(6).random(n) < 0.3
    aff[SOURCE] = False
    dist = np.where(aff, np.inf, s.dist.numpy()).astype(np.float32)
    parent = np.where(aff, -1, s.parent.numpy()).astype(np.int32)
    got = delete.pull_once(torch.from_numpy(dist), torch.from_numpy(parent),
                           pool, torch.from_numpy(aff), n)
    want = jdel.pull_once(jnp.asarray(dist), jnp.asarray(parent), jpool,
                          jnp.asarray(aff), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
