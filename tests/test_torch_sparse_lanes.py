"""The batched sparse frontier of the port: K3's lane form and the
lane-generic ladder wave and epochs (``[S, N]`` trees, the batched engine's
``sources=``) against the reference's vmapped renderings.

K3's lane plain version (``gathered_rows_relax_lanes_ref``, the CPU route
of ``gathered_rows_relax_lanes``) against ``jax.vmap`` of the Pallas
``gathered_rows_relax`` (interpret mode) and of ``gathered_rows_relax_ref``,
and against S single-lane calls; ``gather.wave_bytes`` with ``lanes=S``
against S single-lane counts.  ``frontier.ladder_wave`` on ``[S, N]``
against ``jax.vmap(repro.core.frontier.ladder_wave)`` on one OUT layout
with hub overflow, lanes on different rungs: the low rung, the top rung,
and one lane past the top, which sends every lane to the dense wave.  The
sparse relax, delete and drain epochs on ``[S, N]`` against the JAX
``sparse_relax_batched`` / ``sparse_delete_batched`` /
``sparse_drain_batched``: dist, parent, the per-lane stats and occupancy,
with a lane that has no deletion seed.

Inputs are made from seeds with numpy.  Tolerance: 0.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buckets as jbuckets
from repro.core import delete as jdel
from repro.core import frontier as jfr
from repro.core.state import EdgePool as JPool
from repro.core.state import SSSPState as JState
from repro.graphs import generators
from repro.kernels.relax import gather as jgather
from repro_torch.core import buckets, delete, frontier, ingest, relax
from repro_torch.core.state import EdgePool, SSSPState
from repro_torch.kernels.relax import gather

BIG = 2**31 - 1


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------ K3's lane form --
def _lane_edges(seed, lanes, e, n, *, ties=False, hub=False):
    """[S, E] edge lists: lane 1 all masked, with ``hub`` lane 2's slots
    all on one row; masked slots carry out-of-range ``nbr``."""
    rng = np.random.default_rng(seed)
    shape = (lanes, e)
    if ties:
        wd = rng.integers(0, 3, shape).astype(np.float32)
        w = rng.integers(1, 3, shape).astype(np.float32)
    else:
        wd = rng.uniform(0, 3, shape).astype(np.float32)
        w = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    wd[rng.random(shape) < 0.1] = np.inf
    w[rng.random(shape) < 0.1] = np.inf
    src = rng.integers(0, n, shape).astype(np.int32)
    nbr = rng.integers(0, n, shape).astype(np.int32)
    mask = rng.random(shape) < 0.8
    if lanes > 1:
        mask[1] = False
    if hub and lanes > 2:
        nbr[2] = n // 2
    nbr[~mask] = rng.integers(-5, 2 * n, int((~mask).sum()))   # never read
    return wd, src, nbr, w, mask


@pytest.mark.parametrize("seed,lanes,e,n,ties,hub", [
    (0, 1, 85, 40, False, False), (1, 3, 64, 50, False, False),
    (2, 3, 300, 17, True, True), (3, 4, 120, 60, True, False),
    (4, 5, 200, 33, True, True), (5, 4, 0, 12, False, False),
    (6, 5, 40, 1, True, False)])
def test_k3_lane_plain_version_matches_vmapped_reference(seed, lanes, e, n,
                                                         ties, hub):
    """The lane plain version, the CPU wrapper (no launch counted) and S
    single-lane calls agree with ``jax.vmap`` of the Pallas K3 (interpret
    mode) and of its reference: ties, an all-masked lane, a hub row,
    E = 0 and R = 1."""
    args = _lane_edges(seed, lanes, e, n, ties=ties, hub=hub)
    before = (gather.gathered_rows_relax.launches,
              gather.gathered_rows_relax.lane_launches)
    b, a = gather.gathered_rows_relax_lanes(*_t(*args), num_rows=n)
    assert (gather.gathered_rows_relax.launches,
            gather.gathered_rows_relax.lane_launches) == before
    rb, ra = gather.gathered_rows_relax_lanes_ref(*_t(*args), num_rows=n)
    assert torch.equal(b, rb) and torch.equal(a, ra)
    assert b.shape == a.shape == (lanes, n)
    assert b.dtype == torch.float32 and a.dtype == torch.int32
    for s in range(lanes):
        ob, oa = gather.gathered_rows_relax_ref(
            *_t(*[x[s] for x in args]), num_rows=n)
        assert torch.equal(b[s], ob) and torch.equal(a[s], oa)
    jargs = _j(*[np.where(args[4], x, 0) if i == 2 else x
                 for i, x in enumerate(args)])     # JAX needs in-range nbr
    want = [jax.vmap(functools.partial(jgather.gathered_rows_relax_ref,
                                       num_rows=n))(*jargs)]
    if e:
        want.append(jax.vmap(functools.partial(
            jgather.gathered_rows_relax, num_rows=n, interpret=True))(*jargs))
    for jb, ja in want:
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert (a.numpy()[np.isinf(b.numpy())] == BIG).all()
    if lanes > 1:                                   # the all-masked lane
        assert np.isinf(b[1].numpy()).all() and (a[1].numpy() == BIG).all()


@pytest.mark.parametrize("lanes,e,n", [(1, 85, 40), (4, 300, 17), (5, 0, 9)])
def test_k3_lane_wave_bytes_are_s_single_lane_counts(lanes, e, n):
    """The lane form moves what S single-lane calls move, and at S = 4,
    E = 16,384, R = 2^20 with every slot masked in its bound is 34.7 MB,
    97 % of it the [S, R] outputs."""
    mask = _lane_edges(lanes + e, lanes, e, n)[4]
    total = gather.wave_bytes(e, int(mask.sum()), n, lanes=lanes)
    assert total == sum(gather.wave_bytes(e, int(m.sum()), n) for m in mask)
    big = gather.wave_bytes(16_384, 4 * 16_384, 1 << 20, lanes=4)
    assert big == 4 * (17 * 16_384 + 8 * (1 << 20))
    assert big == 34_668_544 and 8 * 4 * (1 << 20) / big > 0.96


# ---------------------------------------------------------- the layout --
def _graph(log2_n, factor, seed):
    n, src, dst, w = generators.rmat(log2_n, factor, seed=seed)
    return n, src.astype(np.int32), dst.astype(np.int32), w


def _sidecars(n, src, dst, w, hub_k):
    """The port's and the reference's OUT sidecar and pool over one graph,
    their arrays equal."""
    alloc = ingest.make_allocator(len(src))
    plan = alloc.plan_adds(src, dst, w)
    out = frontier.OutAdjacency(n, "cpu", hub_k=hub_k)
    out.apply_adds(plan, alloc)
    jout = jfr.OutAdjacency(n, hub_k=hub_k)
    jout.apply_adds(plan, alloc)
    for f in ("flat_idx", "flat_w", "fill", "osrc", "odst", "ow"):
        np.testing.assert_array_equal(getattr(out.state, f).numpy(),
                                      np.asarray(getattr(jout.state, f)))
    act = np.ones(len(src), bool)
    return out, jout, EdgePool(*_t(src, dst, w, act)), JPool(*_j(src, dst, w,
                                                                  act))


@functools.cache
def _ladder_setup():
    n, src, dst, w = _graph(12, 4, 5)
    return (n, src, dst, w, *_sidecars(n, src, dst, w, hub_k=8),
            frontier.capacity_ladder(n, 1024))


def _frontiers(n, sizes, seed):
    """One lane a size: that many distinct vertices (0 = empty)."""
    rng = np.random.default_rng(seed)
    f = np.zeros((len(sizes), n), bool)
    for i, k in enumerate(sizes):
        f[i, rng.choice(n, k, replace=False)] = True
    return f


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("sizes,rung", [
    ((40, 0, 90), "low"), ((40, 0, 500), "top"), ((40, 500, 2000), "dense"),
    ((0, 0, 0), "low")],
    ids=["low rung", "top rung", "one lane past the top", "all empty"])
def test_ladder_wave_lanes_match_vmapped_reference(monkeypatch, sizes, rung,
                                                   use_kernel):
    """Lanes share the smallest rung every lane fits; the result equals
    ``jax.vmap`` of the reference's ladder wave lane for lane (dist,
    parent, improved), and the per-lane counts are the frontiers'."""
    n, src, dst, w, out, jout, pool, jpool, caps = _ladder_setup()
    assert len(caps) == 2
    assert int((out.state.ow < np.inf).sum()) > 0       # hub overflow
    lanes = len(sizes)
    rng = np.random.default_rng(sum(sizes))
    dist = rng.uniform(0, 20, (lanes, n)).astype(np.float32)
    dist[rng.random((lanes, n)) < 0.2] = np.inf
    parent = rng.integers(-1, n, (lanes, n)).astype(np.int32)
    f = _frontiers(n, sizes, sum(sizes) + 1)
    taken = []
    push, dense = frontier.sparse_push_wave, relax.relax_round

    def counted_push(*a, **k):
        taken.append(a[2].shape[-1])
        return push(*a, **k)

    def counted_dense(*a, **k):
        taken.append("dense")
        return dense(*a, **k)

    monkeypatch.setattr(frontier, "sparse_push_wave", counted_push)
    monkeypatch.setattr(relax, "relax_round", counted_dense)
    d, p, imp, count = frontier.ladder_wave(
        *_t(dist, parent, f), out.state, pool, caps=caps, num_vertices=n,
        use_kernel=use_kernel)
    assert taken == [{"low": caps[0], "top": caps[-1],
                      "dense": "dense"}[rung]]
    assert isinstance(count, np.ndarray) and count.dtype == np.int64
    np.testing.assert_array_equal(count, f.sum(-1))
    jd, jp, jimp = jax.vmap(lambda a, b, c: jfr.ladder_wave(
        a, b, c, jout.state, jpool, caps=caps, num_vertices=n))(
            *_j(dist, parent, f))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(imp.numpy(), np.asarray(jimp))
    jcount = jax.vmap(lambda m: jfr.compact_mask(m, cap=caps[-1])[1])(
        jnp.asarray(f))
    np.testing.assert_array_equal(count, np.asarray(jcount))
    if any(sizes):
        assert imp.any()


@pytest.mark.parametrize("cap", [16, 256])
def test_compact_mask_lanes_match_vmapped_reference(cap):
    """Per-lane worklists and counts of an [S, N] mask, an empty and a full
    lane among them, and the inverse ``worklist_to_mask``."""
    n = 300
    rng = np.random.default_rng(cap)
    mask = rng.random((4, n)) < np.array([[0.02], [0.0], [0.3], [1.0]])
    wl, count = frontier.compact_mask(*_t(mask), cap=cap)
    jwl, jcount = jax.vmap(lambda m: jfr.compact_mask(m, cap=cap))(
        jnp.asarray(mask))
    np.testing.assert_array_equal(wl.numpy(), np.asarray(jwl))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    assert wl.shape == (4, cap) and wl.dtype == torch.int32
    fits = count.numpy() <= cap
    np.testing.assert_array_equal(
        frontier.worklist_to_mask(wl, n).numpy()[fits], mask[fits])


# --------------------------------------------------------- the epochs --
SOURCES = (3, 17, 40, 101)


def _same_stats(got, want):
    """Per-lane stats of a port epoch against the reference's, field by
    field (host round arrays and device counts alike)."""
    assert type(got)._fields == type(want)._fields
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.shape == (len(SOURCES),)


def _same_state(s, js):
    np.testing.assert_array_equal(s.dist.numpy(), np.asarray(js.dist))
    np.testing.assert_array_equal(s.parent.numpy(), np.asarray(js.parent))


def _epoch_setup():
    """A fresh graph, sidecars and pools (the epochs' cases delete
    edges)."""
    n, src, dst, w = _graph(8, 6, 2)
    return (n, src, dst, w, *_sidecars(n, src, dst, w, hub_k=16),
            frontier.capacity_ladder(n, 16))


def _doomed(par, lane_without):
    """Two tree edges of lane 0 that are not tree edges of lane
    ``lane_without``: (their tails, their heads)."""
    kids = np.nonzero((par[0] >= 0) & (par[lane_without] != par[0]))[0]
    kids = kids[[0, -1]].astype(np.int32)
    return par[0][kids].astype(np.int32), kids


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sparse_lane_epochs_match_vmapped_reference(use_kernel):
    """From each lane's source to fixpoint over a shared ADD frontier, then
    a deletion of two of lane 0's tree edges that lane 2's tree does not
    hold (lane 2 has no seed), through the ladder (its rung and the dense
    fallback both occur) against the JAX batched epochs."""
    n, src, dst, w, out, jout, pool, jpool, caps = _epoch_setup()
    f = np.zeros(n, bool)
    f[list(SOURCES)] = True
    s = SSSPState.init_batched(n, SOURCES, "cpu")
    js = JState.init_batched(n, SOURCES)
    s, st, occ = frontier.sparse_relax_batched(
        s, pool, out.state, *_t(f), num_vertices=n, caps=caps,
        use_kernel=use_kernel)
    js, jst, jocc = jfr.sparse_relax_batched(
        js, jpool, jout.state, jnp.asarray(f), num_vertices=n, caps=caps)
    _same_state(s, js)
    _same_stats(st, jst)
    np.testing.assert_array_equal(occ, np.asarray(jocc))
    assert occ.dtype == np.int64 and (occ > 0).all()

    tails, heads = _doomed(s.parent.numpy(), 2)
    seed = delete.deletion_seed_for_edges(s, *_t(tails, heads), n)
    jseed = jdel.deletion_seed_for_edges_batched(js, *_j(tails, heads), n)
    np.testing.assert_array_equal(seed.numpy(), np.asarray(jseed))
    assert seed[0].any() and not seed[2].any()
    dead = np.isin((src.astype(np.int64) << 32) | dst,
                   (tails.astype(np.int64) << 32) | heads)
    pool = EdgePool(pool.src, pool.dst, pool.w, torch.from_numpy(~dead))
    jpool = JPool(*_j(src, dst, w, ~dead))
    out.apply_dels(tails, heads)
    jout.apply_dels(tails, heads)
    s2, d2, occ = frontier.sparse_delete_batched(
        s, pool, out.state, seed, num_vertices=n, caps=caps,
        use_kernel=use_kernel)
    js2, jd2, jocc = jfr.sparse_delete_batched(
        js, jpool, jout.state, jseed, num_vertices=n, caps=caps)
    _same_state(s2, js2)
    _same_stats(d2, jd2)
    np.testing.assert_array_equal(occ, np.asarray(jocc))
    assert d2.affected[0] > 0 and d2.affected[2] == 0
    assert d2.recompute_rounds[2] == d2.invalidation_rounds[2] == 0
    assert occ[2] == 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sparse_lane_drain_matches_vmapped_reference(use_kernel):
    """The bucketed drain on [S, N]: from each lane's source (push only),
    then after a lazy deletion of lane 0's tree edges (a pull too, none in
    lane 2), against the JAX ``sparse_drain_batched``."""
    n, src, dst, w, out, jout, pool, jpool, caps = _epoch_setup()
    f = np.zeros(n, bool)
    f[list(SOURCES)] = True
    s = SSSPState.init_batched(n, SOURCES, "cpu")
    js = JState.init_batched(n, SOURCES)
    pend = buckets.enqueue_push(
        buckets.empty_pending(n, len(SOURCES)), *_t(f), s.dist)
    jpend = jbuckets.enqueue_push(
        jbuckets.empty_pending(n, len(SOURCES)), jnp.asarray(f), js.dist)
    kw = dict(num_vertices=n, caps=caps, bucket_width=1.0)
    s, pend, st, occ = frontier.sparse_drain_batched(
        s, pool, out.state, pend, use_kernel=use_kernel, **kw)
    js, jpend, jst, jocc = jfr.sparse_drain_batched(
        js, jpool, jout.state, jpend, **kw)
    _same_state(s, js)
    _same_stats(st, jst)
    np.testing.assert_array_equal(occ, np.asarray(jocc))
    assert (occ > 0).all() and not pend.push.any()

    tails, heads = _doomed(s.parent.numpy(), 2)
    slots = np.nonzero(np.isin((src.astype(np.int64) << 32) | dst,
                               (tails.astype(np.int64) << 32) | heads))[0]
    slots = slots.astype(np.int32)
    s, pool, pend, _ = buckets.lazy_delete(
        s, pool, pend, *_t(tails, heads, slots), num_vertices=n)
    js, jpool, jpend, _ = jbuckets.lazy_delete_batched(
        js, jpool, jpend, *_j(tails, heads, slots), num_vertices=n)
    out.apply_dels(tails, heads)
    jout.apply_dels(tails, heads)
    np.testing.assert_array_equal(pend.pull.numpy(), np.asarray(jpend.pull))
    assert pend.pull[0].any() and not pend.pull[2].any()
    s, pend, st, occ = frontier.sparse_drain_batched(
        s, pool, out.state, pend, use_kernel=use_kernel, **kw)
    js, jpend, jst, jocc = jfr.sparse_drain_batched(
        js, jpool, jout.state, jpend, **kw)
    _same_state(s, js)
    _same_stats(st, jst)
    np.testing.assert_array_equal(occ, np.asarray(jocc))
    assert not pend.pull.any() and not pend.push.any()
