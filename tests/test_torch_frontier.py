"""Sparse frontier path of the port (core/frontier.py) against
``repro.core.frontier``: the compaction primitive, the capacity ladder, kernel
K3's plain version and CPU wrapper against the JAX ``gathered_rows_relax``
(Pallas, interpret mode) and ``gathered_rows_relax_ref``, the OUT-adjacency
sidecar's arrays, the sparse epochs, and whole engines with
``frontier_mode="sparse"`` / ``"auto"`` (``frontier_kernel`` on and off) at
every query of an RMAT sliding-window stream with deletions.  A small
``frontier_cap`` makes waves take both the sparse rung and the ladder's
dense fallback, which the engine test counts.

Inputs are made from seeds with numpy.  Tolerance: 0 — dist, parent,
n_rounds, n_messages and every array bit-identical.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import delete as jdel
from repro.core import frontier as jfr
from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.core.state import EdgePool as JPool
from repro.core.state import SSSPState as JState
from repro.graphs import generators, window
from repro.kernels.relax import gather as jgather
from repro_torch import make_engine
from repro_torch.core import delete, frontier, ingest, relax
from repro_torch.core.oracle import check_tree
from repro_torch.core.state import EdgePool, SSSPState
from repro_torch.kernels.relax import gather

SOURCE = 3
CAP = 32          # one rung of 32 vertices / 256 edges at n = 256


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ----------------------------------------------------- compaction primitive
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,cap", [(64, 64), (257, 32), (1000, 256)])
def test_compact_mask_matches_reference(seed, n, cap):
    rng = np.random.default_rng(seed)
    for mask in (rng.random(n) < rng.uniform(0.0, 0.5), np.zeros(n, bool),
                 np.ones(n, bool)):
        wl, count = frontier.compact_mask(*_t(mask), cap=cap)
        jwl, jcount = jfr.compact_mask(jnp.asarray(mask), cap=cap)
        np.testing.assert_array_equal(wl.numpy(), np.asarray(jwl))
        assert wl.dtype == torch.int32 and int(count) == int(jcount)
        if int(count) <= cap:
            np.testing.assert_array_equal(
                frontier.worklist_to_mask(wl, n).numpy(), mask)


def test_capacity_ladder_and_edge_budget_match_reference():
    for n in (10, 100, 300, 4096, 1 << 20):
        for cap in (0, 8, 100, 512, 4096):
            assert frontier.capacity_ladder(n, cap) == \
                jfr.capacity_ladder(n, cap)
    for c in (1, 256, 4096):
        assert frontier.edge_budget(c) == jfr.edge_budget(c)


# ------------------------------------------------------ gathered-rows kernel
def _edges(seed, m, n, *, ties=False, mask_frac=0.7):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    if ties:
        wd = rng.integers(0, 3, m).astype(np.float32)
        w = rng.integers(1, 3, m).astype(np.float32)
    else:
        wd = rng.uniform(0, 3, m).astype(np.float32)
        w = rng.uniform(0.1, 1.0, m).astype(np.float32)
    wd[rng.random(m) < 0.1] = np.inf
    w[rng.random(m) < 0.1] = np.inf                # tombstoned cells
    nbr = rng.integers(0, n, m).astype(np.int32)
    mask = rng.random(m) < mask_frac
    nbr[~mask] = rng.integers(-5, 2 * n, int((~mask).sum()))  # never read
    return wd, src, nbr, w, mask


@pytest.mark.parametrize("seed,m,n,ties,mask_frac", [
    (0, 85, 40, False, 0.7), (3, 85, 40, True, 0.7), (5, 300, 17, True, 1.0),
    (6, 64, 64, False, 0.0), (7, 0, 12, False, 0.7)])
def test_k3_plain_version_matches_jax_kernel_and_ref(seed, m, n, ties,
                                                     mask_frac):
    """Ties, +inf sources and weights, masked slots with out-of-range
    ``nbr``, an all-masked list and an empty list."""
    args = _edges(seed, m, n, ties=ties, mask_frac=mask_frac)
    jargs = _j(*[np.where(args[4], a, 0) if i == 2 else a
                 for i, a in enumerate(args)])     # JAX needs in-range nbr
    before = gather.gathered_rows_relax.launches
    b, a = gather.gathered_rows_relax(*_t(*args), num_rows=n)
    assert gather.gathered_rows_relax.launches == before   # CPU: no launch
    rb, ra = gather.gathered_rows_relax_ref(*_t(*args), num_rows=n)
    assert torch.equal(b, rb) and torch.equal(a, ra)
    assert b.dtype == torch.float32 and a.dtype == torch.int32
    want = [jgather.gathered_rows_relax_ref(*jargs, num_rows=n)]
    if m:
        want.append(jgather.gathered_rows_relax(*jargs, num_rows=n,
                                                interpret=True))
    for jb, ja in want:
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert (a.numpy()[np.isinf(b.numpy())] == 2**31 - 1).all()


# ------------------------------------------------------------ sparse epochs
def _graph(seed=2):
    n, src, dst, w = generators.rmat(8, 6, seed=seed)
    return n, src.astype(np.int32), dst.astype(np.int32), w


def test_sparse_epochs_match_reference():
    """Relax to fixpoint from the source through the ladder (both rungs and
    the dense fallback occur), then delete tree edges and recompute."""
    n, src, dst, w = _graph()
    m = len(src)
    alloc = ingest.make_allocator(m)
    plan = alloc.plan_adds(src, dst, w)
    out = frontier.OutAdjacency(n, "cpu")
    out.apply_adds(plan, alloc)
    jout = jfr.OutAdjacency(n)
    jout.apply_adds(plan, alloc)
    for f in ("flat_idx", "flat_w", "fill", "osrc", "odst", "ow"):
        np.testing.assert_array_equal(getattr(out.state, f).numpy(),
                                      np.asarray(getattr(jout.state, f)))
    act = np.ones(m, bool)
    pool = EdgePool(*_t(src, dst, w, act))
    jpool = JPool(*_j(src, dst, w, act))
    caps = frontier.capacity_ladder(n, 16)
    s, js = SSSPState.init(n, SOURCE, "cpu"), JState.init(n, SOURCE)
    f = np.zeros(n, bool)
    f[SOURCE] = True
    s, st, occ = frontier.sparse_relax_until_converged(
        s, pool, out.state, *_t(f), num_vertices=n, caps=caps)
    js, jst, jocc = jfr.sparse_relax_until_converged(
        js, jpool, jout.state, jnp.asarray(f), num_vertices=n, caps=caps)
    np.testing.assert_array_equal(s.dist.numpy(), np.asarray(js.dist))
    np.testing.assert_array_equal(s.parent.numpy(), np.asarray(js.parent))
    assert (st.rounds, int(st.messages)) == (int(jst.rounds),
                                             int(jst.messages))
    assert occ == int(jocc) > 0

    par = s.parent.numpy()
    kids = np.nonzero(par >= 0)[0][[0, -1]].astype(np.int32)
    srcs = par[kids].astype(np.int32)
    seed_t = delete.deletion_seed_for_edges(s, *_t(srcs, kids), n)
    jseed = jdel.deletion_seed_for_edges(js, *_j(srcs, kids), n)
    dead = np.isin((src.astype(np.int64) << 32) | dst,
                   (srcs.astype(np.int64) << 32) | kids)
    pool.active[torch.from_numpy(dead)] = False
    jpool = JPool(*_j(src, dst, w, act & ~dead))
    out.apply_dels(srcs, kids)
    jout.apply_dels(srcs, kids)
    for use_kernel in (False, True):
        s2, d2, occ = frontier.sparse_invalidate_and_recompute(
            s, pool, out.state, seed_t, num_vertices=n, caps=caps,
            use_kernel=use_kernel)
        js2, jd2, jocc = jfr.sparse_invalidate_and_recompute(
            js, jpool, jout.state, jseed, num_vertices=n, caps=caps)
        assert occ == int(jocc)
        np.testing.assert_array_equal(s2.dist.numpy(), np.asarray(js2.dist))
        np.testing.assert_array_equal(s2.parent.numpy(),
                                      np.asarray(js2.parent))
        assert (d2.invalidation_rounds, d2.recompute_rounds) == (
            int(jd2.invalidation_rounds), int(jd2.recompute_rounds))
        assert int(d2.affected) == int(jd2.affected) > 0
        assert int(d2.recompute_messages) == int(jd2.recompute_messages)


# ----------------------------------------------------- engine-level parity
def _stream():
    n, src, dst, w = generators.rmat(8, 6, seed=3)
    m = len(src)
    log = window.sliding_window_stream(src, dst, w, window=m // 3,
                                       delta=0.4, seed=3, query_every=m // 4)
    return n, m + 64, log


@functools.cache
def _jax_run(mode: str, backend: str):
    n, cap, log = _stream()
    eng = JaxEngine(JaxConfig(n, cap, SOURCE, relax_backend=backend,
                              batch_deletions=True, frontier_mode=mode,
                              frontier_cap=CAP))
    return eng.ingest_log(log), eng


@pytest.mark.parametrize("mode,backend,kernel", [
    ("sparse", "segment", False), ("sparse", "segment", True),
    ("auto", "segment", True), ("sparse", "sliced", True),
    ("auto", "sliced", False), ("sparse", "segment", None),
    ("auto", "sliced", None)])
def test_engine_bit_identical_to_reference(mode, backend, kernel,
                                           monkeypatch):
    n, cap, log = _stream()
    want, jeng = _jax_run(mode, backend)
    rungs = {"sparse": 0, "dense": 0}

    def counting(fn, key):
        def wrapped(*a, **k):
            rungs[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(frontier, "sparse_push_wave",
                        counting(frontier.sparse_push_wave, "sparse"))
    monkeypatch.setattr(relax, "relax_round",
                        counting(relax.relax_round, "dense"))
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=SOURCE,
                      relax_backend=backend, batch_deletions=True,
                      frontier_mode=mode, frontier_cap=CAP,
                      frontier_kernel=kernel, device="cpu")
    got = eng.ingest_log(log)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.dist, w.dist)
        np.testing.assert_array_equal(g.parent, w.parent)
        assert g.epoch_stats == w.epoch_stats
    assert rungs["sparse"] > 0
    if mode == "sparse":
        assert rungs["dense"] > 0            # the ladder's dense fallback
    for f in ("flat_idx", "flat_w", "fill", "osrc", "odst", "ow"):
        np.testing.assert_array_equal(getattr(eng._out.state, f).numpy(),
                                      np.asarray(getattr(jeng._out.state, f)))
    q = eng.query()
    check_tree(n, *eng.alloc.active_coo(), SOURCE, q.dist, q.parent)


def test_restore_rebuilds_the_sidecar():
    """A JAX checkpoint restored into a sparse engine rebuilds the OUT
    sidecar from the pool mirror: the rest of the stream matches a restored
    dense engine in everything and the uninterrupted JAX engine in dist and
    parent (a restored engine's counters start again at zero)."""
    n, cap, log = _stream()
    cut = len(log) // 2
    want, jeng = _jax_run("sparse", "segment")
    jeng = JaxEngine(JaxConfig(n, cap, SOURCE, batch_deletions=True))
    jeng.ingest_log(log[:cut])
    ckpt = jeng.checkpoint()
    runs = []
    for kw in (dict(frontier_mode="sparse", frontier_cap=CAP,
                    frontier_kernel=True), {}):
        eng = make_engine(num_vertices=n, edge_capacity=cap, source=SOURCE,
                          batch_deletions=True, device="cpu", **kw)
        eng.restore(ckpt)
        runs.append(eng.ingest_log(log[cut:]))
    got, dense = runs
    assert len(got) == len(dense) > 0
    for g, d, w in zip(got, dense, want[len(want) - len(got):]):
        for other in (d, w):
            np.testing.assert_array_equal(g.dist, other.dist)
            np.testing.assert_array_equal(g.parent, other.parent)
        assert g.epoch_stats == d.epoch_stats


def test_frontier_knob_discipline():
    """The reference's rules: frontier knobs need a non-dense mode, the cap
    is non-negative, and an unknown mode names the valid ones."""
    with pytest.raises(ValueError, match="frontier_kernel"):
        make_engine(num_vertices=8, edge_capacity=8, device="cpu",
                    frontier_kernel=True)
    with pytest.raises(ValueError, match="frontier_cap"):
        make_engine(num_vertices=8, edge_capacity=8, device="cpu",
                    frontier_cap=64)
    with pytest.raises(ValueError, match="frontier_cap"):
        make_engine(num_vertices=8, edge_capacity=8, device="cpu",
                    frontier_mode="sparse", frontier_cap=-1)
    with pytest.raises(ValueError, match="valid modes"):
        make_engine(num_vertices=8, edge_capacity=8, device="cpu",
                    frontier_mode="psychic")


def test_frontier_kernel_resolves_by_device():
    """Unset, ``frontier_kernel`` is the kernel iff the device is CUDA: a
    CPU engine runs the plain version and keeps the knob unset; unset or
    False (the reference's default) it is valid under "dense", True is
    not."""
    from repro_torch.core.engine import resolve_kernel
    assert resolve_kernel(None, torch.device("cuda"))
    assert not resolve_kernel(None, torch.device("cpu"))
    for mode in ("sparse", "auto"):
        eng = make_engine(num_vertices=8, edge_capacity=8, device="cpu",
                          frontier_mode=mode)
        assert eng._frontier_kernel is False
        assert eng.cfg.frontier_kernel is None
        eng = make_engine(num_vertices=8, edge_capacity=8, device="cpu",
                          frontier_mode=mode, frontier_kernel=True)
        assert eng._frontier_kernel is True
    make_engine(num_vertices=8, edge_capacity=8, device="cpu")
    make_engine(num_vertices=8, edge_capacity=8, device="cpu",
                frontier_kernel=False)
    with pytest.raises(ValueError, match="frontier_kernel"):
        make_engine(num_vertices=8, edge_capacity=8, device="cpu",
                    frontier_mode="dense", frontier_kernel=True)
