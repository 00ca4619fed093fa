"""The straggler bound (``max_rounds``, DESIGN.md §7) on the port's
single-device epochs, held against the JAX package.

A bounded epoch stops after ``max_rounds`` waves and is re-issued with the
improved frontier (``dist < dist before the issue``) until nothing
improves, as ``tests/test_straggler_and_moe.py`` does.  For each rendering
— segment (``relax.relax_until_converged``), dense ELL (K1's epoch), sliced
(K1 per width run, or K2 fused) and the sparse frontier (K3's ladder) — on
one tree ([N]) and on S = 3 lanes ([S, N], where the lanes converge at
different issues): every issue is bit-identical to the JAX function under
the same bound (``jax.vmap`` of it for lanes) in dist, parent, rounds,
messages and the sparse occupancy; the re-issued sequence ends bit-identical
to the unbounded epoch and passes Dijkstra; ``max_rounds=0`` is the
unbounded call; and a bounded issue reads the host once a wave (the
sparse ladder twice) plus once more only when it ends by converging, so no
bounded wave reads more than an unbounded one.  On CPU tensors the kernel
switches take the wrappers' plain versions.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as jfr
from repro.core import relax as jrelax
from repro.core.backends import ellpack as jell
from repro.core.backends import sliced as jsl
from repro.core.state import EdgePool as JPool
from repro.core.state import SSSPState as JState
from repro.graphs import generators as jgen
from repro_torch.core import frontier, ingest, oracle, relax
from repro_torch.core.backends import ellpack as ell
from repro_torch.core.backends import sliced as sl
from repro_torch.core.state import EdgePool, SSSPState

GRAPHS = {
    "er": lambda: jgen.erdos_renyi(300, 2500, seed=4),
    "hubs": lambda: jgen.power_law_hubs(300, 2500, n_hubs=3, seed=5,
                                        orientation="in"),
}
RENDERINGS = ("segment", "ellpack", "sliced", "sliced_fused", "sparse")
READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
         "__float__", "__index__", "__array__")


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@functools.cache
def _setup(graph):
    """The graph's live edges (through the allocator, as the engines see
    them), every rendering's layout in both packages, and three sources."""
    n, src, dst, w = GRAPHS[graph]()
    alloc = ingest.make_allocator(len(src))
    plan = alloc.plan_adds(src, dst, w)
    src, dst, w = alloc.active_coo()
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    w = w.astype(np.float32)
    act = np.ones(len(src), bool)
    idx, ew, _ = ell.EllPlanner(n, block_rows=256, init_k=1).rebuild_host(
        src, dst, w)
    spl = sl.SlicedEllPlanner(n, slice_rows=16, hub_k=4)
    jspl = jsl.SlicedEllPlanner(n, slice_rows=16, hub_k=4)
    jsliced = jspl.rebuild(src, dst, w)
    out = frontier.OutAdjacency(n, "cpu", hub_k=8)
    out.apply_adds(plan, alloc)
    jout = jfr.OutAdjacency(n, hub_k=8)
    jout.apply_adds(plan, alloc)
    pool = EdgePool(*_t(src, dst, w, act))
    # each vertex's unbounded epoch as a lane: the sources are the deepest,
    # the shallowest and an ordinary vertex, so the lanes of a re-issued
    # sequence converge at different issues
    _, st = relax.relax_until_converged(
        SSSPState.init_batched(n, tuple(range(n)), "cpu"), pool,
        torch.ones(n, dtype=torch.bool), num_vertices=n)
    return SimpleNamespace(
        n=n, src=src, dst=dst, w=w,
        pool=pool, jpool=JPool(*_j(src, dst, w, act)),
        idx=torch.from_numpy(idx), ew=torch.from_numpy(ew),
        jidx=jnp.asarray(idx), jew=jnp.asarray(ew),
        sliced=sl.SlicedEllState.from_host(spl, spl.rebuild_host(src, dst,
                                                                 w), "cpu"),
        jsliced=jsliced,
        geo=dict(widths=tuple(jspl.widths), slice_rows=jspl.sr,
                 num_vertices=n),
        out=out, jout=jout, caps=frontier.capacity_ladder(n, 64),
        sources=(int(np.argmax(st.rounds)), int(np.argmin(st.rounds)), 7))


def _port(su, rend, s, f, **kw):
    """One port epoch: (state, stats, occupancy or None)."""
    if rend == "segment":
        return (*relax.relax_until_converged(s, su.pool, f,
                                             num_vertices=su.n, **kw), None)
    if rend == "ellpack":
        return (*ell.ell_relax_until_converged(s, su.idx, su.ew, f,
                                               use_kernel=True, **kw), None)
    if rend.startswith("sliced"):
        return (*sl.sliced_relax_until_converged(
            s, su.sliced, f, num_vertices=su.n, use_kernel=True,
            use_fused=rend == "sliced_fused", **kw), None)
    return frontier.sparse_relax_until_converged(
        s, su.pool, su.out.state, f, num_vertices=su.n, caps=su.caps,
        use_kernel=True, **kw)


@functools.cache
def _jfn(graph, rend, max_rounds, lanes):
    """The JAX epoch under ``max_rounds`` (K2 fused is held against the
    unfused sliced epoch: the Pallas K2 does not build on jax 0.9)."""
    su = _setup(graph)
    kw = dict(max_rounds=max_rounds)

    def one(js, jf):
        if rend == "segment":
            return (*jrelax.relax_until_converged(
                js, su.jpool, jf, num_vertices=su.n, **kw), 0)
        if rend == "ellpack":
            return (*jell.ell_relax_until_converged(
                js, su.jidx, su.jew, jf, num_vertices=su.n, **kw), 0)
        if rend.startswith("sliced"):
            return (*jsl.sliced_relax_until_converged(
                js, su.jsliced, jf, **su.geo, **kw), 0)
        return jfr.sparse_relax_until_converged(
            js, su.jpool, su.jout.state, jf, num_vertices=su.n,
            caps=su.caps, **kw)

    return jax.jit(jax.vmap(one) if lanes else one)


def _start(su, lanes):
    """The ADD epoch from the source(s): state and shared frontier."""
    sources = su.sources if lanes else su.sources[:1]
    f = np.zeros(su.n, bool)
    f[list(sources)] = True
    s = (SSSPState.init_batched(su.n, sources, "cpu") if lanes
         else SSSPState.init(su.n, sources[0], "cpu"))
    return s, torch.from_numpy(f)


def _same(s, st, occ, js, jst, jocc, rend):
    np.testing.assert_array_equal(s.dist.numpy(), np.asarray(js.dist))
    np.testing.assert_array_equal(s.parent.numpy(), np.asarray(js.parent))
    np.testing.assert_array_equal(np.asarray(st.rounds),
                                  np.asarray(jst.rounds))
    np.testing.assert_array_equal(st.messages.numpy(),
                                  np.asarray(jst.messages))
    if rend == "sparse":
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(jocc))


def _reissue(su, rend, s, f, max_rounds, each=None):
    """Bounded epochs re-issued with ``dist < dist before`` as the
    frontier until nothing improves; ``each(s, f, s', stats, occ)`` sees
    every issue.  Returns the final state and the issue count."""
    issued = 0
    while True:
        s2, st, occ = _port(su, rend, s, f, max_rounds=max_rounds)
        issued += 1
        assert np.max(st.rounds) <= max_rounds
        if each is not None:
            each(s, f, s2, st, occ)
        improved = s2.dist < s.dist
        s = s2
        if not improved.any():
            return s, issued
        f = improved


# every rendering on the ER graph; the hub layouts (sliced, K2, the
# sparse ladder over the sliced OUT sidecar) on the hub graph too
CASES = [(g, r, lanes, k) for g in sorted(GRAPHS) for r in RENDERINGS
         if g == "er" or r.startswith(("sliced", "sparse"))
         for lanes, k in ((False, 1), (False, 3), (True, 2))]


@pytest.mark.parametrize("graph,rend,lanes,max_rounds", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_bounded_epochs_match_reference_and_reach_fixpoint(graph, rend,
                                                           lanes,
                                                           max_rounds):
    su = _setup(graph)
    s0, f0 = _start(su, lanes)
    jfn = _jfn(graph, rend, max_rounds, lanes)
    first = [True]

    def each(s, f, s2, st, occ):
        # the JAX epoch from the same state and frontier, under the bound
        js = JState(dist=jnp.asarray(s.dist.numpy()),
                    parent=jnp.asarray(s.parent.numpy()),
                    source=jnp.asarray(s.source.numpy()))
        jf = jnp.asarray(f.expand(s.dist.shape).numpy())
        js2, jst, jocc = jfn(js, jf)
        _same(s2, st, occ, js2, jst, jocc, rend)
        if lanes and not first[0]:
            assert f.dim() == 2
        first[0] = False

    s, issued = _reissue(su, rend, s0, f0, max_rounds, each)
    assert issued > 1, "the bound never bit"

    want, wst, wocc = _port(su, rend, s0, f0)
    zero, zst, zocc = _port(su, rend, s0, f0, max_rounds=0)
    for a, b in ((want, zero), (want, s)):
        np.testing.assert_array_equal(a.dist.numpy(), b.dist.numpy())
        np.testing.assert_array_equal(a.parent.numpy(), b.parent.numpy())
    np.testing.assert_array_equal(np.asarray(wst.rounds),
                                  np.asarray(zst.rounds))
    np.testing.assert_array_equal(wst.messages.numpy(),
                                  zst.messages.numpy())
    np.testing.assert_array_equal(np.asarray(wocc), np.asarray(zocc))
    assert np.max(wst.rounds) > max_rounds
    dist, parent = s.dist.numpy(), s.parent.numpy()
    srcs = s.source.numpy().reshape(-1)
    for lane, source in enumerate(srcs):
        oracle.check_tree(su.n, su.src, su.dst, su.w, int(source),
                          dist.reshape(len(srcs), -1)[lane],
                          parent.reshape(len(srcs), -1)[lane])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_lanes_converge_at_different_issues(graph):
    """The sources' depths differ, so under a bound of 2 some issue leaves
    a converged lane unchanged while another lane still improves."""
    su = _setup(graph)
    s, f = _start(su, True)
    changed = []
    _reissue(su, "ellpack", s, f, 2, lambda s, f, s2, st, occ:
             changed.append((s2.dist != s.dist).any(-1).numpy()))
    changed = np.stack(changed)
    assert (changed.any(1) & ~changed.all(1)).any()


@pytest.mark.parametrize("lanes", [False, True], ids=["single", "lanes"])
@pytest.mark.parametrize("rend", ["segment", "ellpack", "sliced", "sparse"])
def test_bounded_issue_reads_the_host_no_more_per_wave(monkeypatch, rend,
                                                       lanes):
    """Host reads of each bounded issue: one flag read a wave (a vector of
    all lanes' flags for [S, N]), the sparse ladder's one count read a
    wave, and the closing flag read only when the issue converged rather
    than hit the bound — the unbounded epoch's reads, wave for wave."""
    su = _setup("er")
    s, f = _start(su, lanes)
    counts = {"host": 0, "other": 0}
    inside = [False]
    for meth in READS:
        real = getattr(torch.Tensor, meth)

        def counted(self, *a, _real=real, **k):
            if not inside[0]:
                counts["other"] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, meth, counted)
    real_host = relax.host

    def host(flags):
        counts["host"] += 1
        assert flags.dim() == (1 if lanes else 0)
        inside[0] = True
        try:
            return real_host(flags)
        finally:
            inside[0] = False

    monkeypatch.setattr(relax, "host", host)

    def reads(fn):
        counts.update(host=0, other=0)
        out = fn()
        return out, counts["host"], counts["other"]

    per_wave = 2 if rend == "sparse" else 1
    (_, ust, _), uhost, uother = reads(lambda: _port(su, rend, s, f))
    uwaves = int(np.max(ust.rounds))
    assert (uhost, uother) == (uwaves + 1, (per_wave - 1) * uwaves)
    for max_rounds in (1, 2):
        issue = [s, f]
        while True:
            (s2, st, _), h, o = reads(
                lambda: _port(su, rend, *issue, max_rounds=max_rounds))
            waves = int(np.max(st.rounds))
            cut = waves == max_rounds
            assert h == waves + (not cut)
            assert o == (per_wave - 1) * waves
            improved = s2.dist < issue[0].dist
            if not improved.any():
                break
            issue = [s2, improved]
