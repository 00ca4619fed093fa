"""The lane-minor offers of K1's and K2's lane forms, on the CPU.

S trees over one shared layout gather the same vertex ids, so the lane
forms read their offers interleaved lane-minor — ``(groups, N, W)``, W =
``lane_group(S)`` lanes a group, +inf past the last lane — and one load a
cell serves a group.  Here: the group rule and the copy's shape, padding,
mask and round trip (``relax.lane_minor``, which takes the plain
``lane_minor_ref`` for CPU tensors); K1's plain version and wrapper and
``sliced_gather_min`` fed a copy through ``offers_minor=`` equal to what
they give without one (and to the JAX reference's plain version under
``jax.vmap``); a copy of another shape raises; ``LaneMinorOnce`` makes
one copy per offers tensor; the lane forms' byte models are unchanged;
and lane engines whose waves take the copy (``ell_use_kernel=True`` on
the CPU routes the K1 wrapper to its plain version) stay bit-identical to
the JAX batched engines at S = 4 — the dense ELL and ``auto`` backends on
one device, and the sharded engine, whose mesh wave makes one copy.

Inputs are made from seeds with numpy.  Tolerance: 0.  The CUDA
interleave and the kernels on a caller-made copy are held against these
on the card by test_torch_cuda_kernels.py.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.engine import EngineConfig as JaxConfig
from repro.core.engine import SSSPDelEngine as JaxEngine
from repro.graphs import generators, window
from repro.kernels.relax.ref import ellpack_relax_ref as jax_ellpack_ref
from repro_torch import EngineConfig, SSSPDelEngine
from repro_torch.core.backends import sliced as sliced_backend
from repro_torch.kernels.relax import fused, ref, relax

INF = np.float32(np.inf)
LANES = [1, 2, 3, 4, 5, 8, 9, 16]


def _offers(rng, s, n):
    v = rng.integers(0, 4, (s, n)).astype(np.float32)   # ties
    v[rng.random((s, n)) < 0.3] = INF
    if s > 1:
        v[1] = INF                                       # an all-+inf lane
    return torch.from_numpy(v)


def _block(rng, n, rows, k):
    w = rng.integers(1, 4, (rows, k)).astype(np.float32)
    w[rng.random((rows, k)) < 0.3] = INF
    w[0] = INF                                           # an all-+inf row
    return (torch.from_numpy(rng.integers(0, n, (rows, k)).astype(np.int32)),
            torch.from_numpy(w))


@pytest.mark.parametrize("s", range(1, 18))
def test_lane_group_rule(s):
    """W = the smallest power of two >= S, at most 8; groups = ceil(S / W)
    (the kernels' lanes::group / lanes::groups)."""
    w = ref.lane_group(s)
    assert w in (1, 2, 4, 8) and w == min(8, 1 << (s - 1).bit_length())
    assert w >= min(s, 8) and (w == 1 or w // 2 < s)
    assert ref.lane_minor_shape(s, 13) == (-(-s // w), 13, w)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", LANES)
def test_lane_minor_layout_and_round_trip(s, masked):
    """out[g, v, j] = offers[g·W + j, v] (+inf where the mask is False),
    +inf past the last lane; reading it back tree-major gives the
    (masked) offers."""
    rng = np.random.default_rng(s)
    offers = _offers(rng, s, 37)
    active = torch.from_numpy(rng.random((s, 37)) < 0.6) if masked else None
    out = relax.lane_minor(offers, active)
    g, n, w = ref.lane_minor_shape(s, 37)
    assert out.shape == (g, n, w) and out.dtype == torch.float32
    assert out.is_contiguous()
    want = offers if active is None else torch.where(active, offers, INF)
    for t in range(g * w):
        lane = out[t // w, :, t % w]
        if t < s:
            assert torch.equal(lane, want[t])
        else:
            assert bool(torch.isinf(lane).all())
    back = out.transpose(1, 2).reshape(g * w, n)
    assert torch.equal(back[:s], want)


@pytest.mark.parametrize("s", [1, 3, 4, 5, 9, 16])
@pytest.mark.parametrize("n,rows,k", [(50, 8, 1), (300, 256, 5),
                                      (500, 130, 32), (90, 40, 64)])
def test_k1_plain_version_on_a_lane_minor_copy(n, rows, k, s):
    """``ellpack_relax_ref`` and the wrapper (CPU: the plain version, no
    launch) read the offers from ``offers_minor``: equal to the call
    without it, to S single-lane calls and to the JAX reference's plain
    version vmapped over the lanes."""
    rng = np.random.default_rng(n + k + s)
    offers = _offers(rng, s, n)
    idx, w = _block(rng, n, rows, k)
    minor = relax.lane_minor(offers)
    want = ref.ellpack_relax_ref(offers, idx, w)
    before = (relax.ellpack_relax.launches, relax.lane_minor.launches)
    for got in (ref.ellpack_relax_ref(offers, idx, w, offers_minor=minor),
                relax.ellpack_relax(offers, idx, w, offers_minor=minor)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (relax.ellpack_relax.launches, relax.lane_minor.launches) == before
    for t in range(s):
        b1, a1 = ref.ellpack_relax_ref(offers[t], idx, w)
        assert torch.equal(want[0][t], b1) and torch.equal(want[1][t], a1)
    jb, ja = jax.vmap(jax_ellpack_ref, in_axes=(0, None, None))(
        jnp.asarray(offers.numpy()), jnp.asarray(idx.numpy()),
        jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(want[0].numpy(), np.asarray(jb))
    np.testing.assert_array_equal(want[1].numpy(), np.asarray(ja))
    if s > 1:
        assert bool(torch.isinf(want[0][1]).all())
        assert bool((want[1][1] == -1).all())


@pytest.mark.parametrize("s", [1, 4, 5, 16])
def test_sliced_gather_min_on_one_copy_for_every_run(s):
    """The unfused sliced wave's ELL lane: one lane-minor copy handed to
    every width run's K1 call gives what the runs give on the offers."""
    rng = np.random.default_rng(s)
    widths, slice_rows, n = (1, 1, 4, 4, 4, 2, 8, 64), 16, 100
    L = slice_rows * sum(widths)
    flat_w = np.where(rng.random(L) < 0.6, rng.integers(1, 3, L),
                      INF).astype(np.float32)
    flat_idx = torch.from_numpy(rng.integers(0, n, L).astype(np.int32))
    offers = _offers(rng, s, n)
    kw = dict(widths=widths, slice_rows=slice_rows)
    calls = []

    def counted(*a, **k):
        calls.append(k.get("offers_minor"))
        return relax.ellpack_relax(*a, **k)

    minor = relax.lane_minor(offers)
    got = ref.sliced_gather_min(offers, flat_idx, torch.from_numpy(flat_w),
                                relax=counted, offers_minor=minor, **kw)
    want = ref.sliced_gather_min(offers, flat_idx, torch.from_numpy(flat_w),
                                 **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(calls) == 5 and all(c is minor for c in calls)


def test_a_copy_of_another_shape_raises():
    rng = np.random.default_rng(0)
    offers = _offers(rng, 5, 40)
    idx, w = _block(rng, 40, 16, 4)
    g, n, lw = ref.lane_minor_shape(5, 40)
    for bad in (torch.zeros(g, n + 1, lw), torch.zeros(g, n, 4),
                torch.zeros(g + 1, n, lw)):
        with pytest.raises(ValueError, match="offers_minor"):
            ref.ellpack_relax_ref(offers, idx, w, offers_minor=bad)
    with pytest.raises(ValueError, match="offers_minor"):
        ref.ellpack_relax_ref(offers[0], idx, w,
                              offers_minor=relax.lane_minor(offers[:1]))


def test_lane_minor_once_makes_one_copy_per_offers_tensor():
    """The sharded wave's memo: the same tensor gives the same copy, a
    tensor written in place or another tensor a new one; (N,) offers
    none."""
    once = relax.LaneMinorOnce()
    offers = torch.rand(3, 20)
    first = once(offers)
    assert once(offers) is first
    assert torch.equal(first, relax.lane_minor(offers))
    offers[1, 4] = 7.0
    again = once(offers)
    assert again is not first and float(again[0, 4, 1]) == 7.0
    other = offers.clone()
    assert once(other) is not again and torch.equal(once(other), again)
    assert once(offers[0]) is None


@pytest.mark.parametrize("widths,wide", [((1, 2, 32), False),
                                         ((4, 64, 2), True),
                                         ((128,), True), ((), False)])
def test_chunk_table_flags_rows_wider_than_a_warp(widths, wide):
    """K2's lane form launches its wide-row pass only for a layout whose
    table says it has a slice wider than 32 cells."""
    t = fused.ChunkTable.build(widths, 8, "cpu")
    assert t.wide is wide
    log2k = t.blocks.view(-1, 4)[:, 2]
    assert bool((log2k > 5).any()) is wide


@pytest.mark.parametrize("s", [1, 3, 4, 5, 8, 9, 16])
def test_lane_byte_models_unchanged(s):
    """``wave_bytes(lanes=S)`` stays the function's floor — the layout
    once, the per-lane vectors S times — whatever the kernels' lane-minor
    copy and padding cost."""
    n, rows, k, live = 1000, 512, 32, 4000
    assert relax.wave_bytes(n, rows, k, live, lanes=s) == \
        s * (4 * n + 8 * rows) + 4 * rows * k + 4 * live
    L, live_l, c, live_c = 9000, 2000, 512, 100
    assert fused.wave_bytes(n, L, live_l, c, live_c, rows, lanes=s) == \
        s * (5 * n + 8 * rows) + 4 * L + 4 * live_l + 4 * c + 8 * live_c


# ------------------------------------------- engines on the copy's path --
SOURCES = (3, 17, 40, 61)
BACKENDS = {
    "ellpack": ("ellpack", dict(ell_init_k=2)),
    "auto": ("auto", dict(ell_init_k=1, sliced_slice_rows=32,
                          sliced_hub_k=4, sliced_init_k=4)),
}
PORT_ONLY = {"ellpack": {}, "auto": dict(sliced_fused=False)}


@functools.cache
def _stream(seed=11, n=72, m=320):
    n, src, dst, w = generators.erdos_renyi(n, m, seed=seed)
    log = window.sliding_window_stream(src, dst, w, window=m // 3, delta=0.5,
                                       seed=seed, query_every=m // 2)
    return n, len(src) + 64, log


def _ingest(eng, log):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # ELL blowup
        return eng.ingest_log(log) + [eng.query()]


def _same(got, want):
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        for k in ("rounds", "messages"):
            np.testing.assert_array_equal(np.asarray(a.epoch_stats[k]),
                                          np.asarray(b.epoch_stats[k]))


def _spy(monkeypatch, module):
    """Count the lane-minor copies ``module`` makes for its waves."""
    made = []
    real = module.lane_minor

    def counted(offers, *a):
        made.append(offers.shape)
        return real(offers, *a)

    monkeypatch.setattr(module, "lane_minor", counted)
    return made


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_lane_engines_on_the_copy_match_jax(monkeypatch, backend):
    """S = 4 lanes with ``ell_use_kernel=True`` (and K2 off): the dense ELL
    waves and the unfused sliced waves that ``auto`` switches to, which
    make one lane-minor copy a wave for every width run, equal the JAX
    batched engine at every query (dist, parent, per-lane counters)."""
    name, knobs = BACKENDS[backend]
    n, cap, log = _stream()
    made = _spy(monkeypatch, sliced_backend)
    eng = SSSPDelEngine(EngineConfig(
        n, cap, SOURCES[0], relax_backend=name, sources=SOURCES,
        ell_use_kernel=True, device="cpu", **knobs, **PORT_ONLY[backend]))
    got = _ingest(eng, log)
    jeng = JaxEngine(JaxConfig(n, cap, SOURCES[0], relax_backend=name,
                               sources=SOURCES, **knobs))
    _same(got, _ingest(jeng, log))
    if backend == "auto":      # the sliced waves took the copy
        assert made and all(m == (len(SOURCES), n) for m in made)


@pytest.mark.parametrize("backend", ["ellpack", "sliced"])
def test_sharded_lane_engine_makes_one_copy_per_mesh_wave(monkeypatch,
                                                          backend):
    """The sharded lane engine at P = 4 on the CPU with the K1 switch on:
    every partition's wave takes the one lane-minor copy of the gathered
    offers (one copy a mesh wave, not one a partition or width run), and
    the lanes equal the single-device lane engine's, counters included."""
    from repro_torch.core.dist_engine import (ShardedEngineConfig,
                                              ShardedSSSPDelEngine)
    from repro_torch.launch.mesh import make_mesh
    n, cap, log = _stream()
    knobs = (dict(ell_init_k=2) if backend == "ellpack" else
             dict(sliced_slice_rows=32, sliced_hub_k=4, sliced_init_k=1))
    made = _spy(monkeypatch, relax)
    mesh = make_mesh((4,), ("graph",), devices=[torch.device("cpu")] * 4)
    eng = ShardedSSSPDelEngine(ShardedEngineConfig(
        n, -(-cap // 4), SOURCES[0], sources=SOURCES, relax_backend=backend,
        ell_use_kernel=True, device="cpu", **knobs), mesh=mesh)
    waves = []
    real = eng.ds._apply_wave

    def counted(*a, **k):
        waves.append(1)
        return real(*a, **k)

    eng.ds._apply_wave = counted
    got = _ingest(eng, log)
    assert waves and len(made) == len(waves)
    single = SSSPDelEngine(EngineConfig(n, cap, SOURCES[0], sources=SOURCES,
                                        relax_backend=backend, device="cpu",
                                        **knobs))
    _same(got, _ingest(single, log))
