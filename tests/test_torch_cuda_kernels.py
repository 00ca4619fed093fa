"""The port's CUDA kernels on the card: kernels K1 (``ellpack_relax``), K2
(``fused_sliced_relax``), K3 (``gathered_rows_relax``), K4 (``spmm_ell``)
and K5 (``embedding_bag``) against their plain torch versions, and engines
on the kernels against the same engines on the plain versions (dense ELL
on K1; sliced on K2 and on K1 per run of slices; the sparse frontier on
K3).  Every test here needs a CUDA device and skips without one (decided
inside the test).  Tolerance: 0 — bit-identical — except the gradients of
``neighbor_reduce`` and ``bag_lookup``, whose backward scatters with
``index_add_``: on the card its atomics add in no fixed order, so the
kernel route's gradient is held against the plain route's within rtol =
atol = 1e-5 in f32 and one bf16 rounding (rtol 2^-7) in bf16.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only the port's requirements:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch import make_engine
from repro_torch.core import events as ev
from repro_torch.graphs import generators, window
from repro_torch.graphs import csr
from repro_torch.kernels.embed_bag.embed_bag import embedding_bag
from repro_torch.kernels.embed_bag.ops import bag_lookup
from repro_torch.kernels.embed_bag.ref import embedding_bag_ref
from repro_torch.kernels.relax.fused import fused_sliced_relax
from repro_torch.kernels.relax.gather import gathered_rows_relax
from repro_torch.kernels.relax.ref import (ellpack_relax_ref,
                                           fused_sliced_relax_ref,
                                           gathered_rows_relax_ref)
from repro_torch.kernels.relax.relax import ellpack_relax
from repro_torch.kernels.spmm.ops import neighbor_reduce
from repro_torch.kernels.spmm.ref import spmm_ell_ref
from repro_torch.kernels.spmm.spmm import spmm_ell

# (n offers, rows, K): K = 1, non-power-of-two K, K = 32, K > 32
SHAPES = [(50, 8, 1), (300, 256, 5), (64, 256, 32), (1000, 512, 40),
          (70000, 65536, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, n, rows, k, ties, device):
    rng = np.random.default_rng(seed)
    if ties:
        offers = rng.integers(0, 4, n).astype(np.float32)
        w = rng.integers(1, 4, (rows, k)).astype(np.float32)
    else:
        offers = (4 * rng.random(n)).astype(np.float32)
        w = (0.5 + 1.5 * rng.random((rows, k))).astype(np.float32)
    offers[rng.random(n) < 0.3] = np.inf
    idx = rng.integers(0, n, (rows, k)).astype(np.int32)
    w[rng.random((rows, k)) < 0.2] = np.inf
    w[0] = np.inf                                  # an all-tombstone row
    return [torch.from_numpy(a).to(device) for a in (offers, idx, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,rows,k", SHAPES)
def test_k1_matches_plain_version(cuda, n, rows, k, ties):
    offers, idx, w = _case(n + k, n, rows, k, ties, cuda)
    before = ellpack_relax.launches
    best, arg = ellpack_relax(offers, idx, w)
    torch.cuda.synchronize()
    assert ellpack_relax.launches == before + 1
    rb, ra = ellpack_relax_ref(offers, idx, w)
    assert torch.equal(best, rb) and torch.equal(arg, ra)


@pytest.mark.cuda
def test_k1_refuses_wrong_dtype_on_the_card(cuda):
    offers, idx, w = _case(1, 50, 8, 3, False, cuda)
    with pytest.raises(ValueError, match="expected"):
        ellpack_relax(offers.double(), idx, w)


# (widths, slice_rows, n, overflow capacity, tie weights, active fraction)
K2_SHAPES = [((2, 2, 2), 8, 20, 8, False, 1.0),
             ((2,) * 40, 8, 300, 16, False, 0.5),
             ((1, 1, 4, 4, 4, 2, 8), 16, 100, 8, False, 1.0),
             ((2, 2, 4, 4), 16, 60, 32, True, 0.7),
             ((4, 32, 16, 2, 1, 8), 256, 1500, 4096, True, 0.6),
             ((2, 4), 8, 14, 0, False, 1.0)]


def _k2_case(seed, widths, slice_rows, n, ocap, ties, active_frac, device):
    rng = np.random.default_rng(seed)
    L = slice_rows * sum(widths)
    wpool = np.asarray([0.5, 1.0] if ties else rng.uniform(0.1, 2.0, 8),
                       np.float32)
    flat_idx = rng.integers(0, n, L).astype(np.int32)
    flat_w = np.where(rng.random(L) < 0.6, rng.choice(wpool, L),
                      np.inf).astype(np.float32)
    osrc = rng.integers(0, n, ocap).astype(np.int32)
    odst = rng.integers(0, n, ocap).astype(np.int32)
    ow = np.where(rng.random(ocap) < 0.7, rng.choice(wpool, ocap),
                  np.inf).astype(np.float32)
    dist = np.where(rng.random(n) < 0.8, rng.uniform(0.0, 4.0, n),
                    np.inf).astype(np.float32)
    if ties:
        dist = np.floor(dist)
    active = rng.random(n) < active_frac
    _, rowk, base, _ = csr.sliced_geometry(list(widths), slice_rows)
    t = [torch.from_numpy(a).to(device) for a in
         (dist, active, flat_idx, flat_w, osrc, odst, ow,
          base.astype(np.int32), rowk)]
    return t[:7], dict(widths=widths, slice_rows=slice_rows, base=t[7],
                       rowk=t[8])


@pytest.mark.cuda
@pytest.mark.parametrize("widths,slice_rows,n,ocap,ties,active_frac",
                         K2_SHAPES)
def test_k2_matches_plain_version(cuda, widths, slice_rows, n, ocap, ties,
                                  active_frac):
    args, kw = _k2_case(n + ocap, widths, slice_rows, n, ocap, ties,
                        active_frac, cuda)
    before = fused_sliced_relax.launches
    best, arg = fused_sliced_relax(*args, **kw)
    torch.cuda.synchronize()
    assert fused_sliced_relax.launches == before + 1
    rb, ra = fused_sliced_relax_ref(*args, widths=widths,
                                    slice_rows=slice_rows)
    assert torch.equal(best, rb) and torch.equal(arg, ra)


def _k3_case(seed, e, n, ties, mask_frac, device):
    rng = np.random.default_rng(seed)
    if ties:
        wd = rng.integers(0, 3, e).astype(np.float32)
        w = rng.integers(1, 3, e).astype(np.float32)
    else:
        wd = rng.uniform(0, 3, e).astype(np.float32)
        w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    wd[rng.random(e) < 0.1] = np.inf
    w[rng.random(e) < 0.1] = np.inf
    src = rng.integers(0, n, e).astype(np.int32)
    nbr = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < mask_frac
    return [torch.from_numpy(a).to(device) for a in (wd, src, nbr, w, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,ties,mask_frac", [
    (85, 40, False, 0.7), (300, 17, True, 1.0), (64, 64, False, 0.0),
    (0, 12, False, 0.7), (1 << 20, 1 << 16, True, 0.8)])
def test_k3_matches_plain_version(cuda, e, n, ties, mask_frac):
    args = _k3_case(e + n, e, n, ties, mask_frac, cuda)
    before = gathered_rows_relax.launches
    best, arg = gathered_rows_relax(*args, num_rows=n)
    torch.cuda.synchronize()
    assert gathered_rows_relax.launches == before + 1
    rb, ra = gathered_rows_relax_ref(*args, num_rows=n)
    assert torch.equal(best, rb) and torch.equal(arg, ra)


@pytest.mark.cuda
def test_k2_k3_refuse_wrong_dtype_on_the_card(cuda):
    args, kw = _k2_case(1, (2, 2), 8, 16, 8, False, 1.0, cuda)
    args[1] = args[1].to(torch.uint8)
    with pytest.raises(ValueError, match="active"):
        fused_sliced_relax(*args, **kw)
    args = _k3_case(1, 16, 8, False, 1.0, cuda)
    args[1] = args[1].long()
    with pytest.raises(ValueError, match="src_ids"):
        gathered_rows_relax(*args, num_rows=8)


def _same_bits(got, want):
    """The same NaN positions and equal bits everywhere else."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    ints = torch.int32 if got.dtype == torch.float32 else torch.int16
    assert torch.equal(got[~nan].view(ints), want[~nan].view(ints))


# (s, r, k, f, integer features): K = 1, K past a warp, F not a multiple
# of 4, F = 1, F over one 128-feature chunk; ties with integer features
K4_SHAPES = [(40, 64, 1, 32, False), (300, 96, 40, 18, False),
             (16, 128, 12, 24, True), (10, 8, 5, 1, True),
             (1000, 512, 15, 602, False)]


def _k4_case(seed, s, r, k, f, ties, dtype, device):
    """All-masked first rows, -1 in masked cells, a duplicate index in
    each row's second cell."""
    rng = np.random.default_rng(seed)
    feats = (rng.integers(-3, 4, (s, f)) if ties
             else rng.standard_normal((s, f))).astype(np.float32)
    idx = rng.integers(0, s, (r, k)).astype(np.int32)
    if k > 1:
        idx[:, 1] = idx[:, 0]
    mask = rng.random((r, k)) < 0.7
    mask[:3] = False
    idx[~mask] = -1
    return (torch.from_numpy(feats).to(device, dtype),
            torch.from_numpy(idx).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
@pytest.mark.parametrize("s,r,k,f,ties", K4_SHAPES)
def test_k4_matches_plain_version(cuda, s, r, k, f, ties, agg, dtype):
    args = _k4_case(s + k + f, s, r, k, f, ties, dtype, cuda)
    before = spmm_ell.launches
    out = spmm_ell(*args, agg=agg)
    torch.cuda.synchronize()
    assert spmm_ell.launches == before + 1
    _same_bits(out, spmm_ell_ref(*args, agg))


@pytest.mark.cuda
def test_k4_max_propagates_nan(cuda):
    feats, idx, mask = _k4_case(3, 50, 64, 9, 40, False, torch.float32, cuda)
    feats[idx[mask][:5].long(), 7] = float("nan")
    out = spmm_ell(feats, idx, mask, agg="max")
    assert bool(out.isnan().any())
    _same_bits(out, spmm_ell_ref(feats, idx, mask, "max"))


# (v, b, l, d): DIN's D = 18, L = 1, L past a warp, D over one chunk
K5_SHAPES = [(500, 64, 100, 18), (40, 24, 1, 32), (300, 8, 45, 130),
             (30, 10, 7, 1)]


def _k5_case(seed, v, b, l, d, dtype, device):
    """A quarter of the slots padding, the first bags all padding, the
    second bag one row repeated."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    idx[rng.random((b, l)) < 0.25] = -1
    idx[:2] = -1
    idx[2] = 5
    return torch.from_numpy(table).to(device, dtype), torch.from_numpy(
        idx).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("agg", ["sum", "mean"])
@pytest.mark.parametrize("v,b,l,d", K5_SHAPES)
def test_k5_matches_plain_version(cuda, v, b, l, d, agg, dtype):
    table, idx = _k5_case(v + l + d, v, b, l, d, dtype, cuda)
    before = embedding_bag.launches
    out = embedding_bag(table, idx, agg=agg)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    _same_bits(out, embedding_bag_ref(table, idx, agg=agg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_clamp_a_live_index_past_the_end(cuda, dtype):
    """A live index >= S (K4) or >= V (K5) reads the last row, as the plain
    versions clamp it; a negative live cell of K4 reads row 0."""
    feats, idx, mask = _k4_case(4, 50, 64, 9, 40, False, dtype, cuda)
    mask[5:, :3] = True
    idx[5:, 0], idx[5:, 1], idx[5:, 2] = 50, 1 << 30, -7
    for agg in ("sum", "mean", "max"):
        _same_bits(spmm_ell(feats, idx, mask, agg=agg),
                   spmm_ell_ref(feats, idx, mask, agg))
    table, bags = _k5_case(5, 30, 8, 45, 18, dtype, cuda)
    bags[3:, 0], bags[3:, 7] = 30, (1 << 31) - 1
    for agg in ("sum", "mean"):
        _same_bits(embedding_bag(table, bags, agg=agg),
                   embedding_bag_ref(table, bags, agg=agg))


def _grads(entry, leaf, rest, agg, w):
    """d(leaf) through ``entry`` on the kernel (None) and the plain
    (False) route, with the forward outputs, which must be equal."""
    outs = []
    for use_kernel in (None, False):
        x = leaf.detach().requires_grad_(True)
        out = entry(x, *rest, agg, use_kernel)
        (g,) = torch.autograd.grad(out, x, w.to(out.dtype))
        outs.append((out.detach(), g))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_gradients_match_plain_route(cuda, dtype):
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(
        rtol=2**-7, atol=1e-5)
    before = (spmm_ell.launches, embedding_bag.launches)
    for agg in ("sum", "mean", "max"):
        feats, idx, mask = _k4_case(7, 300, 512, 15, 64, agg == "max",
                                    dtype, cuda)
        w = torch.randn(512, 64, device=cuda)
        (ko, kg), (po, pg) = _grads(neighbor_reduce, feats, (idx, mask),
                                    agg, w)
        _same_bits(ko, po)
        torch.testing.assert_close(kg, pg, **tol)
    for agg in ("sum", "mean"):
        table, idx = _k5_case(8, 700, 256, 100, 18, dtype, cuda)
        w = torch.randn(256, 18, device=cuda)
        (ko, kg), (po, pg) = _grads(bag_lookup, table, (idx,), agg, w)
        _same_bits(ko, po)
        torch.testing.assert_close(kg, pg, **tol)
    assert (spmm_ell.launches, embedding_bag.launches) == (before[0] + 3,
                                                           before[1] + 2)


@pytest.mark.cuda
def test_k4_k5_refuse_device_mix_and_wrong_dtype(cuda):
    feats, idx, mask = _k4_case(1, 20, 16, 4, 8, False, torch.float32, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        spmm_ell(feats, idx.cpu(), mask)
    with pytest.raises(ValueError, match="expected"):
        spmm_ell(feats.double(), idx, mask)
    with pytest.raises(ValueError, match="expected"):
        spmm_ell(feats, idx.long(), mask)
    table, bags = _k5_case(2, 30, 8, 5, 18, torch.float32, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        embedding_bag(table.cpu(), bags)
    with pytest.raises(ValueError, match="expected"):
        embedding_bag(table.half(), bags)


def _er_stream():
    n, src, dst, w = generators.erdos_renyi(1 << 10, 8 << 10, seed=7)
    win = int(0.3 * len(src))
    log = ev.interleave_queries(window.sliding_window_stream(
        src, dst, w, window=win, delta=0.3, seed=0), win // 10)
    return n, len(src) + 64, log


def _rmat_stream():
    n, src, dst, w = generators.rmat(11, 8, seed=7)
    win = int(0.3 * len(src))
    log = ev.interleave_queries(window.sliding_window_stream(
        src, dst, w, window=win, delta=0.3, seed=0), win // 10)
    return n, len(src) + 64, log


def _same_runs(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        assert a.epoch_stats == b.epoch_stats


def _run(stream, kernel, **knobs):
    n, cap, log = stream
    before = kernel.launches
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      batch_deletions=True, **knobs)
    return eng.ingest_log(log), kernel.launches - before


@pytest.mark.cuda
def test_engine_on_k1_matches_engine_on_plain_version(cuda):
    stream = _er_stream()
    got, launched = _run(stream, ellpack_relax, relax_backend="ellpack",
                         ell_use_kernel=True)
    want, plain = _run(stream, ellpack_relax, relax_backend="ellpack",
                       ell_use_kernel=False)
    assert launched > 0 and plain == 0
    _same_runs(got, want)


@pytest.mark.cuda
def test_sliced_engines_on_k2_and_k1_match_plain_version(cuda):
    """RMAT hubs, small slices and hub threshold: the fused wave on K2, the
    unfused wave on K1 per run of slices, and the plain wave agree."""
    stream = _rmat_stream()
    kw = dict(relax_backend="sliced", sliced_slice_rows=32, sliced_hub_k=8)
    want, _ = _run(stream, ellpack_relax, ell_use_kernel=False, **kw)
    fused, k2 = _run(stream, fused_sliced_relax, sliced_fused=True, **kw)
    unfused, k1 = _run(stream, ellpack_relax, ell_use_kernel=True, **kw)
    assert k2 > 0 and k1 > 0
    _same_runs(fused, want)
    _same_runs(unfused, want)


@pytest.mark.cuda
def test_sparse_engine_on_k3_matches_plain_version(cuda):
    stream = _rmat_stream()
    kw = dict(frontier_mode="sparse", frontier_cap=64)
    got, launched = _run(stream, gathered_rows_relax, frontier_kernel=True,
                         **kw)
    want, plain = _run(stream, gathered_rows_relax, **kw)
    assert launched > 0 and plain == 0
    _same_runs(got, want)
