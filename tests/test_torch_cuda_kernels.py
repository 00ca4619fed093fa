"""The port's CUDA kernels on the card: kernels K1 (``ellpack_relax``), K2
(``fused_sliced_relax``) and K3 (``gathered_rows_relax``) against their
plain torch versions, and engines on the kernels against the same engines
on the plain versions (dense ELL on K1; sliced on K2 and on K1 per run of
slices; the sparse frontier on K3).  Every test here needs a CUDA device
and skips without one (decided inside the test).  Tolerance: 0 —
bit-identical.

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
from repro_torch.kernels.relax.fused import fused_sliced_relax
from repro_torch.kernels.relax.gather import gathered_rows_relax
from repro_torch.kernels.relax.ref import (ellpack_relax_ref,
                                           fused_sliced_relax_ref,
                                           gathered_rows_relax_ref)
from repro_torch.kernels.relax.relax import ellpack_relax

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
