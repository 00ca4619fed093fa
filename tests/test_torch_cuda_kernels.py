"""The port's CUDA kernels on the card: kernel K1 (``ellpack_relax``)
against its plain torch version, and the dense-ELL engine with K1 against
the same engine on the plain version.  Every test here needs a CUDA device
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
from repro_torch.kernels.relax.ref import ellpack_relax_ref
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


@pytest.mark.cuda
def test_engine_on_k1_matches_engine_on_plain_version(cuda):
    n, src, dst, w = generators.erdos_renyi(1 << 10, 8 << 10, seed=7)
    win = int(0.3 * len(src))
    log = ev.interleave_queries(window.sliding_window_stream(
        src, dst, w, window=win, delta=0.3, seed=0), win // 10)
    runs = []
    for use_kernel in (True, False):
        before = ellpack_relax.launches
        eng = make_engine(num_vertices=n, edge_capacity=len(src) + 64,
                          source=3, relax_backend="ellpack",
                          batch_deletions=True, ell_use_kernel=use_kernel)
        runs.append((eng.ingest_log(log), ellpack_relax.launches - before))
    (got, launched), (want, plain_launched) = runs
    assert launched > 0 and plain_launched == 0
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        assert a.epoch_stats == b.epoch_stats
