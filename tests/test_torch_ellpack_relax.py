"""Kernel K1 (ELLPACK min-plus relaxation): the port's ``ellpack_relax_ref``
and ``ellpack_relax`` wrapper against the JAX package's Pallas kernel (run in
interpret mode, as the JAX package's own CPU tests run it) and its jnp
oracle; ``relax_wave`` against the JAX ``relax_wave`` with frontier masks.

Inputs are made from seeds with numpy and fed to both packages.  Tolerance:
0 everywhere — f32 add and compare are exact IEEE operations in both, so
``best`` and ``arg`` must be bit-identical.  The CUDA kernel itself is
held against the plain version on the card by test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.relax.ops import relax_wave as jax_relax_wave
from repro.kernels.relax.ref import ellpack_relax_ref as jax_ref
from repro.kernels.relax.relax import ellpack_relax as jax_kernel
from repro_torch.kernels.relax.ops import relax_wave
from repro_torch.kernels.relax.ref import ellpack_relax_ref
from repro_torch.kernels.relax.relax import ellpack_relax

# (n offers, rows, K): K = 1, K < 32 not a power of two, K = 32, K > 32
SHAPES = [(50, 8, 1), (300, 256, 5), (64, 256, 32), (1000, 512, 40)]


def _case(seed: int, n: int, rows: int, k: int, *, ties: bool):
    """offers with +inf entries, ELL block with tombstones, an all-tombstone
    row (0) and a row whose every neighbour offers +inf (1).  ``ties``
    draws integer offers and weights so equal candidates are common."""
    rng = np.random.default_rng(seed)
    if ties:
        offers = rng.integers(0, 4, n).astype(np.float32)
        w = rng.integers(1, 4, (rows, k)).astype(np.float32)
    else:
        offers = (4 * rng.random(n)).astype(np.float32)
        w = (0.5 + 1.5 * rng.random((rows, k))).astype(np.float32)
    offers[rng.random(n) < 0.3] = np.inf
    offers[0] = np.inf
    idx = rng.integers(0, n, (rows, k)).astype(np.int32)
    w[rng.random((rows, k)) < 0.2] = np.inf
    w[0] = np.inf
    idx[1] = 0
    return offers, idx, w


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,rows,k", SHAPES)
def test_ref_matches_jax_kernel_and_oracle(n, rows, k, ties):
    offers, idx, w = _case(n + rows + k, n, rows, k, ties=ties)
    best, arg = ellpack_relax_ref(*_torch(offers, idx, w))
    kb, ka = jax_kernel(jnp.asarray(offers), jnp.asarray(idx),
                        jnp.asarray(w), interpret=True)
    rb, ra = jax_ref(jnp.asarray(offers), jnp.asarray(idx), jnp.asarray(w))
    for jb, ja in ((kb, ka), (rb, ra)):
        np.testing.assert_array_equal(best.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(arg.numpy(), np.asarray(ja))
    assert torch.isinf(best[0]) and int(arg[0]) == int(arg[1]) == -1
    assert best.dtype == torch.float32 and arg.dtype == torch.int32


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    offers, idx, w = _case(3, 300, 256, 5, ties=True)
    before = ellpack_relax.launches
    got = ellpack_relax(*_torch(offers, idx, w))
    want = ellpack_relax_ref(*_torch(offers, idx, w))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ellpack_relax.launches == before


@pytest.mark.parametrize("on_meta", [(0, 1, 2), (0,)])
def test_wrapper_never_falls_back_off_the_cpu(on_meta):
    """A tensor that is not on the CPU must launch the kernel or raise —
    never take the plain version.  The ``meta`` device stands in for a
    device the kernel cannot take (all inputs there, or only some)."""
    args = _torch(*_case(4, 50, 8, 3, ties=False))
    args = [a.to("meta") if i in on_meta else a for i, a in enumerate(args)]
    before = ellpack_relax.launches
    with pytest.raises(ValueError, match="CUDA device"):
        ellpack_relax(*args)
    assert ellpack_relax.launches == before


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n,rows,k", [(90, 256, 4), (300, 512, 40)])
def test_relax_wave_frontier_masked_matches_jax(n, rows, k, use_kernel):
    """Frontier-masked waves, ELL rows padded past n (the planner's row
    padding): (dist, parent, improved) equal the JAX wave's."""
    rng = np.random.default_rng(n * k)
    offers, idx, w = _case(n * k + 1, n, rows, k, ties=True)
    idx = np.minimum(idx, n - 1)
    w[n:] = np.inf
    dist = offers[:n].copy()
    parent = rng.integers(-1, n, n).astype(np.int32)
    for frontier in (None, rng.random(n) < 0.4):
        got = relax_wave(*_torch(dist, parent, idx, w),
                         frontier=(None if frontier is None
                                   else torch.from_numpy(frontier)),
                         use_kernel=use_kernel)
        want = jax_relax_wave(
            jnp.asarray(dist), jnp.asarray(parent), jnp.asarray(idx),
            jnp.asarray(w),
            frontier=None if frontier is None else jnp.asarray(frontier),
            use_kernel=True, interpret=True)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
