"""Kernel K4 (ELL gather-reduce SpMM): the port's ``spmm_ell_ref``, the
``spmm_ell`` wrapper (its plain path, on the CPU) and ``neighbor_reduce``
against the JAX package's Pallas kernel (interpret mode, as the JAX
package's own CPU tests run it) and its jnp oracle, forward and gradient.

Inputs are made from seeds with numpy and handed to both packages; a bf16
case hands the same f32 array to both, each casting it to bf16 (exact).
Tolerances: f32 rtol = atol = 1e-5 (the jnp oracle sums over k in XLA's
order, the port in index order 0..K-1); bf16 2e-2, as
tests/test_kernels.py, because the jnp oracle rounds in bf16 where the
port accumulates in f32 and rounds once; max is exact in both dtypes (it
does no arithmetic).  Gradients: f32 1e-5 (scatter-add order); a bf16
gradient is held against JAX's VJP in f32 on the same bf16 values, within
one bf16 rounding (rtol 2^-8), because the port scatters in f32 and rounds
once where JAX's bf16 VJP rounds at every add.  The CUDA kernel itself is
held against the plain version on the card by test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.spmm.ops import neighbor_reduce as jax_neighbor_reduce
from repro.kernels.spmm.ref import spmm_ell_ref as jax_ref
from repro.kernels.spmm.spmm import spmm_ell as jax_kernel
from repro_torch.kernels.spmm.ops import neighbor_reduce
from repro_torch.kernels.spmm.ref import spmm_ell_ref
from repro_torch.kernels.spmm.spmm import spmm_ell

AGGS = ["sum", "mean", "max"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(agg, dtype):
    return 0.0 if agg == "max" else (1e-5 if dtype == "f32" else 2e-2)


def _case(seed, s, r, k, f, *, ties=False, live=0.7, pad=None,
          dead_rows=0, dups=False):
    """feats (s, f), nbr_idx/nbr_mask (r, k).  ``ties`` draws integer
    features so equal maxima are common; ``pad`` is written into masked
    cells (-1 as the sampler writes); the first ``dead_rows`` rows are all
    masked; ``dups`` repeats each row's first index in its second cell."""
    rng = np.random.default_rng(seed)
    feats = (rng.integers(-3, 4, (s, f)) if ties
             else rng.standard_normal((s, f))).astype(np.float32)
    idx = rng.integers(0, s, (r, k)).astype(np.int32)
    mask = rng.random((r, k)) < live
    mask[:dead_rows] = False
    if dups and k > 1:
        idx[:, 1] = idx[:, 0]
    if pad is not None:
        idx[~mask] = pad
    return feats, idx, mask


def _port(feats, idx, mask, dtype):
    return (torch.from_numpy(feats).to(DTYPES[dtype][1]),
            torch.from_numpy(idx), torch.from_numpy(mask))


def _jax(feats, idx, mask, dtype):
    return (jnp.asarray(feats, DTYPES[dtype][0]), jnp.asarray(idx),
            jnp.asarray(mask))


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# tests/test_kernels.py's cases (s, r, k, f, dtype)
KERNEL_CASES = [(64, 64, 8, 128, "f32"), (128, 256, 16, 256, "f32"),
                (64, 128, 4, 128, "bf16")]


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("s,r,k,f,dtype", KERNEL_CASES)
def test_ref_matches_jax_kernel_and_oracle(agg, s, r, k, f, dtype):
    feats, idx, mask = _case(r + k, s, r, k, f)
    got = spmm_ell_ref(*_port(feats, idx, mask, dtype), agg=agg)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (r, f)
    jf, ji, jm = _jax(feats, idx, mask, dtype)
    for want in (jax_kernel(jf, ji, jm, agg=agg, block_rows=64,
                            block_feat=128, interpret=True),
                 jax_ref(jf, ji, jm, agg=agg)):
        _assert_close(got, want, _tol(agg, dtype))


# (name, s, r, k, f, case options): the edge cases the card also checks
EDGE_CASES = [
    ("k1", 40, 64, 1, 32, {}),
    ("all-masked rows, -1 pads", 50, 96, 6, 20, dict(pad=-1, dead_rows=9)),
    ("duplicates in a row", 30, 64, 8, 128, dict(dups=True)),
    ("ties", 16, 128, 12, 24, dict(ties=True, dups=True, pad=-1)),
    ("k past a warp, odd f", 300, 32, 40, 18, dict(pad=-1, dead_rows=2)),
    ("f = 1", 10, 8, 5, 1, dict(ties=True)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("name,s,r,k,f,opts", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_edge_cases_match_jax(name, s, r, k, f, opts, agg, dtype):
    feats, idx, mask = _case(s + r + k + f, s, r, k, f, **opts)
    got = spmm_ell_ref(*_port(feats, idx, mask, dtype), agg=agg)
    jf, ji, jm = _jax(feats, idx, mask, dtype)
    _assert_close(got, jax_kernel(jf, ji, jm, agg=agg, interpret=True),
                  _tol(agg, dtype))
    _assert_close(got, jax_ref(jf, ji, jm, agg=agg), _tol(agg, dtype))
    dead = ~mask.any(1)
    assert (got[torch.from_numpy(dead)] == 0).all()


def test_max_propagates_nan_as_jnp_max():
    feats, idx, mask = _case(3, 20, 16, 6, 8, pad=-1)
    feats[idx[mask][:3]] = np.nan        # three live cells' rows
    feats[0] = np.nan                    # row 0: reached only if live
    got = spmm_ell_ref(*_port(feats, idx, mask, "f32"), agg="max")
    want = np.asarray(jax_ref(*_jax(feats, idx, mask, "f32"), agg="max"))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(got.numpy(), want)


def test_empty_inputs():
    feats = torch.randn(5, 7)
    for r, k in ((0, 4), (3, 0)):
        idx = torch.zeros((r, k), dtype=torch.int32)
        mask = torch.zeros((r, k), dtype=torch.bool)
        for agg in AGGS:
            out = spmm_ell_ref(feats, idx, mask, agg)
            assert out.shape == (r, 7) and (out == 0).all()


def test_wrapper_and_entry_point_take_the_plain_version_on_cpu():
    feats, idx, mask = _port(*_case(5, 30, 40, 6, 20, pad=-1), "f32")
    before = spmm_ell.launches
    for agg in AGGS:
        want = spmm_ell_ref(feats, idx, mask, agg)
        assert torch.equal(spmm_ell(feats, idx, mask, agg=agg), want)
        for use_kernel in (None, True, False):
            assert torch.equal(neighbor_reduce(feats, idx, mask, agg,
                                               use_kernel), want)
    assert spmm_ell.launches == before
    with pytest.raises(ValueError, match="unknown agg"):
        spmm_ell(feats, idx, mask, agg="min")


def _jax_grad(feats, idx, mask, w, agg, dtype):
    """JAX's VJP, in f32 on the values of ``dtype``."""
    jf, ji, jm = _jax(feats, idx, mask, dtype)
    jf = jf.astype(jnp.float32)
    jw = jnp.asarray(w, DTYPES[dtype][0]).astype(jnp.float32)
    return np.asarray(jax.grad(lambda x: jnp.sum(
        jax_neighbor_reduce(x, ji, jm, agg, False, True) * jw))(jf),
        np.float32)


def _port_grad(feats, idx, mask, w, agg, dtype):
    tf, ti, tm = _port(feats, idx, mask, dtype)
    tf.requires_grad_(True)
    out = neighbor_reduce(tf, ti, tm, agg)
    (g,) = torch.autograd.grad(out, tf, torch.from_numpy(w).to(out.dtype))
    assert g.dtype == tf.dtype
    return g


# (s, r, k, f, case options): ties and duplicates make max split its
# cotangent; -1 pads and all-masked rows must pass nothing
GRAD_CASES = [(32, 48, 6, 16, dict(live=0.8)),
              (12, 40, 8, 8, dict(ties=True, dups=True, pad=-1,
                                  dead_rows=5))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("s,r,k,f,opts", GRAD_CASES)
def test_gradient_matches_jax_vjp(s, r, k, f, opts, agg, dtype):
    feats, idx, mask = _case(s * r + k, s, r, k, f, **opts)
    w = np.random.default_rng(k).standard_normal((r, f)).astype(np.float32)
    got = _port_grad(feats, idx, mask, w, agg, dtype)
    np.testing.assert_allclose(
        got.float().numpy(), _jax_grad(feats, idx, mask, w, agg, dtype),
        rtol=1e-5 if dtype == "f32" else 2**-8, atol=1e-5)


def test_max_gradient_splits_ties_equally():
    """Integer features: rows 0 and 1 gather the same value at 1 and 3
    cells; JAX's reduce_max JVP gives each tied cell an equal share."""
    feats = np.array([[2.0], [2.0], [1.0], [2.0]], np.float32)
    idx = np.array([[0, 2, -1], [0, 1, 3]], np.int32)
    mask = np.array([[True, True, False], [True, True, True]])
    w = np.array([[6.0], [9.0]], np.float32)
    got = _port_grad(feats, idx, mask, w, "max", "f32")
    want = _jax_grad(feats, idx, mask, w, "max", "f32")
    np.testing.assert_array_equal(want, [[9.0], [3.0], [0.0], [3.0]])
    np.testing.assert_array_equal(got.numpy(), want)


def test_gradient_of_a_nan_row_matches_jax():
    """A NaN row's max sends NaN to each of its live cells, as JAX's does;
    masked cells and other rows stay finite."""
    feats, idx, mask = _case(9, 20, 16, 5, 4, pad=-1)
    feats[idx[mask][0], 2] = np.nan
    w = np.ones((16, 4), np.float32)
    got = _port_grad(feats, idx, mask, w, "max", "f32").numpy()
    want = _jax_grad(feats, idx, mask, w, "max", "f32")
    assert np.isnan(want).any() and not np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("agg", AGGS)
def test_masked_cells_pass_no_gradient(agg):
    """Row 0 is reached only through masked -1 cells (the plain version
    clamps -1 to 0 before its gather): its gradient is exactly 0."""
    feats, idx, mask = _case(2, 24, 32, 6, 8, pad=-1, dead_rows=4)
    idx[mask & (idx == 0)] = 1
    w = np.ones((32, 8), np.float32)
    got = _port_grad(feats, idx, mask, w, agg, "f32").numpy()
    unreached = np.setdiff1d(np.arange(24), idx[mask])
    assert 0 in unreached
    assert (got[unreached] == 0).all()


@pytest.mark.parametrize("agg", AGGS)
def test_live_index_past_the_end_reads_the_last_row_as_jax_does(agg):
    """A live index >= S reads row S-1 in JAX's gather, and its transpose
    drops the cell's gradient; the plain version (and so the kernel, held
    to it on the card) and the backward do the same."""
    feats, idx, mask = _case(4, 20, 16, 6, 8, pad=-1)
    past = mask & (np.arange(6) < 2)
    idx[past] = 20 + np.nonzero(past)[1]
    got = spmm_ell_ref(*_port(feats, idx, mask, "f32"), agg=agg)
    want = jax_ref(*_jax(feats, idx, mask, "f32"), agg=agg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    w = np.random.default_rng(3).standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_allclose(
        _port_grad(feats, idx, mask, w, agg, "f32").numpy(),
        _jax_grad(feats, idx, mask, w, agg, "f32"), rtol=1e-5, atol=1e-5)
