"""Kernel K5 (embedding-bag lookup): the port's ``embedding_bag_ref``
(optional per-slot weights too), the ``embedding_bag`` wrapper (its plain
path, on the CPU) and ``bag_lookup`` against the JAX package's jnp oracle
``embedding_bag_ref`` and ``bag_lookup(use_kernel=False)``, forward and
gradient.  The JAX Pallas kernel itself calls ``pl.load``, which the
installed jax no longer has, so the oracle is the reference here.

Inputs are made from seeds with numpy and handed to both packages; a bf16
case hands the same f32 array to both, each casting it to bf16 (exact).
Tolerances: f32 rtol = atol = 1e-5 (the jnp oracle sums over l in XLA's
order, the port in index order 0..L-1); bf16 3e-2, as
tests/test_kernels.py, because the jnp oracle rounds in bf16 where the
port accumulates in f32 and rounds once.  Gradients: f32 1e-5
(scatter-add order); a bf16 gradient is held against JAX's VJP in f32 on
the same bf16 values, within one bf16 rounding (rtol 2^-8), because the
port scatters in f32 and rounds once where JAX's bf16 VJP rounds at every
add (several ulps on a row that many slots share).  The CUDA kernel itself
is held against the plain version on the card by
test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.embed_bag.ops import bag_lookup as jax_bag_lookup
from repro.kernels.embed_bag.ref import embedding_bag_ref as jax_ref
from repro_torch.kernels.embed_bag.embed_bag import embedding_bag
from repro_torch.kernels.embed_bag.ops import bag_lookup
from repro_torch.kernels.embed_bag.ref import embedding_bag_ref

AGGS = ["sum", "mean"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return 1e-5 if dtype == "f32" else 3e-2


def _case(seed, v, b, l, d, *, pad=0.25, dead_bags=0, repeats=False):
    """table (v, d), idx (b, l) with a ``pad`` share of -1 slots; the
    first ``dead_bags`` bags are all padding; ``repeats`` draws indices
    from a few rows so a bag holds the same row several times."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, min(v, 3) if repeats else v, (b, l))
    idx = idx.astype(np.int32)
    idx[rng.random((b, l)) < pad] = -1
    idx[:dead_bags] = -1
    return table, idx


def _port(table, idx, dtype):
    return torch.from_numpy(table).to(DTYPES[dtype][1]), torch.from_numpy(idx)


def _jax(table, idx, dtype):
    return jnp.asarray(table, DTYPES[dtype][0]), jnp.asarray(idx)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# tests/test_kernels.py's cases (v, b, l, d, dtype), then the edge cases
# the card also checks: DIN's width D = 18, all-padded bags, L = 1,
# repeated indices, L past a warp, D = 1
CASES = [(128, 16, 8, 128, "f32"), (1024, 32, 20, 128, "f32"),
         (256, 8, 4, 256, "bf16")]
EDGE_CASES = [
    ("din width, dead bags", 500, 64, 100, 18, dict(dead_bags=5)),
    ("l = 1", 40, 24, 1, 32, {}),
    ("repeated rows", 50, 16, 12, 20, dict(repeats=True, pad=0.1)),
    ("l past a warp", 300, 8, 45, 130, dict(pad=0.5)),
    ("d = 1", 30, 10, 7, 1, {}),
]


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("v,b,l,d,dtype", CASES)
def test_ref_matches_jax_oracle(agg, v, b, l, d, dtype):
    table, idx = _case(v + b, v, b, l, d)
    got = embedding_bag_ref(*_port(table, idx, dtype), agg=agg)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, d)
    jt, ji = _jax(table, idx, dtype)
    for want in (jax_ref(jt, ji, agg=agg),
                 jax_bag_lookup(jt, ji, agg, False, True)):
        _assert_close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("name,v,b,l,d,opts", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_edge_cases_match_jax(name, v, b, l, d, opts, agg, dtype):
    table, idx = _case(v + l + d, v, b, l, d, **opts)
    got = embedding_bag_ref(*_port(table, idx, dtype), agg=agg)
    _assert_close(got, jax_ref(*_jax(table, idx, dtype), agg=agg),
                  _tol(dtype))
    dead = torch.from_numpy((idx < 0).all(1))
    assert (got[dead] == 0).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", AGGS)
def test_weighted_ref_matches_jax(agg, dtype):
    table, idx = _case(4, 64, 16, 9, 24)
    wts = np.random.default_rng(5).random((16, 9)).astype(np.float32)
    tt, ti = _port(table, idx, dtype)
    got = embedding_bag_ref(tt, ti, torch.from_numpy(wts), agg=agg)
    jt, ji = _jax(table, idx, dtype)
    _assert_close(got, jax_ref(jt, ji, jnp.asarray(wts), agg=agg),
                  _tol(dtype))


def test_empty_inputs():
    table = torch.randn(6, 5)
    for b, l in ((0, 4), (3, 0)):
        for agg in AGGS:
            out = embedding_bag_ref(table, torch.zeros((b, l),
                                                       dtype=torch.int32),
                                    agg=agg)
            assert out.shape == (b, 5) and (out == 0).all()


def test_wrapper_and_entry_point_take_the_plain_version_on_cpu():
    table, idx = _port(*_case(6, 90, 20, 11, 18), "f32")
    before = embedding_bag.launches
    for agg in AGGS:
        want = embedding_bag_ref(table, idx, agg=agg)
        assert torch.equal(embedding_bag(table, idx, agg=agg), want)
        for use_kernel in (None, True, False):
            assert torch.equal(bag_lookup(table, idx, agg, use_kernel), want)
    assert embedding_bag.launches == before
    with pytest.raises(ValueError, match="unknown agg"):
        embedding_bag(table, idx, agg="max")


def _port_grad(table, idx, w, agg, dtype):
    tt, ti = _port(table, idx, dtype)
    tt.requires_grad_(True)
    out = bag_lookup(tt, ti, agg)
    (g,) = torch.autograd.grad(out, tt, torch.from_numpy(w).to(out.dtype))
    assert g.dtype == tt.dtype
    return g


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("v,b,l,d,opts", [
    (64, 8, 5, 16, dict(pad=0.0)),
    (40, 24, 10, 18, dict(dead_bags=3, repeats=True))])
def test_gradient_matches_jax_vjp(v, b, l, d, opts, agg, dtype):
    table, idx = _case(v * b + l, v, b, l, d, **opts)
    w = np.random.default_rng(l).standard_normal((b, d)).astype(np.float32)
    got = _port_grad(table, idx, w, agg, dtype)
    jt, ji = _jax(table, idx, dtype)
    jt, jw = jt.astype(jnp.float32), jnp.asarray(w, jt.dtype).astype(
        jnp.float32)                 # JAX's VJP in f32 on the same values
    want = jax.grad(lambda t: jnp.sum(
        jax_bag_lookup(t, ji, agg, False, True) * jw))(jt)
    tol = 1e-5 if dtype == "f32" else 2**-8
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=1e-5)


@pytest.mark.parametrize("agg", AGGS)
def test_padding_passes_no_gradient(agg):
    """Row 0 is reached only through -1 slots (the plain version clamps -1
    to 0 before its gather): its gradient is exactly 0."""
    table, idx = _case(8, 30, 12, 6, 8, pad=0.4, dead_bags=2)
    idx[idx == 0] = 1
    w = np.ones((12, 8), np.float32)
    got = _port_grad(table, idx, w, agg, "f32").numpy()
    unreached = np.setdiff1d(np.arange(30), idx[idx >= 0])
    assert 0 in unreached
    assert (got[unreached] == 0).all()


@pytest.mark.parametrize("agg", AGGS)
def test_live_index_past_the_end_reads_the_last_row_as_jax_does(agg):
    """A live index >= V reads row V-1 in JAX's gather, and its transpose
    drops the slot's gradient; the plain version (and so the kernel, held
    to it on the card) and the backward do the same."""
    table, idx = _case(5, 30, 12, 6, 8)
    idx[::3, 1] = 30 + np.arange(4)
    got = embedding_bag_ref(*_port(table, idx, "f32"), agg=agg)
    _assert_close(got, jax_ref(*_jax(table, idx, "f32"), agg=agg), 1e-5)
    w = np.random.default_rng(2).standard_normal((12, 8)).astype(np.float32)
    jt, ji = _jax(table, idx, "f32")
    want = jax.grad(lambda t: jnp.sum(
        jax_bag_lookup(t, ji, agg, False, True) * jnp.asarray(w)))(jt)
    np.testing.assert_allclose(_port_grad(table, idx, w, agg, "f32").numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
