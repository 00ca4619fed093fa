"""The port's flash attention (``repro_torch.models.flash``, a
``torch.autograd.Function`` with the reference's block-recompute
backward) against the dense oracle and the JAX package's custom-VJP
``flash_attention``: values and gradients over GQA group sizes, block
sizes, ragged T, causal or not, a value dim that differs from the key dim,
a row with no valid keys, and bf16 gradients against the autograd-through-
the-loop baseline.  Twins of tests/test_flash.py with the same shapes.

Tolerances: against the oracle, those of tests/test_flash.py (forward
rtol/atol 2e-5; gradients rtol 3e-4, atol 3e-5; bf16 flash against the
scan rtol 0.1, atol 0.05); against the JAX flash function, f32 within 1e-5
of the tensor's largest entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _lm_ref as R
from repro.models import flash as jflash
from repro_torch.models import flash, layers


def _mk(B, S, T, nq, nkv, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, nq, D)).astype(np.float32),
            rng.standard_normal((B, T, nkv, D)).astype(np.float32),
            rng.standard_normal((B, T, nkv, Dv)).astype(np.float32))


def _t(arrs, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad) for a in arrs]


@pytest.mark.parametrize("nq,nkv", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("block_k", [16, 64, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_matches_oracle(nq, nkv, block_k, causal):
    arrs = _mk(2, 24, 48, nq, nkv, 16, 16)
    out = flash.flash_attention(*_t(arrs), causal, block_k)
    ref = layers.attention_ref(*_t(arrs), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    want = jflash.flash_attention(*(jnp.asarray(a) for a in arrs), causal,
                                  block_k)
    R.close(out, want, R.F32_REL)


@pytest.mark.parametrize("nq,nkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_oracle_and_reference(nq, nkv, causal):
    arrs = _mk(2, 16, 32, nq, nkv, 8, 8, seed=3)
    ts = _t(arrs, grad=True)
    gf = torch.autograd.grad(
        torch.sum(flash.flash_attention(*ts, causal, 16) ** 2), ts)
    gr = torch.autograd.grad(
        torch.sum(layers.attention_ref(*ts, causal=causal) ** 2), ts)
    jg = jax.grad(lambda q, k, v: jnp.sum(
        jflash.flash_attention(q, k, v, causal, 16) ** 2),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    for a, b, c, name in zip(gf, gr, jg, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4,
                                   atol=3e-5, err_msg=f"d{name} vs oracle")
        R.close(a, c, R.F32_REL, what=f"d{name} vs the reference's flash")


def test_flash_grads_match_naive_scan_bf16():
    """bf16 inputs: the custom backward ~= autograd through the loop."""
    arrs = _mk(1, 8, 24, 4, 2, 8, 8, seed=5)
    ts = _t(arrs, torch.bfloat16, grad=True)
    gf = torch.autograd.grad(torch.sum(
        flash.flash_attention(*ts, True, 8).float() ** 2), ts)
    gs = torch.autograd.grad(torch.sum(layers.blockwise_attention(
        *ts, causal=True, block_k=8).float() ** 2), ts)
    for a, b in zip(gf, gs):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=0.1, atol=0.05)


def test_flash_different_value_dim():
    arrs = _mk(2, 12, 12, 4, 2, 16, 8)   # Dv != D (MLA-style)
    ts = _t(arrs, grad=True)
    out = flash.flash_attention(*ts, True, 8)
    ref = layers.attention_ref(*_t(arrs), causal=True)
    assert tuple(out.shape) == (2, 12, 4, 8)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    w = np.random.default_rng(9).standard_normal(out.shape).astype(
        np.float32)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(w))
    _, vjp = jax.vjp(lambda q, k, v: jflash.flash_attention(q, k, v, True, 8),
                     *(jnp.asarray(a) for a in arrs))
    for g, jg, name in zip(grads, vjp(jnp.asarray(w)), "qkv"):
        R.close(g, jg, R.F32_REL, what=f"d{name}")


def test_flash_row_with_no_valid_keys():
    """All-masked rows produce zeros, not NaN (the m = -inf guards)."""
    arrs = _mk(1, 4, 4, 2, 2, 8, 8)
    ts = _t(arrs, grad=True)
    out = flash.flash_attention(*ts, True, 2)
    assert bool(torch.all(torch.isfinite(out)))
    # a query block past every key: scan_blocks with kv_len = 0
    acc, m, l = layers.scan_blocks(*_t(arrs), causal=True, block_k=2,
                                   kv_len=0)
    assert torch.all(acc == 0) and torch.all(l == 0)
    assert torch.all(torch.isinf(m))
    out0 = layers.blockwise_attention(*_t(arrs), causal=True, block_k=2,
                                      kv_len=0)
    assert torch.all(out0 == 0)
    grads = torch.autograd.grad(out.sum(), ts)
    assert all(bool(torch.all(torch.isfinite(g))) for g in grads)


def test_flash_saves_the_reference_residuals():
    """The backward reads (q, k, v, out5, m, l) alone: O(S*d), no per-block
    probabilities."""
    arrs = _mk(1, 16, 64, 4, 2, 8, 8)
    ts = _t(arrs, grad=True)
    out = flash.flash_attention(*ts, True, 16)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6
    shapes = [tuple(s.shape) for s in saved]
    assert shapes[3] == (1, 2, 2 * 16, 8)          # out5 (B, nkv, G*S, Dv)
    assert shapes[4] == shapes[5] == (1, 2, 2 * 16)
