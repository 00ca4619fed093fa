"""The port's transformer layers (``repro_torch.models.layers``) against the
JAX package's on the same seeded inputs: ``rms_norm`` (f32 inside, cast
back), ``rope_angles`` / ``apply_rope``, ``blockwise_attention`` (causal
or not, GQA groups, ragged T, ``q_offset`` and ``kv_len`` as a decode
with a part-filled cache calls it), ``attention_ref``, ``swiglu`` and
``linear``, in f32 and bf16, forward and gradient.

Tolerances: f32 within 1e-5 of the tensor's largest entry (XLA and torch
sum in different orders); bf16 inputs within one bf16 ulp (2^-8) of the
largest entry, for outputs cast back to bf16 (the two round f32 values
that differ in the last bits).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _lm_ref as R
from repro.models import layers as J
from repro_torch.models import layers as L

BF16_ULP = 2.0 ** -8


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    if dtype == "bf16":
        return (torch.from_numpy(a).to(torch.bfloat16),
                jnp.asarray(a, jnp.bfloat16))
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_reference(dtype):
    x, jx = _pair(_arr((3, 5, 16), 0, 3.0), dtype)
    scale = _arr((16,), 1)
    got = L.rms_norm(x, torch.from_numpy(scale))
    want = J.rms_norm(jx, jnp.asarray(scale))
    assert got.dtype == x.dtype
    R.close(got, want, R.F32_REL if dtype == "f32" else BF16_ULP)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches_reference(dtype):
    pos = np.array([[0, 1, 7, 4096, 32767]], np.int32)
    cos, sin = L.rope_angles(torch.from_numpy(pos), 8, 1e4)
    jcos, jsin = J.rope_angles(jnp.asarray(pos), 8, 1e4)
    R.close(cos, jcos, R.F32_REL)
    R.close(sin, jsin, R.F32_REL)
    x, jx = _pair(_arr((2, 5, 3, 8), 2), dtype)
    got = L.apply_rope(x, cos, sin)
    want = J.apply_rope(jx, jcos, jsin)
    assert got.dtype == x.dtype
    R.close(got, want, R.F32_REL if dtype == "f32" else BF16_ULP)


CASES = [  # (B, S, T, nq, nkv, D, Dv, block_k, causal, q_offset, kv_len)
    (2, 12, 12, 4, 4, 8, 8, 4, True, 0, None),
    (2, 10, 23, 6, 2, 8, 8, 8, False, 0, None),      # ragged T, GQA
    (1, 8, 20, 8, 2, 16, 8, 16, True, 0, None),      # Dv != D
    (2, 1, 16, 4, 2, 8, 8, 8, True, 9, 10),           # decode: part-filled
    (1, 3, 16, 4, 1, 8, 8, 4, True, 5, 8),            # chunk at an offset
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_blockwise_attention_matches_reference(case):
    B, S, T, nq, nkv, D, Dv, bk, causal, off, kv_len = case
    q, k, v = (_arr((B, S, nq, D), 3), _arr((B, T, nkv, D), 4),
               _arr((B, T, nkv, Dv), 5))
    w = _arr((B, S, nq, Dv), 6)
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = L.blockwise_attention(*ts, block_k=bk, **kw)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(w))

    def f(q, k, v):
        return J.blockwise_attention(q, k, v, block_k=bk, **kw)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(w))
    R.close(got, want, R.F32_REL, what="output")
    for g, jg, name in zip(grads, jgrads, "qkv"):
        R.close(g, jg, R.F32_REL, what=f"d{name}")
    # the dense oracle, both packages
    ref = L.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    R.close(ref, J.attention_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw),
            R.F32_REL, what="oracle")
    padded_keys_seen = not causal and kv_len is None and T % bk
    if not padded_keys_seen:
        R.close(got, ref, R.F32_REL, what="output against the oracle")


def test_blockwise_attention_sees_padded_keys_as_the_reference():
    """Without a causal mask or ``kv_len``, ragged T (T % block_k != 0)
    lets the zero padding keys into the softmax in both packages alike
    (the reference masks at the padded length); flash masks at T.  The LM
    only calls attention causally, where the padding lies past every
    query."""
    q, k, v = _arr((1, 4, 2, 8), 10), _arr((1, 6, 2, 8), 11), \
        _arr((1, 6, 2, 8), 12)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = L.blockwise_attention(*args, causal=False, block_k=4)
    want = J.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=False, block_k=4)
    R.close(got, want, R.F32_REL)
    ref = L.attention_ref(*args, causal=False)
    assert float((got - ref).abs().max()) > 1e-2
    from repro_torch.models import flash
    R.close(flash.flash_attention(*args, False, 4), ref, R.F32_REL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swiglu_and_linear_match_reference(dtype):
    x, jx = _pair(_arr((2, 5, 16), 7), dtype)
    ws = [_arr(s, 8 + i, 0.25) for i, s in
          enumerate([(16, 24), (16, 24), (24, 16)])]
    got = L.swiglu(x, *(torch.from_numpy(w) for w in ws))
    want = J.swiglu(jx, *(jnp.asarray(w) for w in ws))
    assert got.dtype == x.dtype
    # bf16: two bf16 matmuls and an elementwise chain before the last one
    R.close(got, want, R.F32_REL if dtype == "f32" else 4 * BF16_ULP)
    got = L.linear(x, torch.from_numpy(ws[0]))
    R.close(got, J.linear(jx, jnp.asarray(ws[0])),
            R.F32_REL if dtype == "f32" else BF16_ULP)


def test_inits_draw_the_reference_shapes_and_scales():
    """Shapes, dtypes and the scale of each init against the reference's
    (the draws themselves differ: tests carry the reference's parameters
    across)."""
    g = torch.Generator().manual_seed(0)
    sw = L.init_swiglu(64, 256, g, "cpu", leading=(3,))
    jsw = J.init_swiglu(jax.random.key(0), 64, 256)
    for k in jsw:
        assert tuple(sw[k].shape) == (3,) + jsw[k].shape
        np.testing.assert_allclose(float(sw[k].std()), float(jsw[k].std()),
                                   rtol=0.05)
    lin = L.init_linear(64, 128, g, "cpu", dtype=torch.bfloat16)
    assert lin.dtype == torch.bfloat16 and tuple(lin.shape) == (64, 128)
    assert torch.equal(L.init_rms_norm(8, "cpu"), torch.ones(8))
