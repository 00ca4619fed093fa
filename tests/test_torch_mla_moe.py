"""The port's MoE layer (``repro_torch.models.moe``) and MLA
(``repro_torch.models.mla``) against the JAX package's, from the
reference's parameters on the same seeded inputs.

MoE: the output, aux losses (balance, z, dropped fraction) and every
gradient, with drops (capacity factor 0.5) and without; the routing
itself (the reference's top-k indices and gates, its kept mask and slots,
recomputed from its own functions); a zero router (every probability
tied: ``lax.top_k`` picks the lowest ids, so do we); the chunked dispatch
equal to the one-shot one, twinning tests/test_straggler_and_moe.py; an
indivisible chunk falling back to one shot; bf16 compute.

MLA: ``mla_qkv_full`` (q, k, v and the latent pair), ``mla_attention_full``
on both attention paths with gradients, ``mla_latent_for_token`` and the
absorbed decode against the reference's, and against full attention over
the same prefix.

Tolerances: f32 within 1e-5 of the tensor's largest entry; bf16 as
tests/_lm_ref.py (outputs 3e-2 of the largest entry, loss-like scalars
rtol 2e-3); the routing and drop counts exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _lm_ref as R
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.models import mla, moe
from repro_torch.models.params import ParamTree, load_jax_params

D_MODEL = 64


def _moe_setup(n_experts=8, top_k=2, d_ff=32, cf=1.25, seed=0):
    cfg = moe.MoEConfig(n_experts=n_experts, top_k=top_k, d_ff=d_ff,
                        capacity_factor=cf)
    jcfg = jmoe.MoEConfig(n_experts=n_experts, top_k=top_k, d_ff=d_ff,
                          capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.key(seed), D_MODEL, jcfg)
    tp = load_jax_params(ParamTree(moe.init_moe(D_MODEL, cfg,
                                                device="cpu")), jp)
    return cfg, jcfg, tp, jp


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same_aux(aux, jaux, rtol):
    """The aux losses within ``rtol``; the dropped fraction within 1e-6
    (the reference's 1 - kept / (T K) lands off an exact 0 by ~5e-8)."""
    assert set(aux) == set(jaux)
    for k in aux:
        if k == "moe_dropped":
            assert abs(float(aux[k]) - float(jaux[k])) <= 1e-6
        else:
            R.close(aux[k], jaux[k], 0, rtol=rtol, what=k)


@pytest.mark.parametrize("cf", [0.5, 4.0], ids=["drops", "no-drops"])
def test_moe_forward_aux_and_grads_match_reference(cf):
    cfg, jcfg, tp, jp = _moe_setup(cf=cf)
    x = _x((3, 20, D_MODEL))
    w = _x((3, 20, D_MODEL), seed=2)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg))(
        jp, jnp.asarray(x))
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(
        jmoe.moe_forward(p, x, jcfg)[0] * jnp.asarray(w)),
        argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_forward(tp, xt, cfg)
    R.close(y, jy, R.F32_REL, what="moe output")
    assert set(aux) == set(jaux)
    _same_aux(aux, jaux, 1e-6)
    assert (float(aux["moe_dropped"]) > 0) == (cf < 2)
    torch.sum(y * torch.from_numpy(w)).backward()
    R.close_leaves({k: p.grad for k, p in tp.named_parameters()}, jg[0],
                   R.F32_REL, "moe gradient")
    R.close(xt.grad, jg[1], R.F32_REL, what="moe dx")


def _jax_routing(jp, x, jcfg):
    """The reference's routing, recomputed from its own functions as
    moe_forward computes it."""
    T, K, E = x.shape[0], jcfg.top_k, jcfg.n_experts
    C = jmoe.moe_capacity(T, jcfg)
    probs = jax.nn.softmax(x @ jp["router"], axis=-1)
    gv, gi = jax.lax.top_k(probs, K)
    flat_e = gi.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos = jnp.arange(T * K) - jnp.searchsorted(se, jnp.arange(E),
                                               side="left")[se]
    return (np.asarray(gi), np.asarray(gv), np.asarray(order),
            np.asarray(pos < C))


@pytest.mark.parametrize("zero_router", [False, True],
                         ids=["seeded", "ties"])
def test_moe_routing_and_drops_equal_reference(zero_router):
    cfg, jcfg, tp, jp = _moe_setup(cf=0.5)
    if zero_router:   # uniform probabilities: every expert ties
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
        with torch.no_grad():
            tp.router.zero_()
    x = _x((40, D_MODEL), seed=3)
    gi, gv, order, keep = _jax_routing(jp, jnp.asarray(x), jcfg)
    probs = torch.softmax(torch.from_numpy(x) @ tp.router.detach(), dim=-1)
    tv, ti = moe.top_k(probs, cfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), gi)
    np.testing.assert_allclose(tv.numpy(), gv, rtol=1e-6)
    if zero_router:
        assert np.all(gi == np.arange(cfg.top_k))
        assert np.all(np.sort(torch.argsort(ti.reshape(-1), stable=True)
                              .numpy()) == np.sort(order))
    y, aux = moe.moe_forward(tp, torch.from_numpy(x), cfg)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg))(
        jp, jnp.asarray(x))
    _same_aux(aux, jaux, 1e-6)
    assert abs(float(aux["moe_dropped"]) - (1.0 - keep.mean())) < 1e-6
    assert 0 < keep.mean() < 1
    if zero_router:   # experts 0 and 1 take every token; C of T keep each
        C = moe.moe_capacity(40, cfg)
        assert int(round((1 - float(aux["moe_dropped"])) * 80)) == 2 * C
    R.close(y, jy, R.F32_REL, what="output")


@pytest.mark.parametrize("chunk", [0, 256, 512])
def test_chunked_moe_dispatch_matches_oneshot_and_reference(chunk,
                                                            monkeypatch):
    """T*K = 2048: chunks of 256 and 512 engage the chunked path, 0 the
    one-shot; outputs and gradients equal the one-shot's and the
    reference's (its own chunk setting alike)."""
    cfg, jcfg, tp, jp = _moe_setup()
    x = _x((16, 64, D_MODEL))
    monkeypatch.setattr(moe, "DISPATCH_CHUNK", chunk)
    monkeypatch.setattr(jmoe, "DISPATCH_CHUNK", chunk)
    xt = torch.from_numpy(x)
    y, _ = moe.moe_forward(tp, xt, cfg)
    torch.sum(y ** 2).backward()
    jy, _ = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg))(
        jp, jnp.asarray(x))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jmoe.moe_forward(
        p, jnp.asarray(x), jcfg)[0] ** 2)))(jp)
    R.close(y, jy, R.F32_REL, what="output")
    R.close_leaves({k: p.grad for k, p in tp.named_parameters()}, jg,
                   R.F32_REL, "gradient")
    monkeypatch.setattr(moe, "DISPATCH_CHUNK", 0)
    tp.zero_grad()
    y0, _ = moe.moe_forward(tp, xt, cfg)
    np.testing.assert_allclose(y.detach().numpy(), y0.detach().numpy(),
                               rtol=1e-6, atol=1e-7)


def test_chunked_moe_disabled_when_indivisible(monkeypatch):
    cfg, jcfg, tp, jp = _moe_setup(n_experts=4, top_k=2, d_ff=16)
    x = _x((3, 7, D_MODEL))         # T*K = 42: 16 does not divide it
    monkeypatch.setattr(moe, "DISPATCH_CHUNK", 16)
    y, _ = moe.moe_forward(tp, torch.from_numpy(x), cfg)
    assert bool(torch.all(torch.isfinite(y)))
    monkeypatch.setattr(jmoe, "DISPATCH_CHUNK", 16)
    jy, _ = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    R.close(y, jy, R.F32_REL)


def test_moe_capacity_rounds_up_to_8():
    cfg = moe.MoEConfig(n_experts=64, top_k=8, d_ff=8)
    jcfg = jmoe.MoEConfig(n_experts=64, top_k=8, d_ff=8)
    for t in (1, 7, 8, 100, 4096, 32768, 1 << 20):
        assert moe.moe_capacity(t, cfg) == jmoe.moe_capacity(t, jcfg)
        assert moe.moe_capacity(t, cfg) % 8 == 0


def test_moe_bf16_matches_reference():
    cfg, jcfg, tp, jp = _moe_setup(cf=4.0)
    x = _x((2, 16, D_MODEL))
    y, aux = moe.moe_forward(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    assert y.dtype == torch.bfloat16
    R.close(y, jy, R.BF16_OUT, what="bf16 output")
    _same_aux(aux, jaux, R.BF16_LOSS)


# -------------------------------------------------------------------- MLA ----

MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4,
           v_head_dim=8)
HEADS = 4


def _mla_setup():
    cfg, jcfg = mla.MLAConfig(**MLA), jmla.MLAConfig(**MLA)
    jp = jmla.init_mla(jax.random.key(0), D_MODEL, HEADS, jcfg)
    tp = load_jax_params(ParamTree(mla.init_mla(D_MODEL, HEADS, cfg,
                                                device="cpu")), jp)
    return cfg, jcfg, tp, jp


def test_mla_qkv_full_matches_reference():
    cfg, jcfg, tp, jp = _mla_setup()
    x = _x((2, 10, D_MODEL))
    pos = np.arange(10, dtype=np.int32)[None]
    got = mla.mla_qkv_full(tp, torch.from_numpy(x), HEADS, cfg,
                           torch.from_numpy(pos), 1e4)
    want = jmla.mla_qkv_full(jp, jnp.asarray(x), HEADS, jcfg,
                             jnp.asarray(pos), 1e4)
    for a, b, name in zip(got, want, ("q", "k", "v", "c_kv", "k_rope")):
        R.close(a, b, R.F32_REL, what=name)


@pytest.mark.parametrize("impl", ["flash_vjp", "scan"])
def test_mla_attention_full_matches_reference(impl):
    cfg, jcfg, tp, jp = _mla_setup()
    x = _x((2, 12, D_MODEL))
    pos = np.arange(12, dtype=np.int32)[None]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mla.mla_attention_full(tp, xt, HEADS, cfg, torch.from_numpy(pos),
                                 1e4, block_k=8, attn_impl=impl)
    torch.sum(out ** 2).backward()
    f = lambda p, x: jmla.mla_attention_full(  # noqa: E731
        p, x, HEADS, jcfg, jnp.asarray(pos), 1e4, 8, impl)
    jout = jax.jit(f)(jp, jnp.asarray(x))
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) ** 2),
                          argnums=(0, 1)))(jp, jnp.asarray(x))
    R.close(out, jout, R.F32_REL, what="output")
    R.close_leaves({k: p.grad for k, p in tp.named_parameters()}, jg[0],
                   R.F32_REL, "gradient")
    R.close(xt.grad, jg[1], R.F32_REL, what="dx")


def test_mla_absorbed_decode_matches_reference_and_full_attention():
    """The absorbed decode of the token at position 9 over a latent cache
    of 12 slots (10 valid; the rest garbage that the mask hides), against
    the reference's absorbed decode and full attention's last row."""
    cfg, jcfg, tp, jp = _mla_setup()
    x = _x((2, 10, D_MODEL))
    pos = np.arange(10, dtype=np.int32)[None]
    *_, c_kv, k_rope = mla.mla_qkv_full(tp, torch.from_numpy(x), HEADS, cfg,
                                        torch.from_numpy(pos), 1e4)
    # the latent of the last token, as decode appends it
    lc, lr = mla.mla_latent_for_token(tp, torch.from_numpy(x[:, 9:]), cfg, 9,
                                      1e4)
    jlc, jlr = jmla.mla_latent_for_token(jp, jnp.asarray(x[:, 9:]), jcfg,
                                         jnp.int32(9), 1e4)
    R.close(lc, jlc, R.F32_REL, what="latent c_kv")
    R.close(lr, jlr, R.F32_REL, what="latent k_rope")
    R.close(lc, c_kv[:, 9:], R.F32_REL, what="latent vs full c_kv")
    cc = np.concatenate([c_kv.detach().numpy(), _x((2, 2, 16), 5)], 1)
    cr = np.concatenate([k_rope.detach().numpy(), _x((2, 2, 4), 6)], 1)
    got = mla.mla_decode_absorbed(tp, torch.from_numpy(x[:, 9:]), HEADS, cfg,
                                  torch.from_numpy(cc), torch.from_numpy(cr),
                                  10, 1e4)
    want = jmla.mla_decode_absorbed(jp, jnp.asarray(x[:, 9:]), HEADS, jcfg,
                                    jnp.asarray(cc), jnp.asarray(cr),
                                    jnp.int32(10), 1e4)
    R.close(got, want, R.F32_REL, what="absorbed decode")
    full = mla.mla_attention_full(tp, torch.from_numpy(x), HEADS, cfg,
                                  torch.from_numpy(pos), 1e4, block_k=4)
    R.close(got, full[:, 9:], R.F32_REL, what="absorbed vs full attention")


def test_mla_bf16_matches_reference():
    cfg, jcfg, tp, jp = _mla_setup()
    x = _x((2, 8, D_MODEL))
    pos = np.arange(8, dtype=np.int32)[None]
    got = mla.mla_attention_full(tp, torch.from_numpy(x).to(torch.bfloat16),
                                 HEADS, cfg, torch.from_numpy(pos), 1e4,
                                 block_k=4)
    want = jmla.mla_attention_full(jp, jnp.asarray(x, jnp.bfloat16), HEADS,
                                   jcfg, jnp.asarray(pos), 1e4, 4)
    assert got.dtype == torch.bfloat16
    R.close(got, want, R.BF16_OUT)


def test_init_shapes_equal_reference():
    cfg, jcfg, tp, jp = _mla_setup()
    assert {k: tuple(v.shape) for k, v in tp.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    m = ParamTree(moe.init_moe(D_MODEL, moe.MoEConfig(8, 2, 32),
                               device="meta", leading=(3,)))
    jm = jmoe.init_moe(jax.random.key(0), D_MODEL, jmoe.MoEConfig(8, 2, 32))
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == \
        {k: (3,) + tuple(v.shape) for k, v in jm.items()}
