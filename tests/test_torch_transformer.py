"""The port's LM (``repro_torch.models.transformer``) against the JAX
package's, for the five LM archs at REDUCED, from the reference's initial
parameters: ``lm_forward``'s logits and aux, ``lm_loss`` and the gradient
of every leaf (f32 compute and the configs' bf16); one train step with
grad_accum 1 and 2; ``prefill``'s logits and bf16 cache and a decode step
after it; decode steps against ``lm_forward`` at the same positions;
``decode_step`` at length == capacity (the clamped cache write);
``param_count`` / ``active_param_count`` / ``model_flops``; and the
remat and attention variants (twins of tests/test_perf_variants.py).

Tolerances: tests/_lm_ref.py (f32 1e-5 of the largest entry; bf16 logits
3e-2, gradients 6e-2 of the leaf's largest, losses rtol 2e-3).  Decode
reads a bf16 cache where ``lm_forward`` keeps k and v in f32, so decode
against the forward holds to the bf16 logit tolerance; decoding from an
f32 cache holds to f32's.
"""
import dataclasses
import functools
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _lm_ref as R
from repro.configs import registry as jreg
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import registry as reg
from repro_torch.models import transformer as tfm
from repro_torch.models.params import params_from_jax
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod

ARCHS = R.LM_ARCHS
OPT = dict(warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The reference's loss, metrics, gradients and logits, computed once."""
    jc, _ = R.configs(arch, dtype)
    jp = R.jax_params(arch)
    batch = R.j(R.tokens(jc))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.lm_loss(p, batch, jc), has_aux=True))(jp)
    logits, aux = jax.jit(lambda p: jtfm.lm_forward(p, batch["tokens"], jc))(
        jp)
    return loss, metrics, grads, logits, aux


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients(arch, dtype):
    jl, jm, jg, jlogits, jaux = _reference(arch, dtype)
    _, tc = R.configs(arch, dtype)
    model = R.port_model(tc, R.jax_params(arch))
    batch = R.t(R.tokens(tc))
    f32 = dtype == "f32"
    out_rel, grad_rel = (R.F32_REL, R.F32_REL) if f32 else (R.BF16_OUT,
                                                            R.BF16_GRAD)
    loss_rtol = 1e-5 if f32 else R.BF16_LOSS
    with torch.no_grad():
        logits, aux = tfm.lm_forward(model, batch["tokens"], tc)
    assert logits.dtype == tc.compute_dtype
    R.close(logits, jlogits, out_rel, what="logits")
    assert set(aux) == set(jaux)
    for k in aux:
        R.close(aux[k], jaux[k], 0, rtol=loss_rtol, what=k)
    loss, metrics = tfm.lm_loss(model, batch, tc)
    loss.backward()
    R.close(loss, jl, 0, rtol=loss_rtol, what="loss")
    assert set(metrics) == set(jm)
    for k in metrics:
        R.close(metrics[k], jm[k], 0, rtol=loss_rtol, what=k)
    R.close_leaves({k: p.grad for k, p in model.named_parameters()}, jg,
                   grad_rel, "gradient")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, accum):
    """One AdamW step (f32 compute), the batch pre-split into ``accum``
    microbatches as both packages take it: metrics, the first moment (the
    clipped, accumulated gradient) and the parameters after the step
    (within 1e-6 where the gradient is significant, else within 2 lr:
    Adam's step of a near-zero gradient is its sign)."""
    jc, tc = R.configs(arch, "f32", grad_accum=accum)
    jp = R.jax_params(arch)
    raw = R.tokens(jc, B=4)
    if accum > 1:
        raw = {k: v.reshape((accum, 4 // accum) + v.shape[1:])
               for k, v in raw.items()}
    jcfg, tcfg = jopt.AdamWConfig(**OPT), opt_mod.AdamWConfig(**OPT)
    jstep = jsteps.make_train_step(lambda p, b: jtfm.lm_loss(p, b, jc), jcfg,
                                   accum)
    jnew, jstate, jm = jax.jit(jstep)(jp, jopt.adamw_init(jp), R.j(raw))
    model = R.port_model(tc, jp)
    step = steps_mod.make_train_step(partial(tfm.lm_loss, cfg=tc), tcfg,
                                     accum)
    state = opt_mod.adamw_init(dict(model.named_parameters()))
    metrics = step(model, state, R.t(raw))
    assert set(metrics) == set(jm)
    for k in metrics:
        R.close(metrics[k], jm[k], 0, rtol=1e-5, what=k)
    assert int(state["step"]) == int(jstate["step"]) == 1
    R.close_leaves(state["m"], jstate["m"], R.F32_REL, "first moment")
    lr = float(jm["lr"])
    new, old = params_from_jax(jnew), params_from_jax(jp)
    g = {k: np.abs(v.numpy()) / (1 - jcfg.b1)
         for k, v in params_from_jax(jstate["m"]).items()}
    for k, p in model.named_parameters():
        big = g[k] > max(1e-4 * g[k].max(), R.F32_REL * g[k].max())
        got, want = p.detach().numpy(), new[k].numpy()
        np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert np.all(np.abs(got - old[k].numpy())[~big] <= 2 * lr), k


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` (f32 compute; its cache bf16 in both packages) then one
    decode step, against the reference's: logits to f32's tolerance, the
    bf16 cache within one bf16 ulp of its largest entry (the two round
    f32 values that differ in the last bits)."""
    jc, tc = R.configs(arch, "f32")
    jp = R.jax_params(arch)
    toks = R.tokens(jc, S=12)["tokens"]
    nxt = np.array([3, 5], np.int32)
    jlog, jcache = jax.jit(partial(jtfm.prefill, cfg=jc, capacity=16))(
        jp, jnp.asarray(toks))
    jlog2, jcache2 = jax.jit(partial(jtfm.decode_step, cfg=jc))(
        jp, jcache, jnp.asarray(nxt))
    model = R.port_model(tc, jp)
    log, cache = tfm.prefill(model, torch.from_numpy(toks), tc, capacity=16)
    R.close(log, jlog, R.F32_REL, what="prefill logits")
    assert cache.length == int(jcache.length) == 12
    for a, b in ((cache.k, jcache.k), (cache.v, jcache.v)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        R.close(a, b, 2.0 ** -8, what="prefill cache")
    log2, cache2 = tfm.decode_step(model, cache, torch.from_numpy(nxt), tc)
    R.close(log2, jlog2, R.F32_REL, what="decode logits")
    assert cache2.length == int(jcache2.length) == 13
    R.close(cache2.k[:, :, 12], jcache2.k[:, :, 12], 2.0 ** -8,
            what="appended cache row")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_forward(arch):
    """Decoding a sequence token by token gives ``lm_forward``'s logits at
    every position: from an f32 cache to f32's tolerance; after a bf16
    ``prefill`` of the first half to the bf16 logit tolerance.  MoE
    capacity follows the number of tokens in the call, so the MoE archs
    run with a capacity factor that drops nothing (E / top_k): a decode
    step and the forward then route alike.  Their bf16-cache leg is left
    out: routing is discontinuous, and the cache's rounding flips a
    router's choice (``test_prefill_and_decode_match_reference`` holds
    their bf16 cache against the reference's instead)."""
    _, tc = R.configs(arch, "f32")
    if tc.moe is not None:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=tc.moe.n_experts / tc.moe.top_k))
    model = R.port_model(tc, R.jax_params(arch))
    toks = torch.from_numpy(R.tokens(tc, S=10)["tokens"])
    with torch.no_grad():
        want, _ = tfm.lm_forward(model, toks, tc)
    cache = tfm.init_cache(tc, 2, 10, dtype=torch.float32, device="cpu")
    for s in range(10):
        got, cache = tfm.decode_step(model, cache, toks[:, s], tc)
        R.close(got, want[:, s], R.F32_REL, what=f"f32 cache, position {s}")
    pre, cache = tfm.prefill(model, toks[:, :5], tc, capacity=10)
    R.close(pre, want[:, :5], R.F32_REL, what="prefill logits")
    if tc.moe is not None:
        return
    for s in range(5, 10):
        got, cache = tfm.decode_step(model, cache, toks[:, s], tc)
        R.close(got, want[:, s], R.BF16_OUT, what=f"bf16 cache, position {s}")


@pytest.mark.parametrize("arch", ["qwen3-14b", "minicpm3-4b"])
def test_decode_at_capacity_clamps_like_the_reference(arch):
    """At length == capacity ``dynamic_update_slice`` clamps its start: the
    new token overwrites the last slot, and every slot is attended."""
    jc, tc = R.configs(arch, "f32")
    jp = R.jax_params(arch)
    cap = 6
    meta = tfm.cache_shapes(tc, 2, cap)
    ks, vs = meta.k.shape, meta.v.shape
    rng = np.random.default_rng(4)
    k0 = rng.standard_normal(ks).astype(np.float32)
    v0 = rng.standard_normal(vs).astype(np.float32)
    jcache = jtfm.KVCache(k=jnp.asarray(k0, jnp.bfloat16),
                          v=jnp.asarray(v0, jnp.bfloat16),
                          length=jnp.int32(cap))
    nxt = np.array([7, 9], np.int32)
    jlog, jnew = jax.jit(partial(jtfm.decode_step, cfg=jc))(
        jp, jcache, jnp.asarray(nxt))
    model = R.port_model(tc, jp)
    cache = tfm.KVCache(k=torch.from_numpy(k0).to(torch.bfloat16),
                        v=torch.from_numpy(v0).to(torch.bfloat16),
                        length=cap)
    log, new = tfm.decode_step(model, cache, torch.from_numpy(nxt), tc)
    R.close(log, jlog, R.F32_REL, what="logits at capacity")
    assert new.length == int(jnew.length) == cap + 1
    R.close(new.k, jnew.k, 2.0 ** -8, what="cache k")
    R.close(new.v, jnew.v, 2.0 ** -8, what="cache v")
    # only the last slot changed
    assert torch.equal(new.k[:, :, :cap - 1],
                       torch.from_numpy(k0).to(torch.bfloat16)[:, :, :cap - 1])
    assert not torch.equal(new.k[:, :, cap - 1],
                           torch.from_numpy(k0).to(torch.bfloat16)[:, :,
                                                                   cap - 1])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_flops_equal_reference(arch):
    for which in ("CONFIG", "REDUCED"):
        a = getattr(reg.ARCHES[arch], which)
        b = getattr(jreg.ARCHES[arch], which)
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert a.params_per_layer() == b.params_per_layer()
        for n in (1, 4096 * 256, 32768 * 32):
            for train in (True, False):
                assert a.model_flops(n, train=train) == \
                    b.model_flops(n, train=train)


# ------------------------------------- twins of tests/test_perf_variants ----

def _loss_grads(tc, model, batch):
    model.zero_grad()
    loss, _ = tfm.lm_loss(model, batch, tc)
    loss.backward()
    return float(loss), {k: p.grad.clone()
                         for k, p in model.named_parameters()}


@functools.lru_cache(maxsize=None)
def _variant_setup():
    """qwen3's REDUCED at 4 layers (f32 compute), the reference's grads
    under sqrt remat (groups of 2)."""
    jc, tc = R.configs("qwen3-14b", "f32", n_layers=4)
    jp = R.jax_params("qwen3-14b", 4)
    raw = R.tokens(jc)
    jcs = dataclasses.replace(jc, remat_policy="sqrt", remat_group=2)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.lm_loss(p, R.j(raw), jcs), has_aux=True))(jp)
    return tc, jp, R.t(raw), float(jl), jg


def test_sqrt_remat_matches_layer_remat_and_reference():
    tc, jp, batch, jl, jg = _variant_setup()
    model = R.port_model(tc, jp)
    l1, g1 = _loss_grads(tc, model, batch)
    tcs = dataclasses.replace(tc, remat_policy="sqrt", remat_group=2)
    l2, g2 = _loss_grads(tcs, model, batch)
    l3, g3 = _loss_grads(dataclasses.replace(tc, remat=False), model, batch)
    assert l1 == l2 == l3
    for k in g1:   # recomputation repeats the same ops: bit for bit
        assert torch.equal(g1[k], g2[k]) and torch.equal(g1[k], g3[k]), k
    R.close(l2, jl, 0, rtol=1e-5, what="sqrt remat loss")
    R.close_leaves(g2, jg, R.F32_REL, "sqrt remat gradient")
    with pytest.raises(ValueError, match="remat_group"):
        tfm.lm_forward(model, batch["tokens"], dataclasses.replace(
            tc, remat_policy="sqrt", remat_group=3))


def test_flash_matches_scan_attention():
    tc, jp, batch, _, _ = _variant_setup()
    model = R.port_model(tc, jp)
    l1, g1 = _loss_grads(dataclasses.replace(tc, attn_impl="scan"), model,
                         batch)
    l2, g2 = _loss_grads(tc, model, batch)
    assert abs(l1 - l2) < 1e-5 * abs(l1)
    for k in g1:
        R.close(g2[k], g1[k], R.F32_REL, what=k)


def test_act_sharding_context_is_noop():
    from repro_torch.launch.mesh import make_mesh
    tc, jp, batch, _, _ = _variant_setup()
    model = R.port_model(tc, jp)
    l1, g1 = _loss_grads(tc, model, batch)
    mesh = make_mesh((1,), ("data",), devices=["cpu"])
    with tfm.activation_sharding(mesh, ("data",)):
        l2, g2 = _loss_grads(tc, model, batch)
    assert l1 == l2 and all(torch.equal(g1[k], g2[k]) for k in g1)
