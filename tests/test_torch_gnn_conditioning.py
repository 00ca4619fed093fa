"""EquiformerV2's conditioning, which sets its looser tolerances in
tests/test_torch_gnn.py and chip_smoke.py phase 15 (ROADMAP F4).

Only the l = 0 slot of its node features is ever non-zero, and its
equivariant norm divides every coefficient by sqrt(sum of squares +
1e-6): a derivative of up to 1e3, twice a layer.  At REDUCED (2 layers)
the reference's f32 gradients are therefore far from exact arithmetic —
beyond the default gradient tolerance of 1e-5 x a leaf's largest entry,
within the 5e-3 that tests/test_torch_gnn.py grants EquiformerV2 — and at
12 layers the backward overflows, so both packages give NaN gradients
(the embedding's and the stacked blocks'; the head's stay finite).  The
exact values are the port run in f64 (the reference's own f32 casts in
the bases, norms and softmax kept)."""
import copy
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.models.gnn import equiformer as jeq
from repro_torch.configs import registry as reg
from repro_torch.configs import smoke as smoke_mod
from repro_torch.models.gnn import equiformer as teq
from repro_torch.models.params import load_jax_params, params_from_jax


def _both(cfg, flat):
    jparams = jax.jit(jeq.init_eqv2, static_argnums=1)(jax.random.key(0),
                                                      cfg)
    jb = {k: jnp.asarray(v) for k, v in flat.items()}
    jgrads = jax.jit(jax.grad(lambda p: jeq.eqv2_node_loss(p, jb, cfg)[0]))(
        jparams)
    tcfg = teq.EqV2Config(**dataclasses.asdict(cfg))
    model = load_jax_params(teq.init_eqv2(tcfg, device="cpu"), jparams)
    return ({k: v.numpy() for k, v in params_from_jax(jgrads).items()},
            model, tcfg)


def _grads(model, flat, cfg, dtype):
    b = {k: torch.as_tensor(v) for k, v in flat.items()}
    if dtype == torch.float64:
        model = copy.deepcopy(model).double()
        b = {k: v.double() if v.is_floating_point() else v
             for k, v in b.items()}
    loss, _ = teq.eqv2_node_loss(model, b, cfg)
    loss.backward()
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def test_reduced_gradients_are_ill_conditioned():
    flat, _ = smoke_mod.smoke_batches("equiformer-v2", seed=0)
    cfg = reg.ARCHES["equiformer-v2"].REDUCED
    ref32, model, tcfg = _both(cfg, flat)
    exact = _grads(model, flat, tcfg, torch.float64)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in exact.values())
    worst = max(float(np.abs(ref32[k] - g).max())
                / max(float(np.abs(g).max()), floor)
                for k, g in exact.items())
    assert 1e-5 < worst < 5e-3, worst


def test_full_depth_gradients_are_nan_in_both():
    flat, _ = smoke_mod.smoke_batches("equiformer-v2", seed=0)
    cfg = jeq.EqV2Config(n_layers=12, d_hidden=16, l_max=6, m_max=2,
                         n_heads=2, d_in=8, n_out=4)
    ref, model, tcfg = _both(cfg, flat)
    ours = _grads(model, flat, tcfg, torch.float32)
    nan_ref = {k for k, g in ref.items() if np.isnan(g).any()}
    nan_ours = {k for k, g in ours.items() if np.isnan(g).any()}
    assert nan_ref == nan_ours
    assert {"embed.w.0", "blocks.so2_w0", "blocks.ffn_mix"} <= nan_ref
    assert not any(k.startswith("head.") for k in nan_ref)
