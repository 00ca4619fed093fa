"""Helpers shared by the LM tests of the port (``tests/test_torch_*``): the
reference's parameters built once per config, configs in both packages at
a chosen compute dtype, seeded token batches, and the tolerance checks.

Tolerances, stated once for every LM test file:

* f32 compute: outputs and gradients within 1e-5 of the tensor's largest
  entry (``F32_REL``), losses rtol 1e-5.  XLA and torch sum in different
  orders, nothing more.
* bf16 compute (the configs' own): XLA:CPU fuses elementwise chains in
  f32 and rounds once where torch rounds every op to bf16, so the two
  drift by bf16 ulps a layer: logits within 3e-2 of the largest logit
  (``BF16_OUT``), gradients within 6e-2 of the leaf's largest entry
  (``BF16_GRAD``), losses rtol 2e-3 (``BF16_LOSS``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import transformer as jtfm
from repro_torch.configs import registry as reg
from repro_torch.models import transformer as tfm
from repro_torch.models.params import load_jax_params, params_from_jax

LM_ARCHS = ["qwen3-14b", "olmoe-1b-7b", "minicpm3-4b", "mistral-large-123b",
            "moonshot-v1-16b-a3b"]
F32_REL = 1e-5
BF16_OUT, BF16_GRAD, BF16_LOSS = 3e-2, 6e-2, 2e-3


def configs(arch: str, dtype: str = "bf16", **kw):
    """(reference config, port config) at REDUCED, compute in ``dtype``
    ("f32" or the configs' own "bf16"), with ``kw`` replaced in both."""
    jc, tc = jreg.ARCHES[arch].REDUCED, reg.ARCHES[arch].REDUCED
    if dtype == "f32":
        kw = dict(kw)
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32, **kw)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32, **kw)
    elif kw:
        jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    return jc, tc


@functools.lru_cache(maxsize=None)
def jax_params(arch: str, n_layers: int | None = None):
    """The reference's initial parameters (jitted: the eager vmapped init
    takes seconds)."""
    cfg = jreg.ARCHES[arch].REDUCED
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jax.jit(jtfm.init_lm, static_argnums=1)(jax.random.key(0), cfg)


def port_model(tcfg, jparams) -> tfm.LM:
    """The port's LM on the CPU holding the reference's parameters."""
    return load_jax_params(tfm.init_lm(tcfg, device="cpu"), jparams)


def tokens(cfg, B: int = 2, S: int = 16, seed: int = 0) -> dict:
    """Seeded tokens and labels (label -1 = masked, about one in 8)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.125] = -1
    return {"tokens": toks, "labels": labels}


def t(batch: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(got, want, rel: float, rtol: float = 0.0, what: str = ""):
    """|got - want| <= rtol |want| + rel x max|want|."""
    got, want = np32(got), np32(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel * scale,
                               err_msg=what)


def close_leaves(got: dict, want_tree, rel: float, what: str = ""):
    """Every leaf of ``got`` ({path: tensor}) against the reference tree's,
    within ``rel`` of that leaf's largest entry (and at least 1e-6 of the
    largest entry of any leaf: a leaf whose exact value is 0 holds rounding
    noise alone)."""
    want = {k: v.numpy() for k, v in params_from_jax(want_tree).items()}
    assert set(got) == set(want), (what, set(got) ^ set(want))
    floor = 1e-6 * max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        atol = max(rel * float(np.abs(w).max()), floor)
        np.testing.assert_allclose(np32(got[k]), w, rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")
