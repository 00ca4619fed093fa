"""DIN in the port (``repro_torch.models.din``) against the JAX package's
at the REDUCED config: the forward's logits, the loss and accuracy,
``din_score``, ``din_retrieval``, the gradients of every parameter (the
item table's dense gradient included) and one train step; the reference's
initial parameters carried in (``load_jax_params``), batches from the
click stream.  Also the serving example ``examples/torch_serve_din.py``
on the CPU, run to its accuracy assertion.

Tolerances (f32 on both sides, different summation orders): outputs,
losses and metrics rtol 1e-5, atol 1e-6 x the largest reference entry;
gradients atol 1e-5 x the largest entry of the leaf's reference gradient;
parameters after one step atol 1e-6 where the reference's gradient
exceeds 1e-4 x its largest entry, elsewhere within 2 lr (Adam's first
step is the gradient's sign).
"""
import functools
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import din as jdin
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import din as c_din
from repro_torch.models import din as din_mod
from repro_torch.models.params import load_jax_params, params_from_jax
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod

ROOT = Path(__file__).resolve().parents[1]
CFG = c_din.REDUCED
OPT = dict(warmup_steps=2, total_steps=10)


def close(got, want, rtol=1e-5, rel=1e-6, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.jit(jdin.init_din, static_argnums=1)(jax.random.key(0), CFG)


def _setup(batch=32, seed=1):
    jparams = _jax_params()
    model = load_jax_params(din_mod.init_din(CFG, device="cpu"), jparams)
    b = data_mod.ClickStream(n_items=CFG.n_items, n_cates=CFG.n_cates,
                             batch=batch, seq_len=CFG.seq_len,
                             seed=seed).next_batch()
    return jparams, model, b


def _t(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_forward_loss_and_score():
    jparams, model, b = _setup()
    with torch.no_grad():
        close(din_mod.din_forward(model, _t(b), CFG),
              jdin.din_forward(jparams, _j(b), CFG), what="logits")
        close(din_mod.din_score(model, _t(b), CFG),
              jdin.din_score(jparams, _j(b), CFG), what="score")
        loss, m = din_mod.din_loss(model, _t(b), CFG)
    jl, jm = jdin.din_loss(jparams, _j(b), CFG)
    close(loss, jl, what="loss")
    close(m["acc"], jm["acc"], what="acc")


@pytest.mark.parametrize("n_cand", [1, 64, 1000])
def test_retrieval(n_cand):
    jparams, model, _ = _setup()
    rng = np.random.default_rng(n_cand)
    rb = {"hist_items": rng.integers(0, CFG.n_items, CFG.seq_len),
          "hist_cates": rng.integers(0, CFG.n_cates, CFG.seq_len),
          "hist_mask": rng.random(CFG.seq_len) < 0.7,
          "cand_items": rng.integers(0, CFG.n_items, n_cand),
          "cand_cates": rng.integers(0, CFG.n_cates, n_cand)}
    rb = {k: v.astype(np.int32) if v.dtype != bool else v
          for k, v in rb.items()}
    with torch.no_grad():
        got = din_mod.din_retrieval(model, _t(rb), CFG)
    assert tuple(got.shape) == (n_cand,)
    close(got, jdin.din_retrieval(jparams, _j(rb), CFG), what="retrieval")


def test_gradients_every_leaf():
    jparams, model, b = _setup(batch=64)
    jg = jax.grad(lambda p: jdin.din_loss(p, _j(b), CFG)[0])(jparams)
    loss, _ = din_mod.din_loss(model, _t(b), CFG)
    loss.backward()
    want = params_from_jax(jg)
    got = dict(model.named_parameters())
    assert set(got) == set(want) == {
        "item_emb", "cate_emb", "attn.w.0", "attn.w.1", "attn.w.2",
        "attn.b.0", "attn.b.1", "attn.b.2", "mlp.w.0", "mlp.w.1", "mlp.w.2",
        "mlp.b.0", "mlp.b.1", "mlp.b.2"}
    assert got["item_emb"].grad.layout == torch.strided   # dense
    for k, g in want.items():
        close(got[k].grad, g.numpy(), rtol=0, rel=1e-5, what=f"grad {k}")


def test_train_step_matches_reference():
    jparams, model, b = _setup(batch=64)
    jcfg, tcfg = jopt.AdamWConfig(**OPT), opt_mod.AdamWConfig(**OPT)
    loss_j = lambda p, bb: jdin.din_loss(p, bb, CFG)   # noqa: E731
    jnew, jstate, jm = jax.jit(jsteps.make_train_step(loss_j, jcfg, 1))(
        jparams, jopt.adamw_init(jparams), _j(b))
    step = steps_mod.make_train_step(partial(din_mod.din_loss, cfg=CFG),
                                     tcfg, 1)
    state = opt_mod.adamw_init(dict(model.named_parameters()))
    metrics = step(model, state, _t(b))
    for k in ("loss", "acc", "grad_norm", "lr"):
        close(metrics[k], jm[k], what=k)
    lr = float(jm["lr"])
    g = {k: np.abs(v.numpy()) / (1 - jcfg.b1)
         for k, v in params_from_jax(jstate["m"]).items()}
    new, old = params_from_jax(jnew), params_from_jax(jparams)
    for k, p in model.named_parameters():
        big = g[k] > 1e-4 * g[k].max()
        got = p.detach().numpy()
        np.testing.assert_allclose(got[big], new[k].numpy()[big], rtol=0,
                                   atol=1e-6, err_msg=k)
        assert np.all(np.abs(got - old[k].numpy())[~big] <= 2 * lr), k


def test_serve_example_trains_and_serves_on_cpu():
    # one intra-op thread: the reduced model is tiny, and the suite's
    # parallel workers would otherwise oversubscribe the cores
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_din.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step 400:" in out.stdout and "serve: batch=256" in out.stdout
    assert "retrieval: 50000 candidates" in out.stdout
