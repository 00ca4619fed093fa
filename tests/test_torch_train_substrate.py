"""The port's training substrate (``repro_torch.train``) against the JAX
package's: the warmup + cosine schedule, ``adamw_update`` over 5 steps
with the clip active and inactive, ``make_train_step`` with grad_accum 1
and 4 on a small MLP loss, and the token and click streams (batches equal
array for array, and again after ``restore``).

Tolerances: the schedule rtol 1e-6 (both evaluate it in f32, with cos
from different libraries); AdamW's parameters and moments rtol 1e-6, atol
1e-7 x the largest reference entry, over 5 steps (f32 elementwise ops; XLA
may fuse them into fused multiply-adds where torch rounds each op); the
train step's metrics rtol 1e-5, its parameters as the GNN tests hold them
(tests/test_torch_gnn.py): atol 1e-6 where the reference's gradient
exceeds 1e-4 x its largest entry, elsewhere within 2 lr.  The streams
are host numpy on both sides: exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.models.params import adamw_state_from_jax, params_from_jax
from repro_torch.models.params import ParamTree
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod

CFG = dict(lr=1e-2, warmup_steps=10, total_steps=50, min_lr_frac=0.1)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 30, 49, 50, 51, 200])
def test_schedule_matches_reference(step):
    want = jopt.schedule(jnp.int32(step), jopt.AdamWConfig(**CFG))
    got = opt_mod.schedule(torch.tensor(step, dtype=torch.int32),
                           opt_mod.AdamWConfig(**CFG))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got.dtype == torch.float32


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": [rng.standard_normal((6, 4)).astype(np.float32),
                  rng.standard_normal((4, 3)).astype(np.float32)],
            "b": rng.standard_normal(3).astype(np.float32),
            "emb": {"table": (0.01 * rng.standard_normal((10, 4)))
                    .astype(np.float32)}}


def _close(got: dict, want: dict, rtol=1e-6, rel=1e-7, what=""):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(
            got[k].detach().numpy(), w, rtol=rtol,
            atol=rel * float(np.abs(w).max()), err_msg=f"{what} {k}")


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_five_steps(clip):
    cfg = dict(CFG, warmup_steps=2, grad_clip=clip, weight_decay=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), opt_mod.AdamWConfig(**cfg)
    jparams = jax.tree.map(jnp.asarray, _tree(0))
    jstate = jopt.adamw_init(jparams)
    params = params_from_jax(jparams)
    state = adamw_state_from_jax(jstate, device="cpu")
    norms = []
    for i in range(5):
        g = jax.tree.map(jnp.asarray, _tree(10 + i))
        jparams, jstate, jm = jopt.adamw_update(g, jstate, jparams, jcfg)
        tm = opt_mod.adamw_update(params_from_jax(g), state, params, tcfg)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]),
                                   rtol=1e-6)
        norms.append(float(jm["grad_norm"]))
    assert int(state["step"]) == int(jstate["step"]) == 5
    assert state["step"].dtype == torch.int32
    _close(params, params_from_jax(jparams), what="params")
    _close(state["m"], params_from_jax(jstate["m"]), what="m")
    _close(state["v"], params_from_jax(jstate["v"]), what="v")
    # the clip was active at every step, or at none
    assert all((n > clip) == (clip < 1) for n in norms)


def _mlp_loss_jax(params, batch):
    h = jax.nn.silu(batch["x"] @ params["w"][0] + params["b"][0])
    y = h @ params["w"][1] + params["b"][1]
    loss = jnp.mean((y - batch["y"]) ** 2)
    return loss, {"loss": loss, "mae": jnp.mean(jnp.abs(y - batch["y"]))}


def _mlp_loss_torch(model, batch):
    h = torch.nn.functional.silu(batch["x"] @ model.w[0] + model.b[0])
    y = h @ model.w[1] + model.b[1]
    loss = torch.mean((y - batch["y"]) ** 2)
    return loss, {"loss": loss, "mae": torch.mean(torch.abs(y - batch["y"]))}


@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_reference(accum):
    rng = np.random.default_rng(3)
    tree = {"w": [rng.standard_normal((5, 8)).astype(np.float32) / 2,
                  rng.standard_normal((8, 2)).astype(np.float32) / 3],
            "b": [np.zeros(8, np.float32), np.zeros(2, np.float32)]}
    x = rng.standard_normal((16, 5)).astype(np.float32)
    y = rng.standard_normal((16, 2)).astype(np.float32)
    batch = ({"x": x, "y": y} if accum == 1 else
             {"x": x.reshape(accum, -1, 5), "y": y.reshape(accum, -1, 2)})
    cfg = dict(lr=1e-2, warmup_steps=0)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(jsteps.make_train_step(
        _mlp_loss_jax, jopt.AdamWConfig(**cfg), accum))
    jnew, jstate, jm = jstep(jparams, jopt.adamw_init(jparams),
                             jax.tree.map(jnp.asarray, batch))
    model = ParamTree({k: [torch.tensor(a) for a in v]
                       for k, v in tree.items()})
    state = opt_mod.adamw_init(dict(model.named_parameters()))
    step = steps_mod.make_train_step(_mlp_loss_torch,
                                     opt_mod.AdamWConfig(**cfg), accum)
    metrics = step(model, state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert set(metrics) == set(jm) == {"loss", "mae", "grad_norm", "lr"}
    for k in jm:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, err_msg=k)
    g = {k: np.abs(np.asarray(v)) / 0.1
         for k, v in params_from_jax(jstate["m"]).items()}
    new, old = params_from_jax(jnew), params_from_jax(jparams)
    for k, p in model.named_parameters():
        big = g[k] > 1e-4 * g[k].max()
        got = p.detach().numpy()
        np.testing.assert_allclose(got[big], new[k].numpy()[big], rtol=0,
                                   atol=1e-6, err_msg=k)
        assert np.all(np.abs(got - old[k].numpy())[~big] <= 2 * cfg["lr"])


def test_grad_accum_matches_full_batch():
    """As the reference's own test: 4 microbatches of 2 = one batch of 8."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))

    def loss(model, batch):
        out = batch["x"] @ model.w
        l = torch.mean(out * out)
        return l, {"loss": l}

    cfg = opt_mod.AdamWConfig(lr=1e-2, warmup_steps=0)
    m1, m4 = ParamTree({"w": w.clone()}), ParamTree({"w": w.clone()})
    steps_mod.make_train_step(loss, cfg, 1)(
        m1, opt_mod.adamw_init(dict(m1.named_parameters())), {"x": x})
    steps_mod.make_train_step(loss, cfg, 4)(
        m4, opt_mod.adamw_init(dict(m4.named_parameters())),
        {"x": x.reshape(4, 2, 4)})
    np.testing.assert_allclose(m1.w.detach().numpy(), m4.w.detach().numpy(),
                               rtol=2e-5, atol=2e-6)


def test_eval_step_returns_metrics_without_grad():
    model = ParamTree({"w": torch.ones(3)})
    ev = steps_mod.make_eval_step(
        lambda m, b: (m.w.sum(), {"loss": m.w.sum() * b["s"]}))
    out = ev(model, {"s": 2.0})
    assert float(out["loss"]) == 6.0 and not out["loss"].requires_grad


@pytest.mark.parametrize("kind", ["token", "click"])
def test_streams_equal_reference_and_restore(kind):
    if kind == "token":
        kw = dict(vocab_size=97, batch=4, seq_len=16, seed=3)
        ours, ref = data_mod.TokenStream(**kw), jdata.TokenStream(**kw)
    else:
        kw = dict(n_items=1000, n_cates=16, batch=8, seq_len=12, seed=3)
        ours, ref = data_mod.ClickStream(**kw), jdata.ClickStream(**kw)
    first = [ours.next_batch() for _ in range(3)]
    for b in first:
        want = ref.next_batch()
        assert set(b) == set(want)
        for k in want:
            np.testing.assert_array_equal(b[k], want[k])
            assert b[k].dtype == want[k].dtype
    assert ours.state() == ref.state() == {"step": 3}
    ours.restore({"step": 1})
    for b in first[1:]:
        again = ours.next_batch()
        for k in b:
            np.testing.assert_array_equal(again[k], b[k])
