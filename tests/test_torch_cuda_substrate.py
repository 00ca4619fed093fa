"""The GNN and recsys substrate on the card against the same code on the
CPU: GraphSAGE, MeshGraphNet, DimeNet, EquiformerV2 and DIN at REDUCED,
one train step each from the same initial parameters (the reduced
smoke's batches), and each GNN's molecule graph loss.

Every test needs a CUDA device and skips without one (decided inside the
test).  Tolerances: on the card ``index_add`` adds with atomics in no
fixed order and cuBLAS sums in its own order (TF32 stays off), so results
are close, not bit-identical: losses and metrics rtol 1e-5; Adam's first
moments (the clipped gradient) atol 1e-5 x the leaf's largest CPU entry,
and at least 1e-6 x the model's largest; parameters after the step atol
1e-6 where the gradient exceeds both 1e-4 x the leaf's largest and that
tolerance, elsewhere within 2 lr.  EquiformerV2's gradients hold to 5e-3
x the leaf's and its gradient norm to rtol 2e-3, for the reason
tests/test_torch_gnn.py gives (its equivariant norm amplifies f32
rounding).

This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_substrate.py
"""
import copy
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as reg
from repro_torch.configs import smoke as smoke_mod
from repro_torch.models import din as din_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod

GNN = ["graphsage-reddit", "meshgraphnet", "dimenet", "equiformer-v2"]
LOOSE = {"equiformer-v2": (5e-3, 2e-3)}   # (gradient x leaf max, norm rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _on(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items()}


def _step_both(model, loss_fn, batch, dev):
    """One train step on the CPU and on the card from the same state."""
    step = steps_mod.make_train_step(loss_fn, smoke_mod.SMOKE_OPT, 1)
    card = copy.deepcopy(model).to(dev)
    old = {k: p.detach().clone() for k, p in model.named_parameters()}
    out = []
    for m, d in ((model, "cpu"), (card, dev)):
        state = opt_mod.adamw_init(dict(m.named_parameters()))
        metrics = step(m, state, _on(batch, d))
        out.append((m, state, {k: float(v) for k, v in metrics.items()}))
    return old, out


def _check(old, out, grad_rel=1e-5, norm_rtol=1e-5):
    (cpu, cs, cm), (card, ks, km) = out
    assert next(card.parameters()).device.type == "cuda"
    for k in cm:
        rtol = norm_rtol if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(km[k], cm[k], rtol=rtol, err_msg=k)
    m_cpu = {k: v.numpy() for k, v in cs["m"].items()}
    floor = 1e-6 * max(float(np.abs(v).max()) for v in m_cpu.values())
    lr = cm["lr"]
    card_p = dict(card.named_parameters())
    for k, p in cpu.named_parameters():
        g = np.abs(m_cpu[k])
        atol = max(grad_rel * float(g.max()), floor)
        np.testing.assert_allclose(ks["m"][k].cpu().numpy(), m_cpu[k],
                                   rtol=0, atol=atol, err_msg=f"m {k}")
        big = g > max(1e-4 * g.max(), atol)
        got, want = card_p[k].detach().cpu().numpy(), p.detach().numpy()
        np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert np.all(np.abs(got - old[k].numpy())[~big] <= 2 * lr), k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GNN)
def test_gnn_train_step_card_vs_cpu(cuda, arch):
    cfg = reg.ARCHES[arch].REDUCED
    node_loss, graph_loss, init_fn, _, _ = reg._GNN_FNS[arch]
    flat, mol = smoke_mod.smoke_batches(arch, seed=0)
    model = init_fn(cfg, torch.Generator().manual_seed(0), "cpu")
    old, out = _step_both(model, partial(node_loss, cfg=cfg), flat, cuda)
    _check(old, out, *LOOSE.get(arch, (1e-5, 1e-5)))
    (cpu, _, _), (card, _, _) = out
    with torch.no_grad():
        want, _ = graph_loss(cpu, _on(mol, "cpu"), cfg)
        got, _ = graph_loss(card, _on(mol, cuda), cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.cuda
def test_din_train_step_card_vs_cpu(cuda):
    cfg = reg.ARCHES["din"].REDUCED
    batch = data_mod.ClickStream(n_items=cfg.n_items, n_cates=cfg.n_cates,
                                 batch=64, seq_len=cfg.seq_len,
                                 seed=1).next_batch()
    model = din_mod.init_din(cfg, torch.Generator().manual_seed(0), "cpu")
    old, out = _step_both(model, partial(din_mod.din_loss, cfg=cfg), batch,
                          cuda)
    _check(old, out)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GNN + ["din"])
def test_smoke_on_the_card(cuda, arch):
    metrics = smoke_mod.smoke(arch, seed=0)
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["loss"] > 0.0
