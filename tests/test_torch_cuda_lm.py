"""The LM substrate on the card against the same code on the CPU: each of
the five LM archs at REDUCED, one AdamW train step from the same initial
parameters (f32 compute and the configs' bf16), prefill and decode on the
card, and flash attention's forward and backward; the smoke and the
launcher's crash-and-resume cycle on the card.

Every test needs a CUDA device and skips without one (decided inside the
test).  Tolerances: TF32 stays off, so f32 runs SGEMM on the card; cuBLAS
and ``index_add``'s atomics sum in their own orders, so results are close,
not bit-identical.  f32: losses and metrics rtol 1e-5, grad norm rtol
1e-4, Adam's first moments within 1e-5 of the leaf's largest CPU entry
(and 1e-6 of the model's largest), logits and flash's outputs and
gradients within 1e-5 of the largest entry, the bf16 decode cache within
one bf16 ulp (2^-8) of its largest entry; decode from each device's own
bf16 cache (the GQA and MLA archs) within the bf16 logit tolerance 3e-2
of the largest logit.  bf16 (cuBLAS and the CPU
round bf16 products and sums differently): loss rtol 2e-3, grad norm rtol
1e-2 — the bf16 tolerances of tests/_lm_ref.py.
MoE routing is discontinuous, so a bf16 step of the MoE archs is held by
its loss and grad norm alone.

This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_lm.py
"""
import copy
import dataclasses
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as reg
from repro_torch.configs import smoke as smoke_mod
from repro_torch.models import flash, layers
from repro_torch.models import transformer as tfm
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod

ROOT = Path(__file__).resolve().parents[1]
LM = ["qwen3-14b", "olmoe-1b-7b", "minicpm3-4b", "mistral-large-123b",
      "moonshot-v1-16b-a3b"]
OPT = opt_mod.AdamWConfig(warmup_steps=2, total_steps=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _cfg(arch, dtype):
    cfg = reg.arch(arch).REDUCED
    if dtype == "f32":
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    return cfg


def _batch(cfg, B=4, S=32, seed=1):
    return data_mod.TokenStream(vocab_size=cfg.vocab_size, batch=B,
                                seq_len=S, seed=seed).next_batch()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", LM)
def test_train_step_card_vs_cpu(cuda, arch, dtype):
    cfg = _cfg(arch, dtype)
    model = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(model).to(cuda)
    batch = _batch(cfg)
    step = steps_mod.make_train_step(partial(tfm.lm_loss, cfg=cfg), OPT, 1)
    out = []
    for m, dev in ((model, "cpu"), (card, cuda)):
        state = opt_mod.adamw_init(dict(m.named_parameters()))
        metrics = step(m, state, {k: torch.as_tensor(v, device=dev)
                                  for k, v in batch.items()})
        out.append((state, {k: float(v) for k, v in metrics.items()}))
    (cs, cm), (ks, km) = out
    f32 = dtype == "f32"
    np.testing.assert_allclose(km["loss"], cm["loss"],
                               rtol=1e-5 if f32 else 2e-3)
    np.testing.assert_allclose(km["grad_norm"], cm["grad_norm"],
                               rtol=1e-4 if f32 else 1e-2)
    if not f32:
        return
    m_cpu = {k: v.numpy() for k, v in cs["m"].items()}
    floor = 1e-6 * max(float(np.abs(v).max()) for v in m_cpu.values())
    for k, g in m_cpu.items():
        atol = max(1e-5 * float(np.abs(g).max()), floor)
        np.testing.assert_allclose(ks["m"][k].cpu().numpy(), g, rtol=0,
                                   atol=atol, err_msg=k)


def _copy(cache, device):
    """A copy of ``cache`` on ``device`` (decode_step writes in place)."""
    return tfm.KVCache(k=cache.k.to(device, copy=True),
                       v=cache.v.to(device, copy=True), length=cache.length)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM)
def test_prefill_and_decode_card_vs_cpu(cuda, arch):
    cfg = _cfg(arch, "f32")
    model = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(model).to(cuda)
    toks = torch.as_tensor(_batch(cfg, B=2, S=12)["tokens"])
    nxt = torch.tensor([3, 5], dtype=torch.int32)
    res, caches = [], []
    for m, dev in ((model, "cpu"), (card, cuda)):
        log, cache = tfm.prefill(m, toks.to(dev), cfg, capacity=16)
        res.append((log.cpu(), cache.k.float().cpu(), cache.v.float().cpu()))
        caches.append(cache)
    # prefill logits to f32's tolerance; the bf16 cache within one bf16 ulp
    # of its largest entry (the two round f32 values differing in the last
    # bits)
    for a, b, rel in zip(*res, (1e-5, 2.0 ** -8, 2.0 ** -8)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=rel * float(a.abs().max()))
    # a decode step from the same (the CPU's) cache on both devices: the
    # decode arithmetic alone, to f32's tolerance
    want, _ = tfm.decode_step(model, _copy(caches[0], "cpu"), nxt, cfg)
    got, new = tfm.decode_step(card, _copy(caches[0], cuda), nxt.to(cuda),
                               cfg)
    assert new.length == 13
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    if cfg.moe is not None:
        # the caches' last-bit differences can flip a near-tied router
        # choice, so the MoE archs stop at the shared cache
        return
    # each device decodes three steps from its own prefill cache: the
    # caches differ by up to one bf16 ulp, so the logits are held to the
    # bf16 logit tolerance (3e-2 of the largest)
    for step in range(3):
        tok = nxt + step
        want, caches[0] = tfm.decode_step(model, caches[0], tok, cfg)
        got, caches[1] = tfm.decode_step(card, caches[1], tok.to(cuda), cfg)
        assert caches[1].length == 13 + step
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=3e-2 * float(want.abs().max()),
                                   err_msg=f"own cache, step {step}")


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv,D,Dv", [(8, 2, 16, 16), (4, 4, 24, 8)])
def test_flash_card_vs_cpu(cuda, nq, nkv, D, Dv):
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 40, nq, D), (2, 40, nkv, D), (2, 40, nkv, Dv))]
    w = rng.standard_normal((2, 40, nq, Dv)).astype(np.float32)
    res = []
    for dev in ("cpu", cuda):
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in arrs]
        out = flash.flash_attention(*ts, True, 16)
        grads = torch.autograd.grad(out, ts, torch.tensor(w, device=dev))
        res.append([out.detach().cpu()] + [g.cpu() for g in grads])
        ref = layers.attention_ref(*ts, causal=True)
        np.testing.assert_allclose(out.detach().cpu().numpy(),
                                   ref.detach().cpu().numpy(), rtol=2e-5,
                                   atol=2e-5)
    for a, b in zip(*res):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-5 * float(a.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM)
def test_smoke_on_the_card(cuda, arch):
    metrics = smoke_mod.smoke(arch, seed=0)
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["loss"] > 0.0


@pytest.mark.cuda
def test_launcher_crash_and_resume_on_the_card(cuda, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    args = [sys.executable, "-m", "repro_torch.launch.train", "--steps", "8",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(args + ["--fail-at-step", "5"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 17, out.stderr[-2000:]
    out = subprocess.run(args + ["--resume"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resumed from step 4" in out.stdout and "device=cuda" in out.stdout
