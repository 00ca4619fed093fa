"""Training driver: config -> train loop on one device with
checkpoint/restart, failure injection (for fault-tolerance tests) and
async saves.  Runs on the card unless ``--device cpu`` is given.

Usage (see examples/torch_train_lm.py for a wrapped demo)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --preset smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20
    ...                                  --resume   # restart after a crash

Checkpoints hold ``{"params", "opt": {"m", "v", "step"}, "data":
{"step"}}`` in the reference's layout and leaf order
(``train/checkpoint.py``), so either package's launcher resumes the
other's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from functools import partial

import numpy as np
import torch

from repro_torch.configs import registry as reg
from repro_torch.models import transformer as tfm
from repro_torch.models.params import resolve_device
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod


def preset_config(arch: str, preset: str) -> tfm.LMConfig:
    mod = reg.arch(arch)
    if preset == "full":
        return mod.CONFIG
    if preset == "smoke":
        return mod.REDUCED
    if preset == "100m":   # ~110M-param end-to-end trainable config
        return dataclasses.replace(
            mod.REDUCED, n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
            d_ff=2304, vocab_size=16384, vocab_pad_to=256, moe=None,
            mla=None, attn="gqa", d_head=64, name=arch + "-100m")
    raise ValueError(preset)


def train_tree(model, opt_state: dict, data_step: int) -> dict:
    """The checkpointed state in the reference's tree."""
    return {"params": ckpt_mod.nest(dict(model.named_parameters())),
            "opt": {"m": ckpt_mod.nest(opt_state["m"]),
                    "v": ckpt_mod.nest(opt_state["v"]),
                    "step": opt_state["step"]},
            "data": {"step": torch.tensor(data_step, dtype=torch.int32)}}


def _flat(tree) -> dict:
    return {".".join(map(str, p)): v
            for p, v in ckpt_mod.flat_leaves(tree)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-14b")
    p.add_argument("--preset", default="smoke",
                   choices=["smoke", "100m", "full"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--fail-at-step", type=int, default=0,
                   help="fault-tolerance test: hard-exit at this step")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default the card; 'cpu' to run on "
                        "the host)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = tfm.init_lm(cfg, gen, dev)
    opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=20,
                                  total_steps=args.steps)
    opt_state = opt_mod.adamw_init(dict(model.named_parameters()))
    stream = data_mod.TokenStream(vocab_size=cfg.vocab_size,
                                  batch=args.batch, seq_len=args.seq,
                                  seed=args.seed)
    start_step = 0
    if args.resume and args.ckpt_dir:
        latest = ckpt_mod.latest_step(args.ckpt_dir)
        if latest is not None:
            restored = ckpt_mod.restore(
                train_tree(model, opt_state, 0), args.ckpt_dir,
                device=dev)
            with torch.no_grad():
                for k, v in _flat(restored["params"]).items():
                    model.get_parameter(k).copy_(v)
            opt_state = {"m": _flat(restored["opt"]["m"]),
                         "v": _flat(restored["opt"]["v"]),
                         "step": restored["opt"]["step"]}
            stream.restore({"step": int(restored["data"]["step"])})
            start_step = latest
            print(f"[train] resumed from step {latest}", flush=True)

    step_fn = steps_mod.make_train_step(partial(tfm.lm_loss, cfg=cfg),
                                        opt_cfg, 1)
    saver = ckpt_mod.AsyncSaver()
    n_params = sum(x.numel() for x in model.parameters())
    print(f"[train] arch={cfg.name} params={n_params:,} device={dev} "
          f"steps {start_step}..{args.steps}", flush=True)

    t_start = time.perf_counter()
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.next_batch().items()}
        metrics = step_fn(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if args.fail_at_step and step + 1 == args.fail_at_step:
            print(f"[train] INJECTED FAILURE at step {step + 1}", flush=True)
            sys.stdout.flush()
            os._exit(17)       # hard crash: no cleanup, tests restart cycle
        if (step + 1) % args.log_every == 0:
            dt = time.perf_counter() - t_start
            print(f"[train] step {step+1} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt / (step - start_step + 1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            saver.save(train_tree(model, opt_state, stream.step),
                       args.ckpt_dir, step + 1)
    saver.wait()
    if args.ckpt_dir:
        ckpt_mod.save(train_tree(model, opt_state, stream.step),
                      args.ckpt_dir, args.steps)
        ckpt_mod.cleanup(args.ckpt_dir, keep=2)
    if len(losses) >= 20:
        first = float(np.mean(losses[:10]))
        last = float(np.mean(losses[-10:]))
        print(f"[train] loss first10={first:.4f} last10={last:.4f} "
              f"improved={last < first}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
