"""DIN recsys serving demo on the PyTorch port: train briefly, then serve
batched requests and run candidate retrieval (the serve_p99 /
retrieval_cand shapes, reduced).

Run: PYTHONPATH=src python examples/torch_serve_din.py [--device cpu]
(the card by default).
"""
import argparse
import time
from functools import partial

import numpy as np
import torch

from repro_torch.configs import din as din_cfg
from repro_torch.models import din as din_mod
from repro_torch.models.params import resolve_device
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the same "
                         "code on the CPU)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def on_device(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    cfg = din_cfg.REDUCED
    stream = data_mod.ClickStream(n_items=cfg.n_items, n_cates=cfg.n_cates,
                                  batch=256, seq_len=cfg.seq_len, seed=0)
    model = din_mod.init_din(cfg, torch.Generator().manual_seed(0), dev)
    step = steps_mod.make_train_step(
        partial(din_mod.din_loss, cfg=cfg),
        opt_mod.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=400), 1)
    opt_state = opt_mod.adamw_init(dict(model.named_parameters()))
    print(f"training DIN on the synthetic click stream ({dev}) ...")
    acc = None
    for i in range(400):
        m = step(model, opt_state, on_device(stream.next_batch()))
        if (i + 1) % 50 == 0:
            acc = float(m["acc"])
            print(f"  step {i+1}: loss {float(m['loss']):.4f} acc {acc:.3f}")
    assert acc > 0.55, "DIN failed to learn the planted preference structure"

    # --- batched online scoring (serve_p99 shape, reduced)
    batch = on_device({k: v for k, v in stream.next_batch().items()
                       if k != "labels"})
    with torch.no_grad():
        din_mod.din_score(model, batch, cfg)   # warm-up
        sync()
        lats = []
        for _ in range(20):
            t0 = time.perf_counter()
            din_mod.din_score(model, batch, cfg)
            sync()
            lats.append(time.perf_counter() - t0)
    print(f"serve: batch=256 p50 {np.median(lats)*1e3:.2f}ms "
          f"p99 {np.percentile(lats, 99)*1e3:.2f}ms")

    # --- retrieval: one user vs many candidates, one (C, S) interaction
    rng = np.random.default_rng(0)
    n_cand = 50_000
    rbatch = on_device({
        "hist_items": rng.integers(0, cfg.n_items, cfg.seq_len).astype(
            np.int32),
        "hist_cates": rng.integers(0, cfg.n_cates, cfg.seq_len).astype(
            np.int32),
        "hist_mask": np.ones((cfg.seq_len,), bool),
        "cand_items": rng.integers(0, cfg.n_items, n_cand).astype(np.int32),
        "cand_cates": rng.integers(0, cfg.n_cates, n_cand).astype(np.int32),
    })
    with torch.no_grad():
        din_mod.din_retrieval(model, rbatch, cfg)   # warm-up
        sync()
        t0 = time.perf_counter()
        scores = din_mod.din_retrieval(model, rbatch, cfg)
        sync()
        dt = time.perf_counter() - t0
    top = np.argsort(scores.cpu().numpy())[-5:][::-1]
    print(f"retrieval: {n_cand} candidates in {dt*1e3:.1f}ms "
          f"({n_cand/dt/1e6:.2f}M cand/s); top-5 ids {top.tolist()}")


if __name__ == "__main__":
    main()
