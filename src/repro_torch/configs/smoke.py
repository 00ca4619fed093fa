"""Reduced-config smoke programs: real (tiny) tensors, one train step on
one device (``device``, default the card; tests pass ``"cpu"``).

Every architecture gets: init -> one train step (forward + backward +
AdamW) -> metric dict, plus a decode step for the LM family, the molecule
graph loss for the GNNs and retrieval for DIN.  The SSSP family has its
own tests and no smoke.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.configs import registry as reg
from repro_torch.graphs import generators as gen
from repro_torch.graphs import triplets as tri_mod
from repro_torch.models import din as din_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.params import resolve_device
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod

SMOKE_OPT = opt_mod.AdamWConfig(warmup_steps=2, total_steps=10)


def _on(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in arrays.items()}


def _host(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def smoke_lm(arch_id: str, seed: int = 0, device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = reg.arch(arch_id).REDUCED
    model = tfm.init_lm(cfg, torch.Generator().manual_seed(seed), dev)
    stream = data_mod.TokenStream(vocab_size=cfg.vocab_size, batch=2,
                                  seq_len=16, seed=seed)
    step = steps_mod.make_train_step(partial(tfm.lm_loss, cfg=cfg),
                                     SMOKE_OPT, 1)
    opt_state = opt_mod.adamw_init(dict(model.named_parameters()))
    metrics = step(model, opt_state, _on(stream.next_batch(), dev))

    # decode: 3 tokens against a small cache
    cache = tfm.init_cache(cfg, batch=2, capacity=8, device=dev)
    for t in range(3):
        tok = torch.full((2,), t + 1, dtype=torch.int32, device=dev)
        logits, cache = tfm.decode_step(model, cache, tok, cfg)
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    metrics["decode_finite"] = torch.all(torch.isfinite(logits.float()))
    return _host(metrics)


def _small_graph(seed=0, n=24, m=64):
    n, src, dst, w = gen.erdos_renyi(n, m, seed=seed)
    rng = np.random.default_rng(seed)
    d_in = 8
    return {
        "n": n, "src": src.astype(np.int32), "dst": dst.astype(np.int32),
        "feats": rng.normal(size=(n, d_in)).astype(np.float32),
        "pos": rng.normal(size=(n, 3)).astype(np.float32),
        "labels": rng.integers(0, 4, n).astype(np.int32),
        "label_mask": np.ones(n, bool),
        "edge_mask": np.ones(len(src), bool),
    }


def smoke_batches(arch_id: str, seed: int = 0) -> tuple[dict, dict]:
    """The smoke's flat graph batch and its 3-molecule batch, as numpy."""
    needs_tri = reg._GNN_FNS[arch_id][4]
    g = _small_graph(seed)
    batch = {k: v for k, v in g.items() if k != "n"}
    if needs_tri:
        batch["t_kj"], batch["t_ji"], batch["triplet_mask"] = \
            tri_mod.build_triplets(g["n"], g["src"], g["dst"], budget=256,
                                   per_edge_cap=4, seed=seed)
    B = 3
    gs = [_small_graph(seed + i, n=10, m=20) for i in range(B)]
    mol = {
        "feats": np.stack([g["feats"][:10] for g in gs]),
        "pos": np.stack([g["pos"][:10] for g in gs]),
        "src": np.stack([g["src"][:20] % 10 for g in gs]),
        "dst": np.stack([g["dst"][:20] % 10 for g in gs]),
        "edge_mask": np.stack([g["edge_mask"][:20] for g in gs]),
        "target": np.zeros((B,), np.float32),
    }
    if needs_tri:
        tris = [tri_mod.build_triplets(10, mol["src"][i], mol["dst"][i],
                                       budget=64, per_edge_cap=4,
                                       seed=seed + i) for i in range(B)]
        for k, parts in zip(("t_kj", "t_ji", "triplet_mask"), zip(*tris)):
            mol[k] = np.stack(parts)
    return batch, mol


def smoke_gnn(arch_id: str, seed: int = 0, device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = reg.arch(arch_id).REDUCED
    node_loss, graph_loss, init_fn, _, _ = reg._GNN_FNS[arch_id]
    flat, mol = smoke_batches(arch_id, seed)
    model = init_fn(cfg, torch.Generator().manual_seed(seed), dev)
    step = steps_mod.make_train_step(
        partial(node_loss, cfg=cfg), SMOKE_OPT, 1)
    opt_state = opt_mod.adamw_init(dict(model.named_parameters()))
    metrics = step(model, opt_state, _on(flat, dev))

    # batched-molecule path (the graph regression loss)
    with torch.no_grad():
        gl, _ = graph_loss(model, _on(mol, dev), cfg)
    metrics["mol_loss"] = gl
    return _host(metrics)


def smoke_din(seed: int = 0, device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = reg.arch("din").REDUCED
    stream = data_mod.ClickStream(n_items=cfg.n_items, n_cates=cfg.n_cates,
                                  batch=8, seq_len=cfg.seq_len, seed=seed)
    batch = _on(stream.next_batch(), dev)
    model = din_mod.init_din(cfg, torch.Generator().manual_seed(seed), dev)
    step = steps_mod.make_train_step(
        partial(din_mod.din_loss, cfg=cfg), SMOKE_OPT, 1)
    opt_state = opt_mod.adamw_init(dict(model.named_parameters()))
    metrics = step(model, opt_state, batch)
    # retrieval path
    rng = np.random.default_rng(seed)
    rbatch = _on({
        "hist_items": rng.integers(0, cfg.n_items, cfg.seq_len).astype(
            np.int32),
        "hist_cates": rng.integers(0, cfg.n_cates, cfg.seq_len).astype(
            np.int32),
        "hist_mask": np.ones((cfg.seq_len,), bool),
        "cand_items": rng.integers(0, cfg.n_items, 64).astype(np.int32),
        "cand_cates": rng.integers(0, cfg.n_cates, 64).astype(np.int32),
    }, dev)
    with torch.no_grad():
        scores = din_mod.din_retrieval(model, rbatch, cfg)
    metrics["retrieval_mean"] = torch.mean(scores)
    return _host(metrics)


def smoke(arch_id: str, seed: int = 0, device="cuda") -> dict:
    fam = reg.arch(arch_id).FAMILY
    if fam == "lm":
        return smoke_lm(arch_id, seed, device)
    if fam == "gnn":
        return smoke_gnn(arch_id, seed, device)
    if fam == "recsys":
        return smoke_din(seed, device)
    raise ValueError(f"no smoke for family {fam} (sssp has its own tests)")
