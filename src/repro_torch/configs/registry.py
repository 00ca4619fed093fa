"""Architecture/shape registry: every arch of the reference (``ARCHES``:
the LM, GNN, recsys and SSSP families), every (arch x input-shape) cell
(``all_cells``), the padded batch each GNN and DIN shape takes, and the
analytic FLOP counts (the LMs': ``LMConfig.model_flops``).

``_gnn_flat_batch`` / ``_gnn_mol_batch`` / ``_din_batch`` allocate, on a
device, the padded shapes that the reference's ShapeDtypeStruct batches
describe; ``graph_batch``, ``sampled_batch``, ``molecule_batch`` and
``click_batch`` fill them with seeded data.  ``build_program`` (programs
lowered and sharded over a mesh) waits for the last slice of the port
(13c) and raises ``ValueError`` naming it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs import (din as c_din, dimenet as c_dimenet,
                                 equiformer_v2 as c_eqv2,
                                 graphsage_reddit as c_sage,
                                 meshgraphnet as c_mgn,
                                 minicpm3_4b as c_minicpm,
                                 mistral_large_123b as c_mistral,
                                 moonshot_v1_16b_a3b as c_moonshot,
                                 olmoe_1b_7b as c_olmoe,
                                 qwen3_14b as c_qwen,
                                 sssp_del as c_sssp)
from repro_torch.graphs import generators as gen
from repro_torch.graphs import sampler as sampler_mod
from repro_torch.graphs import triplets as tri_mod
from repro_torch.models import din as din_mod
from repro_torch.models.gnn import (dimenet as dimenet_mod,
                                    equiformer as eqv2_mod,
                                    graphsage as sage_mod,
                                    meshgraphnet as mgn_mod)
from repro_torch.models.params import resolve_device
from repro_torch.train import data as data_mod

ARCHES = {
    m.ARCH_ID: m for m in (
        c_olmoe, c_moonshot, c_minicpm, c_mistral, c_qwen,
        c_mgn, c_sage, c_dimenet, c_eqv2, c_din, c_sssp)
}

LM_SHAPES = {
    "train_4k":    dict(kind="train",   seq=4096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,  batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,  batch=128),
    "long_500k":   dict(kind="decode",  seq=524288, batch=1,
                        skip="pure full-attention arch: 500k decode is "
                             "sub-quadratic-only per the assignment"),
}
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n=2708, e=10556, d_feat=1433,
                          classes=7),
    "minibatch_lg":  dict(kind="train", n_total=232_965, e_total=114_615_892,
                          batch_nodes=1024, fanout=(15, 10), d_feat=602,
                          classes=41),
    "ogb_products":  dict(kind="train", n=2_449_029, e=61_859_140,
                          d_feat=100, classes=47),
    "molecule":      dict(kind="train", n=30, e=64, batch=128, graph=True),
}
DIN_SHAPES = {
    "train_batch":    dict(kind="train", batch=65_536),
    "serve_p99":      dict(kind="serve", batch=512),
    "serve_bulk":     dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_000),
}
SSSP_SHAPES = {
    "relax_rmat24":  dict(kind="relax", n=1 << 24, epp=1 << 20),
    "delete_rmat24": dict(kind="delete", n=1 << 24, epp=1 << 20),
    "relax_web1b":   dict(kind="relax", n=1 << 26, epp=1 << 22),
    "delete_web1b":  dict(kind="delete", n=1 << 26, epp=1 << 22),
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": DIN_SHAPES,
                 "sssp": SSSP_SHAPES}

# padding unit that divides both production meshes (256 and 512 devices)
PAD = 512


def _pad(n: int, m: int = PAD) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str
    skip: str | None = None


def all_cells(include_sssp: bool = True) -> list[Cell]:
    cells = []
    for arch_id, mod in ARCHES.items():
        if mod.FAMILY == "sssp" and not include_sssp:
            continue
        for shape, info in FAMILY_SHAPES[mod.FAMILY].items():
            cells.append(Cell(arch=arch_id, shape=shape, kind=info["kind"],
                              skip=info.get("skip")))
    return cells


def arch(arch_id: str):
    """The config module of an arch; ``ValueError`` for an unknown one."""
    if arch_id not in ARCHES:
        raise ValueError(f"unknown arch {arch_id!r}; known: "
                         f"{sorted(ARCHES)}")
    return ARCHES[arch_id]


def build_program(arch_id: str, shape: str, mesh=None, overrides=None):
    raise ValueError("build_program (programs lowered and sharded over a "
                     "mesh) comes with slice 13c of the port")


# ==================================================================== GNN ====

_GNN_FNS = {
    "meshgraphnet": (mgn_mod.mgn_node_loss, mgn_mod.mgn_graph_loss,
                     mgn_mod.init_mgn, True, False),
    "graphsage-reddit": (sage_mod.sage_node_loss, sage_mod.sage_graph_loss,
                         sage_mod.init_sage, False, False),
    "dimenet": (dimenet_mod.dimenet_node_loss, dimenet_mod.dimenet_graph_loss,
                dimenet_mod.init_dimenet, True, True),
    "equiformer-v2": (eqv2_mod.eqv2_node_loss, eqv2_mod.eqv2_graph_loss,
                      eqv2_mod.init_eqv2, True, False),
}


def _gnn_resolve_cfg(arch_mod, info, reduced=False):
    cfg = arch_mod.REDUCED if reduced else arch_mod.CONFIG
    d_feat = info.get("d_feat", 16)
    classes = info.get("classes", cfg.n_out)
    if not reduced:
        cfg = dataclasses.replace(cfg, d_in=d_feat, n_out=classes)
    return cfg


def _zeros(spec: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in spec.items()}


def _gnn_flat_batch(info, d_feat, *, needs_pos, needs_tri,
                    device="cuda") -> dict:
    if "n" in info:
        n, e = _pad(info["n"]), _pad(info["e"])
    else:  # minibatch_lg: padded sampled subgraph
        n0, e0 = sampler_mod.subgraph_capacity(info["batch_nodes"],
                                               info["fanout"])
        n, e = _pad(n0), _pad(e0)
    spec = {
        "feats": ((n, d_feat), torch.float32),
        "src": ((e,), torch.int32), "dst": ((e,), torch.int32),
        "edge_mask": ((e,), torch.bool),
        "labels": ((n,), torch.int32),
        "label_mask": ((n,), torch.bool),
    }
    if needs_pos:
        spec["pos"] = ((n, 3), torch.float32)
    if needs_tri:
        t = _pad(tri_mod.triplet_budget(e))
        spec["t_kj"] = ((t,), torch.int32)
        spec["t_ji"] = ((t,), torch.int32)
        spec["triplet_mask"] = ((t,), torch.bool)
    return _zeros(spec, device)


def _gnn_mol_batch(info, d_feat, *, needs_pos, needs_tri,
                   device="cuda") -> dict:
    B, n, e = info["batch"], info["n"], info["e"]
    spec = {
        "feats": ((B, n, d_feat), torch.float32),
        "src": ((B, e), torch.int32), "dst": ((B, e), torch.int32),
        "edge_mask": ((B, e), torch.bool),
        "target": ((B,), torch.float32),
    }
    if needs_pos:
        spec["pos"] = ((B, n, 3), torch.float32)
    if needs_tri:
        t = e * 8
        spec["t_kj"] = ((B, t), torch.int32)
        spec["t_ji"] = ((B, t), torch.int32)
        spec["triplet_mask"] = ((B, t), torch.bool)
    return _zeros(spec, device)


def _fill(batch: dict, arrays: dict) -> dict:
    """Copies each host array into the leading rows of its padded tensor
    (masks stay False past the real rows)."""
    for k, a in arrays.items():
        t = batch[k]
        t[tuple(slice(0, s) for s in a.shape)] = torch.as_tensor(a).to(
            t.device, t.dtype)
    return batch


def graph_batch(info, d_feat, *, needs_pos, needs_tri, device="cuda",
                seed=0) -> dict:
    """A full-graph shape (``n`` and ``e`` in ``info``) as a padded flat
    batch: an Erdős–Rényi stand-in with the shape's node and edge counts,
    N(0, 1) features and positions, labels uniform over the shape's
    classes on every real node; DimeNet's triplets within the padded
    budget."""
    n, e, classes = info["n"], info["e"], info["classes"]
    _, src, dst, _ = gen.erdos_renyi(n, e, seed=seed)
    rng = np.random.default_rng(seed)
    arrays = {"feats": rng.standard_normal((n, d_feat), np.float32),
              "src": src, "dst": dst, "edge_mask": np.ones(len(src), bool),
              "labels": rng.integers(0, classes, n),
              "label_mask": np.ones(n, bool)}
    if needs_pos:
        arrays["pos"] = rng.standard_normal((n, 3), np.float32)
    batch = _gnn_flat_batch(info, d_feat, needs_pos=needs_pos,
                            needs_tri=needs_tri, device=device)
    if needs_tri:
        t_kj, t_ji, tmask = tri_mod.build_triplets(
            n, src, dst, budget=batch["t_kj"].shape[0], seed=seed)
        arrays.update(t_kj=t_kj, t_ji=t_ji, triplet_mask=tmask)
    return _fill(batch, arrays)


def sampled_batch(sampler: sampler_mod.NeighborSampler, seeds, info,
                  feats: np.ndarray, labels: np.ndarray, *, seed=0,
                  device="cuda") -> dict:
    """``minibatch_lg``: a sampled subgraph (``build_batch``) in the padded
    flat batch of the shape."""
    sub = sampler.sample(np.asarray(seeds), info["fanout"], seed=seed)
    arrays = sampler_mod.build_batch(sub, feats, labels)
    batch = _gnn_flat_batch(info, feats.shape[1], needs_pos=False,
                            needs_tri=False, device=device)
    return _fill(batch, arrays)


def molecule_batch(info, d_feat, *, needs_pos, needs_tri, device="cuda",
                   seed=0) -> dict:
    """The ``molecule`` shape: B Erdős–Rényi graphs of n nodes and e edges
    (seeds ``seed + b``), N(0, 1) features, positions and targets, e·8
    triplets a graph."""
    B, n, e = info["batch"], info["n"], info["e"]
    rng = np.random.default_rng(seed)
    arrays = {k: [] for k in ("src", "dst", "t_kj", "t_ji", "triplet_mask")}
    for b in range(B):
        _, src, dst, _ = gen.erdos_renyi(n, e, seed=seed + b)
        arrays["src"].append(src)
        arrays["dst"].append(dst)
        if needs_tri:
            for k, a in zip(("t_kj", "t_ji", "triplet_mask"),
                            tri_mod.build_triplets(n, src, dst, budget=e * 8,
                                                   seed=seed + b)):
                arrays[k].append(a)
    arrays = {k: np.stack(v) for k, v in arrays.items() if v}
    arrays["edge_mask"] = np.ones(arrays["src"].shape, bool)
    arrays["feats"] = rng.standard_normal((B, n, d_feat), np.float32)
    arrays["target"] = rng.standard_normal(B, np.float32)
    if needs_pos:
        arrays["pos"] = rng.standard_normal((B, n, 3), np.float32)
    batch = _gnn_mol_batch(info, d_feat, needs_pos=needs_pos,
                           needs_tri=needs_tri, device=device)
    return _fill(batch, arrays)


def _gnn_model_flops(arch_id, cfg, batch) -> float:
    """Analytic 'useful' FLOPs (fwd+bwd = 3x fwd matmul FLOPs)."""
    E = float(math.prod(batch["src"].shape))
    N = float(math.prod(batch["feats"].shape[:-1]))
    d = cfg.d_hidden
    if arch_id == "meshgraphnet":
        per_layer = E * (3 * d * d + d * d) * 2 + N * (2 * d * d + d * d) * 2
        fwd = cfg.n_layers * per_layer
    elif arch_id == "graphsage-reddit":
        d_in = batch["feats"].shape[-1]
        fwd = N * 2 * (d_in * d + d_in * d) + N * 2 * (d * d * 2)
    elif arch_id == "dimenet":
        T = float(math.prod(batch["t_kj"].shape))
        fwd = cfg.n_blocks * (E * 6 * d * d * 2
                              + T * (cfg.n_bilinear * d * d) * 2)
    else:  # equiformer-v2
        nc, nl = cfg.n_coef, cfg.n_l
        n_pair = len(cfg.pair_index()[0])
        fwd = cfg.n_layers * (E * (nl + 4 * n_pair) * d * d * 2
                              + N * 2 * nc * d * d * 2)
    return 3.0 * fwd


# ==================================================================== DIN ====

def _din_batch(info, cfg: din_mod.DINConfig, kind, device="cuda") -> dict:
    if kind == "retrieval":
        C = _pad(info["n_cand"])
        spec = {
            "hist_items": ((cfg.seq_len,), torch.int32),
            "hist_cates": ((cfg.seq_len,), torch.int32),
            "hist_mask": ((cfg.seq_len,), torch.bool),
            "cand_items": ((C,), torch.int32),
            "cand_cates": ((C,), torch.int32),
        }
        return _zeros(spec, device)
    B = info["batch"]
    spec = {
        "target_item": ((B,), torch.int32),
        "target_cate": ((B,), torch.int32),
        "hist_items": ((B, cfg.seq_len), torch.int32),
        "hist_cates": ((B, cfg.seq_len), torch.int32),
        "hist_mask": ((B, cfg.seq_len), torch.bool),
    }
    if kind == "train":
        spec["labels"] = ((B,), torch.float32)
    return _zeros(spec, device)


def click_batch(info, cfg: din_mod.DINConfig, *, device="cuda",
                seed=0) -> dict:
    """A DIN shape's batch with data: train and serve rows from
    ``ClickStream`` (serve without labels); retrieval one history and
    ``n_cand`` candidates (padded), ids uniform, a category its item id
    modulo ``n_cates`` as the stream's."""
    kind = info["kind"]
    batch = _din_batch(info, cfg, kind, device=device)
    if kind == "retrieval":
        rng = np.random.default_rng(seed)
        hist = rng.integers(0, cfg.n_items, cfg.seq_len)
        cand = rng.integers(0, cfg.n_items, batch["cand_items"].shape[0])
        arrays = {"hist_items": hist, "hist_cates": hist % cfg.n_cates,
                  "hist_mask": np.ones(cfg.seq_len, bool),
                  "cand_items": cand, "cand_cates": cand % cfg.n_cates}
    else:
        arrays = data_mod.ClickStream(
            n_items=cfg.n_items, n_cates=cfg.n_cates, batch=info["batch"],
            seq_len=cfg.seq_len, seed=seed).next_batch()
        arrays = {k: v for k, v in arrays.items() if k in batch}
    return _fill(batch, arrays)


def _din_flops(cfg: din_mod.DINConfig, rows: int) -> float:
    di = cfg.d_item
    attn = 4 * di * cfg.attn_mlp[0] + cfg.attn_mlp[0] * cfg.attn_mlp[1]
    mlp = 3 * di * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1]
    return rows * 2.0 * (cfg.seq_len * attn + mlp)
