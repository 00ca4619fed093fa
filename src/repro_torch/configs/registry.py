"""Architecture/shape registry: every arch of the reference (``ARCHES``:
the LM, GNN, recsys and SSSP families), every (arch x input-shape) cell
(``all_cells``), the padded batch each GNN and DIN shape takes, and the
analytic FLOP counts (the LMs': ``LMConfig.model_flops``).

``_gnn_flat_batch`` / ``_gnn_mol_batch`` / ``_din_batch`` allocate, on a
device, the padded shapes that the reference's ShapeDtypeStruct batches
describe; ``graph_batch``, ``sampled_batch``, ``molecule_batch`` and
``click_batch`` fill them with seeded data.

``build_program(arch, shape, mesh)`` returns a ``Program``: the step
function, its inputs as ``meta`` tensors (shapes and dtypes, nothing
allocated: the counterpart of the reference's ShapeDtypeStructs), the
in/out sharding specs over the production mesh (trees of the spec tuples
of ``models/sharding.py``, in the reference's tree structure), the
donated arguments and the reference's ``meta`` dict — consumed by
``launch/dryrun.py`` and the roofline tracer.  ``Program.fill(seed)``
makes the same inputs with seeded data on the mesh's device(s), so the
same ``fn`` runs on the card.

Departures from the reference's programs:

  * the train steps update the parameters and the AdamW state in place
    (``train/steps.py``) and return ``(params, opt_state, metrics)`` with
    the same tensors (``params`` as ``{path: tensor}``, the model's
    ``named_parameters``), so the donated inputs are the outputs;
  * the decode cache's ``length`` is a host int (``KVCache``): the meta
    argument holds a full cache (``length = seq - 1``), and the length
    has no tensor, no spec bytes and no sharding leaf of its own;
  * the SSSP programs run ``DistributedSSSP``'s epochs, which take one
    tensor a partition (``Parts`` lists) and one ``EdgePool`` a
    partition: ``(dist, parent, frontier_or_seed, pools)`` in place of
    the reference's seven flat arrays, one spec a list (the list as the
    global vector, sharded over every mesh axis), and ``rounds`` comes
    back as a host int.  The pools hold exactly (src, dst, w, active):
    the per-device argument bytes are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable

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
from repro_torch.launch.mesh import Mesh
from repro_torch.models import din as din_mod
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import (dimenet as dimenet_mod,
                                    equiformer as eqv2_mod,
                                    graphsage as sage_mod,
                                    meshgraphnet as mgn_mod)
from repro_torch.models.params import resolve_device
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod

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


@dataclasses.dataclass
class Program:
    """A cell's step: ``fn(*args)``.  ``args`` are ``meta`` tensors (and
    modules of them); ``in_shardings`` / ``out_shardings`` mirror the
    argument and output trees with one spec tuple a tensor (a ``Parts``
    list or a parameter dict takes one spec, or a dict of them);
    ``fill(seed)`` builds ``args`` with seeded data on the mesh's
    device(s), or is None where no seeded filler exists at the cell's
    size; ``exchange`` is the SSSP program's ``DistributedSSSP``, whose
    ``all_gather`` / ``psum`` are the cell's collectives."""
    fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: tuple
    meta: dict
    mesh: Mesh
    fill: Callable[[int], tuple] | None = None
    exchange: Any = None


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


# ============================================================ programs ====

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _replicated(tree: dict) -> dict:
    """The reference's ``_replicated_tree``: ``()`` (``P()``) a leaf."""
    return {k: () for k in tree}


def _lead(axes, ndim: int) -> tuple:
    """The first dim over ``axes``, the rest replicated: the reference's
    ``P(axes, None, ...)``."""
    return (shd._entry(axes),) + (None,) * (ndim - 1)


def _device(mesh: Mesh) -> torch.device:
    """Where a one-controller program runs: the mesh's first device."""
    return mesh.devices[0]


def _seeded(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _train_fn(step):
    """The port's in-place step as the reference's
    ``(params, opt_state, batch) -> (params, opt_state, metrics)``."""
    def fn(model, opt_state, batch):
        metrics = step(model, opt_state, batch)
        return dict(model.named_parameters()), opt_state, metrics
    return fn


def _train_specs(pspec: dict, metric_keys) -> tuple[dict, dict]:
    """(optimizer-state specs, metric specs) of a train step whose
    parameters take ``pspec``: the moments follow the parameters, the
    step and every metric are replicated."""
    return ({"m": pspec, "v": pspec, "step": ()},
            {k: () for k in metric_keys})


def _metric_keys(loss_keys) -> tuple:
    """A train step's metric keys: the loss's, then AdamW's."""
    return tuple(loss_keys) + ("grad_norm", "lr")


# ===================================================================== LM ====

def _lm_cast(model, dtype):
    """The serving copy's weights: every leaf in ``dtype`` (meta: shapes
    alone)."""
    return model.to(dtype)


def lm_loss_adapter(params, batch, cfg):
    return tfm.lm_loss(params, batch, cfg)


def _with_act_sharding(fn, cfg, mesh):
    """Run ``fn`` under the activation-sharding context (an identity in
    the port, kept for the reference's structure)."""
    def wrapped(*args):
        with tfm.activation_sharding(mesh, shd.batch_axes(mesh)):
            return fn(*args)
    return wrapped


def _lm_metric_keys(cfg) -> tuple:
    moe = ("moe_balance", "moe_z", "moe_dropped") if cfg.moe else ()
    return _metric_keys(("loss", "ntok") + moe)


def _lm_tokens(cfg, shape, device, generator) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, shape, generator=generator,
                         device=generator.device, dtype=torch.int32
                         ).to(device)


def _lm_train_program(cfg, mesh: Mesh, info) -> Program:
    model = tfm.init_lm(cfg, device="meta")
    opt = opt_mod.adamw_init(dict(model.named_parameters()))
    pspec = shd.lm_param_specs(model, mesh)
    bx = shd.batch_axes(mesh)
    A, B, S = cfg.grad_accum, info["batch"], info["seq"]
    shape = (A, B // A, S) if A > 1 else (B, S)
    batch = {"tokens": _meta(shape, torch.int32),
             "labels": _meta(shape, torch.int32)}
    bspec = (None, shd._entry(bx), None) if A > 1 else _lead(bx, 2)
    bsh = {k: bspec for k in batch}
    osh, msh = _train_specs(pspec, _lm_metric_keys(cfg))
    step = steps_mod.make_train_step(partial(lm_loss_adapter, cfg=cfg),
                                     opt_mod.AdamWConfig(), A)
    fn = _with_act_sharding(_train_fn(step), cfg, mesh)

    def fill(seed: int = 0) -> tuple:
        dev = _device(mesh)
        gen_ = _seeded(dev, seed)
        m = tfm.init_lm(cfg, gen_, dev)
        toks = _lm_tokens(cfg, shape, dev, gen_)
        return (m, opt_mod.adamw_init(dict(m.named_parameters())),
                {"tokens": toks, "labels": toks.roll(-1, dims=-1)})

    return Program(
        fn=fn, args=(model, opt, batch), in_shardings=(pspec, osh, bsh),
        out_shardings=(pspec, osh, msh), donate_argnums=(0, 1),
        meta={"model_flops": cfg.model_flops(B * S, train=True),
              "tokens": B * S, "params": cfg.param_count(),
              "active_params": cfg.active_param_count()},
        mesh=mesh, fill=fill)


def _lm_prefill_program(cfg, mesh: Mesh, info) -> Program:
    model = _lm_cast(tfm.init_lm(cfg, device="meta"), torch.bfloat16)
    pspec = shd.lm_param_specs(model, mesh)
    bx = shd.batch_axes(mesh)
    B, S = info["batch"], info["seq"]
    tokens = _meta((B, S), torch.int32)

    def prefill_fn(params, toks):
        with tfm.activation_sharding(mesh, bx):
            logits, cache = tfm.prefill(params, toks, cfg, capacity=S)
        return logits[:, -1, :], cache

    csh = shd.cache_spec(tfm.init_cache(cfg, B, S, device="meta"), mesh)

    def fill(seed: int = 0) -> tuple:
        dev = _device(mesh)
        gen_ = _seeded(dev, seed)
        return (tfm.init_lm(cfg, gen_, dev, torch.bfloat16),
                _lm_tokens(cfg, (B, S), dev, gen_))

    return Program(
        fn=prefill_fn, args=(model, tokens),
        in_shardings=(pspec, _lead(bx, 2)),
        out_shardings=(_lead(bx, 2), csh), donate_argnums=(),
        meta={"model_flops": cfg.model_flops(B * S, train=False),
              "tokens": B * S, "params": cfg.param_count(),
              "active_params": cfg.active_param_count()},
        mesh=mesh, fill=fill)


def _lm_decode_program(cfg, mesh: Mesh, info) -> Program:
    model = _lm_cast(tfm.init_lm(cfg, device="meta"), torch.bfloat16)
    pspec = shd.lm_param_specs(model, mesh)
    bx = shd.batch_axes(mesh)
    B, S = info["batch"], info["seq"]
    cache = tfm.init_cache(cfg, B, S, device="meta")
    cache.length = S - 1          # decode the last position of a full cache
    csh = shd.cache_spec(cache, mesh)
    tokens = _meta((B,), torch.int32)

    def decode_fn(params, cache_, toks):
        return tfm.decode_step(params, cache_, toks, cfg)

    def fill(seed: int = 0) -> tuple:
        dev = _device(mesh)
        gen_ = _seeded(dev, seed)
        c = tfm.init_cache(cfg, B, S, device=dev)
        for t in (c.k, c.v):
            t.copy_(torch.randn(t.shape, generator=gen_, device=dev))
        c.length = S - 1
        return (tfm.init_lm(cfg, gen_, dev, torch.bfloat16), c,
                _lm_tokens(cfg, (B,), dev, gen_))

    return Program(
        fn=decode_fn, args=(model, cache, tokens),
        in_shardings=(pspec, csh, (shd._entry(bx),)),
        out_shardings=(_lead(bx, 2), csh), donate_argnums=(1,),
        # decode FLOPs: 2*N_act per token + attention reads; memory-bound
        meta={"model_flops": cfg.model_flops(B, train=False), "tokens": B,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "kv_bytes": sum(math.prod(t.shape) * 2
                              for t in (cache.k, cache.v))},
        mesh=mesh, fill=fill)


# ============================================================ GNN program ====

# shapes whose inputs ``graph_batch`` / ``molecule_batch`` make in seconds;
# minibatch_lg needs the sampler over a 114.6M-edge graph, ogb_products a
# 61.9M-edge graph (and DimeNet's triplets over it)
_GNN_FILLS = {"full_graph_sm": graph_batch, "molecule": molecule_batch}


def _gnn_loss_call(params, batch, loss, cfg):
    return loss(params, batch, cfg)


def _gnn_program(arch_id: str, shape: str, mesh: Mesh, info) -> Program:
    arch_mod = ARCHES[arch_id]
    node_loss, graph_loss, init_fn, needs_pos, needs_tri = _GNN_FNS[arch_id]
    cfg = _gnn_resolve_cfg(arch_mod, info)
    model = init_fn(cfg, device="meta")
    opt = opt_mod.adamw_init(dict(model.named_parameters()))
    psh = _replicated(dict(model.named_parameters()))  # small: replicate
    molecule = info.get("graph", False)
    d_feat = info.get("d_feat", 16)
    make = _gnn_mol_batch if molecule else _gnn_flat_batch
    batch = make(info, d_feat, needs_pos=needs_pos, needs_tri=needs_tri,
                 device="meta")
    ax = shd.batch_axes(mesh) if molecule else shd.graph_axes(mesh)
    bsh = {k: _lead(ax, v.dim()) for k, v in batch.items()}
    loss = graph_loss if molecule else node_loss
    osh, msh = _train_specs(psh, _metric_keys(
        ("loss", "mae") if molecule else ("loss", "acc")))
    step = steps_mod.make_train_step(
        partial(_gnn_loss_call, loss=loss, cfg=cfg), opt_mod.AdamWConfig(),
        1)
    filler = _GNN_FILLS.get(shape)

    def fill(seed: int = 0) -> tuple:
        dev = _device(mesh)
        m = init_fn(cfg, _seeded(dev, seed), dev)
        b = filler(info, d_feat, needs_pos=needs_pos, needs_tri=needs_tri,
                   device=dev, seed=seed)
        return m, opt_mod.adamw_init(dict(m.named_parameters())), b

    return Program(
        fn=_train_fn(step), args=(model, opt, batch),
        in_shardings=(psh, osh, bsh), out_shardings=(psh, osh, msh),
        donate_argnums=(0, 1),
        meta={"model_flops": _gnn_model_flops(arch_id, cfg, batch),
              "edges": int(math.prod(batch["src"].shape)),
              "params": sum(p.numel() for p in model.parameters())},
        mesh=mesh, fill=fill if filler else None)


# ============================================================ DIN program ====

def _din_param_shardings(model, mesh) -> dict:
    gx = shd.graph_axes(mesh)
    return {k: (shd._entry(gx), None) if "item_emb" in k else ()
            for k, _ in model.named_parameters()}


def _din_loss_call(params, batch, cfg):
    return din_mod.din_loss(params, batch, cfg)


def _din_score_call(params, batch, cfg):
    return din_mod.din_score(params, batch, cfg)


def _din_retrieval_call(params, batch, cfg):
    return din_mod.din_retrieval(params, batch, cfg)


def _din_program(mesh: Mesh, info) -> Program:
    cfg = c_din.CONFIG
    kind = info["kind"]
    model = din_mod.init_din(cfg, device="meta")
    psh = _din_param_shardings(model, mesh)
    gx = shd.graph_axes(mesh)
    batch = _din_batch(info, cfg, kind, device="meta")
    params = cfg.n_items * cfg.embed_dim

    def fill_batch(seed: int) -> tuple:
        dev = _device(mesh)
        return (din_mod.init_din(cfg, _seeded(dev, seed), dev),
                click_batch(info, cfg, device=dev, seed=seed))

    if kind == "train":
        opt = opt_mod.adamw_init(dict(model.named_parameters()))
        osh, msh = _train_specs(psh, _metric_keys(("loss", "acc")))
        bsh = {k: _lead(gx, v.dim()) for k, v in batch.items()}
        step = steps_mod.make_train_step(partial(_din_loss_call, cfg=cfg),
                                         opt_mod.AdamWConfig(), 1)

        def fill(seed: int = 0) -> tuple:
            m, b = fill_batch(seed)
            return m, opt_mod.adamw_init(dict(m.named_parameters())), b

        return Program(
            fn=_train_fn(step), args=(model, opt, batch),
            in_shardings=(psh, osh, bsh), out_shardings=(psh, osh, msh),
            donate_argnums=(0, 1),
            meta={"model_flops": _din_flops(cfg, info["batch"]) * 3,
                  "rows": info["batch"], "params": params},
            mesh=mesh, fill=fill)
    if kind == "serve":
        bsh = {k: _lead(gx, v.dim()) for k, v in batch.items()}
        return Program(
            fn=partial(_din_score_call, cfg=cfg), args=(model, batch),
            in_shardings=(psh, bsh), out_shardings=_lead(gx, 1),
            donate_argnums=(),
            meta={"model_flops": _din_flops(cfg, info["batch"]),
                  "rows": info["batch"], "params": params},
            mesh=mesh, fill=fill_batch)
    # retrieval
    bsh = {k: _lead(gx, 1) if v.dim() == 1 and v.shape[0] >= PAD else ()
           for k, v in batch.items()}
    C = batch["cand_items"].shape[0]
    return Program(
        fn=partial(_din_retrieval_call, cfg=cfg), args=(model, batch),
        in_shardings=(psh, bsh), out_shardings=_lead(gx, 1),
        donate_argnums=(),
        meta={"model_flops": _din_flops(cfg, C), "rows": C,
              "params": params},
        mesh=mesh, fill=fill_batch)


# =========================================================== SSSP program ====

SSSP_DELETIONS = 64    # tree edges a seeded delete cell deletes


def _sssp_graph(n: int, e: int, seed: int):
    """A Graph500 R-MAT graph of at most ``e`` edges (after dedup) on the
    lowest ``2**scale <= n`` ids, weights in (0, 4]."""
    scale = min(n.bit_length() - 1, max(1, (e - 1).bit_length()))
    _, src, dst, w = gen.rmat(scale, max(1, e >> scale), seed=seed)
    return src[:e], dst[:e], w[:e]


def _sssp_fill(eng, info, kind: str, seed: int) -> tuple:
    """Seeded pools and state for an SSSP cell on ``eng``'s partitions:
    R-MAT edges placed by destination; the relax cell starts from the
    source (the highest out-degree vertex), the delete cell from that
    source's converged tree with its first ``SSSP_DELETIONS`` tree edges
    (by distance) deleted from the pools and seeded."""
    n = info["n"]
    src, dst, w = _sssp_graph(n, eng.P * info["epp"], seed)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    ps, pd, pw, pa = eng.place_edges(src, dst, w)
    dist, parent = eng.init_vertex_arrays(source)
    frontier = eng.frontier_of(np.array([source]))
    if kind == "relax":
        return dist, parent, frontier, eng.put_edges(ps, pd, pw, pa)
    dist, parent, _ = eng.make_relax_epoch()(
        dist, parent, frontier, eng.put_edges(ps, pd, pw, pa))
    d, q = eng.to_host(dist), eng.to_host(parent)
    tree = np.flatnonzero((q >= 0) & np.isfinite(d))
    gone = tree[np.argsort(d[tree], kind="stable")][:SSSP_DELETIONS]
    hit = pa & np.isin(pd, gone) & (ps == q[np.minimum(pd, n - 1)])
    pa = pa & ~hit
    seed_parts = eng.make_seed_from_deletions()(parent, q[gone], gone)
    return dist, parent, seed_parts, eng.put_edges(ps, pd, pw, pa)


def _sssp_program(mesh: Mesh, info, overrides: dict | None = None
                  ) -> Program:
    from repro_torch.core.distributed import DistConfig, DistributedSSSP
    from repro_torch.core.state import EdgePool
    cfg0 = c_sssp.CONFIG
    if overrides:
        cfg0 = dataclasses.replace(cfg0, **overrides)
    axes = tuple(mesh.axis_names)
    dcfg = DistConfig(num_vertices=info["n"], edges_per_part=info["epp"],
                      mesh_axes=axes, exchange=cfg0.exchange,
                      delta_cap=cfg0.delta_cap)
    eng = DistributedSSSP(mesh, dcfg)
    P_, npp, epp = eng.P, eng.npp, info["epp"]
    E = P_ * epp

    def parts(k, dtype):
        return [_meta((k,), dtype) for _ in range(P_)]

    args = (parts(npp, torch.float32), parts(npp, torch.int32),
            parts(npp, torch.bool),
            [EdgePool(_meta((epp,), torch.int32), _meta((epp,), torch.int32),
                      _meta((epp,), torch.float32), _meta((epp,), torch.bool))
             for _ in range(P_)])
    vsh = (shd._entry(axes),)
    kind = info["kind"]
    fn = eng.make_relax_epoch() if kind == "relax" else \
        eng.make_delete_epoch()
    # per-round useful work: one fused gather+add+segmin over E edges
    return Program(
        fn=fn, args=args, in_shardings=(vsh, vsh, vsh, vsh),
        out_shardings=(vsh, vsh, ()), donate_argnums=(),
        meta={"model_flops": 2.0 * E, "edges": E, "vertices": info["n"],
              "note": "while_loop: terms reported per round"},
        mesh=mesh, fill=lambda seed=0: _sssp_fill(eng, info, kind, seed),
        exchange=eng)


# =============================================================== dispatch ====

def build_program(arch_id: str, shape: str, mesh: Mesh,
                  overrides: dict | None = None) -> Program:
    """``overrides``: dataclasses.replace kwargs applied to the arch config
    (the LM and SSSP families) — the dry run pins the attention variant
    (attn_impl='scan' vs 'flash_vjp') with them."""
    mod = ARCHES[arch_id]
    info = FAMILY_SHAPES[mod.FAMILY][shape]
    if info.get("skip"):
        raise ValueError(f"cell ({arch_id}, {shape}) is skipped: "
                         f"{info['skip']}")
    if mod.FAMILY == "lm":
        cfg = mod.CONFIG
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if info["kind"] == "train":
            return _lm_train_program(cfg, mesh, info)
        if info["kind"] == "prefill":
            return _lm_prefill_program(cfg, mesh, info)
        return _lm_decode_program(cfg, mesh, info)
    if mod.FAMILY == "gnn":
        return _gnn_program(arch_id, shape, mesh, info)
    if mod.FAMILY == "recsys":
        return _din_program(mesh, info)
    return _sssp_program(mesh, info, overrides)
