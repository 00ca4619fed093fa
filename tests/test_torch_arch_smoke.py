"""The port's configs, registry and reduced-config smoke
(``repro_torch.configs``) against the JAX package's: ``smoke(arch,
device="cpu")`` for the GNN, recsys and (two of the) LM archs (finite
metrics, loss > 0); the configs field by field (EquiformerV2's static
coefficient tables too; the five LM configs); the port's inits' shapes
against ``jax.eval_shape`` of the reference's, at REDUCED and at full
CONFIG (on the ``meta`` device: nothing is drawn); the shape tables, the
cells (``all_cells``), the padded batches' shapes and dtypes and the
analytic FLOP counts; and ``build_program``'s ``meta`` for three archs
(tests/test_torch_registry_programs.py holds every cell).
All exact: these are integers, shapes and host numpy."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import registry as jreg
from repro.configs import smoke as jsmoke
from repro.models import din as jdin
from repro_torch.configs import registry as reg
from repro_torch.configs import smoke as smoke_mod
from repro_torch.models import din as din_mod

ARCHS = ["graphsage-reddit", "meshgraphnet", "dimenet", "equiformer-v2",
         "din"]
GNN = ARCHS[:4]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_on_cpu(arch):
    metrics = smoke_mod.smoke(arch, seed=0, device="cpu")
    for k, v in metrics.items():
        assert np.isfinite(v), f"{arch}:{k} = {v}"
    assert metrics["loss"] > 0.0
    assert {"loss", "grad_norm", "lr"} <= set(metrics)
    assert ("mol_loss" if arch != "din" else "retrieval_mean") in metrics


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    ours, ref = reg.ARCHES[arch], jreg.ARCHES[arch]
    assert (ours.ARCH_ID, ours.FAMILY) == (ref.ARCH_ID, ref.FAMILY)
    for which in ("CONFIG", "REDUCED"):
        a, b = getattr(ours, which), getattr(ref, which)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), which
        if arch == "equiformer-v2":
            for f in ("coef_table", "pair_index", "m0_index"):
                for x, y in zip(getattr(a, f)(), getattr(b, f)()):
                    np.testing.assert_array_equal(x, y)
            assert (a.n_coef, a.n_l) == (b.n_coef, b.n_l)
    if arch == "equiformer-v2":
        assert ours.CONFIG.n_coef == 29


def _shapes(module: torch.nn.Module) -> dict:
    return {k: tuple(p.shape) for k, p in module.state_dict().items()}


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_equal_reference(arch, full):
    mod = reg.ARCHES[arch]
    if arch == "din":
        cfg = mod.CONFIG if full else mod.REDUCED
        ours = din_mod.init_din(cfg, device="meta")
        ref = jax.eval_shape(lambda: jdin.init_din(jax.random.key(0), cfg))
    else:
        info = jreg.GNN_SHAPES["full_graph_sm"]
        cfg = reg._gnn_resolve_cfg(mod, info, reduced=not full)
        ours = reg._GNN_FNS[arch][2](cfg, device="meta")
        ref = jax.eval_shape(
            lambda: jreg._GNN_FNS[arch][2](jax.random.key(0), cfg))
    want = {k: tuple(v.shape) for k, v in _flat_sds(ref).items()}
    assert _shapes(ours) == want
    assert all(p.dtype == torch.float32 for p in ours.parameters())


def _flat_sds(tree):
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = node
    walk("", tree)
    return out


LM = ["olmoe-1b-7b", "moonshot-v1-16b-a3b", "minicpm3-4b",
      "mistral-large-123b", "qwen3-14b"]


@pytest.mark.parametrize("arch", LM)
def test_lm_configs_equal_reference(arch):
    """Field by field; ``compute_dtype`` is torch's bf16 for jnp's."""
    import jax.numpy as jnp
    ours, ref = reg.arch(arch), jreg.ARCHES[arch]
    assert (ours.ARCH_ID, ours.FAMILY) == (ref.ARCH_ID, ref.FAMILY)
    for which in ("CONFIG", "REDUCED"):
        a = dataclasses.asdict(getattr(ours, which))
        b = dataclasses.asdict(getattr(ref, which))
        assert a.pop("compute_dtype") == torch.bfloat16
        assert b.pop("compute_dtype") == jnp.bfloat16
        assert a == b, which


def test_registry_cells_equal_reference():
    assert list(reg.ARCHES) == list(jreg.ARCHES)
    for inc in (True, False):
        assert [dataclasses.asdict(c) for c in reg.all_cells(inc)] == \
            [dataclasses.asdict(c) for c in jreg.all_cells(inc)]
    cells = reg.all_cells()
    assert len(cells) == 5 * 4 + 4 * 4 + 4 + 4
    assert [c.arch for c in cells if c.skip] == LM
    with pytest.raises(ValueError, match="unknown arch"):
        reg.arch("gpt-2")


def test_shape_tables_equal_reference():
    assert reg.LM_SHAPES == jreg.LM_SHAPES
    assert reg.SSSP_SHAPES == jreg.SSSP_SHAPES
    assert set(reg.FAMILY_SHAPES) == set(jreg.FAMILY_SHAPES)
    assert reg.GNN_SHAPES == jreg.GNN_SHAPES
    assert reg.DIN_SHAPES == jreg.DIN_SHAPES
    assert reg.PAD == jreg.PAD
    for n in (0, 1, 511, 512, 513, 2708, 169_984):
        assert reg._pad(n) == jreg._pad(n)
    assert set(reg._GNN_FNS) == set(jreg._GNN_FNS)
    for arch in GNN:
        assert reg._GNN_FNS[arch][3:] == jreg._GNN_FNS[arch][3:]


_DT = {"float32": torch.float32, "int32": torch.int32, "bool": torch.bool}


def _same_spec(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k, s in ref.items():
        assert tuple(ours[k].shape) == tuple(s.shape), k
        assert ours[k].dtype == _DT[str(s.dtype)], k


@pytest.mark.parametrize("shape", list(jreg.GNN_SHAPES))
@pytest.mark.parametrize("arch", GNN)
def test_gnn_batches_and_flops_equal_reference(arch, shape):
    info = jreg.GNN_SHAPES[shape]
    _, _, _, needs_pos, needs_tri = jreg._GNN_FNS[arch]
    d_feat = info.get("d_feat", 16)
    kw = dict(needs_pos=needs_pos, needs_tri=needs_tri)
    if info.get("graph"):
        ref = jreg._gnn_mol_batch(info, d_feat, **kw)
        ours = reg._gnn_mol_batch(info, d_feat, **kw, device="meta")
    else:
        ref = jreg._gnn_flat_batch(info, d_feat, **kw)
        ours = reg._gnn_flat_batch(info, d_feat, **kw, device="meta")
    _same_spec(ours, ref)
    cfg = reg._gnn_resolve_cfg(reg.ARCHES[arch], info)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jreg._gnn_resolve_cfg(jreg.ARCHES[arch], info))
    assert reg._gnn_model_flops(arch, cfg, ours) == \
        jreg._gnn_model_flops(arch, cfg, ref)


@pytest.mark.parametrize("shape", list(jreg.DIN_SHAPES))
def test_din_batches_and_flops_equal_reference(shape):
    info = jreg.DIN_SHAPES[shape]
    cfg = reg.ARCHES["din"].CONFIG
    _same_spec(reg._din_batch(info, cfg, info["kind"], device="meta"),
               jreg._din_batch(info, jreg.ARCHES["din"].CONFIG, info["kind"]))
    for rows in (1, 512, 65_536, 1_000_448):
        assert reg._din_flops(cfg, rows) == jreg._din_flops(
            jreg.ARCHES["din"].CONFIG, rows)


def test_data_batches_fill_the_padded_shapes():
    info = reg.GNN_SHAPES["full_graph_sm"]
    b = reg.graph_batch(info, 8, needs_pos=True, needs_tri=True,
                        device="cpu", seed=3)
    assert tuple(b["feats"].shape) == (3072, 8)
    assert int(b["edge_mask"].sum()) == 10556
    assert int(b["label_mask"].sum()) == 2708
    assert int(b["labels"].max()) < 7 and int(b["triplet_mask"].sum()) > 0
    mol = reg.molecule_batch(dict(reg.GNN_SHAPES["molecule"], batch=3), 4,
                             needs_pos=True, needs_tri=True, device="cpu")
    assert tuple(mol["t_kj"].shape) == (3, 512)
    assert bool(mol["edge_mask"].all())
    c = reg.click_batch(dict(reg.DIN_SHAPES["retrieval_cand"], n_cand=700),
                        reg.ARCHES["din"].REDUCED, device="cpu")
    assert tuple(c["cand_items"].shape) == (1024,)


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b", "sssp-del"])
def test_not_yet_ported_archs_raise(arch):
    """The archs that slice 13b brought smoke as the reference's
    (tests/test_arch_smoke.py::test_smoke: finite metrics, loss > 0, the
    reference's metric keys plus the decode check); the SSSP family has
    no smoke in either package and raises in both.  ``build_program``
    (13c, once the part that raised here) now returns a ``Program`` whose
    ``meta`` is the reference's (the name is kept from when it raised)."""
    assert reg.arch(arch).FAMILY == jreg.ARCHES[arch].FAMILY
    if arch == "sssp-del":
        with pytest.raises(ValueError, match="no smoke for family sssp"):
            smoke_mod.smoke(arch, device="cpu")
        with pytest.raises(ValueError, match="no smoke for family sssp"):
            jsmoke.smoke(arch)
    else:
        metrics = smoke_mod.smoke(arch, seed=0, device="cpu")
        for k, v in metrics.items():
            assert np.isfinite(v), f"{arch}:{k} = {v}"
        assert metrics["loss"] > 0.0 and metrics["decode_finite"] == 1.0
        assert set(metrics) == set(jsmoke.smoke_lm(arch, seed=0))
    from repro.launch.mesh import make_test_mesh
    from repro_torch.launch.mesh import make_mesh
    shape = "train_4k" if arch != "sssp-del" else "relax_rmat24"
    prog = reg.build_program(arch, shape, make_mesh(
        (1, 1), ("data", "model"), devices=["meta"]))
    assert isinstance(prog, reg.Program)
    assert prog.meta == jreg.build_program(
        arch, shape, make_test_mesh((1, 1), ("data", "model"))).meta


def test_smoke_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smoke_mod.smoke("din")
