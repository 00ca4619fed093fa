"""The port's sharding rules (``repro_torch.models.sharding``) against the
JAX package's: ``lm_param_specs`` for every leaf of the five LM archs at
full CONFIG (the port's init on ``meta``, the reference's
``jax.eval_shape``) and ``cache_spec`` of the decode_32k and prefill_32k
caches, on the production meshes {data: 16, model: 16} and {pod: 2,
data: 16, model: 16}; ``spec_for``, ``batch_axes``, ``lm_batch_spec`` and
``graph_axes``; the activation constraints are identities; and the port's
LM parameter shapes and dtypes against the reference's at REDUCED and full
CONFIG.  The reference's functions read only ``mesh.shape`` and
``mesh.axis_names``, so a stand-in object serves it; the port takes its
own ``Mesh`` (256 or 512 CPU devices listed, nothing allocated).  All
exact: these are axis names and shapes.
"""
from types import SimpleNamespace

import pytest
import torch

import jax

import _lm_ref as R
from repro.configs import registry as jreg
from repro.models import sharding as jshd
from repro.models import transformer as jtfm
from repro_torch.configs import registry as reg
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tfm

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(which):
    shape, axes = MESHES[which]
    ours = make_mesh(shape, axes, devices=["cpu"] * int(
        torch.tensor(shape).prod()))
    ref = SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)
    return ours, ref


def _flat_specs(tree) -> dict:
    """The reference's spec tree as {path joined by '.': tuple}."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jshd.P))[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        out[key] = tuple(spec)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    cfg = reg.arch(arch).CONFIG
    ours_mesh, ref_mesh = _meshes(mesh)
    model = tfm.init_lm(cfg, device="meta")
    pshape = jtfm.lm_param_shapes(jreg.ARCHES[arch].CONFIG)
    got = shd.lm_param_specs(model, ours_mesh)
    want = _flat_specs(jshd.lm_param_specs(pshape, ref_mesh))
    assert got == want
    # shapes alone serve as well as the module
    assert shd.lm_param_specs({k: tuple(v.shape) for k, v in
                               model.state_dict().items()}, ours_mesh) == got
    # something is sharded over each axis the mesh has
    used = {a for s in got.values() for e in s if e is not None
            for a in ((e,) if isinstance(e, str) else e)}
    assert used == {"data", "model"}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_cache_spec_equal_reference(arch, shape, mesh):
    info = reg.LM_SHAPES[shape]
    cfg = reg.arch(arch).CONFIG
    ours_mesh, ref_mesh = _meshes(mesh)
    cache = tfm.init_cache(cfg, info["batch"], info["seq"], device="meta")
    jcache = jtfm.cache_shapes(jreg.ARCHES[arch].CONFIG, info["batch"],
                               info["seq"])
    assert tuple(cache.k.shape) == jcache.k.shape
    assert tuple(cache.v.shape) == jcache.v.shape
    assert cache.k.dtype == torch.bfloat16
    want = _flat_specs(jshd.cache_spec(jcache, ref_mesh))
    assert shd.cache_spec(cache, ours_mesh) == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_axis_helpers_equal_reference(mesh):
    ours, ref = _meshes(mesh)
    assert shd.batch_axes(ours) == jshd.batch_axes(ref)
    assert shd.lm_batch_spec(ours) == tuple(jshd.lm_batch_spec(ref))
    assert shd.graph_axes(ours) == jshd.graph_axes(ref)
    for shape, wanted in [((48, 32), ("data", "model")),
                          ((40, 7), ("model", "data")),
                          ((64, 64, 2), (("pod", "data"), None, "model")),
                          ((3,), (None,)), ((32,), ("nope",))]:
        assert shd.spec_for(shape, wanted, ours) == \
            tuple(jshd.spec_for(shape, wanted, ref))


def test_activation_constraints_are_identities():
    ours, _ = _meshes("pod")
    x = torch.randn(4, 8)
    with shd.activation_context(ours, shd.batch_axes(ours)):
        assert shd.wsc(x, "batch", None) is x
        assert shd.wsc_batch(x) is x


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_init_shapes_equal_reference(arch, full):
    cfg = getattr(reg.arch(arch), "CONFIG" if full else "REDUCED")
    jcfg = getattr(jreg.ARCHES[arch], "CONFIG" if full else "REDUCED")
    model = tfm.init_lm(cfg, device="meta")
    want = {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jtfm.lm_param_shapes(jcfg))[0]}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        want
    assert all(p.dtype == torch.float32 for p in model.parameters())
    half = tfm.init_lm(cfg, device="meta", dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in half.parameters())
