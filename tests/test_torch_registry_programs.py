"""The port's ``build_program`` (``repro_torch.configs.registry``) against
the JAX package's, cell by cell: the ``meta`` dict equal for every cell
that is not skipped, the argument shapes and dtypes equal leaf by leaf at
a (1, 1) mesh, the sharding specs equal at the pod (16, 16) and multipod
(2, 16, 16) mesh shapes, donated arguments equal, and a skipped cell
raises with the reference's message.  Departures (registry docstring):
the decode cache's ``length`` is a host int (no leaf), the SSSP
programs take one tensor a partition (compared as the global vector) and
the pools as ``EdgePool`` fields; the reference's ``rounds`` output is a
host int.  All exact: shapes, dtypes, specs and integers."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_test_mesh
from repro.models import sharding as jshd
from repro_torch.configs import registry as reg
from repro_torch.roofline.trace_analysis import leaves, sharded_leaves
from repro_torch.launch.mesh import make_mesh

CELLS = [(c.arch, c.shape) for c in reg.all_cells() if not c.skip]
SKIPPED = [(c.arch, c.shape) for c in reg.all_cells() if c.skip]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
# the reference's seven flat SSSP arrays and the port's leaves for them
SSSP_LEAVES = {"0": "0", "1": "1", "2": "2", "3": "3.src", "4": "3.dst",
               "5": "3.w", "6": "3.active"}
DTYPES = {"float32": torch.float32, "int32": torch.int32,
          "bool": torch.bool, "bfloat16": torch.bfloat16}


def _key(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "name",
                                                  getattr(k, "idx", k))))
                    for k in path)


def _ref_leaves(tree, is_leaf=None) -> dict:
    return {_key(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=is_leaf)[0]}


def _port_mesh(shape, axes):
    return make_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def ref_programs():
    mesh = make_test_mesh((1, 1), ("data", "model"))
    return {cell: jreg.build_program(*cell, mesh) for cell in CELLS}


@pytest.fixture(scope="module")
def programs():
    mesh = _port_mesh((1, 1), ("data", "model"))
    return {cell: reg.build_program(*cell, mesh) for cell in CELLS}


def _ports_view(arch, leaves: dict) -> dict:
    """The reference's leaf names for the port's (the SSSP departure)."""
    if reg.ARCHES[arch].FAMILY != "sssp":
        return leaves
    return {r: leaves[p] for r, p in SSSP_LEAVES.items()}


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_meta_and_donation_equal_reference(cell, programs, ref_programs):
    prog, ref = programs[cell], ref_programs[cell]
    assert isinstance(prog, reg.Program)
    assert prog.meta == ref.meta
    assert {k: type(v) for k, v in prog.meta.items()}.keys() == \
        ref.meta.keys()
    assert prog.donate_argnums == ref.donate_argnums
    assert len(prog.args) == len(ref.args) or \
        reg.ARCHES[cell[0]].FAMILY == "sssp"


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_argument_shapes_equal_reference(cell, programs, ref_programs):
    prog, ref = programs[cell], ref_programs[cell]
    got = _ports_view(cell[0], {
        path: (shape, ts[0].dtype) for path, shape, _, ts, _ in
        sharded_leaves(prog.args, prog.in_shardings)})
    want = {k: (tuple(v.shape), DTYPES[np.dtype(v.dtype).name])
            for k, v in _ref_leaves(ref.args).items()}
    if reg.LM_SHAPES.get(cell[1], {}).get("kind") == "decode":
        assert want.pop("1.length") == ((), torch.int32)  # a host int here
    assert got == want
    assert all(t.is_meta for _, t in leaves(prog.args))


def _ref_specs(monkeypatch, cell, ref_mesh):
    """The reference's in/out spec trees on a mesh of the given shape: its
    builders with ``NamedSharding`` returning the bare spec (so a
    ``SimpleNamespace`` serves as the mesh) and the activation constraints
    off (they need devices)."""
    monkeypatch.setattr(jreg, "_ns", lambda mesh, spec: spec)
    monkeypatch.setattr(jshd, "wsc", lambda x, *wanted: x)
    monkeypatch.setattr(jshd, "wsc_batch", lambda x: x)
    import repro.models.transformer as jtfm
    monkeypatch.setattr(jtfm, "_wsc_batch", lambda x: x)
    ref = jreg.build_program(*cell, ref_mesh)
    is_spec = lambda x: isinstance(x, jshd.P)  # noqa: E731
    return ({k: tuple(v) for k, v in
             _ref_leaves(ref.in_shardings, is_spec).items()},
            {k: tuple(v) for k, v in
             _ref_leaves(ref.out_shardings, is_spec).items()})


NON_SSSP = [c for c in CELLS if reg.ARCHES[c[0]].FAMILY != "sssp"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", NON_SSSP, ids=["/".join(c) for c in
                                                NON_SSSP])
def test_specs_equal_reference(cell, mesh, monkeypatch):
    shape, axes = MESHES[mesh]
    ref_mesh = SimpleNamespace(shape=dict(zip(axes, shape)),
                               axis_names=axes)
    want_in, want_out = _ref_specs(monkeypatch, cell, ref_mesh)
    prog = reg.build_program(*cell, _port_mesh(shape, axes))
    got_in = {p: s for p, _, _, _, s in
              sharded_leaves(prog.args, prog.in_shardings)}
    if reg.LM_SHAPES.get(cell[1], {}).get("kind") == "decode":
        assert want_in.pop("1.length") == ()
    assert got_in == want_in
    assert _flat_specs(prog.out_shardings) == want_out


def _is_spec(x) -> bool:
    """A spec tuple: every entry None, an axis name or a tuple of names
    (a tree tuple holds dicts or specs; the meshes here have 2-3 axes)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _flat_specs(tree, path="") -> dict:
    """The port's spec tree as ``{path: spec}``, the reference's paths."""
    if _is_spec(tree):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{path}.{k}" if path else str(k)))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(reg.SSSP_SHAPES))
def test_sssp_specs_equal_reference(shape, mesh):
    """The reference shards each of its seven arrays, and its dist and
    parent outputs, over every mesh axis (``P(axes)``); the port gives
    each partition list, and each pool field, that one spec."""
    mshape, axes = MESHES[mesh]
    ref_mesh = SimpleNamespace(shape=dict(zip(axes, mshape)),
                               axis_names=axes)
    want = tuple(jshd.P(jshd.graph_axes(ref_mesh)))
    prog = reg.build_program("sssp-del", shape, _port_mesh(mshape, axes))
    leaves = list(sharded_leaves(prog.args, prog.in_shardings))
    assert [p for p, *_ in leaves] == list(SSSP_LEAVES.values())
    assert all(s == want for *_, s in leaves)
    assert prog.out_shardings == (want, want, ())
    info = reg.SSSP_SHAPES[shape]
    P = int(np.prod(mshape))
    assert [sh for _, sh, *_ in leaves] == [(info["n"],)] * 3 + \
        [(P * info["epp"],)] * 4


@pytest.mark.parametrize("cell", SKIPPED, ids=["/".join(c) for c in SKIPPED])
def test_skipped_cell_raises_reference_message(cell):
    mesh = _port_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError) as got:
        reg.build_program(*cell, mesh)
    with pytest.raises(ValueError) as want:
        jreg.build_program(*cell, make_test_mesh((1, 1), ("data", "model")))
    assert str(got.value) == str(want.value)


def test_fill_and_fn_run_on_the_cpu():
    """``fill`` makes the meta arguments' shapes and dtypes with data, and
    ``fn`` runs on them (a cheap cell of each kind on a (1, 1) CPU mesh):
    a GNN train step updates the parameters in place and returns them."""
    mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    prog = reg.build_program("graphsage-reddit", "molecule", mesh)
    args = prog.fill(3)
    assert [(p, s, t[0].dtype) for p, s, _, t, _ in
            sharded_leaves(args, prog.in_shardings)] == \
        [(p, s, t[0].dtype) for p, s, _, t, _ in
         sharded_leaves(prog.args, prog.in_shardings)]
    before = {k: v.clone() for k, v in args[0].named_parameters()}
    params, opt, metrics = prog.fn(*args)
    assert set(metrics) == {"loss", "mae", "grad_norm", "lr"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(params[k] is v for k, v in args[0].named_parameters())
    assert any(not torch.equal(before[k], params[k]) for k in before)
    assert int(opt["step"]) == 1


@pytest.mark.parametrize("kind", ["relax", "delete"])
def test_sssp_fill_and_epoch_on_the_cpu(kind, monkeypatch):
    """The SSSP cells' seeded inputs (a cell shrunk to 2^12 vertices):
    relax from the highest out-degree vertex, or its converged tree with
    ``SSSP_DELETIONS`` tree edges deleted and seeded; the epoch's result
    is Dijkstra's on the remaining edges."""
    from repro_torch.core import oracle
    shape = f"{kind}_rmat24"
    monkeypatch.setitem(reg.SSSP_SHAPES, shape,
                        dict(kind=kind, n=1 << 12, epp=1 << 12))
    mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    prog = reg.build_program("sssp-del", shape, mesh)
    args = prog.fill(5)
    dist, parent, mask, pools = args
    assert [(s, t[0].dtype) for _, s, _, t, _ in
            sharded_leaves(args, prog.in_shardings)] == \
        [(s, t[0].dtype) for _, s, _, t, _ in
         sharded_leaves(prog.args, prog.in_shardings)]
    eng = prog.exchange
    src, dst = eng.to_host([p.src for p in pools]), \
        eng.to_host([p.dst for p in pools])
    w, act = eng.to_host([p.w for p in pools]), \
        eng.to_host([p.active for p in pools])
    source = int(np.flatnonzero(eng.to_host(dist) == 0.0)[0])
    if kind == "relax":
        assert int(eng.to_host(mask).sum()) == 1
    else:
        assert int(eng.to_host(mask).sum()) == reg.SSSP_DELETIONS
        assert int((~act).sum()) >= reg.SSSP_DELETIONS
    out_dist, _, rounds = prog.fn(*args)
    assert rounds >= 1
    want, _ = oracle.dijkstra(1 << 12, src[act], dst[act], w[act], source)
    got = eng.to_host(out_dist)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4)
