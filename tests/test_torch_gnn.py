"""The GNN substrate of the port (``repro_torch.models.gnn``) against the
JAX package's: the segment aggregators (masks, empty segments, tied
maxima), and GraphSAGE, MeshGraphNet, DimeNet and EquiformerV2 at their
REDUCED configs — the node-loss forward output, loss, gradients (against
``jax.grad``) and the parameters after one train step on a padded flat
batch; the molecule graph loss on a (3, 10, 20) batch, DimeNet with its
triplets.  Inputs come from numpy seeds and the reference's initial
parameters are carried into the port (``load_jax_params``).

Tolerances (f32 on both sides; XLA and torch sum in different orders and
XLA fuses where torch rounds each op): outputs, losses and metrics rtol
1e-5 with atol 1e-6 x the largest reference entry; gradients (and Adam's
first moments) atol 1e-5 x the largest entry of the leaf's reference
gradient, and at least 1e-6 x the model's largest (a leaf whose gradient
is zero in exact arithmetic holds rounding noise alone: EquiformerV2's
attention output bias, which the softmax cannot see); parameters after
one step atol 1e-6 where |g_ref| exceeds both 1e-4 x max|g_ref| of the
leaf and the gradient's tolerance, elsewhere |delta| <= 2 lr (Adam's step
of a near-zero gradient is its sign, which rounding may flip).

EquiformerV2 is held looser (``TOLS``): its equivariant norm divides the
lone l = 0 coefficient by sqrt(x^2 + 1e-6), whose derivative reaches 1e3
where |x| ~ 1e-3, so f32 rounding is amplified: the reference's own f32
gradients lie between 1e-5 and 5e-3 of a leaf's largest entry from the
exact (f64) values (tests/test_torch_gnn_conditioning.py, ROADMAP F4).
So EquiformerV2's outputs hold to 1e-4 x the largest entry, gradients to
5e-3 x the leaf's, the gradient norm to rtol 2e-3.
"""
import functools
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models.gnn import common as JC
from repro.models.gnn import dimenet as jdimenet
from repro.models.gnn import equiformer as jeqv2
from repro.models.gnn import graphsage as jsage
from repro.models.gnn import meshgraphnet as jmgn
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import registry as reg
from repro_torch.configs import smoke as smoke_mod
from repro_torch.models.gnn import common as C
from repro_torch.models.params import load_jax_params, params_from_jax
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod

ARCHS = ["graphsage-reddit", "meshgraphnet", "dimenet", "equiformer-v2"]
OPT = dict(warmup_steps=2, total_steps=10)
# each arch's reference forward and the batch keys it takes before cfg
FORWARDS = {
    "graphsage-reddit": (jsage.sage_forward, ["feats", "src", "dst"]),
    "meshgraphnet": (jmgn.mgn_forward, ["feats", "pos", "src", "dst"]),
    "dimenet": (jdimenet.dimenet_forward,
                ["feats", "pos", "src", "dst", "t_kj", "t_ji"]),
    "equiformer-v2": (jeqv2.eqv2_forward, ["feats", "pos", "src", "dst"]),
}
# (outputs x max, gradients x leaf max, gradient-norm rtol); see above
TOLS = {"equiformer-v2": (1e-4, 5e-3, 2e-3)}
DEFAULT_TOLS = (1e-6, 1e-5, 1e-5)


def close(got, want, rtol=1e-5, rel=1e-6, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel * scale,
                               err_msg=what)


# ----------------------------------------------------------- aggregators ----

def _agg_case(seed, e=60, n=12, f=5, ties=False):
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-2, 3, (e, f)) if ties
            else rng.standard_normal((e, f))).astype(np.float32)
    dst = rng.integers(0, n - 3, e).astype(np.int32)   # last 3 segments empty
    mask = rng.random(e) < 0.7
    mask[dst == 0] = False                             # segment 0: all masked
    w = rng.standard_normal((n, f)).astype(np.float32)
    return vals, dst, mask, w, n


AGGS = {"sum": (JC.segment_sum, C.segment_sum),
        "mean": (JC.segment_mean, C.segment_mean),
        "max": (JC.segment_max, C.segment_max)}


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("ties", [False, True], ids=["real", "ties"])
@pytest.mark.parametrize("agg", list(AGGS))
def test_aggregator_matches_reference(agg, ties, masked):
    vals, dst, mask, w, n = _agg_case(3, ties=ties)
    jfn, tfn = AGGS[agg]
    m = mask if masked else None
    jout, jvjp = jax.vjp(lambda v: jfn(v, jnp.asarray(dst), n,
                                       None if m is None else jnp.asarray(m)),
                         jnp.asarray(vals))
    (jg,) = jvjp(jnp.asarray(w))
    x = torch.from_numpy(vals).requires_grad_(True)
    out = tfn(x, torch.from_numpy(dst), n,
              None if m is None else torch.from_numpy(m))
    (g,) = torch.autograd.grad(out, x, torch.from_numpy(w))
    tol = 0.0 if agg == "max" else 1e-6
    close(out, jout, rtol=tol, rel=tol, what=f"{agg} forward")
    close(g, jg, rtol=1e-6, rel=1e-6, what=f"{agg} gradient")
    if masked:   # the all-masked and the empty segments
        assert np.all(out.detach().numpy()[[0, n - 3, n - 2, n - 1]] == 0)


def test_segment_max_splits_tied_gradient_evenly():
    vals = np.array([[1.0], [3.0], [3.0], [3.0], [2.0]], np.float32)
    dst = np.array([0, 0, 0, 0, 1], np.int32)
    x = torch.from_numpy(vals).requires_grad_(True)
    (g,) = torch.autograd.grad(C.segment_max(x, torch.from_numpy(dst), 2)
                               .sum(), x)
    jg = jax.grad(lambda v: JC.segment_max(v, jnp.asarray(dst), 2).sum())(
        jnp.asarray(vals))
    want = np.array([[0], [1 / 3], [1 / 3], [1 / 3], [1]], np.float32)
    np.testing.assert_allclose(np.asarray(jg), want, rtol=1e-7)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-7)


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
def test_segment_softmax_matches_reference(masked, heads):
    rng = np.random.default_rng(5)
    e, n = 50, 10
    lg = (rng.standard_normal((e, heads)) * 4).astype(np.float32)
    dst = rng.integers(0, n - 2, e).astype(np.int32)
    mask = rng.random(e) < 0.6
    w = rng.standard_normal((e, heads)).astype(np.float32)
    m = mask if masked else None

    def jfn(v):   # the reference vmaps one column at a time
        return jax.vmap(lambda c: JC.segment_softmax(
            c, jnp.asarray(dst), n, None if m is None else jnp.asarray(m)),
            in_axes=1, out_axes=1)(v)
    jout, jvjp = jax.vjp(jfn, jnp.asarray(lg))
    (jg,) = jvjp(jnp.asarray(w))
    x = torch.from_numpy(lg).requires_grad_(True)
    out = C.segment_softmax(x, torch.from_numpy(dst), n,
                            None if m is None else torch.from_numpy(m))
    (g,) = torch.autograd.grad(out, x, torch.from_numpy(w))
    close(out, jout, what="softmax")
    close(g, jg, rel=1e-6, what="softmax gradient")


@pytest.mark.parametrize("fn", ["radial_bessel", "envelope",
                                "angular_fourier"])
def test_bases_match_reference(fn):
    rng = np.random.default_rng(1)
    d = np.concatenate([[0.0, 1e-12, 5.0, 7.0],
                        rng.random(40) * 6]).astype(np.float32)
    cosines = np.concatenate([[-1.0, 1.0, -1.5, 1.5],
                              rng.uniform(-1, 1, 40)]).astype(np.float32)
    args = {"radial_bessel": (d, 6, 5.0), "envelope": (d, 5.0),
            "angular_fourier": (cosines, 7)}[fn]
    want = getattr(JC, fn)(jnp.asarray(args[0]), *args[1:])
    got = getattr(C, fn)(torch.from_numpy(args[0]), *args[1:])
    close(got, want, what=fn)


# ------------------------------------------------------------ the models ----

def _pad_flat(batch: dict, n_pad: int, e_pad: int) -> dict:
    """The smoke graph padded as a shape's batch is: masked edges (0 -> 0)
    and nodes (label -1, zero features) past the real ones."""
    out = dict(batch)
    n, e = len(batch["labels"]), len(batch["src"])
    for k in ("feats", "pos", "labels", "label_mask"):
        a = batch[k]
        pad = np.zeros((n_pad - n,) + a.shape[1:], a.dtype)
        if k == "labels":
            pad -= 1
        out[k] = np.concatenate([a, pad])
    for k in ("src", "dst", "edge_mask"):
        out[k] = np.concatenate([batch[k], np.zeros(e_pad - e,
                                                    batch[k].dtype)])
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The reference's initial parameters (jitted: its eager vmapped inits
    take seconds)."""
    jinit = jreg._GNN_FNS[arch][2]
    return jax.jit(jinit, static_argnums=1)(jax.random.key(0),
                                            reg.ARCHES[arch].REDUCED)


def _setup(arch):
    cfg = reg.ARCHES[arch].REDUCED
    node_loss, graph_loss, init_fn, _, _ = reg._GNN_FNS[arch]
    jnode, jgraph, _, _, _ = jreg._GNN_FNS[arch]
    jparams = _jax_params(arch)
    model = load_jax_params(init_fn(cfg, device="cpu"), jparams)
    flat, mol = smoke_mod.smoke_batches(arch, seed=0)
    flat = _pad_flat(flat, 32, 80)
    return (cfg, (node_loss, graph_loss, model),
            (jnode, jgraph, jparams), flat, mol)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grad_atol(want: dict, rel: float) -> dict:
    """Each leaf's gradient tolerance (see the module docstring)."""
    floor = 1e-6 * max(float(np.abs(g).max()) for g in want.values())
    return {k: max(rel * float(np.abs(g).max()), floor)
            for k, g in want.items()}


def _close_leaves(got: dict, want: dict, rel: float, what: str):
    assert set(want) == set(got)
    for k, atol in _grad_atol(want, rel).items():
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


def _check_grads(arch, model, jgrads):
    _close_leaves({k: p.grad.numpy() for k, p in model.named_parameters()},
                  {k: v.numpy() for k, v in params_from_jax(jgrads).items()},
                  TOLS.get(arch, DEFAULT_TOLS)[1], "gradient")


@pytest.mark.parametrize("arch", ARCHS)
def test_node_forward_loss_and_gradients(arch):
    cfg, (node_loss, _, model), (jnode, _, jparams), flat, _ = _setup(arch)
    (jl, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnode(p, _j(flat), cfg), has_aux=True))(jparams)
    out_rel = TOLS.get(arch, DEFAULT_TOLS)[0]
    loss, metrics = node_loss(model, _t(flat), cfg)
    loss.backward()
    close(loss, jl, what="loss")
    for k in jm:
        close(metrics[k], jm[k], what=k)
    _check_grads(arch, model, jgrads)
    # the forward's node outputs, padded rows included (the port through
    # the module's ``forward``)
    jfn, keys = FORWARDS[arch]
    extra = ["edge_mask"] + (["triplet_mask"] if arch == "dimenet" else [])
    want = jax.jit(lambda p, a, x: jfn(p, *a, cfg, *x))(
        jparams, [jnp.asarray(flat[k]) for k in keys],
        [jnp.asarray(flat[k]) for k in extra])
    with torch.no_grad():
        got = model(*[torch.as_tensor(flat[k]) for k in keys + extra])
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want, rel=out_rel, what="node outputs")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    cfg, (node_loss, _, model), (jnode, _, jparams), flat, _ = _setup(arch)
    jcfg, tcfg = jopt.AdamWConfig(**OPT), opt_mod.AdamWConfig(**OPT)
    jstep = jsteps.make_train_step(partial(jnode, cfg=cfg), jcfg, 1)
    jnew, jstate, jm = jax.jit(jstep)(jparams, jopt.adamw_init(jparams),
                                      _j(flat))
    step = steps_mod.make_train_step(partial(node_loss, cfg=cfg), tcfg, 1)
    state = opt_mod.adamw_init(dict(model.named_parameters()))
    metrics = step(model, state, _t(flat))
    _, grad_rel, norm_rtol = TOLS.get(arch, DEFAULT_TOLS)
    for k in ("loss", "acc", "lr"):
        close(metrics[k], jm[k], what=k)
    close(metrics["grad_norm"], jm["grad_norm"], rtol=norm_rtol, rel=0)
    assert int(state["step"]) == int(jstate["step"]) == 1
    lr = float(jm["lr"])
    new, old = params_from_jax(jnew), params_from_jax(jparams)
    # the reference's clipped gradient, from its first moment (1 - b1) g
    g = {k: np.abs(v.numpy()) / (1 - jcfg.b1)
         for k, v in params_from_jax(jstate["m"]).items()}
    atol = _grad_atol(g, grad_rel)
    for k, p in model.named_parameters():
        big = g[k] > max(1e-4 * g[k].max(), atol[k])
        got, want = p.detach().numpy(), new[k].numpy()
        np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert np.all(np.abs(got - old[k].numpy())[~big] <= 2 * lr), k
    _close_leaves({k: m.numpy() for k, m in state["m"].items()},
                  {k: v.numpy()
                   for k, v in params_from_jax(jstate["m"]).items()},
                  grad_rel, "first moment")


@pytest.mark.parametrize("arch", ARCHS)
def test_molecule_graph_loss_matches_reference(arch):
    cfg, (_, graph_loss, model), (_, jgraph, jparams), _, mol = _setup(arch)
    mol = dict(mol, target=np.random.default_rng(2).standard_normal(3)
               .astype(np.float32))
    (jl, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgraph(p, _j(mol), cfg), has_aux=True))(jparams)
    loss, metrics = graph_loss(model, _t(mol), cfg)
    loss.backward()
    close(loss, jl, what="graph loss")
    close(metrics["mae"], jm["mae"], what="mae")
    _check_grads(arch, model, jgrads)
