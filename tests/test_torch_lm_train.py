"""The port's training substrate for the LMs against the JAX package's:
``train/checkpoint.py`` (a checkpoint written by either package restores
in the other, chunked leaves too; a crash that leaves only ``.tmp``;
retention; the async saver's snapshot; leaf-count and shape mismatches
raise), ``train/compression.py`` (against the reference under
``jax.vmap(axis_name=...)``), ``TokenStream`` restarts, and the launcher
``python -m repro_torch.launch.train --device cpu`` in subprocesses: a run
crashed at step k and resumed ends with the parameters, moments and data
position of an uninterrupted run; the example
``examples/torch_train_lm.py`` runs its crash-and-resume cycle.

Tolerances: checkpoints and restarts bit for bit (the same bytes; on the
CPU the resumed run repeats the same ops); compression exactly (int8
grids and their f32 rescale: the same f32 ops in both packages).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _lm_ref as R
from repro.launch import train as jlaunch
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro_torch.launch import train as launch
from repro_torch.models.params import params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod

ROOT = Path(__file__).resolve().parents[1]
ARCH = "minicpm3-4b"   # MLA: the leaf names that sort least like a join


def _jax_tree():
    """A reference train tree with every leaf distinct (moments and step
    non-zero)."""
    jp = R.jax_params(ARCH)
    rng = np.random.default_rng(0)
    m = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), jp)
    v = jax.tree.map(lambda p: jnp.asarray(
        rng.random(p.shape).astype(np.float32)), jp)
    return {"params": jp, "opt": {"m": m, "v": v, "step": jnp.int32(7)},
            "data": {"step": jnp.int32(11)}}


def _port_tree():
    _, tc = R.configs(ARCH)
    model = R.port_model(tc, R.jax_params(ARCH))
    state = opt_mod.adamw_init(dict(model.named_parameters()))
    return model, state


def _flat_np(tree) -> dict:
    return {".".join(map(str, p)): np.asarray(
        v.detach().numpy() if isinstance(v, torch.Tensor) else v)
        for p, v in ckpt.flat_leaves(tree)}


@pytest.mark.parametrize("chunk_bytes", [256 << 20, 4096],
                         ids=["whole", "chunked"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, chunk_bytes):
    jt = _jax_tree()
    jckpt.save(jt, str(tmp_path), 5, chunk_bytes=chunk_bytes)
    model, state = _port_tree()
    like = launch.train_tree(model, state, 0)
    got = ckpt.restore(like, str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 5
    want = {**{f"params.{k}": v.numpy()
               for k, v in params_from_jax(jt["params"]).items()},
            **{f"opt.m.{k}": v.numpy()
               for k, v in params_from_jax(jt["opt"]["m"]).items()},
            **{f"opt.v.{k}": v.numpy()
               for k, v in params_from_jax(jt["opt"]["v"]).items()},
            "opt.step": np.int32(7), "data.step": np.int32(11)}
    flat = _flat_np(got)
    assert set(flat) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(flat[k], w, err_msg=k)
    assert got["opt"]["step"].dtype == torch.int32
    if chunk_bytes == 4096:
        files = os.listdir(tmp_path / "step_000000005")
        assert any(f.endswith("_0001.npy") for f in files)


@pytest.mark.parametrize("chunk_bytes", [256 << 20, 4096],
                         ids=["whole", "chunked"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, chunk_bytes):
    model, state = _port_tree()
    g = torch.Generator().manual_seed(1)
    for d in (state["m"], state["v"]):
        for t in d.values():
            t.normal_(generator=g)
    state["step"] = torch.tensor(3, dtype=torch.int32)
    tree = launch.train_tree(model, state, 9)
    ckpt.save(tree, str(tmp_path), 3, chunk_bytes=chunk_bytes)
    jt = _jax_tree()
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jt)
    got = jckpt.restore(like, str(tmp_path))
    assert int(got["opt"]["step"]) == 3 and int(got["data"]["step"]) == 9
    for k, v in params_from_jax(got["params"]).items():
        np.testing.assert_array_equal(
            v.numpy(), model.get_parameter(k).detach().numpy(), err_msg=k)
    for which in ("m", "v"):
        for k, v in params_from_jax(got["opt"][which]).items():
            np.testing.assert_array_equal(v.numpy(), state[which][k].numpy())


@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_reference_params_and_adamw_state_load_strictly(arch):
    """Every LM arch's reference parameters load with one strict
    ``load_state_dict`` (``port_model``), and its AdamW state maps onto the
    port's flat state leaf for leaf (``adamw_state_from_jax``)."""
    from repro_torch.models.params import adamw_state_from_jax
    jp = R.jax_params(arch)
    _, tc = R.configs(arch)
    model = R.port_model(tc, jp)
    js = jopt.adamw_init(jp)
    js = dict(js, m=jax.tree.map(lambda p: p * 0.5, jp),
              step=jnp.int32(4))
    state = adamw_state_from_jax(js, device="cpu")
    names = dict(model.named_parameters())
    assert set(state["m"]) == set(state["v"]) == set(names)
    for k, p in names.items():
        np.testing.assert_array_equal(state["m"][k].numpy(),
                                      p.detach().numpy() * 0.5)
    assert int(state["step"]) == 4 and state["step"].dtype == torch.int32


def test_leaf_order_is_by_path_segments():
    """Keys sort segment by segment, as ``tree_flatten`` sorts dicts, not
    by the joined string: "a" / "b" comes before "a-b" although the string
    "a-b" sorts before "a.b"."""
    tree = ckpt.nest({"a-b": 1, "a.b": 2, "a.c.0": 3, "a.c.1": 4, "b": 5})
    assert [v for _, v in ckpt.flat_leaves(tree)] == \
        jax.tree_util.tree_leaves(tree) == [2, 3, 4, 1, 5]
    assert tree["a"]["c"] == [3, 4]


def test_crash_leaves_only_tmp_and_retention(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "s": torch.tensor(1, dtype=torch.int32)}
    for s in (1, 2, 3):
        ckpt.save(tree, d, s)
    # a crash mid-write of step 4: its .tmp exists, no rename happened
    os.makedirs(tmp_path / "step_000000004.tmp")
    np.save(tmp_path / "step_000000004.tmp" / "leaf_00000_0000.npy",
            np.zeros(3))
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 3
    ckpt.cleanup(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_000000002", "step_000000003",
                                     "step_000000004.tmp"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tree, str(tmp_path / "none"))


def test_restore_checks_leaves_and_shapes(tmp_path):
    d = str(tmp_path)
    ckpt.save({"a": torch.zeros(2, 3), "b": torch.zeros(4)}, d, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore({"a": torch.zeros(3, 2), "b": torch.zeros(4)}, d)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore({"a": torch.zeros(2, 3)}, d)
    got = ckpt.restore({"a": torch.zeros(2, 3, dtype=torch.float64),
                        "b": np.zeros(4, np.float32)}, d)
    assert got["a"].dtype == torch.float64
    assert isinstance(got["b"], np.ndarray)
    # a tensor leaf lands on the device of the tensor it replaces unless
    # the caller names one
    assert got["a"].device == torch.device("cpu")
    on_meta = ckpt.restore({"a": torch.zeros(2, 3), "b": torch.zeros(4)},
                           d, device="meta")
    assert on_meta["a"].is_meta and on_meta["b"].is_meta


def test_async_saver_snapshots_before_returning(tmp_path):
    d = str(tmp_path)
    w = torch.arange(1 << 16, dtype=torch.float32)
    saver = ckpt.AsyncSaver()
    saver.save({"w": w}, d, 1, chunk_bytes=1 << 12)
    w.add_(1.0)              # the next step writes the parameters in place
    saver.save({"w": w}, d, 2)
    saver.wait()
    assert ckpt.latest_step(d) == 2
    one = ckpt.restore({"w": w}, d, 1)["w"]
    two = ckpt.restore({"w": w}, d, 2)["w"]
    assert torch.equal(one + 1.0, two) and torch.equal(two, w)
    got = jckpt.restore({"w": jax.ShapeDtypeStruct(w.shape, jnp.float32)},
                        d, 1)
    np.testing.assert_array_equal(np.asarray(got["w"]), one.numpy())


# ------------------------------------------------------------ compression ----

def _grads(P=4, seed=0):
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((P, 5, 7)).astype(np.float32) * 3,
         "b": rng.standard_normal((P, 33)).astype(np.float32)}
    g["b"][1] *= 1e-3          # a participant with a far smaller scale
    return g


def test_quantize_rounds_half_to_even_as_the_reference():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.25], np.float32)
    q, s = comp.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    ties = np.array([0.5, 1.5, 2.5, 127.0], np.float32)   # scale = 1
    assert comp.quantize_int8(torch.from_numpy(ties))[0].tolist() == \
        [0, 2, 2, 127]
    np.testing.assert_array_equal(
        comp.dequantize_int8(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))


def test_compressed_psum_and_error_feedback_match_reference():
    g = _grads()
    for k, x in g.items():
        want = jax.vmap(lambda v: jcomp.compressed_psum(v, "pod"),
                        axis_name="pod")(jnp.asarray(x))
        got = comp.compressed_psum(torch.from_numpy(x))
        for p in range(x.shape[0]):     # every participant gets the sum
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[p]))
        listed = comp.compressed_psum([torch.from_numpy(a) for a in x])
        assert torch.equal(listed, got)
    ef = comp.ef_init({k: torch.from_numpy(v) for k, v in g.items()})
    jef = jcomp.ef_init({k: jnp.asarray(v) for k, v in g.items()})
    for rnd in range(3):       # the memory carries across rounds
        g = _grads(seed=rnd + 1)
        red, ef = comp.ef_compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, ef)
        jred, jef = jax.vmap(lambda gg, e: jcomp.ef_compress_tree(
            gg, e, "pod"), axis_name="pod")(
            {k: jnp.asarray(v) for k, v in g.items()}, jef)
        for k in g:
            np.testing.assert_array_equal(red[k].numpy(),
                                          np.asarray(jred[k][0]))
            np.testing.assert_array_equal(ef[k].numpy(), np.asarray(jef[k]))
    tree = {k: torch.from_numpy(v) for k, v in g.items()}
    assert comp.compression_ratio(tree) == jcomp.compression_ratio(
        {k: jnp.asarray(v) for k, v in g.items()})


# ------------------------------------------------------ data, launcher ----

def test_token_stream_restarts_where_it_stopped():
    a = data_mod.TokenStream(vocab_size=300, batch=2, seq_len=9, seed=4)
    ja = jdata.TokenStream(vocab_size=300, batch=2, seq_len=9, seed=4)
    for _ in range(3):
        x, y = a.next_batch(), ja.next_batch()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    b = data_mod.TokenStream(vocab_size=300, batch=2, seq_len=9, seed=4)
    b.restore(a.state())
    x, y, z = b.next_batch(), a.next_batch(), ja.next_batch()
    for k in x:
        np.testing.assert_array_equal(x[k], y[k])
        np.testing.assert_array_equal(x[k], z[k])
    assert b.state() == a.state() == ja.state() == {"step": 4}


@pytest.mark.parametrize("preset", ["smoke", "100m", "full"])
def test_preset_configs_equal_reference(preset):
    import dataclasses
    ours = dataclasses.asdict(launch.preset_config("qwen3-14b", preset))
    ref = dataclasses.asdict(jlaunch.preset_config("qwen3-14b", preset))
    assert ours.pop("compute_dtype") == torch.bfloat16
    assert ref.pop("compute_dtype") == jnp.bfloat16
    assert ours == ref


def _launch(args, **kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "12", "--batch", "2", "--seq", "16", "--ckpt-every", "4",
         "--log-every", "1"] + args, env=env, capture_output=True, text=True,
        timeout=240, **kw)


def test_launcher_crash_and_resume_equals_an_uninterrupted_run(tmp_path):
    crashed, whole = str(tmp_path / "crashed"), str(tmp_path / "whole")
    out = _launch(["--ckpt-dir", crashed, "--fail-at-step", "7"])
    assert out.returncode == 17, out.stderr
    assert "INJECTED FAILURE at step 7" in out.stdout
    assert ckpt.latest_step(crashed) == 4
    resumed = _launch(["--ckpt-dir", crashed, "--resume"])
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed from step 4" in resumed.stdout
    ref = _launch(["--ckpt-dir", whole])
    assert ref.returncode == 0, ref.stderr

    def losses(text):
        return {ln.split()[2]: ln.split()[4] for ln in text.splitlines()
                if ln.startswith("[train] step ")}
    a, b = losses(resumed.stdout), losses(ref.stdout)
    assert set(a) == {str(s) for s in range(5, 13)}
    assert all(a[s] == b[s] for s in a)
    # retention: the final save and one before it
    assert sorted(os.listdir(crashed)) == ["step_000000008",
                                           "step_000000012"]
    for p in ("step_000000008", "step_000000012"):
        x = _flat_np(_restore_np(os.path.join(crashed, p)))
        y = _flat_np(_restore_np(os.path.join(whole, p)))
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{p} {k}")


def _restore_np(path: str) -> dict:
    """A checkpoint's leaves as {index: array}, read through the JAX
    package's restore with shapes from its manifest."""
    import json
    with open(os.path.join(path, "MANIFEST.json")) as f:
        meta = json.load(f)["leaves"]
    like = {f"{i:05d}": jax.ShapeDtypeStruct(tuple(m["shape"]), m["dtype"])
            for i, m in enumerate(meta)}
    d, step = os.path.split(path)
    return jax.tree.map(np.asarray, jckpt.restore(like, d,
                                                  int(step.split("_")[1])))


def test_example_runs_its_restart_cycle_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_lm.py"),
         "--device", "cpu", "--steps", "12"], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "INJECTED FAILURE at step 6" in out.stdout
    assert "resumed from step 4" in out.stdout
    assert "restart cycle complete" in out.stdout
