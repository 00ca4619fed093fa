"""The harness end to end on the CPU at a tiny scale: the port judged
correct by the harness's own comparison, each fault of the timed path
judged not correct, the metric readers, the import guard and the
benchmark's file against its contract."""
from __future__ import annotations

import ast
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import graphs, harness, phases  # noqa: E402
from repro_torch.core import stream as port_stream  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TEST_SCALE = 8     # a configuration's CPU-test scale where it sets none


def tiny(workload: str) -> tuple[dict, dict]:
    """A cell's configuration and traffic cut to a CPU test's size: the
    configuration's own ``test_scale`` (``TEST_SCALE`` where it has none)
    and a stream of some 30 to 40 batches, which every window runs to its
    end."""
    cell = harness.load_cell(workload)
    config, traffic = dict(cell["config"]), dict(cell["traffic"])
    config["scale"] = int(config.get("test_scale", TEST_SCALE))
    traffic.update(batch_events=128, block_edges=48, warmup_batches=4,
                   lanes=min(int(traffic["lanes"]), 3))
    return config, traffic


def run(workload: str, seed: int = 17, trace: bool = False,
        device: str = "cpu") -> dict:
    config, traffic = tiny(workload)
    res = harness.run_cell(config, traffic, seed=seed, seconds=120,
                           trace=trace, device=device)
    assert res["end_of_stream"] and res["run"].batches > 20
    return res


def line(workload: str, res: dict, trace: bool) -> dict:
    return harness.result_line(harness.load_cell(workload), res, trace,
                               {"platform": "cpu", "kind": "cpu",
                                "count": 1})


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_port_is_judged_correct(workload):
    res = run(workload)
    out = line(workload, res, trace=False)
    assert out["correct"] and out["failed"] == 0
    assert res["checks"]["answers"] >= 7
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert out["attempted"] == res["run"].batches + len(res["run"].query_s)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_port_on_the_card_is_judged_correct(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only there")
    out = line(workload, run(workload, trace=trace, device="cuda"), trace)
    assert out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_traced_run_reports_its_per_layer_metrics(workload):
    res = run(workload, trace=True)
    out = line(workload, res, trace=True)
    assert out["correct"]
    cell = harness.load_cell(workload)
    # a CPU run has no device records: the kernels' readers find nothing
    device_free = {m["name"] for m in cell["per_layer"]
                   if m["source"] != "device_trace"}
    assert device_free <= set(out["metrics"])
    assert not any("roofline" in k for k in out["metrics"])
    # what the cell's entries promise: a wave count where it is listed
    if any(m["name"] == "waves_per_batch" for m in cell["per_layer"]):
        assert out["metrics"]["waves_per_batch"]["value"] > 0
    assert {"device_ops", "idle_gaps"} <= set(out["breakdown"])


# ------------------------------- what the traced run hands the readers --
PHASE_METRICS = ("plan_ms_per_batch", "layout_ms_per_batch",
                 "dispatch_us_per_wave", "loop_idle_pct")


@pytest.mark.parametrize("trace", [False, True])
def test_the_phase_readers_read_the_runs_phase_table(trace):
    run_ = run("kron20.micro4k", trace=trace)["run"]
    figs = (phases.figures(run_.phases, run_.batches) if trace
            else dict.fromkeys(PHASE_METRICS))
    for name in PHASE_METRICS:
        got = harness.load_reader(name)(run_)
        assert got == figs[name]
        assert (got is not None and got > 0) is trace, name
    assert (run_.counters is None) is not trace


@pytest.mark.parametrize("workload", ["kron20.micro4k", "kron20.lanes16"])
def test_run_counters_are_the_windows_part_of_the_programs(monkeypatch,
                                                          workload):
    made = []
    real = harness.make_engine
    monkeypatch.setattr(harness, "make_engine",
                        lambda *a: made.append(real(*a)) or made[-1])
    run_ = run(workload, trace=True)["run"]
    whole = made[0].obs.counters.snapshot()
    got = run_.counters
    # the set-up's layout swap is the program's, not the window's
    assert got["rebuilds"] == run_.rebuilds < whole["rebuilds"]
    assert got["add_epochs"] == run_.phases["add_epoch"]["count"]
    assert got["add_epochs"] < whole["add_epochs"]
    assert got["queries"] == len(run_.query_s)      # not the final query
    if run_.lanes > 1:
        assert got["queries_per_lane"].shape == (run_.lanes,)
        assert int(got["queries_per_lane"].sum()) == len(run_.query_s)


def test_counter_delta_of_scalars_and_vectors():
    start = {"a": 3, "v": np.array([1, 2])}
    end = {"a": 5, "v": np.array([4, 2]), "new": 7}
    got = harness._counter_delta(end, start)
    assert got["a"] == 2 and got["new"] == 7
    np.testing.assert_array_equal(got["v"], [3, 0])


GRID = '''"""A rows x cols grid, each edge to the right and down, weights and
arrival order from the seed."""
import torch
from portbench.graphs import Edges


def generate(cfg, gen):
    rows, cols, dev = int(cfg["rows"]), int(cfg["cols"]), gen.device
    ids = torch.arange(rows * cols, device=dev).reshape(rows, cols)
    u = torch.cat([ids[:, :-1].reshape(-1), ids[:-1, :].reshape(-1)])
    v = torch.cat([ids[:, 1:].reshape(-1), ids[1:, :].reshape(-1)])
    order = torch.randperm(len(u), generator=gen, device=dev)
    w = torch.randint(int(cfg["weight_min"]), int(cfg["weight_max"]) + 1,
                      (len(u),), generator=gen, device=dev)
    return Edges(rows * cols, u[order], v[order], w.to(torch.float32))
'''


@pytest.mark.parametrize("trace", [False, True])
def test_a_generator_file_runs_a_cell_with_no_harness_edit(
        monkeypatch, tmp_path, trace):
    """A configuration that names ``generators/grid.py``, a graph of long
    paths, runs to ``correct`` under the cell's own limits."""
    (tmp_path / "grid.py").write_text(GRID)
    monkeypatch.setattr(graphs, "GENERATORS_DIR", tmp_path)
    config, traffic = tiny("urand20.micro4k")
    del config["scale"], config["edge_factor"]
    config.update(generator="grid", rows=30, cols=34)
    res = harness.run_cell(config, traffic, seed=2**31 + 5, seconds=120,
                           trace=trace, device="cpu")
    out = line("urand20.micro4k", res, trace)
    assert res["run"].n == 30 * 34 and res["run"].batches > 20
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["answers_checked"]["value"] >= 7
    # far ends of a grid: tens of hops at weights up to 255
    assert 2000 < out["checks"]["max_ref_dist"]["value"] < 2**24
    if trace:
        assert set(PHASE_METRICS) <= set(out["metrics"])


# ------------------------------------------- faults of the timed path ---
def _after_setup(real, broken, setup_calls: int):
    """``real`` for the first ``setup_calls`` calls, then ``broken``."""
    calls = [0]

    def wrapped(self, *a, **k):
        calls[0] += 1
        return (broken if calls[0] > setup_calls else real)(self, *a, **k)
    return wrapped


def faults(real_ingest, real_query):
    """The timed path broken underneath, by fault: each returns the
    ``ingest_log`` or ``query`` that takes the real one's place."""
    def skip_step(self, log, *a, **k):
        return []                      # the state left unchanged

    def half_batch(self, log, *a, **k):
        return real_ingest(self, log[:len(log) // 2], *a, **k)

    def altered_answer(self, *a, **k):
        res = real_query(self, *a, **k)
        dist = res.dist.copy()
        flat = dist.reshape(-1)        # a lane, or the [S, N] stack
        flat[np.flatnonzero(np.isfinite(flat))[-1]] += 1
        return dataclasses.replace(res, dist=dist)

    # the base load and the 4 warm-up batches (and a query) run intact
    return {
        "skip_step": ("ingest_log", _after_setup(real_ingest, skip_step, 5)),
        "half_batch": ("ingest_log", _after_setup(real_ingest, half_batch, 5)),
        "altered_answer": ("query", _after_setup(real_query, altered_answer,
                                                 4))}


@pytest.mark.parametrize("fault", ["skip_step", "half_batch",
                                   "altered_answer"])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_broken_timed_path_is_judged_not_correct(monkeypatch, workload,
                                                   fault):
    base = port_stream.StreamEngineBase
    name, broken = faults(base.ingest_log, base.query)[fault]
    monkeypatch.setattr(base, name, broken)
    out = line(workload, run(workload), trace=False)
    assert not out["correct"]
    assert out["failed"] > 0
    assert out["checks"]["dist_wrong"]["value"] > 0


def test_a_corrupted_parent_is_judged_not_correct(monkeypatch):
    real_query = port_stream.StreamEngineBase.query

    def query(self, *a, **k):
        res = real_query(self, *a, **k)
        par = res.parent.copy()
        par[par >= 0] = (par[par >= 0] + 1) % len(par)
        return dataclasses.replace(res, parent=par)
    monkeypatch.setattr(port_stream.StreamEngineBase, "query", query)
    out = line("urand20.micro4k", run("urand20.micro4k"), trace=False)
    assert not out["correct"]
    assert out["checks"]["parent_wrong"]["value"] > 0


# ------------------------------------------------------- import guard ---
def test_guard_finds_jax_and_the_jax_package_by_whole_name(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "repro.core.engine", object())
    monkeypatch.setitem(sys.modules, "jaxlib_like", object())
    found = harness.forbidden_modules()
    assert "repro" in found and "jaxlib_like" not in found
    assert "repro_torch" not in found


def test_a_run_loads_no_jax_in_a_fresh_process():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from portbench import harness\n"
            "import json\n"
            "cfg = json.loads(open(%r).read()); cfg['scale'] = 8\n"
            "tr = json.loads(open(%r).read())\n"
            "tr.update(batch_events=64, block_edges=24, warmup_batches=2)\n"
            "harness.run_cell(cfg, tr, seed=3, seconds=0.2, trace=True, "
            "device='cpu')\n"
            "print(harness.forbidden_modules())\n"
            % (str(ROOT), str(ROOT / "src"),
               str(ROOT / "portbench/configs/gap-kron20.json"),
               str(ROOT / "portbench/traffic/micro4k.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_harness_imports_nothing_of_jax_and_reads_no_old_benchmark():
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_sssp" not in text
        for node in ast.walk(ast.parse(text)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, path


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "kron20.micro4k",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


# --------------------------------------------- the file and its parts ---
def test_benchmark_file_meets_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(
        cells)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert set(c["reduced"]) <= set(json.loads(
            (ROOT / c["file"]).read_text())["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m["unit"]
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert m["moves"] in [x["name"] for x in
                                  harness.load_cell(w)["end_to_end"]]
    for text in [c["source"] for c in configs.values()] + [
            m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
