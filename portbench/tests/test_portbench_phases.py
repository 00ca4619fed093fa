"""The program's phase spans read out of a harness window on the CPU at a
tiny scale (``portbench/phases.py``): the table and its four figures,
the program's counts beside the harness's wave fold, and the clock check
on a device trace made by hand."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import devtrace, phases  # noqa: E402
from repro_torch.obs.spans import Span, SpanTracer  # noqa: E402
from test_portbench_harness import tiny  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FIGURES = ("plan_ms_per_batch", "layout_ms_per_batch",
           "dispatch_us_per_wave", "loop_idle_pct")


def run_tiny(workload: str, mode: str = "trace", obs: bool = False) -> dict:
    config, traffic = tiny(workload)
    return phases.run_one({"config": config, "traffic": traffic}, 17, 120,
                          mode, obs, device="cpu")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_window_fills_the_phase_table(workload):
    """Each span the window opens is in the table; the four figures are
    numbers; the program's waves agree with the harness's fold (exactly on
    one tree, whose deletion epochs each mark and pull once; at least as
    many on lanes, where the harness takes each epoch's busiest lane)."""
    out = run_tiny(workload)
    assert out["correct"] and out["batches"] > 20
    table = out["table"]
    assert set(phases.LOOPS + phases.PLANS + phases.LAYOUT) <= set(table)
    assert table["ingest_log"]["count"] == out["batches"]
    for name, row in table.items():
        assert 0 <= row["self_s"] <= row["s"], name
        assert 0 <= row["idle_s"] <= row["s"] + 1e-9, name
    figs = out["figures"]
    assert set(figs) == set(FIGURES)
    assert all(isinstance(figs[k], float) and figs[k] > 0 for k in FIGURES)
    # no device records on the CPU: the loops' time is all idle
    assert figs["loop_idle_pct"] == pytest.approx(100.0)
    if "lanes" in workload:
        assert out["program_waves"] >= out["harness_waves"] > 0
    else:
        assert out["program_waves"] == out["harness_waves"] > 0
    assert out["program_reads"] >= table["waves"]["iterations"]
    assert out["clock"]["inside_pct"] is None       # no device time


@pytest.mark.parametrize("obs", [False, True])
def test_an_untraced_run_with_observability_on_and_off(obs):
    out = run_tiny("kron20.micro4k", mode="onoff", obs=obs)
    assert out["correct"] and out["obs"] is obs
    assert out["events_per_s"] > 0 and out["batch_p95_ms"] > 0
    assert "table" not in out


def test_figures_from_a_table():
    table = {
        "plan_adds": dict(s=0.010, iterations=0), "plan_dels": dict(
            s=0.002, iterations=0),
        "apply_adds": dict(s=0.004, iterations=0),
        "waves": dict(s=0.030, read_wait_s=0.010, iterations=40,
                      idle_s=0.015),
        "mark": dict(s=0.010, read_wait_s=0.002, iterations=8, idle_s=0.009),
    }
    figs = phases.figures(table, batches=4)
    assert figs["plan_ms_per_batch"] == pytest.approx(3.0)
    assert figs["layout_ms_per_batch"] == pytest.approx(1.0)
    assert figs["dispatch_us_per_wave"] == pytest.approx(28e-3 / 48 * 1e6)
    assert figs["loop_idle_pct"] == pytest.approx(60.0)
    assert phases.figures({}, batches=0) == dict.fromkeys(FIGURES)


def test_clock_check_maps_spans_onto_the_device_trace():
    """Ops are judged by where they start, against the union of the
    mapped spans (a query nested in an ingest_log included), weighted by
    their device time; the drift is the offset's last sample less its
    first."""
    tr = SpanTracer(enabled=True)
    tr.offsets = [(0, 1000), (10, 1003)]
    tr.spans = [Span("ingest_log", 0, 100, 0, "X", cat="phase"),
                Span("query", 10, 20, 1, "X"),
                Span("query", 200, 10, 0, "X"),
                Span("add_epoch", 300, 50, 0, "X")]
    off = 1003
    ops = [("k", off + 50, off + 70),      # in ingest_log, past the query
           ("k", off + 205, off + 215),    # in the second query
           ("k", off + 310, off + 340),    # in add_epoch alone: not mapped
           ("k", off - 50, off - 40)]      # before the window
    dt = devtrace.DeviceTrace(ops, off, off + 400)
    got = phases.clock_check(tr, 0, 400, dt)
    assert got["inside_pct"] == pytest.approx(100 * 30 / 60)
    assert got["drift_us"] == pytest.approx(3e-3)
    assert got["offset_samples"] == 2
