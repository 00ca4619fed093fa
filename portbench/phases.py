"""The program's phase spans in a traced window, beside the device trace,
and a runner that runs cells with them read out.

``repro_torch``'s tracer splits each epoch into host phases (``obs/
spans.py``: ``ingest_log``, ``plan_adds``, ``plan_dels``, ``apply_adds``,
``apply_dels``, ``mark``, ``waves``), each with its host reads, the time
blocked in them and, on the loops, their passes.  ``window_table`` folds
the spans that start inside the measured window per name and adds the
device-idle seconds inside them, mapped with the tracer's own clock offset;
``figures`` reduces that table to four per-layer numbers, and
``clock_check`` says how well the two clocks line up.  The harness's
traced run keeps the table as ``Run.phases`` and prints it with the clock
check; ``metrics/`` reads the four numbers from it.

    python3 portbench/phases.py --workload kron20.micro4k --seeds 7,8 \
        --seconds 51 --mode trace      # traced runs, phases read out
    python3 portbench/phases.py --workload kron20.micro4k --seeds 7,8,9 \
        --seconds 51 --mode onoff      # observability off and on, no profiler

Each run prints ``PHASES {json}`` on standard output and the tables on
standard error; ``--out FILE`` appends each line to FILE as well.  Exits
2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LOOPS = ("waves", "mark")          # the epochs' wave and marking loops
PLANS = ("plan_adds", "plan_dels")     # the slot allocator
LAYOUT = ("apply_adds", "apply_dels")  # pool and layout patches
MAPPED = ("ingest_log", "query")       # the program's outermost spans


def _intervals(tracer, spans) -> np.ndarray:
    """[k, 2] Unix-epoch ns intervals of ``spans`` (the tracer's clock)."""
    return np.array([[tracer.to_unix_ns(s.t0_ns),
                      tracer.to_unix_ns(s.t0_ns + s.dur_ns)]
                     for s in spans], np.int64).reshape(-1, 2)


def window_spans(tracer, w0: int, w1: int) -> list:
    """The complete spans that start in [w0, w1) (perf_counter_ns)."""
    return [s for s in tracer.spans
            if s.phase == "X" and w0 <= s.t0_ns < w1]


def window_table(tracer, w0: int, w1: int, device=None) -> dict:
    """Per span name, in seconds: ``count``, ``s``, ``self_s``, ``reads``,
    ``read_wait_s``, ``iterations`` and, with a ``DeviceTrace``,
    ``idle_s`` (the card's idle time inside the name's spans, which never
    nest within one another)."""
    from repro_torch.obs.spans import phase_table
    spans = window_spans(tracer, w0, w1)
    tracer.sample_clock()
    out = {}
    for name, row in phase_table(spans).items():
        out[name] = {"count": row["count"], "s": row["ns"] / 1e9,
                     "self_s": row["self_ns"] / 1e9, "reads": row["reads"],
                     "read_wait_s": row["read_wait_ns"] / 1e9,
                     "iterations": row["iterations"]}
        if device is not None:
            out[name]["idle_s"] = device.idle_in(_intervals(
                tracer, [s for s in spans if s.name == name]))
    return out


def _total(table: dict, names, key: str) -> float:
    return sum(table.get(n, {}).get(key, 0) for n in names)


def figures(table: dict, batches: int) -> dict:
    """The four per-layer numbers (None where the window has nothing to
    read): the slot allocator's plans and the layout patches in ms a
    batch; the loops' host time a pass less their read waits, in us; and
    the device's idle share inside the loops, in %."""
    passes = _total(table, LOOPS, "iterations")
    loop_s = _total(table, LOOPS, "s")
    idle = [table[n]["idle_s"] for n in LOOPS
            if n in table and "idle_s" in table[n]]

    def per_batch(names):
        return _total(table, names, "s") * 1e3 / batches if batches else None

    return {
        "plan_ms_per_batch": per_batch(PLANS),
        "layout_ms_per_batch": per_batch(LAYOUT),
        "dispatch_us_per_wave": (
            (loop_s - _total(table, LOOPS, "read_wait_s")) * 1e6 / passes
            if passes else None),
        "loop_idle_pct": (100.0 * sum(idle) / loop_s
                          if idle and loop_s > 0 else None),
    }


def clock_check(tracer, w0: int, w1: int, device) -> dict:
    """The share of the window's device time (by op duration) whose op
    starts inside a mapped ``ingest_log`` or ``query`` span, and the
    drift of the tracer's Unix offset from its first sample to its last."""
    spans = [s for s in window_spans(tracer, w0, w1) if s.name in MAPPED]
    iv = _intervals(tracer, spans)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    start, dur = device.start, device.end - device.start
    inside_window = (start >= device.t0) & (start < device.t1)
    hit = np.zeros(len(start), bool)
    if len(iv):
        # in the union of the spans (a query may nest in an ingest_log):
        # the last span to open before the op, or one before it, is open
        reach = np.maximum.accumulate(iv[:, 1])
        k = np.searchsorted(iv[:, 0], start, side="right") - 1
        hit = (k >= 0) & (start < reach[np.clip(k, 0, None)])
    total = int(dur[inside_window].sum())
    offs = [o for _, o in tracer.offsets]
    return {"inside_pct": (100.0 * int(dur[inside_window & hit].sum())
                           / total if total else None),
            "drift_us": (offs[-1] - offs[0]) / 1e3,
            "offset_samples": len(offs)}


def format_table(table: dict, batches: int) -> list[str]:
    """The ``phases:`` table, a line a span name, per batch."""
    lines = [f"phases: {batches} batches; per batch: count ms self_ms "
             "reads read_wait_ms iterations idle_ms"]
    for name, r in sorted(table.items(), key=lambda kv: -kv[1]["self_s"]):
        b = max(batches, 1)
        idle = r.get("idle_s")
        lines.append(
            f"phases: {name:<12} {r['count'] / b:8.3f} {r['s'] * 1e3 / b:9.4f}"
            f" {r['self_s'] * 1e3 / b:9.4f} {r['reads'] / b:8.3f}"
            f" {r['read_wait_s'] * 1e3 / b:9.4f} {r['iterations'] / b:8.3f}"
            + ("" if idle is None else f" {idle * 1e3 / b:9.4f}"))
    return lines


# ------------------------------------------------------------- the runner --
def run_one(cell: dict, seed: int, seconds: float, mode: str, obs: bool,
            device: str = "cuda", log=sys.stderr) -> dict:
    """One run of the harness with the phases read out of its window:
    ``trace`` runs the harness's traced run; ``onoff`` its untraced run,
    with the engine's observability set to ``obs``."""
    from portbench import harness
    got: dict = {}
    real_read, real_make = harness._read_trace, harness.make_engine

    def read_trace(run, eng, prof, spans, w0, w1, *rest):
        real_read(run, eng, prof, spans, w0, w1, *rest)
        got["clock"] = clock_check(eng.obs.tracer, w0, w1, run.device)

    def make_engine(config, n, capacity, sources, device, observability):
        return real_make(config, n, capacity, sources, device,
                         observability or obs)

    harness._read_trace, harness.make_engine = read_trace, make_engine
    try:
        res = harness.run_cell(cell["config"], cell["traffic"], seed=seed,
                               seconds=seconds, trace=mode == "trace",
                               device=device, log=log)
    finally:
        harness._read_trace, harness.make_engine = real_read, real_make
    run = res["run"]
    out = {"seed": seed, "mode": mode, "obs": obs or mode == "trace",
           "correct": all(res["checks"][k] <= lim
                          for k, lim in harness.LIMITS.items()),
           "batches": run.batches,
           "events_per_s": harness.load_reader("events_per_s")(run),
           "batch_p95_ms": harness.load_reader("batch_p95_ms")(run)}
    if mode == "trace":      # the harness has printed the table
        table = run.phases
        out.update(
            figures=figures(table, run.batches), clock=got["clock"],
            table=table, harness_reads=run.host_reads,
            harness_waves=run.waves,
            program_reads=sum(r["reads"] for r in table.values()),
            # a seeded deletion epoch marks once and pulls once (rounds)
            program_waves=(_total(table, LOOPS, "iterations")
                           + table.get("mark", {}).get("count", 0)),
            device_idle_pct=harness.load_reader("device_idle_pct")(run))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated; onoff alternates which runs first")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("trace", "onoff"), default="trace")
    ap.add_argument("--out", help="a JSONL file each run's line is "
                    "appended to")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.run import _prepare_env, _steady_allocator
    _prepare_env()          # before torch loads: its thread pools
    _steady_allocator()
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.cuda.get_device_name(0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        sides = ([False] if args.mode == "trace"
                 else [bool(i % 2), not i % 2])
        for obs in sides:
            line = {"workload": args.workload, "device": device,
                    **run_one(cell, seed, args.seconds, args.mode, obs)}
            print("PHASES " + json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
