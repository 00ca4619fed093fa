"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json`` (named by the configuration's ``file``),
``traffic/<traffic>.json``, ``metrics/<metric>.py`` (a ``read(run)``
that returns the metric's value, or None where it finds nothing to read)
and, for a graph that is neither ``kron`` nor ``urand``,
``generators/<generator>.py`` (see ``graphs``).

The run, in order:
  1. set-up: the graph and its sliding-window stream made on the device
     from ``--seed``; the engine (``repro_torch.make_engine``) with the
     configuration's knobs; the base graph (the stream's first W edges)
     loaded as one ADD batch; ``warmup_batches`` micro-batches and their
     queries;
  2. the window: consecutive micro-batches of ``batch_events`` arc events
     handed to ``ingest_log`` one at a time, each timed until it returns
     with every tree converged, and a ``query(source=...)`` after every
     ``query_every`` batches, the sources in turn; it closes after
     ``seconds``, or at the end of the stream;
  3. the check: ``CHECK_SAMPLE`` of the window's answers, drawn from the
     seed, and every lane's tree at the window's end, against the
     reference worked out again from the live arcs
     (``reference.judge``), after the program's state is freed.
With ``trace`` the engine's observability is on and the window runs under
``torch.profiler`` (CUDA activity) and a count of the device-to-host reads
outside ``query``; the per-layer metrics are read from that run alone,
which also hands the readers the program's own counters and phase spans
over the window (``Run.counters``, ``Run.phases``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import devtrace, graphs, phases, reference
from portbench import stream as stream_mod

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
CHECK_SAMPLE = 16      # window answers judged a run, drawn from the seed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names
LIMITS = {"dist_wrong": 0, "parent_wrong": 0}    # exact comparison
# the device-to-host reads of a CUDA tensor (chip_smoke.HostReads)
READ_METHODS = ("cpu", "to", "item", "tolist", "numpy", "__bool__",
                "__int__", "__float__", "__index__", "__array__")


# ------------------------------------------------------------ the cells --
def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json"
              ) -> dict:
    """The workload ``name`` with its configuration, traffic and metric
    entries, read from ``BENCHMARK.json`` and the files it names."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def serves(m):
        return name in m.get("workloads", [name])

    return {
        "workload": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads(
            (HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if serves(m)],
        "per_layer": [m for m in bench["per_layer"] if serves(m)],
    }


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------- what the readers see --
@dataclasses.dataclass
class Run:
    """The window's record, handed to every metric's ``read``."""
    n: int                    # vertices
    lanes: int                # maintained trees
    batches: int              # micro-batches in the window
    events: int               # topology (arc) events in them
    window_s: float
    setup_s: float
    batch_s: np.ndarray       # each batch's ingest_log, converged
    query_s: np.ndarray       # each query until numpy on the host
    e_live: float             # live arcs, mean over the window's batches
    ingest_s: float = 0.0     # summed batch spans (as batch_s)
    # the traced run's readings (None otherwise)
    epoch_s: float | None = None      # the program's add/del epoch spans
    rebuilds: int | None = None       # the program's rebuild counter
    waves: int | None = None          # executed waves (batched loop's)
    host_reads: int | None = None     # device-to-host reads outside query
    device: devtrace.DeviceTrace | None = None
    idle: dict[str, float] | None = None   # idle seconds by host span
    # the program's counters (``obs.counters.snapshot()``) at the window's
    # end less at its start, scalars and vectors; histogram samples the
    # program has not folded yet are not in them
    counters: dict | None = None
    phases: dict | None = None        # phases.window_table of the window


class _HostReads:
    """Counts device-to-host reads of CUDA tensors while active, except
    inside ``eng.query``, whose readback is the answer and not a wave's
    (copied from ``chip_smoke.HostReads``)."""

    def __init__(self, eng):
        self.eng, self.reads, self._in_query = eng, 0, False

    def __enter__(self):
        self._saved = {m: getattr(torch.Tensor, m) for m in READ_METHODS}
        for meth, real in self._saved.items():
            def counted(t, *a, _real=real, **k):
                out = _real(t, *a, **k)
                if (not self._in_query and t.is_cuda
                        and not (isinstance(out, torch.Tensor)
                                 and out.is_cuda)):
                    self.reads += 1
                return out
            setattr(torch.Tensor, meth, counted)
        real_query = self.eng.query

        def query(*a, **k):
            self._in_query = True
            try:
                return real_query(*a, **k)
            finally:
                self._in_query = False
        self.eng.query = query
        return self

    def __exit__(self, *exc):
        for meth, real in self._saved.items():
            setattr(torch.Tensor, meth, real)
        del self.eng.query
        return False


class _Waves:
    """The waves the engine executes: each epoch's round count as the
    engine folds it (``_accumulate``), the largest lane's on a lane engine,
    whose batched loop runs until its last lane settles."""

    def __init__(self, eng):
        self.eng, self.waves = eng, 0

    def __enter__(self):
        real = self.eng._accumulate

        def fold(rounds, messages):
            self.waves += int(np.max(rounds))
            return real(rounds, messages)
        self.eng._accumulate = fold
        return self

    def __exit__(self, *exc):
        del self.eng._accumulate
        return False


# ------------------------------------------------------------- the run ---
def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def top_sources(strm: stream_mod.Stream, k: int,
                whole_graph: bool = False) -> list[int]:
    """The ``k`` vertices of highest degree in the base graph (the paper's
    PageRank stand-in), ties to the smaller id.  With ``whole_graph``, in
    the whole graph: for a configuration that fixes its graph
    (``instance_seed``), whose sources are then fixed with it, the same in
    every run, as GAP's and DIMACS 9's fixed source lists are a graph's."""
    if whole_graph:
        src = torch.cat([strm.edges.u, strm.edges.v])
    else:
        src, _, _ = strm.live_arcs(strm.base)
    deg = torch.bincount(src, minlength=strm.edges.n)
    order = torch.sort(deg, descending=True, stable=True).indices
    return [int(s) for s in order[:k].cpu()]


def make_engine(config: dict, n: int, capacity: int, sources: list[int],
                device: torch.device, observability: bool):
    import repro_torch
    lanes = ({"sources": tuple(sources)} if len(sources) > 1
             else {"source": sources[0]})
    return repro_torch.make_engine(
        num_vertices=n, edge_capacity=capacity, device=str(device),
        observability=observability, **lanes, **config.get("engine", {}))


def run_cell(config: dict, traffic: dict, *, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: float | None = None, log=sys.stderr) -> dict:
    """One run; returns the window's ``Run``, the check's counts and the
    device's figures (see ``result_line`` for the printed form)."""
    from repro_torch.core.events import EventLog

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    marks = [("start", time.perf_counter())]
    strm = stream_mod.sliding_window(graphs.generate(config, gen), traffic,
                                     gen)
    n, lanes = strm.edges.n, int(traffic["lanes"])
    sources = top_sources(strm, lanes, "instance_seed" in config)
    marks.append(("generate", time.perf_counter()))
    if dev.type == "cuda":       # the peak is the program's, from here on
        torch.cuda.reset_peak_memory_stats(dev)
    eng = make_engine(config, n, 2 * len(strm.edges.u), sources, dev, trace)
    marks.append(("engine", time.perf_counter()))

    per_batch = int(traffic["batch_events"])
    every = int(traffic["query_every"])

    def chunk(a, b):
        return EventLog(strm.kind[a:b], strm.src[a:b], strm.dst[a:b],
                        strm.w[a:b])

    pos = strm.base
    eng.ingest_log(chunk(0, pos))
    _sync(dev)
    marks.append(("base", time.perf_counter()))
    n_queries = 0
    for i in range(int(traffic["warmup_batches"])):
        eng.ingest_log(chunk(pos, pos + per_batch))
        pos += per_batch
        if (i + 1) % every == 0:
            eng.query(source=sources[n_queries % lanes])
            n_queries += 1
    _sync(dev)
    marks.append(("warmup", time.perf_counter()))
    print("setup: " + " ".join(f"{a}={t1 - t0:.3f}s" for (_, t0), (a, t1)
                               in zip(marks, marks[1:]))
          + f"; {len(strm.edges.u)} edges, {len(strm)} arc events, base "
          f"{strm.base}, sources {sources[:4]}"
          + (f", layout {eng.backend_name}"
             if hasattr(eng, "backend_name") else ""), file=log)

    # the judged answers are copied out of the window's results into
    # buffers made and touched here, so no result outlives its query and
    # the program's host copies find their memory as a service's would
    rng = np.random.default_rng(seed)
    kept_dist = np.zeros((CHECK_SAMPLE, n), np.float32)
    kept_parent = np.zeros((CHECK_SAMPLE, n), np.int32)
    kept: list[tuple[int, int]] = []          # (stream position, source)
    spans: dict[str, list[tuple[int, int]]] = {
        "generate": [], "ingest": [], "query": []}
    batch_ns: list[int] = []
    query_ns: list[int] = []
    first = pos
    counting = contextlib.ExitStack()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        counters0 = eng.obs.counters.snapshot()
        n_spans0 = len(eng.obs.tracer.spans)
        # CUDA activity only: the host's ops stay unrecorded (a CPU run,
        # as in the tests, records its ops and finds no device records)
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if dev.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.start()
        reads = counting.enter_context(_HostReads(eng))
        waves = counting.enter_context(_Waves(eng))
    rounds0, epochs0 = eng.n_rounds, eng.n_epochs
    # the set-up's objects out of the collector's way: a full collection
    # in the window then walks only what the window made
    gc.collect()
    gc.freeze()
    clock = time.perf_counter_ns
    setup_s = time.perf_counter() - t_start
    w0 = clock()
    end_ns = w0 + int(seconds * 1e9)
    k = 0
    while pos + per_batch <= len(strm):
        g0 = clock()
        log_k = chunk(pos, pos + per_batch)
        t0 = clock()
        eng.ingest_log(log_k)
        _sync(dev)
        t1 = clock()
        spans["generate"].append((g0, t0))
        spans["ingest"].append((t0, t1))
        batch_ns.append(t1 - t0)
        pos += per_batch
        k += 1
        if k % every == 0:
            s = sources[n_queries % lanes]
            q0 = clock()
            res = eng.query(source=s)
            q1 = clock()
            spans["query"].append((q0, q1))
            query_ns.append(q1 - q0)
            # reservoir sample of the answers to judge
            slot = len(query_ns) - 1
            if slot >= CHECK_SAMPLE:
                slot = int(rng.integers(0, len(query_ns)))
            if slot < CHECK_SAMPLE:
                np.copyto(kept_dist[slot], res.dist)
                np.copyto(kept_parent[slot], res.parent)
                if slot < len(kept):
                    kept[slot] = (pos, s)
                else:
                    kept.append((pos, s))
            del res
            n_queries += 1
        if clock() >= end_ns:
            break
    w1 = clock()
    end_of_stream = pos + per_batch > len(strm)
    counting.close()
    if trace:
        _sync(dev)
        t_stop = time.perf_counter()
        prof.stop()
        print(f"trace: profiler stopped in {time.perf_counter() - t_stop:.1f}"
              " s", file=log)
        counters = _counter_delta(eng.obs.counters.snapshot(), counters0)
    gc.unfreeze()
    rounds = np.asarray(eng.n_rounds - rounds0)
    print(f"work: lane waves {int(rounds.max())} (summed over lanes "
          f"{int(rounds.sum())}), epochs {eng.n_epochs - epochs0}", file=log)
    final = eng.query()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    bounds = first + per_batch * np.arange(1, k + 1)
    run = Run(n=n, lanes=lanes, batches=k, events=k * per_batch,
              window_s=(w1 - w0) / 1e9, setup_s=setup_s,
              batch_s=np.array(batch_ns) / 1e9,
              query_s=np.array(query_ns) / 1e9,
              e_live=float(np.mean(strm.live_counts(bounds))) if k else 0.0,
              ingest_s=sum(b - a for a, b in spans["ingest"]) / 1e9)
    if trace:
        _read_trace(run, eng, prof, spans, w0, w1, n_spans0, counters,
                    reads.reads, waves.waves, log)
        del prof
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    sample = [(p, s, kept_dist[i], kept_parent[i])
              for i, (p, s) in enumerate(kept)]
    checks = _check(strm, sources, sample, final, pos, lanes)
    t_check = time.perf_counter() - t_check
    print(f"samples: batches={run.batches} queries={len(query_ns)} "
          f"events={run.events} window_s={run.window_s} "
          f"answers_checked={checks['answers']} check_s={t_check:.3f} "
          f"max_ref_dist={checks['max_ref_dist']} "
          f"end_of_stream={end_of_stream}", file=log)
    for name, xs in (("batch", run.batch_s), ("query", run.query_s)):
        if len(xs):
            print(f"{name}_ms: p50={np.percentile(xs, 50) * 1e3} "
                  f"p95={np.percentile(xs, 95) * 1e3} "
                  f"max={np.max(xs) * 1e3}", file=log)
    return {"run": run, "checks": checks, "memory_peak_bytes": int(peak),
            "end_of_stream": end_of_stream}


def _check(strm, sources, sample, final, pos_end, lanes) -> dict:
    """Judge the sampled answers and every lane's final tree."""
    answers = list(sample)
    fd, fp = final.dist, final.parent
    if lanes == 1:
        answers.append((pos_end, sources[0], fd, fp))
    else:
        answers += [(pos_end, s, fd[i], fp[i]) for i, s in enumerate(sources)]
    tot = {"dist_wrong": 0, "parent_wrong": 0}
    wrong, far = 0, 0.0
    n = strm.edges.n
    for p, s, d, par in answers:
        arcs = strm.live_arcs(p)
        ref_dist, _ = reference.bellman_ford(n, *arcs, s)
        far = max(far, float(ref_dist[torch.isfinite(ref_dist)].max()))
        got = reference.judge(n, arcs, s, d, par, ref_dist=ref_dist)
        wrong += any(got.values())
        for key, val in got.items():
            tot[key] += val
    return {**tot, "answers": len(answers), "answers_wrong": wrong,
            "max_ref_dist": far}


def _counter_delta(end: dict, start: dict) -> dict:
    """Each counter's value in ``end`` less its value in ``start``."""
    return {k: v - start[k] if k in start else v for k, v in end.items()}


def _read_trace(run: Run, eng, prof, spans, w0, w1, n_spans0, counters,
                reads, waves, log) -> None:
    """Fill the traced run's readings: the program's spans and counters
    in the window, and the device trace with the host spans mapped on."""
    by_epoch = {k: [(s.t0_ns, s.t0_ns + s.dur_ns)
                    for s in eng.obs.tracer.spans[n_spans0:]
                    if s.phase == "X" and s.name == k
                    and w0 <= s.t0_ns < w1]
                for k in ("add_epoch", "del_epoch")}
    run.epoch_s = sum(b - a for xs in by_epoch.values()
                      for a, b in xs) / 1e9
    run.counters = counters
    run.rebuilds = counters.get("rebuilds", 0)
    run.waves, run.host_reads = waves, reads
    # the host's clock onto the profiler's (Unix-epoch ns)
    off = time.time_ns() - time.perf_counter_ns()
    t_read = time.perf_counter()
    dt = devtrace.from_profiler(prof, w0 + off, w1 + off)
    t_read = time.perf_counter() - t_read
    run.device = dt

    def on_trace(xs):
        return np.array(xs, np.int64).reshape(-1, 2) + off

    idle = {name: dt.idle_in(on_trace(xs)) for name, xs in by_epoch.items()}
    idle["outside_epoch"] = (dt.idle_in(on_trace(spans["ingest"]))
                             - sum(idle.values()))
    idle["generate"] = dt.idle_in(on_trace(spans["generate"]))
    idle["query"] = dt.idle_in(on_trace(spans["query"]))
    idle["harness"] = (dt.window_s - dt.busy_s) - sum(idle.values())
    run.idle = idle
    outside = int(np.sum((dt.start < dt.t0) | (dt.start > dt.t1)))
    print(f"trace: {len(dt.start)} device ops, {outside} starting outside "
          f"the window; "
          f"busy_s={dt.busy_s} window_s={dt.window_s}; read in "
          f"{t_read:.1f} s", file=log)
    tracer = eng.obs.tracer
    run.phases = phases.window_table(tracer, w0, w1, dt)
    for line in phases.format_table(run.phases, run.batches):
        print(line, file=log)
    clock = phases.clock_check(tracer, w0, w1, dt)
    print(f"trace: clock offset drift {clock['drift_us']} us", file=log)
    print("trace: device time starting inside program spans "
          f"{clock['inside_pct']} %", file=log)


# --------------------------------------------------------------- output --
def metric_values(cell: dict, run: Run, trace: bool) -> dict:
    """``{name: {"value", "unit"}}`` of the metrics this run reports."""
    out = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: dict, res: dict, trace: bool, device: dict) -> dict:
    run, checks = res["run"], res["checks"]
    correct = (checks["answers"] > 0
               and all(checks[k] <= lim for k, lim in LIMITS.items()))
    line = {
        "correct": correct,
        "attempted": run.batches + len(run.query_s),
        "failed": checks["answers_wrong"],
        "metrics": metric_values(cell, run, trace),
        "device": dict(device, memory_peak_bytes=res["memory_peak_bytes"]),
    }
    if trace and run.device is not None:
        line["device"]["busy_s"] = run.device.busy_s
        line["device"]["window_s"] = run.device.window_s
        line["breakdown"] = {
            "device_ops": run.device.top_ops(10),
            "idle_gaps": sorted(([k, v] for k, v in run.idle.items()),
                                key=lambda kv: -kv[1])[:10]}
    line["checks"] = {
        **{k: {"value": checks[k], "limit": lim} for k, lim in LIMITS.items()},
        "answers_checked": {"value": checks["answers"], "limit": 1},
        # the reference raises past it (reference.EXACT_BELOW)
        "max_ref_dist": {"value": checks["max_ref_dist"],
                         "limit": reference.EXACT_BELOW - 1}}
    return line
