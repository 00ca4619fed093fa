"""Streaming SSSP over a sliding-window event stream (the paper's §5 setup)
on the PyTorch port (``src/repro_torch``), on an NVIDIA GPU by default.

Run: PYTHONPATH=src python examples/torch_streaming_sssp.py [--delta 0.3]
     (add ``--device cpu`` to run the plain torch path without a card)

Generates an RMAT graph, replays it as a timestamped stream with windowed
deletions (probability --delta), queries every W/10 events, and reports the
paper's three metrics: query latency (beside the ReMo-from-scratch
baseline's, ``repro_torch.core.baseline``, and the speedup), tree
stability, ingestion rate.  The twin of examples/streaming_sssp.py.

Engines are built through ``repro_torch.make_engine``.  Real datasets
(SNAP/Konect edge lists on local disk, .gz ok) stream through the same
pipeline — the loader synthesizes the sliding-window dynamic portion
deterministically and a bad path exits with code 2:

    ... torch_streaming_sssp.py --dataset /path/to/edges.txt

Serving-layer trace flags (the trace format is the JAX package's, both
ways):

    # save the generated workload as an on-disk trace (chunked, v2)
    ... torch_streaming_sssp.py --record-trace /tmp/stream.trace
    # replay a recorded trace through the engine + metrics harness
    # (a missing/incompatible trace path exits with code 2)
    ... torch_streaming_sssp.py --replay-trace /tmp/stream.trace

Observability flags — any one enables the engine's span tracer / counter
registry / histograms / flight recorder:

    # Chrome trace-event JSON of every epoch/drain/query span (Perfetto)
    ... torch_streaming_sssp.py --trace-out /tmp/stream.trace.json
    # JSONL spans + a final metrics_snapshot line
    ... torch_streaming_sssp.py --log-json /tmp/stream.jsonl
    # Prometheus exposition text (counters, lane labels, histograms)
    ... torch_streaming_sssp.py --metrics-out /tmp/stream.prom

(a nonexistent parent directory for any path exits with code 2)
"""
import argparse
import time

import numpy as np

import repro_torch
from repro_torch.core import events as ev
from repro_torch.core.baseline import ReMoBaseline
from repro_torch.graphs import generators as gen
from repro_torch.graphs import window as win
from repro_torch.obs import out_path_or_exit, write_log_jsonl
from repro_torch.obs.export import write_prometheus
from repro_torch.serving import (ServingTrace, TraceRecorder,
                                 load_trace_or_exit, replay_trace)


def dump_obs(eng, args) -> None:
    """Write the requested observability artifacts for a finished engine."""
    if args.trace_out:
        eng.obs.tracer.save_chrome(args.trace_out)
        n_ev = sum(eng.obs.tracer.span_counts().values())
        print(f"wrote chrome trace: {args.trace_out} ({n_ev} events)")
    if args.log_json:
        write_log_jsonl(eng, args.log_json)
        print(f"wrote span/metrics JSONL: {args.log_json}")
    if args.metrics_out:
        write_prometheus(args.metrics_out, eng.metrics_snapshot())
        print(f"wrote prometheus metrics: {args.metrics_out}")


def add_obs_flags(p: argparse.ArgumentParser) -> None:
    """The --trace-out / --log-json / --metrics-out flags (both examples)."""
    p.add_argument("--trace-out", metavar="PATH",
                   help="write the engine span trace as Chrome trace-event "
                        "JSON (a missing parent directory exits 2)")
    p.add_argument("--log-json", metavar="PATH",
                   help="write spans + the final metrics_snapshot as JSONL "
                        "(a missing parent directory exits 2)")
    p.add_argument("--metrics-out", metavar="PATH",
                   help="write the final metrics_snapshot as Prometheus "
                        "text (a missing parent directory exits 2)")


def obs_paths(args) -> tuple:
    """Every observability destination, validated up front (exit 2)."""
    paths = (args.trace_out, args.log_json, args.metrics_out)
    for path in paths:
        if path:
            out_path_or_exit(path)
    return paths


def trace_bounds(trace: ServingTrace) -> int:
    """The number of vertices a trace implies."""
    topo = trace.kind != ev.QUERY
    return int(max(trace.src[topo].max(initial=0),
                   trace.dst[topo].max(initial=0))) + 1


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=int, default=11)
    p.add_argument("--delta", type=float, default=0.3)
    p.add_argument("--window-frac", type=float, default=0.3)
    p.add_argument("--backend",
                   choices=("segment", "ellpack", "sliced", "auto"),
                   default="segment",
                   help="relaxation backend (ellpack: the dense ELL block "
                        "on kernel K1; sliced: the hub-aware hybrid on K2; "
                        "auto: ellpack that swaps to sliced on hub blowup)")
    p.add_argument("--power-law", action="store_true",
                   help="stream in-degree power-law hubs instead of RMAT "
                        "(the sliced backend's target workload)")
    p.add_argument("--dataset", metavar="PATH",
                   help="replay a local SNAP/Konect edge list: "
                        "deterministic sliding-window event synthesis + "
                        "serving metrics (bad paths exit 2)")
    p.add_argument("--record-trace", metavar="PATH",
                   help="save the generated workload as a serving trace")
    p.add_argument("--replay-trace", metavar="PATH",
                   help="replay a recorded trace through the engine and "
                        "report the serving metrics (unknown paths exit 2)")
    add_obs_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu runs "
                        "the plain torch path)")
    args = p.parse_args()
    obs_on = any(obs_paths(args))   # fails fast (exit 2) on a bad path
    knobs = dict(relax_backend=args.backend, observability=obs_on,
                 device=args.device)

    if args.dataset:
        n, trace = repro_torch.load_dataset_or_exit(
            args.dataset, window_frac=args.window_frac, delta=args.delta)
        log = ev.interleave_queries(trace.to_log(),
                                    max(1, trace.n_topology // 10))
        trace = ServingTrace.from_log(log)

    if args.replay_trace or args.dataset:
        if args.replay_trace:
            trace = load_trace_or_exit(args.replay_trace)
            n = trace_bounds(trace)
        cap = int(trace.n_topology * 1.3) + 64
        source = int(gen.top_in_degree_sources(
            n, trace.dst[trace.kind == ev.ADD].astype(np.int64))[0])
        eng = repro_torch.make_engine(num_vertices=n, edge_capacity=cap,
                                      source=source, **knobs)
        report = replay_trace(eng, trace)
        print(f"trace: {args.replay_trace or args.dataset} source={source}")
        print(report.summary())
        dump_obs(eng, args)
        return

    if args.power_law:
        n = 1 << args.scale
        n, src, dst, w = gen.power_law_hubs(n, 10 * n, n_hubs=4, seed=7,
                                            orientation="in")
    else:
        n, src, dst, w = gen.rmat(args.scale, edge_factor=8, seed=7)
    source = int(gen.top_in_degree_sources(n, dst)[0])
    window = int(len(src) * args.window_frac)
    log = win.sliding_window_stream(src, dst, w, window=window,
                                    delta=args.delta, seed=0)
    log = ev.interleave_queries(log, window // 10)
    print(f"graph: n={n} stream={len(log)} events "
          f"(delta={args.delta}, window={window}) source={source}")

    if args.record_trace:
        rec = TraceRecorder()
        rec.extend_from_log(log)
        # version-2 chunked container: replayable at O(chunk) host memory
        rec.trace().save(args.record_trace, chunk_events=65536)
        print(f"recorded trace: {args.record_trace} ({len(log)} events)")

    cap = int(len(src) * 1.3) + 64
    eng = repro_torch.make_engine(num_vertices=n, edge_capacity=cap,
                                  source=source, **knobs)
    lat, stab = [], []
    t0 = time.perf_counter()

    def on_query(r):
        lat.append(r.latency_s)
        stab.append(eng.stability_vs_prev(r.parent, source=r.source))

    eng.ingest_log(log, on_query=on_query)
    wall = time.perf_counter() - t0

    base = ReMoBaseline(n, cap, source, device=args.device)
    base_lat = [r.latency_s for r in base.ingest_log(log)]

    print(f"device: {eng.device}")
    print(f"queries: {len(lat)}")
    print(f"latency p50: ours {np.median(lat) * 1e3:.3f}ms | "
          f"ReMo-from-scratch {np.median(base_lat) * 1e3:.3f}ms | "
          f"speedup {np.median(base_lat) / max(np.median(lat), 1e-9):.1f}x")
    print(f"stability (predecessor overlap): p50 {np.median(stab):.4f}")
    print(f"ingestion: {len(log) / wall:.0f} events/s "
          f"({eng.n_epochs} epochs, {eng.n_rounds} message waves, "
          f"{eng.n_adds} adds, {eng.n_dels} dels)")
    dump_obs(eng, args)


if __name__ == "__main__":
    main()
