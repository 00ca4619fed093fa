"""Streaming SSSP over a sliding-window event stream, sharded over a
partition mesh, on the PyTorch port (``src/repro_torch``); an NVIDIA GPU by
default.  The twin of examples/sharded_streaming_sssp.py.

Run: PYTHONPATH=src python examples/torch_sharded_streaming_sssp.py
     (add ``--device cpu`` to run the plain torch path without a card)

By default the mesh has one partition per visible device of ``--device``'s
type (one on the CPU); ``--partitions P`` stacks P partitions on those
devices in turn — ``--partitions 8`` on one card is the counterpart of the
reference's 8 forced host devices:

    ... torch_sharded_streaming_sssp.py --partitions 8 --backend ellpack
    ... torch_sharded_streaming_sssp.py --device cpu --partitions 8

Pick a relaxation backend (each partition runs its own layout; the ELL
layouts launch kernel K1 once per partition and wave on a card):

    ... --backend segment     # portable COO scatter-min (default)
    ... --backend ellpack     # dense ELL block per partition
    ... --backend sliced --hubs   # hub-aware hybrid, its target workload

Replays an RMAT stream with windowed deletions through the sharded engine,
reports the paper's metrics plus the per-partition edge-pool fill, and
cross-checks the final tree bit for bit against the single-device engine
*running the same backend*.  ``--balanced`` relabels vertices so
partitions own ~equal in-edge mass; ``--exchange delta`` ships only the
improved vertices' offers; ``--buckets`` runs both engines under the
bucketed delta-stepping schedule.

Serving-layer trace flags: ``--record-trace PATH`` saves the generated
workload; ``--replay-trace PATH`` replays a recorded trace (the JAX
package's format, both ways) through the sharded engine and the metrics
harness; ``--dataset PATH`` streams a local SNAP/Konect edge list through
the same pipeline (bad paths exit 2).  Observability flags
(``--trace-out``, ``--log-json``, ``--metrics-out``) enable the engine's
counters, spans and flight recorder (a missing parent directory exits 2).
"""
import argparse
import time

import numpy as np
import torch

import repro_torch
from repro_torch.core import events as ev
from repro_torch.graphs import generators as gen
from repro_torch.graphs import partition as part_mod
from repro_torch.graphs import window as win
from repro_torch.launch.mesh import make_mesh, visible_devices
from repro_torch.serving import (ServingTrace, TraceRecorder,
                                 load_trace_or_exit, replay_trace)

from torch_streaming_sssp import add_obs_flags, dump_obs, obs_paths, \
    trace_bounds


def partition_mesh(device: str, partitions: int | None):
    """``partitions`` partitions over the visible devices of ``device``'s
    type, in turn (one per device by default)."""
    avail = visible_devices(torch.device(device).type)
    if not avail:
        raise SystemExit(f"error: no visible {device} device")
    p = partitions or len(avail)
    return make_mesh((p,), ("graph",),
                     devices=[avail[i % len(avail)] for i in range(p)])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=int, default=10)
    p.add_argument("--delta", type=float, default=0.3)
    p.add_argument("--window-frac", type=float, default=0.3)
    p.add_argument("--exchange", choices=("allgather", "delta"),
                   default="allgather")
    p.add_argument("--backend", choices=("segment", "ellpack", "sliced"),
                   default="segment",
                   help="relaxation backend for BOTH engines")
    p.add_argument("--hubs", action="store_true",
                   help="in-degree power-law hub graph instead of RMAT "
                        "(the sliced backend's target workload)")
    p.add_argument("--balanced", action="store_true",
                   help="edge-balanced vertex relabeling "
                        "(graphs/partition.edge_balanced_relabeling)")
    p.add_argument("--dataset", metavar="PATH",
                   help="replay a local SNAP/Konect edge list (bad paths "
                        "exit 2)")
    p.add_argument("--record-trace", metavar="PATH",
                   help="save the generated workload as a serving trace")
    p.add_argument("--replay-trace", metavar="PATH",
                   help="replay a recorded trace through the sharded "
                        "engine and report the serving metrics (unknown "
                        "paths exit 2)")
    p.add_argument("--buckets", action="store_true",
                   help="bucketed delta-stepping wave schedule on both "
                        "engines")
    add_obs_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device type of the mesh (default cuda; cpu "
                        "runs the plain torch path)")
    p.add_argument("--partitions", type=int, default=None,
                   help="partitions, stacked on the visible devices in "
                        "turn (default: one per visible device)")
    args = p.parse_args()
    obs_on = any(obs_paths(args))   # fails fast (exit 2) on a bad path
    schedule = "buckets" if args.buckets else "rounds"
    mesh = partition_mesh(args.device, args.partitions)
    parts = mesh.size
    knobs = dict(mesh=mesh, exchange=args.exchange,
                 relax_backend=args.backend, wave_schedule=schedule,
                 observability=obs_on, device=args.device)

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
        epp = int(trace.n_topology * 1.3) // max(parts // 2, 1) + 64
        source = int(gen.top_in_degree_sources(
            n, trace.dst[trace.kind == ev.ADD].astype(np.int64))[0])
        eng = repro_torch.make_engine(
            num_vertices=n, edge_capacity=epp * parts, source=source,
            **knobs)
        report = replay_trace(eng, trace)
        print(f"trace: {args.replay_trace or args.dataset} "
              f"source={source} partitions={parts} schedule={schedule}")
        print(report.summary())
        dump_obs(eng, args)
        return

    if args.hubs:
        n = 1 << args.scale
        n, src, dst, w = gen.power_law_hubs(n, 8 * n, n_hubs=4, seed=7,
                                            orientation="in")
    else:
        n, src, dst, w = gen.rmat(args.scale, edge_factor=8, seed=7)
    source = int(gen.top_in_degree_sources(n, dst)[0])
    window = int(len(src) * args.window_frac)
    log = win.sliding_window_stream(src, dst, w, window=window,
                                    delta=args.delta, seed=0)
    log = ev.interleave_queries(log, window // 10)
    on = sorted({str(d) for d in mesh.devices})
    print(f"graph: n={n} stream={len(log)} events (delta={args.delta}) "
          f"source={source} partitions={parts} on {on} "
          f"backend={args.backend}")

    if args.record_trace:
        rec = TraceRecorder()
        rec.extend_from_log(log)
        rec.trace().save(args.record_trace)
        print(f"recorded trace: {args.record_trace} ({len(log)} events)")

    relabel = None
    if args.balanced:
        relabel = part_mod.edge_balanced_relabeling(n, dst, parts)

    epp = int(len(src) * 1.3) // max(parts // 2, 1) + 64
    eng = repro_torch.make_engine(
        num_vertices=n, edge_capacity=epp * parts, source=source,
        relabel=relabel, **knobs)
    lat, stab = [], []
    t0 = time.perf_counter()

    def on_query(r):
        lat.append(r.latency_s)
        stab.append(eng.stability_vs_prev(r.parent, source=r.source))

    eng.ingest_log(log, on_query=on_query)
    wall = time.perf_counter() - t0

    fill = eng.partition_fill()
    print(f"queries: {len(lat)}  latency p50 {np.median(lat)*1e3:.3f}ms")
    print(f"stability (predecessor overlap): p50 {np.median(stab):.4f}")
    print(f"ingestion: {len(log)/wall:.0f} events/s "
          f"({eng.n_epochs} epochs, {eng.n_rounds} message waves)")
    print(f"partition fill (live edges/partition): min={fill.min()} "
          f"max={fill.max()} imbalance={fill.max()/max(fill.mean(), 1):.2f}x")

    dump_obs(eng, args)

    # cross-check: the sharded run must equal the single-device engine
    # running the same relaxation backend
    ref = repro_torch.make_engine(num_vertices=n,
                                  edge_capacity=int(len(src) * 1.3) + 64,
                                  source=source, relax_backend=args.backend,
                                  wave_schedule=schedule, device=args.device)
    ref.ingest_log(log)
    q_ref, q = ref.query(), eng.query()
    np.testing.assert_array_equal(q_ref.dist, q.dist)
    if relabel is None:
        np.testing.assert_array_equal(q_ref.parent, q.parent)
    print("single-device equivalence: OK (bit-identical dist"
          f"{', parent' if relabel is None else ''})")


if __name__ == "__main__":
    main()
