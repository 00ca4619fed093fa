#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit; build kernels K1 (``ellpack_relax``),
     K2 (``fused_sliced_relax``), K3 (``gathered_rows_relax``), K4
     (``spmm_ell``) and K5 (``embedding_bag``) from the repository's CUDA
     sources, one nvcc per source, all started together;
  2. each kernel against its plain torch version on the card, bit for bit,
     at edge cases (K1: K = 1, non-power-of-two K, K > 32, K = 128 and
     130, +inf rows and all-+inf blocks, ties, R not a multiple of the rows
     a block holds, scattered +inf cells and the ELL planner's row-tail
     padding, views at a cell offset that is not a multiple of 4, with the
     variant each case took; K2: ragged run groups, empty and zero-length overflow lanes,
     all-+inf rows, ties across the lanes, inactive sources, rows without
     entries, a width-1 slice beside width-32 ones, slices of fewer cells
     than a warp, runs ending inside a chunk, +inf tombstones between live
     cells, an all-padding slice, slices wider than a warp; K3: ties, an
     empty and an all-masked edge list, one hub row hit by every slot,
     duplicate slots, R = 1, the same inputs twice in a row, a call
     captured in a CUDA graph and replayed on new inputs; K4: K = 1, K > 32, K not a multiple
     of the rows in flight, all-masked rows, -1 in masked cells, duplicate
     indices, ties and NaN for max, live indices past either end, every
     agg, f32 and bf16; K5: all-padded bags, L = 1, L > 32, L = 37, B = 1,
     padding inside and after a bag, DIN's serve_p99 widths, repeated
     indices, a live index past the end, f32 and bf16); then K1 (both
     variants, views at a cell offset) and K2 lane forms at S = 1, 4, 5,
     8, 16 (one lane group and two) against the lane plain version and S
     single-lane kernel calls, and K1's on a caller-made lane-minor copy;
     K3's lane form at the same S against its lane plain version and S
     single-lane K3 calls (an all-masked lane, a hub-row lane, two equal
     lanes; E = 0, R = 1, the sparse path's E = 16,384 over 2^20 rows)
     and in a CUDA graph replayed on new inputs;
  3. the dense-ELL path: ``make_engine(relax_backend="ellpack",
     batch_deletions=True)`` over the ER sliding-window ADD/DEL/QUERY stream
     at 2^20 vertices / 2^23 edges (queries every window/10), K1's count
     reset just before and read just after; final snapshot against scipy's
     Dijkstra; K1 against its plain version and timed on the final block
     (three ways, as phase 7 times K4 and K5);
     the host control plane (allocator + ELL planner) replayed alone just
     before the run, over the legs' cut (its first LEG_QUERIES queries),
     against the run's wall at that query; the cut re-run under
     torch.profiler for its device time;
  4. the hub path: ``relax_backend="auto"`` with no kernel flag (the card's
     default is K2) over the RMAT(20) stream of the same recipe (edge
     factor 8, seed 7; the dense ELL block falls back to the sliced layout
     at its first rebuild), K1 and K2 counts reset just before and read
     just after; Dijkstra check; K2 against its plain version and timed on
     the final layout (three ways); the host control plane (allocator +
     the dense ELL planner, then the sliced one from the blowup rebuild,
     as the engine swaps) replayed alone just before the run over the
     legs' cut, against the run's wall at that query; the cut re-run under
     torch.profiler for its device time and K2's share of it;
  5. at 2^16 on the RMAT recipe: auto on K2 (the default), sliced on K1 per
     run of slices (K1's vector and scalar variants both), sliced plain and
     segment engines identical at every query;
  6. the sparse frontier: the localized stream at 2^20 (``rmat(20, 4,
     seed=11)`` ingested first, then 48 batches of 8 fresh edges inside a
     random 1k window) through ``frontier_mode="sparse"`` with no kernel
     flag (K3 by default) against a dense segment engine, K3's count reset
     just before the batches and read just after; K3 against its plain
     version at the shapes that path gave it, timed three ways at the
     largest; then the 2^16 RMAT
     sliding-window stream (DEL epochs too) sparse on K3 against sparse on
     the plain version; then (6c) the localized stream with ``sources=``
     LANES lanes (vertex 0 and the three other vertices of highest
     in-degree in the base graph), sparse with no kernel flag: K3's lane
     form and never the single-lane kernel (both counts set to 0 just
     before the batches and read just after), a query after each batch,
     every lane equal to a dense segment lane engine at every query, lane
     0 to phase 6a's run at both of its queries, Dijkstra for every lane;
     host reads per wave, source-events/s, and the lane form at the leg's
     largest edge list timed three ways beside S single-lane calls, its
     bound (``gather.wave_bytes(lanes=4)``) and its lane plain version;
  7. the neighbour-aggregation and embedding-bag entry points,
     ``neighbor_reduce`` (K4) and ``bag_lookup`` (K5), forward and
     backward, at the published widths of their two model families:
     GraphSAGE-Reddit's ``minibatch_lg`` (1,024 seeds, fanout (15, 10),
     d_feat 602; mean, f32 and bf16) and a full-graph layer over Reddit's
     232,965 nodes (K = 25 neighbours drawn uniformly, F = 128, f32); DIN's ``train_batch`` (table
     10,485,760 x 18, 65,536 bags of 100 slots, history lengths U[25,
     100]; sum, f32 and bf16) and ``serve_p99`` (512 bags).  At each shape
     the K4 and K5 counts are set to 0 just before the kernel route and
     read just after; the output equals the plain route's bit for bit and
     the gradient agrees within GRAD_RTOL; each kernel is timed beside its
     plain version, its bound and ``F.embedding_bag`` (the same function
     for sum and mean; never called by the port): back-to-back CUDA
     events, device time per call (a CUDA graph of 20 calls replayed, every
     kernel of the call) and host time per call (the submission alone);
  8. the bucketed schedule: phases 3's and 4's 2^20 streams to their
     LEG_QUERIES-th (21st) of 41 queries (the legs' cut) again under
     ``wave_schedule="buckets"`` (bucket_width 1.0, the same kernels by
     default), ``dist`` bit-identical to the rounds run at every query,
     Dijkstra on the final snapshot; waves, launches, events/s;
  9. batched lanes: the same two cuts with ``sources=`` the 4 vertices
     of highest in-degree (K1's and K2's lane forms, counted apart), lane
     0 equal to phases 3's / 4's run at every query, every lane through
     Dijkstra at the end; S x events / wall; each lane form timed at its
     path's final shape beside one lane alone (the ratio to S single-lane
     calls) and its bound (the share), and the lane-minor interleave
     (``relax.lane_minor``, the same pass K2 runs inside its launch)
     timed apart;
  10. at 2^16 (the ER recipe's first quarter of events): 4 lanes on
     segment, ellpack, sliced unfused, auto and the sparse frontier (K3's
     lane form), under rounds and buckets, each lane equal to a
     single-source engine at every query; ``sparse_drain`` on K3 against
     the plain version, one source and then on ``[S, N]`` lanes (K3's lane
     form);
  12. the serving path with observability: phase 8's cut of the ER stream
     lifted into a ``ServingTrace`` and replayed (``replay_trace``) on the
     dense ELL block (K1), observability on with a default watchdog
     armed — bit-identical to phase 3 at every query (dist, parent,
     rounds, messages), Dijkstra at the end; the snapshot's views
     agree (rounds and messages, span counts from the Chrome trace read
     back against the epoch and rebuild counters, histogram totals against
     their counters, the Prometheus text round trip), the watchdog stays
     silent; the report's latency percentiles, churn and cold/warm split,
     and the snapshot's time; the same trace written as a chunked v2 file
     (chunks of 2^20 events) and replayed through ``open_trace`` with
     observability off: dist equal to phase 3's at every query, Dijkstra
     at the end (the ER leg's replays were three, obs off and on from
     memory and the file; the obs-off one now is the file's, so the ER
     on / off ratio is not printed: the sparse leg keeps it); phase 8's
     RMAT(20) cut under auto
     and buckets (K2), observability on: equal to phase 8's run at every
     query, non-zero pending occupancy, ``drain_waves`` equal to the
     drains' waves; phase 6's localized stream, sparse (K3), observability
     off and then on: bit-identical, the on / off events/s ratio over its
     96 short epochs (printed, not held), ``frontier_occupancy`` equal to
     the sum of the ladder counts the waves read.  K1-K3 counts set to 0 before each leg, printed after;
  13. the sharded engine with SHARDS = 8 partitions stacked on cuda:0
     (``make_mesh((8,), ("graph",), devices=[cuda:0] * 8)``): phase 8's
     cut of the ER stream through ``make_engine(relax_backend="ellpack",
     batch_deletions=True, mesh=...)``, K1 once per partition and wave
     (its count set to 0 just before and read just after), bit-identical
     to phase 3's run at every query (dist, parent, rounds, messages),
     Dijkstra at the end; K1 on each partition's block against its plain
     version (variant per partition) and timed three ways, one block and
     all eight; the sharded and the single host control planes replayed
     alone on the cut; then at 2^16 (a quarter of the events), against
     single-device engines on the card: the delta exchange (overflowing
     and sparse rounds counted), the sparse frontier (both branches
     counted), buckets, the edge-balanced relabeling, a checkpoint
     restored into a fresh engine, observability (rounds, messages and the
     per-partition counters summed), and RMAT(16) on the sliced layout (K1
     once per width run and partition);
  14. the sharded lanes and the paper's baselines: phase 13's mesh and cut
     with ``sources=`` phase 9's LANES vertices, K1's lane form once per
     partition and wave (its counts set to 0 just before and read just
     after; launches = SHARDS x mesh waves), every lane equal to phase 9's
     run at every query (dist, parent, per-lane rounds and messages), lane
     0 to phase 13's, Dijkstra for every lane; source-events/s beside phase
     9's; K1's lane form on each partition's block against its plain
     version (variant per partition) and timed three ways, one block and
     all eight, on one lane-minor copy of the offers as the path shares
     it (the interleave timed apart, the ratio to S single-lane calls),
     with its bound (``relax.wave_bytes(lanes=4)``); the
     ReMo-from-scratch baseline at full width on the same cut, queried at
     its 7th, 14th and 21st query points (dist equal to the sharded lane
     0's within check_tree's tolerance, Dijkstra; latency p50 beside the
     engine's; a query with randomized ties leaves dist unchanged) and the
     static solver (convert and solve, Dijkstra); then at 2^16 against the
     single-device lane engine on the card: the delta exchange
     (overflowing lane-rounds counted), the sparse frontier (both
     branches, per partition and lane), buckets, a checkpoint restored
     into a fresh engine, observability, RMAT(16) sliced (K1's lane form
     per width run and partition, both variants), and the batched BSP
     baseline's final dist against the engine's;
  15. the GNN and recsys substrate at full width (no kernel: the
     reference's GNNs aggregate with segment sums and DIN looks rows up
     with plain indexing, so neither reaches K4 or K5): GraphSAGE,
     MeshGraphNet, DimeNet and EquiformerV2 at their full CONFIG on
     ``full_graph_sm`` (an Erdős–Rényi stand-in with Cora's 2,708 nodes
     and 10,556 edges, d_feat 1,433, 7 classes, padded to 512) and on
     ``molecule`` (128 graphs of 30 nodes and 64 edges; DimeNet with 8
     triplets an edge): one AdamW train step on the card against the same
     step on the CPU from the same initial state (loss, grad norm,
     Adam's first moments, parameters; SUB_TOL), then SUB_STEPS steps
     timed with CUDA events, peak memory and model TFLOP/s; GraphSAGE-
     Reddit ``minibatch_lg`` through the ported ``NeighborSampler`` over a
     stand-in with Reddit's 232,965 nodes and 114,615,892 edges (1,024
     seeds, fanout (15, 10), d_feat 602, 41 classes; the sample's host
     time, the step card against CPU, then timed); DIN at full CONFIG
     (table 10,485,760 x 18): ``din_score`` at serve_p99 and a train step
     at batch 512 card against CPU, then ``train_batch`` (65,536) steps
     timed, serve_p99 latency p50/p99 over 50 calls, ``serve_bulk``
     (262,144) rows/s, retrieval over RETRIEVAL_CUT candidates (cut from
     1,000,000: the one-chain form's f32 intermediates outgrow the card)
     held against ``din_score`` on the same user;
  16. the LM substrate at published widths (no kernel: the reference's
     attention is a ``lax.scan`` with a custom VJP and its matmuls plain,
     so neither reaches a ``pl.pallas_call``): (a) the five LM archs at
     their CONFIG widths with one layer, B 1 x S 64, bf16 compute:
     ``lm_loss`` and the global grad norm on the card against the port on
     the CPU from the same seeded weights (LM_TOL; the CPU side on a host
     thread while (b) and (c) run); (b) serving at full
     CONFIG with bf16 weights for qwen3-14b (GQA, G = 5, qk-norm),
     minicpm3-4b (MLA) and olmoe-1b-7b (MoE 64 experts top 8): prefill
     1 x 16,384 (**cut** from prefill_32k's 32 x 32,768: time; minicpm3-4b
     1 x 8,192, **cut** further to keep the script's time), then
     decode_32k's capacity with the cache filled to 32,751 from a seeded
     generator at B 4 / 32 / 8 (**cut** from 128: memory), a warm step
     and DECODE_STEPS timed; prefill s and tokens/s, decode ms p50 and
     tokens/s, peak GB, model TFLOP/s, a step's bytes and their share of
     3.35 TB/s; and at 2 layers a prefill of 256 tokens then 8 decode
     steps against ``lm_forward`` on the whole sequence; (c) training with
     f32 master weights, AdamW and CONFIG's grad_accum, one sequence of
     4,096 a microbatch (**cut** from train_4k's 256): minicpm3-4b at 16
     of 62 layers and olmoe-1b-7b at 4 of 16 (**cut** to fit the
     parameters, gradients and both moments), a warm step, 2 timed (the
     second also profiled: device-busy share), finite loss and grad norm;
     (d)
     ``python -m repro_torch.launch.train`` (qwen3-14b, 100m preset)
     crashed at step 15 (exit 17), resumed (exit 0), against an
     uninterrupted run (LAUNCH_TOL); (e) the port's flash forward at
     (b)'s qwen3 prefill shape beside ``F.scaled_dot_product_attention``
     (printed only);
  17. the tools (no kernel: the programs the registry builds reach no
     ``pl.pallas_call``): (a) ``repro_torch.launch.dryrun.main(["--all",
     "--mesh", "both", ...])`` on ``meta``, its traces in DRYRUN_JOBS
     worker processes: every cell ``ok`` or ``SKIP``, one line a cell,
     the time; (b) the dry run held against
     the card on a one-partition (1, 1) mesh on cuda:0, for every cell
     whose own dry-run peak fits in CARD_SHARE of the card and whose
     inputs the registry fills (``Program.fill``: the GNNs at
     full_graph_sm and molecule, DIN train_batch / serve_p99 /
     serve_bulk, the four SSSP cells on seeded R-MAT pools; the rest
     printed with the reason): the argument bytes predicted from meta
     equal to the filled arguments' bytes, the fastest of CARD_REPEATS
     timed runs after a warm one (CUDA events) at or above the trace's
     ``bound_s`` (SSSP: the meta trace replays the warm run's host reads,
     so it runs the epoch's rounds), the measured peak above the
     arguments beside the predicted ``temp_bytes`` and the roofline share
     ``bound_s / measured`` (printed, not held);
  18. the straggler bound (``max_rounds``, DESIGN.md §7): the ER
     stream's edges as phase 3's dense ELL block (K1), the RMAT stream's
     as phase 4's sliced layout (K2), phase 6's base graph as its OUT
     sidecar (K3); on each, the ADD epoch from the source over the whole
     edge set, for one source and for 4 lanes (phase 9's sources on the
     streams, phase 6c's on the base: the lane forms), unbounded, then
     with ``max_rounds`` 1 and 4 re-issued with ``dist < dist before`` as
     the frontier until nothing improves: at most ``max_rounds`` waves
     an issue, more than one issue, the end bit-identical to the
     unbounded epoch, and under bound 4 every issue on the kernel
     bit-identical to the same issue on the plain versions; issues, waves
     and launches printed;
  11. the whole script's time, the card line, a JSON ``kernels`` line (every kernel with ``ms``,
     ``device_ms``, ``host_us``, ``bound_ms`` and ``launches``; K1, K2
     and K3 with a ``lanes`` record of their lane forms (K3's from phase
     6c, with phase 10's launches as ``cross_check_launches``); K1-K3 with
     ``serving_launches``, their counts in phase 12's legs, and a
     ``bounded`` record of phase 18; K1 with
     ``sharded_launches``, its count in phase 13's full-width leg, a
     ``sharded`` record, and a ``sharded_lanes`` record of phase 14), and
     as the last line ``{"ok": true, "device": {...}}``.  Phases run in
     the order 1-6, 8-10, 18, 12, 13, 14, 15, 16, 17, 7.

It exits non-zero before printing any result when torch sees no CUDA
device.  It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 7
EDGE_FACTOR = 8          # examples/streaming_sssp.py's RMAT edge factor
LANES = 4                # sources of the batched legs (S)
INF = float("inf")
WINDOW_FRAC, DELTA = 0.3, 0.3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# the backward of neighbor_reduce / bag_lookup scatters with index_add_,
# whose atomics add in no fixed order on the card: the kernel route's
# gradient against the plain route's, relative to the largest entry
GRAD_RTOL = {"f32": 1e-5, "bf16": 2**-7}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def stream(log2_n: int, graph: str):
    """The recipe at 2^log2_n vertices: an ER ("er") or RMAT ("rmat")
    graph with edge factor 8 and seed 7, sliding window 0.3·E with delta
    0.3, a QUERY every window/10.  Returns (n, edges, sources, log):
    ``sources`` are the LANES vertices of highest in-degree (the reference
    bench's recipe for batched lanes, benchmarks/bench_sssp.py:656); the
    single-source paths serve the first."""
    from repro_torch.core import events as ev
    from repro_torch.graphs import generators, window as win
    n = 1 << log2_n
    if graph == "er":
        n, src, dst, w = generators.erdos_renyi(n, EDGE_FACTOR * n,
                                                seed=SEED)
    else:
        n, src, dst, w = generators.rmat(log2_n, EDGE_FACTOR, seed=SEED)
    window = int(len(src) * WINDOW_FRAC)
    log = win.sliding_window_stream(src, dst, w, window=window, delta=DELTA,
                                    seed=0)
    log = ev.interleave_queries(log, window // 10)
    sources = [int(v) for v in
               generators.top_in_degree_sources(n, dst, LANES)]
    return n, len(src), sources, log


def engine(n: int, e: int, source: int, **knobs):
    import repro_torch
    return repro_torch.make_engine(
        num_vertices=n, edge_capacity=int(1.3 * e) + 64, source=source,
        batch_deletions=True, **knobs)


def topo_counts(log) -> tuple[int, int]:
    return int((log.kind != 2).sum()), int((log.kind == 1).sum())


def run_path(torch, eng, log, counters, marks=None):
    """Drive ``eng`` over ``log`` with the kernels' launch counts set to 0
    just before and read just after; returns (wall s, query results,
    launches per counter).  ``marks``, where given, receives (seconds
    since the start, waves so far) at every query."""
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    on_query = None if marks is None else (
        lambda _: marks.append((time.perf_counter() - t0, eng.n_rounds)))
    results = eng.ingest_log(log, on_query=on_query)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, results, [c.launches for c in counters]


def p50_ms(results) -> float:
    return float(np.median([r.latency_s for r in results])) * 1e3


def control_plane_seconds(e: int, log, planner, plan) -> float:
    """The host control plane alone: the same runs through a fresh slot
    allocator and layout planner (numpy, no device work), grouped as the
    engine groups them under batch_deletions=True."""
    from repro_torch.core import events as ev
    from repro_torch.core import ingest
    alloc = ingest.make_allocator(int(1.3 * e) + 64)
    t0 = time.perf_counter()
    for batch in log.runs():
        if batch.kind == ev.ADD:
            p = alloc.plan_adds(batch.src, batch.dst, batch.w)
            if plan(planner, p) is None:
                planner.rebuild_host(*alloc.active_coo())
        elif batch.kind == ev.DEL:
            alloc.plan_dels(batch.src, batch.dst)
    return time.perf_counter() - t0


class AutoReplayPlanner:
    """The host planning of ``relax_backend="auto"`` for
    ``control_plane_seconds``: the dense ELL planner until a rebuild
    reports hub blowup (the engine then builds no block), the sliced
    planner from that rebuild on, as the engine swaps layouts."""

    def __init__(self, n: int):
        from repro_torch.core.backends.ellpack import EllPlanner
        self.n, self.ell, self.sliced = n, EllPlanner(n), None

    def plan_appends(self, p):
        rows = p.dst[p.fresh].astype(np.int64)
        if self.sliced is None:
            return self.ell.plan_appends(rows)
        return self.sliced.plan_appends(rows, p.src[p.fresh], p.w[p.fresh])

    def rebuild_host(self, src, dst, w):
        from repro_torch.core.backends.base import ELL_BLOWUP_RATIO
        from repro_torch.core.backends.sliced import SlicedEllPlanner
        if self.sliced is None:
            k = self.ell.required_k(dst)
            if self.ell.rows * k <= ELL_BLOWUP_RATIO * max(len(dst), 1):
                return self.ell.rebuild_host(src, dst, w, k)
            self.sliced = SlicedEllPlanner(self.n)
        return self.sliced.rebuild_host(src, dst, w)


def device_profile(torch, eng, log):
    """``eng`` driven over ``log`` under torch.profiler (CUDA activity
    only): total device time in seconds and every device op as (name,
    seconds, count), largest first.  The profiler only slows the host."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.ingest_log(log)
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda x: -x.self_device_time_total)
    total = sum(x.self_device_time_total for x in ops) / 1e6
    return total, [(x.key, x.self_device_time_total / 1e6, x.count)
                   for x in ops]


def top_ops(ops, n: int = 5) -> str:
    return "; ".join(f"{name[:48]} {sec:.3f} s x{cnt}"
                     for name, sec, cnt in ops[:n])


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one fn() call: ``calls`` calls captured in one CUDA
    graph (every kernel of a library call included), the graph replayed
    ``replays`` times back to back between CUDA events, over calls x
    replays.  The host submits one replay per ``calls`` calls, so this is
    the device's time, launch gaps inside the graph included.  (Short
    torch.profiler sessions after long ones were seen to drop kernel
    records, so the profiler is not used here.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def per_launch_ms(torch, fn, calls: int = 20) -> list[tuple[str, float]]:
    """Device time per launch of each kernel (and memset) of fn(), from
    torch.profiler over ``calls`` calls: each op's total over its own
    count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(x.key, x.self_device_time_total / 1e3 / x.count)
            for x in prof.key_averages() if x.self_device_time_total > 0]


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one fn() call: the submission alone, ``calls`` calls
    back to back on the host clock with no synchronisation inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def kernel_times(torch, fn, iters: int) -> dict:
    """fn() timed three ways: back to back (``ms``, CUDA events over
    ``iters`` calls), device time per call (``device_ms``, a replayed CUDA
    graph) and host time per call (``host_us``, the submission alone)."""
    return {"ms": cuda_ms(torch, fn, iters),
            "device_ms": device_ms(torch, fn), "host_us": host_us(torch, fn)}


def times_text(t: dict) -> str:
    return (f"{t['ms']:.4f} ms back to back, device {t['device_ms']:.4f} "
            f"ms, host {t['host_us']:.1f} us per call")


def sync_us(torch, n: int) -> float:
    """Host time of one ``bool(frontier.any())`` read at N = n."""
    f = torch.rand(n, device="cuda") < 0.01
    for _ in range(10):
        bool(f.any())
    t1 = time.perf_counter()
    for _ in range(200):
        bool(f.any())
    return (time.perf_counter() - t1) / 200 * 1e6


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time of the work on this card: bytes over the memory rate
    against f32 operations over the peak f32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def compare(torch, name, kernel_out, plain_out) -> float:
    """Kernel vs plain version on the same inputs: +inf pattern and arg
    equal, returns max |best difference|, which must be 0."""
    (kb, ka), (rb, ra) = kernel_out, plain_out
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(kb), torch.isinf(rb)), f"{name} +inf"
    assert torch.equal(ka, ra), f"{name} arg differs from the plain version"
    fin = torch.isfinite(rb)
    err = float((kb[fin] - rb[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert err == 0.0, f"{name} best differs by {err}"
    return err


def snapshot_check(n, source, src, dst, w, dist, parent, atol=1e-4):
    """check_tree's contract, vectorized: distances within (atol, rtol
    1e-5) of an f64 Dijkstra; every reached non-source vertex's parent edge
    exists and is tight; unreached vertices have no parent.  ``source``
    may be a sequence of S sources with ``dist`` and ``parent`` [S, N]
    (lanes): the graph and its sorted edge keys are built once for all.
    Returns the reached count (a list of them for lanes)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    lanes = np.ndim(source) > 0
    g = csr_matrix((w.astype(np.float64), (src, dst)), shape=(n, n))
    keys = (src.astype(np.int64) << 32) | dst.astype(np.int64)
    order = np.argsort(keys)
    keys, w_sorted = keys[order], w[order]
    big = lambda x: np.where(np.isinf(x), 1e30, x)   # noqa: E731
    counts = []
    for s, d, par in zip(np.atleast_1d(source), np.atleast_2d(dist),
                         np.atleast_2d(parent)):
        ref = dijkstra(g, directed=True, indices=int(s))
        got = d.astype(np.float64)
        assert np.allclose(big(ref), big(got), atol=atol, rtol=1e-5), \
            "dist differs from Dijkstra"
        reached = np.isfinite(ref)
        v = np.nonzero(reached & (np.arange(n) != s))[0]
        assert (par[~reached] == -1).all(), "unreached vertex has a parent"
        p = par[v].astype(np.int64)
        assert (p >= 0).all(), "reached vertex lacks a parent"
        want = (p << 32) | v
        pos = np.clip(np.searchsorted(keys, want), 0, len(keys) - 1)
        assert (keys[pos] == want).all(), "parent edge not in the graph"
        slack = np.abs(got[p] + w_sorted[pos].astype(np.float64) - got[v])
        assert (slack < np.maximum(atol, 1e-5 * np.maximum(
            1.0, np.abs(got[v])))).all(), "tree edge not tight"
        counts.append(int(reached.sum()))
    return counts if lanes else counts[0]


def same_results(name, got, want) -> None:
    assert len(got) == len(want) > 0, name
    for a, b in zip(got, want):
        assert np.array_equal(a.dist, b.dist), f"{name}: dist differs"
        assert np.array_equal(a.parent, b.parent), f"{name}: parent differs"
        assert a.epoch_stats == b.epoch_stats, f"{name}: stats differ"


# ------------------------------------------------------- kernel edge cases --
def k1_case(torch, seed: int, n: int, rows: int, k: int, ties: bool,
            tail: bool = False):
    """offers (n,) with +inf entries and an ELL block (rows, k) whose row 0
    is all tombstones; the other +inf cells are scattered, or with
    ``tail`` laid out as the ELL planner lays them out: a live head of
    fill[r] cells with tombstones among them, then never-written cells
    (idx 0, w +inf) to the row's end."""
    g = torch.Generator().manual_seed(seed)
    if ties:
        offers = torch.randint(0, 4, (n,), generator=g).float()
        w = torch.randint(1, 4, (rows, k), generator=g).float()
    else:
        offers = 4 * torch.rand(n, generator=g)
        w = 0.5 + 1.5 * torch.rand(rows, k, generator=g)
    offers[torch.rand(n, generator=g) < 0.3] = float("inf")
    idx = torch.randint(0, n, (rows, k), generator=g, dtype=torch.int32)
    if tail:
        fill = torch.randint(0, k + 1, (rows,), generator=g)
        past = torch.arange(k)[None, :] >= fill[:, None]
        w[past], idx[past] = float("inf"), 0
        w[~past & (torch.rand(rows, k, generator=g) < 0.15)] = float("inf")
    else:
        w[torch.rand(rows, k, generator=g) < 0.2] = float("inf")
    w[0] = float("inf")                      # an all-tombstone row
    return [t.cuda() for t in (offers, idx, w)]


def k1_view(torch, args, offset: int):
    """The block of ``args`` as a view at cell ``offset`` of a flat buffer,
    as ``sliced_gather_min`` passes one run of slices."""
    offers, idx, w = args
    rows, k = idx.shape
    flat_i = idx.new_zeros(offset + rows * k)
    flat_w = w.new_zeros(offset + rows * k)
    flat_i[offset:], flat_w[offset:] = idx.reshape(-1), w.reshape(-1)
    return [offers, flat_i[offset:].view(rows, k),
            flat_w[offset:].view(rows, k)]


def k2_case(torch, seed, *, widths, slice_rows, n, ocap, ties=False,
            active_frac=1.0, dead_frac=0.0, tombstones=False):
    """A random flat sliced layout + overflow lane on the card (n <= rows);
    ``ties`` draws integer offers and weights, ``dead_frac`` of the rows get
    no live cell, ``tombstones`` puts +inf between every row's live cells
    and makes the second slice all padding.  Returns ((dist, active),
    layout): the layout object K2's wrapper reads (the fields a
    ``SlicedEllState`` holds for it) with its chunk table."""
    from repro_torch.graphs import csr
    from repro_torch.kernels.relax.fused import ChunkTable
    rng = np.random.default_rng(seed)
    L = slice_rows * sum(widths)
    wpool = np.asarray([0.5, 1.0] if ties else rng.uniform(0.1, 2.0, 8),
                       np.float32)
    flat_idx = rng.integers(0, n, L).astype(np.int32)
    flat_w = np.where(rng.random(L) < 0.6, rng.choice(wpool, L),
                      np.inf).astype(np.float32)
    _, rowk, base, _ = csr.sliced_geometry(list(widths), slice_rows)
    for r in np.nonzero(rng.random(len(base)) < dead_frac)[0]:
        flat_w[base[r]:base[r] + rowk[r]] = np.inf
    if tombstones:
        for r in range(len(base)):
            flat_w[base[r] + 1:base[r] + rowk[r]:2] = np.inf
        flat_w[base[slice_rows]:base[min(2 * slice_rows, len(base) - 1)]] \
            = np.inf
    osrc = rng.integers(0, n, ocap).astype(np.int32)
    odst = rng.integers(0, n, ocap).astype(np.int32)
    ow = np.where(rng.random(ocap) < 0.7, rng.choice(wpool, ocap),
                  np.inf).astype(np.float32)
    dist = np.where(rng.random(n) < 0.8, rng.uniform(0.0, 4.0, n),
                    np.inf).astype(np.float32)
    if ties:
        dist = np.floor(dist)
    active = rng.random(n) < active_frac
    t = [torch.from_numpy(a).cuda() for a in
         (dist, active, flat_idx, flat_w, osrc, odst, ow)]
    widths = tuple(widths)
    return t[:2], SimpleNamespace(
        flat_idx=t[2], flat_w=t[3], osrc=t[4], odst=t[5], ow=t[6],
        widths=widths, slice_rows=slice_rows,
        table=ChunkTable.build(widths, slice_rows, t[3].device))


def k2_plain(dist, active, lay):
    """K2's plain version on a layout object (one lane or S)."""
    from repro_torch.kernels.relax.ref import fused_sliced_relax_ref
    return fused_sliced_relax_ref(dist, active, lay.flat_idx, lay.flat_w,
                                  lay.osrc, lay.odst, lay.ow,
                                  widths=lay.widths,
                                  slice_rows=lay.slice_rows)


def k2_check(torch, dist, active, lay) -> float:
    from repro_torch.kernels.relax.fused import fused_sliced_relax
    return compare(torch, "K2", fused_sliced_relax(dist, active, lay),
                   k2_plain(dist, active, lay))


def k3_case(torch, seed, e, n, *, ties=False, mask_frac=0.7, hub=False,
            dup=False):
    """E edge slots over n rows; ``hub`` sends every slot to one row,
    ``dup`` makes the second half of the slots a copy of the first."""
    rng = np.random.default_rng(seed)
    if ties:
        wd = rng.integers(0, 3, e).astype(np.float32)
        w = rng.integers(1, 3, e).astype(np.float32)
    else:
        wd = rng.uniform(0, 3, e).astype(np.float32)
        w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    wd[rng.random(e) < 0.1] = np.inf
    w[rng.random(e) < 0.1] = np.inf
    src = rng.integers(0, n, e).astype(np.int32)
    nbr = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < mask_frac
    if hub:
        nbr[:] = n // 2
    if dup:
        h = e // 2
        for a in (wd, src, nbr, w, mask):
            a[h:2 * h] = a[:h]
    return [torch.from_numpy(a).cuda() for a in (wd, src, nbr, w, mask)]


def k3_check(torch, args, num_rows) -> float:
    from repro_torch.kernels.relax.gather import gathered_rows_relax
    from repro_torch.kernels.relax.ref import gathered_rows_relax_ref
    return compare(torch, "K3", gathered_rows_relax(*args, num_rows=num_rows),
                   gathered_rows_relax_ref(*args, num_rows=num_rows))


def k3_lanes_case(torch, seed, lanes, e, n):
    """[S, E] edge lists with ties: lane 1 all masked, lane 2 every slot on
    one hub row, lane 3 a copy of lane 0 (the same rows and keys in two
    lanes), the others drawn apart."""
    rows = []
    for t in range(lanes):
        rows.append(rows[0] if t == 3 else k3_case(
            torch, seed + t, e, n, ties=True,
            mask_frac=0.0 if t == 1 else 0.8, hub=t == 2))
    return [torch.stack(col).contiguous() for col in zip(*rows)]


def k3_lanes_check(torch, args, num_rows) -> float:
    """K3's lane form against its lane plain version and, lane by lane,
    single-lane K3 calls on the same edge lists.  Returns the max |best
    difference| (0)."""
    from repro_torch.kernels.relax.gather import (gathered_rows_relax,
                                                  gathered_rows_relax_lanes)
    from repro_torch.kernels.relax.ref import gathered_rows_relax_lanes_ref
    got = gathered_rows_relax_lanes(*args, num_rows=num_rows)
    err = compare(torch, "K3 lanes", got, gathered_rows_relax_lanes_ref(
        *args, num_rows=num_rows))
    for t in range(got[0].shape[0]):
        compare(torch, f"K3 lane {t}", (got[0][t], got[1][t]),
                gathered_rows_relax(*(a[t] for a in args),
                                    num_rows=num_rows))
    return err


def k3_lanes_graph_check(torch) -> None:
    """K3's lane form captured in a CUDA graph, replayed on new inputs
    written in place: each replay equals the lane plain version."""
    from repro_torch.kernels.relax.gather import gathered_rows_relax_lanes
    from repro_torch.kernels.relax.ref import gathered_rows_relax_lanes_ref
    n = 5000
    args = k3_lanes_case(torch, 80, 5, 4096, n)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gathered_rows_relax_lanes(*args, num_rows=n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gathered_rows_relax_lanes(*args, num_rows=n)
    for seed in (81, 82):
        for a, b in zip(args, k3_lanes_case(torch, seed, 5, 4096, n)):
            a.copy_(b)
        graph.replay()
        compare(torch, "K3 lanes graph", out,
                gathered_rows_relax_lanes_ref(*args, num_rows=n))


K3_LANE_SHAPES = ((0, 12), (85, 40), (300, 1), (4096, 5000),
                  (16_384, 1 << 20))   # (E, R): E = 0, R = 1, the sparse path


def k3_lane_edge_cases(torch) -> None:
    """Phase 2 for K3's lane form: S in LANE_CASES on ragged lanes at
    K3_LANE_SHAPES, and in a CUDA graph."""
    n_cases = 0
    for lanes in LANE_CASES:
        for i, (e, n) in enumerate(K3_LANE_SHAPES):
            k3_lanes_check(torch, k3_lanes_case(torch, 90 + 10 * i, lanes, e,
                                                n), n)
            n_cases += 1
    k3_lanes_graph_check(torch)
    print(f"[2] K3 lane form at S = {LANE_CASES}: bit-identical to the lane "
          f"plain version and to S single-lane K3 calls on {n_cases} cases "
          f"((E, R) in {K3_LANE_SHAPES}; an "
          f"all-masked lane, a lane with every slot on one hub row, two "
          f"equal lanes: ties across lanes), and in a CUDA graph replayed "
          f"on new inputs")


def k3_graph_check(torch) -> None:
    """K3 captured in a CUDA graph, replayed, then replayed again after the
    inputs were overwritten in place: both replays equal the plain
    version on the inputs of the moment."""
    from repro_torch.kernels.relax.gather import gathered_rows_relax
    from repro_torch.kernels.relax.ref import gathered_rows_relax_ref
    n = 5000
    args = k3_case(torch, 70, 4096, n, ties=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gathered_rows_relax(*args, num_rows=n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gathered_rows_relax(*args, num_rows=n)
    for seed in (71, 72):
        if seed == 72:
            for a, b in zip(args, k3_case(torch, seed, 4096, n, ties=True)):
                a.copy_(b)
        graph.replay()
        compare(torch, "K3 graph", out,
                gathered_rows_relax_ref(*args, num_rows=n))


def same_bits(torch, name, got, want) -> float:
    """Kernel vs plain version on the same inputs: equal dtype and shape,
    the same NaN positions and equal bits everywhere else.  Returns the
    largest |got - want| over the non-NaN entries (0 when the bits match)."""
    torch.cuda.synchronize()
    got, want = got.detach(), want.detach()
    assert got.dtype == want.dtype and got.shape == want.shape, name
    nan = got.isnan()
    assert torch.equal(nan, want.isnan()), f"{name}: NaN pattern differs"
    diff = (got[~nan].float() - want[~nan].float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ints = torch.int32 if got.dtype == torch.float32 else torch.int16
    assert torch.equal(got[~nan].view(ints), want[~nan].view(ints)), \
        f"{name} differs from the plain version by up to {err}"
    return err


def k4_case(torch, seed, s, r, k, f, dtype, *, ties=False, nan=False):
    """feats (s, f) and an ELL block (r, k): the first rows all masked, -1
    in every masked cell, each row's second cell a duplicate of its first;
    ``ties`` draws integer features, ``nan`` plants NaNs in live rows."""
    rng = np.random.default_rng(seed)
    feats = (rng.integers(-3, 4, (s, f)) if ties
             else rng.standard_normal((s, f))).astype(np.float32)
    idx = rng.integers(0, s, (r, k)).astype(np.int32)
    if k > 1:
        idx[:, 1] = idx[:, 0]
    mask = rng.random((r, k)) < 0.7
    mask[:3] = False
    idx[~mask] = -1
    if nan:
        feats[idx[mask][:5], 1] = np.nan
    return (torch.from_numpy(feats).to("cuda", dtype),
            torch.from_numpy(idx).cuda(), torch.from_numpy(mask).cuda())


def k5_case(torch, seed, v, b, l, d, dtype, tail=False):
    """table (v, d), bags (b, l): a quarter of the slots -1 and, past two
    bags, the first two bags all padding and the third one row repeated;
    ``tail`` also pads each bag after a random length in [1, l]."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    idx[rng.random((b, l)) < 0.25] = -1
    if tail:
        lens = rng.integers(1, l + 1, b)
        idx[np.arange(l)[None, :] >= lens[:, None]] = -1
    if b > 2:
        idx[:2] = -1
        idx[2] = 5
    return (torch.from_numpy(table).to("cuda", dtype),
            torch.from_numpy(idx).cuda())


def lanes_of(torch, base, lanes: int, seed: int):
    """``lanes`` lanes over ``base`` (an (N,) vector): lane 0 is ``base``,
    lane 1 all +inf, the others ``base`` with 30 % of the entries set to
    +inf and the rest shuffled."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = base.unsqueeze(0).repeat(lanes, 1)
    for t in range(2, lanes):
        perm = torch.randperm(base.numel(), generator=g, device="cuda")
        out[t] = base[perm]
        out[t][torch.rand(base.numel(), generator=g, device="cuda") < 0.3] \
            = INF
    if lanes > 1:
        out[1] = INF
    return out


def lanes_check(torch, name, fn, lane_args, one_args, plain) -> float:
    """A lane-form call against its lane plain version and, lane by lane,
    against single-lane kernel calls; ``one_args(t)`` gives lane t's
    single-lane arguments.  Returns the max |best difference| (0)."""
    got = fn(*lane_args)
    err = compare(torch, f"{name} lanes", got, plain)
    for t in range(got[0].shape[0]):
        compare(torch, f"{name} lane {t}", (got[0][t], got[1][t]),
                fn(*one_args(t)))
    return err


LANE_CASES = (1, 4, 5, 8, 16)   # phase 2: one lane group and two


def lane_edge_cases(torch, k2_cases) -> None:
    """Phase 2 for the lane forms: K1 (both variants; views at a cell
    offset) and K2 at S in LANE_CASES against the lane plain version and S
    single-lane kernel calls, bit for bit, on phase 2's edge cases; K1 on
    a caller-made lane-minor copy (``offers_minor=``), which equals its
    plain version."""
    from repro_torch.kernels.relax import fused as k2
    from repro_torch.kernels.relax import relax as k1
    from repro_torch.kernels.relax.ref import (ellpack_relax_ref,
                                               lane_minor_ref)
    cases = [(50, 8, 1), (700, 130, 4), (300, 256, 5), (5000, 4097, 32),
             (70000, 65536, 33), (900, 70, 128), (900, 33, 130),
             (1 << 20, 1 << 20, 32)]
    taken, n1, n2 = set(), 0, 0
    for lanes in LANE_CASES:
        blocks = [k1_case(torch, i, n, r, k, True, True)
                  for i, (n, r, k) in enumerate(cases)]
        blocks += [k1_view(torch, k1_case(torch, 50 + i, 500, 300, k, True,
                                          True), off)
                   for i, (off, k) in enumerate([(3, 32), (1, 4), (2, 36)])]
        for offers, idx, w in blocks:
            if lanes >= 8 and idx.shape[0] == 1 << 20:
                continue       # the plain version's (S, R, K) candidates
            taken.add(k1.variant(idx, w))
            lo = lanes_of(torch, offers, lanes, n1)
            plain = ellpack_relax_ref(lo, idx, w)
            lanes_check(torch, "K1", k1.ellpack_relax, (lo, idx, w),
                        lambda t: (lo[t].contiguous(), idx, w), plain)
            minor = k1.lane_minor(lo)
            assert torch.equal(minor, lane_minor_ref(lo)), "lane_minor"
            compare(torch, "K1 lanes on a caller-made copy",
                    k1.ellpack_relax(lo, idx, w, offers_minor=minor), plain)
            n1 += 1
        for i, (_, c) in enumerate(k2_cases):
            (dist, active), lay = k2_case(torch, 100 + i, **c)
            d = lanes_of(torch, dist, lanes, n2)
            a = torch.rand(d.shape, device="cuda") < 0.7
            a[0] = active
            if lanes > 2:
                a[2] = False          # a lane with no active source
            lanes_check(torch, "K2", k2.fused_sliced_relax, (d, a, lay),
                        lambda t: (d[t].contiguous(), a[t].contiguous(), lay),
                        k2_plain(d, a, lay))
            n2 += 1
    assert taken == {"vector", "scalar"}, taken
    print(f"[2] K1 and K2 lane forms at S = {LANE_CASES}: bit-identical to "
          f"the lane plain version and to S single-lane kernel calls on "
          f"{n1} K1 cases (both variants, views at a cell offset, an "
          f"all-+inf lane; each also on a caller-made lane-minor copy) and "
          f"{n2} K2 cases (an all-+inf lane, a lane with no active source)")


def gather_edge_cases(torch) -> None:
    """Phase 2 for K4 and K5."""
    from repro_torch.kernels.embed_bag.embed_bag import embedding_bag
    from repro_torch.kernels.embed_bag.ref import embedding_bag_ref
    from repro_torch.kernels.spmm.ref import spmm_ell_ref
    from repro_torch.kernels.spmm.spmm import spmm_ell
    dtypes = (torch.float32, torch.bfloat16)
    # (s, r, k, f, ties): K = 1, K > 32 with F not a multiple of 4, ties,
    # F = 1, F over one 128-feature chunk, the sampler's K = 15 at F = 602;
    # K not a multiple of the rows in flight (37 at 16 lanes, 17 at 4)
    k4 = [(40, 64, 1, 32, False), (300, 96, 40, 18, False),
          (16, 128, 12, 24, True), (10, 8, 5, 1, True),
          (1000, 512, 33, 130, False), (4096, 2048, 15, 602, False),
          (500, 256, 37, 64, False), (200, 128, 17, 16, True)]
    n = 0
    for i, (s, r, k, f, ties) in enumerate(k4):
        for dtype in dtypes:
            args = k4_case(torch, i, s, r, k, f, dtype, ties=ties)
            for agg in ("sum", "mean", "max"):
                same_bits(torch, "K4", spmm_ell(*args, agg=agg),
                          spmm_ell_ref(*args, agg))
                n += 1
    args = k4_case(torch, 99, 50, 64, 9, 40, torch.float32, nan=True)
    got = spmm_ell(*args, agg="max")
    assert bool(got.isnan().any()), "K4 max lost the NaNs"
    same_bits(torch, "K4 NaN", got, spmm_ell_ref(*args, "max"))
    feats, idx, mask = k4_case(torch, 98, 50, 64, 9, 40, torch.float32)
    mask[5:, :2] = True
    idx[5:, 0], idx[5:, 1] = 50, -7         # live, past either end: clamped
    for agg in ("sum", "mean", "max"):
        same_bits(torch, "K4 clamp", spmm_ell(feats, idx, mask, agg=agg),
                  spmm_ell_ref(feats, idx, mask, agg))
    print(f"[2] K4 bit-identical to the plain version on {n + 4} cases "
          f"(sum, mean, max; f32 and bf16; K in {sorted({c[2] for c in k4})}, "
          f"F in {sorted({c[3] for c in k4})}; all-masked rows, -1 in masked "
          f"cells, duplicate indices, integer ties, NaN for max, live "
          f"indices past either end)")
    # (v, b, l, d, tail): DIN's D = 18 at L = 100, L = 1, L > 32 with D
    # over one chunk, D = 1; with padding after each bag too: DIN's
    # serve_p99 widths, L = 37 and L = 1 (not multiples of the 16 rows in
    # flight), B = 1
    k5 = [(500, 64, 100, 18, False), (40, 24, 1, 32, False),
          (300, 8, 45, 130, False), (30, 10, 7, 1, False),
          (1 << 16, 4096, 100, 18, False), (10_000, 512, 100, 18, True),
          (300, 64, 37, 18, True), (50, 16, 1, 18, True),
          (100, 1, 100, 18, True)]
    n = 0
    for i, (v, b, l, d, tail) in enumerate(k5):
        for dtype in dtypes:
            table, idx = k5_case(torch, i, v, b, l, d, dtype, tail)
            for agg in ("sum", "mean"):
                same_bits(torch, "K5", embedding_bag(table, idx, agg=agg),
                          embedding_bag_ref(table, idx, agg=agg))
                n += 1
    table, idx = k5_case(torch, 98, 30, 8, 45, 18, torch.float32)
    idx[3:, 0] = 30                         # live, past the end: clamped
    for agg in ("sum", "mean"):
        same_bits(torch, "K5 clamp", embedding_bag(table, idx, agg=agg),
                  embedding_bag_ref(table, idx, agg=agg))
    print(f"[2] K5 bit-identical to the plain version on {n + 2} cases (sum, "
          f"mean; f32 and bf16; L in {sorted({c[2] for c in k5})}, D in "
          f"{sorted({c[3] for c in k5})}, B in {sorted({c[1] for c in k5})}; "
          f"all-padded bags, padding inside and after bags, a repeated row, "
          f"a live index past the end)")


def kernel_edge_cases(torch) -> None:
    from repro_torch.kernels.relax import relax as k1
    from repro_torch.kernels.relax.ref import ellpack_relax_ref
    # (n, rows, K): K = 1, 3, 4, 5, 8, 17, 32, 33, 40, 64, 128, 130; rows
    # not a multiple of the rows a block holds (3, 4,097 at K = 32); the
    # ER path's shape
    cases = [(50, 8, 1), (300, 256, 3), (700, 130, 4), (300, 256, 5),
             (5000, 4096, 8), (5000, 4096, 17), (64, 256, 32),
             (300, 3, 32), (5000, 4097, 32), (70000, 65536, 33),
             (1000, 512, 40), (900, 99, 64), (900, 70, 128),
             (900, 33, 130), (1 << 20, 1 << 20, 32)]
    taken = {"vector": {}, "scalar": {}}   # labels, in case order
    n_cases = 0

    def check(args, label):
        nonlocal n_cases
        taken[k1.variant(args[1], args[2])][label] = None
        compare(torch, "K1", k1.ellpack_relax(*args),
                ellpack_relax_ref(*args))
        n_cases += 1

    for i, (n, rows, k) in enumerate(cases):
        for ties in (False, True):
            for tail in (False, True):
                check(k1_case(torch, i, n, rows, k, ties, tail), f"K={k}")
    for i, (offset, k) in enumerate([(3, 32), (4, 32), (1, 4), (2, 36),
                                     (5, 1), (6, 2)]):
        check(k1_view(torch, k1_case(torch, 50 + i, 500, 300, k, True, True),
                      offset), f"view at cell {offset}, K={k}")
    offers, idx, w = k1_case(torch, 60, 4000, 3000, 32, False, True)
    check([offers, idx, torch.full_like(w, float("inf"))], "all +inf weights")
    check([torch.full_like(offers, float("inf")), idx, w], "all +inf offers")
    print(f"[2] K1 bit-identical to the plain version on {n_cases} cases "
          f"(K in {sorted({c[2] for c in cases})}, scattered +inf cells and "
          f"the ELL planner's row-tail padding); vector variant: "
          f"{', '.join(taken['vector'])}; scalar variant: "
          f"{', '.join(taken['scalar'])}")

    k2_cases = [
        ("ragged run groups", dict(widths=(2,) * 40, slice_rows=8, n=300,
                                   ocap=16)),
        ("mixed widths", dict(widths=(1, 1, 4, 4, 4, 2, 8), slice_rows=16,
                              n=100, ocap=8)),
        ("ties across lanes", dict(widths=(2, 2, 4, 4), slice_rows=16, n=60,
                                   ocap=32, ties=True)),
        ("inactive sources", dict(widths=(4, 32, 16, 2, 1, 8),
                                  slice_rows=256, n=1500, ocap=4096,
                                  ties=True, active_frac=0.5)),
        ("rows with no entries", dict(widths=(8, 8, 2, 32), slice_rows=64,
                                      n=200, ocap=64, dead_frac=0.5)),
        ("all sources inactive", dict(widths=(2, 4), slice_rows=32, n=64,
                                      ocap=16, active_frac=0.0)),
        ("wide hub slices", dict(widths=(32,) * 8 + (1,) * 8,
                                 slice_rows=256, n=4096, ocap=1 << 16)),
        ("a width-1 slice beside width-32 ones",
         dict(widths=(32, 32, 1, 32), slice_rows=64, n=256, ocap=64,
              ties=True, active_frac=0.8)),
        ("slices of fewer cells than a warp",
         dict(widths=(2,), slice_rows=8, n=8, ocap=4)),
        ("runs ending inside a chunk",
         dict(widths=(1,) * 5 + (4,) * 33, slice_rows=8, n=300, ocap=32)),
        ("tombstones between live cells, an all-padding slice",
         dict(widths=(8, 4, 32, 1, 8), slice_rows=64, n=320, ocap=32,
              ties=True, tombstones=True)),
        ("slices wider than a warp",
         dict(widths=(64, 2, 64, 128), slice_rows=16, n=64, ocap=16,
              ties=True, active_frac=0.7)),
    ]
    for i, (_, c) in enumerate(k2_cases):
        (dist, active), lay = k2_case(torch, i, **c)
        k2_check(torch, dist, active, lay)
        if i == 0:   # the same layout with a dead and a zero-length lane
            dead = SimpleNamespace(**{**vars(lay),
                                      "ow": torch.full_like(lay.ow, INF)})
            k2_check(torch, dist, active, dead)
            z = torch.zeros(0, dtype=torch.int32, device="cuda")
            empty = SimpleNamespace(**{**vars(lay), "osrc": z, "odst": z,
                                       "ow": z.float()})
            k2_check(torch, dist, active, empty)
        if i == 2:   # all-+inf rows: every offer +inf
            k2_check(torch, torch.full_like(dist, INF), active, lay)
    print(f"[2] K2 bit-identical to the plain version on {len(k2_cases) + 3} "
          f"cases ({', '.join(c[0] for c in k2_cases)}, a dead and a "
          f"zero-length overflow lane, all-+inf offers)")
    lane_edge_cases(torch, k2_cases)

    k3_cases = [(85, 40, {}), (300, 17, dict(ties=True, mask_frac=1.0)),
                (64, 64, dict(mask_frac=0.0)), (0, 12, {}),
                (1 << 18, 1 << 16, dict(ties=True, mask_frac=0.8)),
                (1 << 20, 1 << 20, dict(mask_frac=0.9)),
                (4096, 5000, dict(ties=True, hub=True, mask_frac=0.9)),
                (3000, 300, dict(ties=True, dup=True, mask_frac=1.0)),
                (300, 1, dict(ties=True)), (16_384, 1 << 20, {})]
    for i, (e, n, kw) in enumerate(k3_cases):
        args = k3_case(torch, i, e, n, **kw)
        k3_check(torch, args, n)
        k3_check(torch, args, n)   # again: no key of the first call leaks
    k3_graph_check(torch)
    print(f"[2] K3 bit-identical to the plain version on {len(k3_cases)} "
          f"cases, each called twice in a row (ties, an all-masked and an "
          f"empty edge list, one hub row hit by every slot, duplicate "
          f"slots, R = 1, up to E = 2^20), and in a CUDA graph replayed on "
          f"new inputs")
    k3_lane_edge_cases(torch)
    gather_edge_cases(torch)


# ------------------------------------------------------------------ phases --
def dense_ell_path(torch, ctx):
    """Phase 3: the ER stream on the dense ELL block, every wave on K1.
    Keeps the stream and its query results in ``ctx["er"]`` for the
    buckets and lanes legs."""
    from repro_torch.core.backends.ellpack import EllPlanner
    from repro_torch.kernels.relax import relax as k1
    from repro_torch.kernels.relax.ref import ellpack_relax_ref
    t0 = time.perf_counter()
    n, e, sources, log = stream(20, "er")
    source = sources[0]
    n_topo, n_dels = topo_counts(log)
    print(f"[3] ER stream: n={n} edges={e} events={len(log)} (topology "
          f"{n_topo}, dels {n_dels}) source={source}; built in "
          f"{time.perf_counter() - t0:.1f} s")
    # the host control plane alone over the legs' cut (first LEG_QUERIES
    # queries), just before the run whose wall at that query it is held
    # against
    cut = leg_cut(log)
    host_s = control_plane_seconds(
        e, cut, EllPlanner(n), lambda pl, p: pl.plan_appends(p.dst[p.fresh]))
    eng = engine(n, e, source, relax_backend="ellpack")
    marks = []
    wall, res, (launches,) = run_path(torch, eng, log, [k1.ellpack_relax],
                                      marks)
    assert launches > 0, "the dense-ELL path never launched K1"
    ctx["er"] = dict(n=n, e=e, sources=sources, log=log, results=res,
                     marks=marks, host_s=host_s)
    ell = eng.backend.state
    print(f"[3] dense-ELL path: {wall:.2f} s, {n_topo / wall:.0f} topology "
          f"events/s, {len(res)} queries, query p50 {p50_ms(res):.3f} ms, "
          f"epochs {eng.n_epochs}, waves {eng.n_rounds}, messages "
          f"{eng.n_messages}, K={ell.k} "
          f"(rows {ell.rows}, rebuilds {eng.backend.planner.rebuilds}), "
          f"K1 launches {launches}")
    q = eng.query()
    reached = snapshot_check(n, source, *eng.alloc.active_coo(), q.dist,
                             q.parent)
    print(f"[3] final snapshot passes the Dijkstra check ({reached} reached)")
    offers, nbr_idx, nbr_w = eng.state.sssp.dist, ell.nbr_idx, ell.nbr_w
    err = compare(torch, "K1", k1.ellpack_relax(offers, nbr_idx, nbr_w),
                  ellpack_relax_ref(offers, nbr_idx, nbr_w))
    times = kernel_times(
        torch, lambda: k1.ellpack_relax(offers, nbr_idx, nbr_w), 50)
    plain_ms = cuda_ms(torch, lambda: ellpack_relax_ref(offers, nbr_idx,
                                                        nbr_w), 10)
    rows, k = nbr_idx.shape
    live = int(torch.isfinite(nbr_w).sum())
    nbytes = k1.wave_bytes(offers.numel(), rows, k, live)
    bound_ms, bound_by = bound(nbytes, 2 * live)
    kind = k1.variant(nbr_idx, nbr_w)
    print(f"[3] K1 ({kind} variant) at R={rows} K={k} "
          f"N={offers.numel()} ({live} live cells): {times_text(times)} "
          f"(plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s); K1 device time on the path "
          f"~ {launches * times['device_ms'] / 1e3:.3f} s of {wall:.2f} s")
    del eng, offers, nbr_idx, nbr_w, ell, q
    cut_wall = marks[LEG_QUERIES - 1][0]
    print(f"[3] host control plane alone (allocator + ELL planner, numpy; "
          f"replayed just before the run) on the first {LEG_QUERIES} "
          f"queries' events: {host_s:.2f} s = {100 * host_s / cut_wall:.1f} "
          f"% of the run's {cut_wall:.2f} s to that query")
    dev_s, top = device_profile(torch, engine(n, e, source,
                                              relax_backend="ellpack"), cut)
    print(f"[3] device time (profiled re-run of the same events): "
          f"{dev_s:.3f} s = {100 * dev_s / cut_wall:.1f} % of "
          f"{cut_wall:.2f} s; top: " + top_ops(top))
    k1_ops = [(sec, cnt) for name, sec, cnt in top
              if "ellpack_relax_kernel" in name]
    assert k1_ops, "the profiled dense-ELL path shows no K1 kernel"
    print(f"[3] K1 device time on the path (profiled): "
          f"{sum(sec for sec, _ in k1_ops):.4f} s over "
          f"{sum(cnt for _, cnt in k1_ops)} launches")
    return {"name": "ellpack_relax", "route": "cuda",
            "source": "src/repro_torch/kernels/relax/csrc/ellpack_relax.cu",
            "replaces": "src/repro/kernels/relax/relax.py:49",
            "launches": launches, "max_abs_err": err, **times,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "check": "bit-identical",
            "variant": kind}


def hub_path(torch, ctx):
    """Phase 4: the RMAT(20) stream under auto (dense ELL, then sliced),
    every sliced wave on K2.  Keeps the stream and its query results in
    ``ctx["rmat"]``."""
    from repro_torch.graphs import csr
    from repro_torch.kernels.relax import fused as k2
    from repro_torch.kernels.relax import relax as k1
    t0 = time.perf_counter()
    n, e, sources, log = stream(20, "rmat")
    source = sources[0]
    n_topo, n_dels = topo_counts(log)
    print(f"[4] RMAT stream: n={n} edges={e} events={len(log)} (topology "
          f"{n_topo}, dels {n_dels}) source={source}; built in "
          f"{time.perf_counter() - t0:.1f} s")
    knobs = dict(relax_backend="auto")     # K2 by default on the card
    # as phase 3: the cut's control plane alone, just before the run
    cut = leg_cut(log)
    host_s = control_plane_seconds(e, cut, AutoReplayPlanner(n),
                                   lambda pl, p: pl.plan_appends(p))
    eng = engine(n, e, source, **knobs)
    marks = []
    wall, res, (l1, l2) = run_path(torch, eng, log,
                                   [k1.ellpack_relax, k2.fused_sliced_relax],
                                   marks)
    assert l2 > 0, "the hub path never launched K2"
    assert eng.backend_name == "sliced", "auto did not fall back to sliced"
    ctx["rmat"] = dict(n=n, e=e, sources=sources, log=log, results=res,
                       marks=marks)
    pl, st = eng.backend.planner, eng.backend.state
    runs = len(csr.width_runs(pl.widths))
    print(f"[4] hub path (auto -> sliced, K2): {wall:.2f} s, "
          f"{n_topo / wall:.0f} topology events/s, {len(res)} queries, query "
          f"p50 {p50_ms(res):.3f} ms, epochs {eng.n_epochs}, waves "
          f"{eng.n_rounds}, messages {eng.n_messages}, sliced rebuilds "
          f"{pl.rebuilds}, spills {pl.spills}, cells {pl.cells}, ocap "
          f"{pl.ocap}, max width {pl.max_width}, width runs {runs} (K1 "
          f"launches per unfused wave); K2 launches {l2}, K1 launches {l1}")
    q = eng.query()
    reached = snapshot_check(n, source, *eng.alloc.active_coo(), q.dist,
                             q.parent)
    print(f"[4] final snapshot passes the Dijkstra check ({reached} reached)")

    dist = eng.state.sssp.dist
    active = torch.ones_like(dist, dtype=torch.bool)   # an unmasked pull wave
    err = k2_check(torch, dist, active, st)
    run_k2 = lambda: k2.fused_sliced_relax(dist, active, st)   # noqa: E731
    times = kernel_times(torch, run_k2, 50)
    passes = per_launch_ms(torch, run_k2)
    plain_ms = cuda_ms(torch, lambda: k2_plain(dist, active, st), 3)
    before_us = k2_host_us_before(torch, run_k2, st)
    print(f"[4] K2 host time per call at the final layout ({len(st.widths)} "
          f"slices; {card_line()}): {before_us:.1f} us with the parent's "
          f"per-call layout lookup in front (an lru_cache keyed on the "
          f"widths tuple, hashed whole at every call; emulated here), "
          f"{times['host_us']:.1f} us with the table and its sizes taken "
          f"from the SlicedEllState")
    live_l = int(torch.isfinite(st.flat_w).sum())
    live_c = int(torch.isfinite(st.ow).sum())
    per_row = torch.bincount(st.odst[torch.isfinite(st.ow)].long(),
                             minlength=1)
    print(f"[4] overflow lane at the end: {live_c} live entries on "
          f"{int((per_row > 0).sum())} rows, at most {int(per_row.max())} "
          f"on one row (one atomic word each row)")
    nbytes = k2.wave_bytes(n, st.flat_w.numel(), live_l, st.ow.numel(),
                           live_c, pl.rows)
    bound_ms, bound_by = bound(nbytes, 2 * (live_l + live_c))
    tpu_bytes = k2.fused_cost(pl.widths, pl.sr, n, pl.ocap)["bytes"]
    print(f"[4] K2 at N={n} R={pl.rows} L={pl.cells} ({live_l} live) "
          f"C={pl.ocap} ({live_c} live): {times_text(times)} "
          f"(plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; the TPU kernel's per-run "
          f"model fused_cost charges {tpu_bytes / 1e9:.2f} GB); K2 device "
          f"time on the path ~ {l2 * times['device_ms'] / 1e3:.3f} s of "
          f"{wall:.2f} s; per "
          f"launch (profiled): "
          + "; ".join(f"{name.split('(')[0]} {t:.4f} ms" for name, t in passes))
    del eng, dist, active, st, q

    cut_wall = marks[LEG_QUERIES - 1][0]
    print(f"[4] host control plane alone (allocator + dense ELL planner, "
          f"then the sliced one from the blowup rebuild, numpy; replayed "
          f"just before the run) on the first {LEG_QUERIES} queries' "
          f"events: {host_s:.2f} s = {100 * host_s / cut_wall:.1f} % of the "
          f"run's {cut_wall:.2f} s to that query")
    dev_s, top = device_profile(torch, engine(n, e, source, **knobs), cut)
    print(f"[4] device time (profiled re-run of the same events): "
          f"{dev_s:.3f} s = {100 * dev_s / cut_wall:.1f} % of "
          f"{cut_wall:.2f} s; top: " + top_ops(top))
    k2_ops = [(name, sec, cnt) for name, sec, cnt in top if "k2_" in name]
    assert k2_ops, "the profiled hub path shows no K2 kernel"
    print(f"[4] K2 device time on the path (profiled): "
          f"{sum(sec for _, sec, _ in k2_ops):.4f} s ("
          + "; ".join(f"{name.split('(')[0]} {sec:.4f} s x{cnt}"
                      for name, sec, cnt in k2_ops) + ")")
    us = sync_us(torch, n)
    print(f"[4] host sync bool(frontier.any()) at N={n}: {us:.1f} us")
    return {"name": "fused_sliced_relax", "route": "cuda",
            "source":
                "src/repro_torch/kernels/relax/csrc/fused_sliced_relax.cu",
            "replaces": "src/repro/kernels/relax/fused.py:122",
            "launches": l2, "max_abs_err": err, **times,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "check": "bit-identical",
            "host_us_parent_lookup": before_us}


def k2_host_us_before(torch, run_k2, st) -> float:
    """K2's host time per call with the parent's per-call layout lookup in
    front: ``fused._layout_size`` was an ``lru_cache`` keyed on
    ``(tuple(widths), slice_rows)``, and CPython hashes a tuple whole at
    every lookup (the sliced backend made the tuple once per epoch)."""
    lookup = functools.lru_cache(maxsize=16)(lambda widths, sr: sr)
    widths = tuple(st.widths)
    return host_us(torch, lambda: (lookup(widths, st.slice_rows), run_k2()))


def hub_cross_check(torch) -> None:
    """Phase 5: four engines on the 2^16 RMAT recipe, identical at every
    query."""
    from repro_torch.graphs import csr
    from repro_torch.kernels.relax import fused as k2
    from repro_torch.kernels.relax import relax as k1
    n, e, sources, log = stream(16, "rmat")
    source = sources[0]
    runs = {}
    for name, knobs in (
            ("auto+K2", dict(relax_backend="auto")),
            ("sliced on K1", dict(relax_backend="sliced",
                                  ell_use_kernel=True, sliced_fused=False)),
            ("sliced plain", dict(relax_backend="sliced",
                                  ell_use_kernel=False, sliced_fused=False)),
            ("segment", dict(relax_backend="segment"))):
        eng = engine(n, e, source, **knobs)
        wall, res, launches = run_path(
            torch, eng, log, [k1.ellpack_relax, k2.fused_sliced_relax])
        runs[name] = (res, launches, wall, eng)
    assert runs["auto+K2"][1][1] > 0 and runs["sliced on K1"][1][0] > 0
    assert runs["sliced plain"][1] == runs["segment"][1] == [0, 0]
    want = runs["segment"][0]
    for name, (res, *_) in runs.items():
        same_results(name, res, want)
    backend = runs["sliced on K1"][3].backend
    planner, st = backend.planner, backend.state
    variants = {"vector": 0, "scalar": 0}
    off = 0
    for k, cnt in csr.width_runs(planner.widths):   # sliced_gather_min's views
        cells = planner.sr * cnt * k
        blk = slice(off, off + cells)
        variants[k1.variant(st.flat_idx[blk].view(-1, k),
                            st.flat_w[blk].view(-1, k))] += 1
        off += cells
    assert variants["vector"] and variants["scalar"], variants
    print(f"[5] n={n}: auto+K2 (K2 launches {runs['auto+K2'][1][1]}), sliced "
          f"on K1 (K1 launches {runs['sliced on K1'][1][0]}, "
          f"{len(csr.width_runs(planner.widths))} per wave at the end: "
          f"{variants['vector']} on the vector variant, "
          f"{variants['scalar']} on the scalar one), "
          f"sliced plain and segment identical at all {len(want)} queries "
          f"(stats {want[-1].epoch_stats}); wall s "
          + ", ".join(f"{k} {v[2]:.2f}" for k, v in runs.items()))


def localized_batches(n: int):
    """48 batches of 8 fresh edges, each inside a random 1k vertex window
    (benchmarks/bench_sssp.py's localized recipe, rng seed 7)."""
    from repro_torch.core import events as ev
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(48):
        ws = int(rng.integers(0, n - 1024))
        u = ws + rng.integers(0, 1024, 8)
        v = ws + rng.integers(0, 1024, 8)
        batches.append(ev.adds(u.astype(np.int64), v.astype(np.int64),
                               rng.uniform(0.5, 1.5, 8).astype(np.float32)))
    return batches   # one log each: ingest_log runs each as its own epoch


def sparse_path(torch, ctx):
    """Phase 6a: the localized stream at 2^20, sparse on K3 against dense
    segment.  The inputs of the last K3 call of each edge-list length are
    kept for the kernel comparison at the path's own shapes; the sparse
    run's queries and rate, and the base graph, go to ``ctx["sparse"]``
    for leg 6c."""
    import repro_torch
    from repro_torch.core import events as ev
    from repro_torch.core import frontier as frontier_mod
    from repro_torch.graphs import generators
    from repro_torch.kernels.relax import gather as k3
    from repro_torch.kernels.relax.ref import gathered_rows_relax_ref
    t0 = time.perf_counter()
    n, bs, bd, bw = generators.rmat(20, 4, seed=11)
    base = ev.adds(bs, bd, bw)
    batches = localized_batches(n)
    cap = len(bs) + 8 * 48 + 64
    print(f"[6] localized stream: n={n}, base {len(bs)} edges (rmat(20, 4, "
          f"seed=11)), then 48 batches of 8 edges; built in "
          f"{time.perf_counter() - t0:.1f} s")
    shapes = {}
    real = frontier_mod.gathered_rows_relax

    def recording(*args, **kw):
        shapes[args[0].shape[0]] = (args, kw)
        return real(*args, **kw)

    runs = {}
    for mode, knobs in (("dense", {}), ("sparse", dict(
            frontier_mode="sparse"))):              # K3 by default
        eng = repro_torch.make_engine(num_vertices=n, edge_capacity=cap,
                                      source=0, **knobs)
        eng.ingest_log(base)                       # untimed base build
        q0 = eng.query()
        r0 = eng.n_rounds
        frontier_mod.gathered_rows_relax = recording
        try:
            wall, _, (l3,) = run_path(torch, eng, batches,
                                      [k3.gathered_rows_relax])
        finally:
            frontier_mod.gathered_rows_relax = real
        runs[mode] = ([q0, eng.query()], wall, l3, eng.n_rounds - r0)
        del eng
    (dense, d_wall, d_l3, d_waves) = runs["dense"]
    (sparse, s_wall, l3, s_waves) = runs["sparse"]
    assert d_l3 == 0 and l3 > 0, "the sparse path never launched K3"
    same_results("sparse vs dense", sparse, dense)
    ctx["sparse"] = dict(results=sparse, events_per_s=384 / s_wall,
                         graph=(n, bs, bd, bw))
    us = sync_us(torch, n)
    print(f"[6] sparse + K3 identical to dense segment (dist, parent, "
          f"rounds, messages; stats {sparse[-1].epoch_stats}): dense "
          f"{384 / d_wall:.0f} events/s ({d_waves} waves x 1 host sync), "
          f"sparse {384 / s_wall:.0f} events/s ({s_waves} waves x 2 host "
          f"syncs: the frontier read and the ladder's one read of three "
          f"counts; {us:.1f} us each); K3 launches {l3}")

    for e, (args, kw) in sorted(shapes.items()):
        err = k3_check(torch, args, kw["num_rows"])
    e, (args, kw) = max(shapes.items())
    times = kernel_times(torch, lambda: k3.gathered_rows_relax(*args, **kw),
                         200)
    plain_ms = cuda_ms(torch, lambda: gathered_rows_relax_ref(*args, **kw),
                       20)
    live = int(args[4].sum())
    nbytes = k3.wave_bytes(e, live, kw["num_rows"])
    bound_ms, bound_by = bound(nbytes, 2 * live)
    print(f"[6] K3 bit-identical to its plain version at the path's edge "
          f"list lengths {sorted(shapes)}; at E={e} ({live} masked in) "
          f"R={kw['num_rows']}: {times_text(times)} (plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms = {nbytes / 1e6:.2f} MB at 3.35 "
          f"TB/s)")
    return {"name": "gathered_rows_relax", "route": "cuda",
            "source":
                "src/repro_torch/kernels/relax/csrc/gathered_rows_relax.cu",
            "replaces": "src/repro/kernels/relax/gather.py:92",
            "launches": l3, "max_abs_err": err, **times,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "check": "bit-identical"}


def sparse_cross_check(torch) -> None:
    """Phase 6b: the 2^16 RMAT sliding-window stream (ADD and DEL epochs)
    sparse on K3 against sparse on the plain version."""
    from repro_torch.kernels.relax import gather as k3
    n, e, sources, log = stream(16, "rmat")
    source = sources[0]
    runs = []
    for kernel in (True, False):
        eng = engine(n, e, source, frontier_mode="sparse",
                     frontier_kernel=kernel)
        runs.append(run_path(torch, eng, log, [k3.gathered_rows_relax]))
    (k_wall, got, (l3,)), (p_wall, want, (plain,)) = runs
    assert l3 > 0 and plain == 0, (l3, plain)
    same_results("sparse K3 vs plain", got, want)
    print(f"[6] n={n} sliding window: sparse on K3 (launches {l3}, "
          f"{k_wall:.2f} s) and on the plain version ({p_wall:.2f} s) "
          f"identical at all {len(got)} queries (stats "
          f"{got[-1].epoch_stats})")


READ_METHODS = ("cpu", "to", "item", "tolist", "numpy", "__bool__",
                "__int__", "__float__", "__index__", "__array__")


class HostReads:
    """Counts device-to-host reads of CUDA tensors (the READ_METHODS whose
    result leaves the card) while active, except inside ``eng.query``,
    whose readback is the answer and not a wave's."""

    def __init__(self, torch, eng):
        self.torch, self.eng, self.reads = torch, eng, 0
        self._query = [False]

    def __enter__(self):
        torch = self.torch
        self._saved = {m: getattr(torch.Tensor, m) for m in READ_METHODS}
        for meth, real in self._saved.items():
            def counted(t, *a, _real=real, **k):
                out = _real(t, *a, **k)
                if (not self._query[0] and t.is_cuda
                        and not (isinstance(out, torch.Tensor)
                                 and out.is_cuda)):
                    self.reads += 1
                return out
            setattr(torch.Tensor, meth, counted)
        real_query = self.eng.query

        def query(*a, **k):
            self._query[0] = True
            try:
                return real_query(*a, **k)
            finally:
                self._query[0] = False
        self.eng.query = query
        return self

    def __exit__(self, *exc):
        for meth, real in self._saved.items():
            setattr(self.torch.Tensor, meth, real)
        del self.eng.query
        return False


def sparse_lanes_path(torch, ctx) -> dict:
    """Phase 6c: phase 6a's localized stream at 2^20 with ``sources=`` 4
    lanes (vertex 0, phase 6a's source, and the three other vertices of
    highest in-degree in the base graph), sparse with no kernel flag: K3's
    lane form, never the single-lane kernel (both counts set to 0 just
    before the batches and read just after).  A query after each batch;
    every lane equal to a dense segment engine with the same sources at
    every query, lane 0 to phase 6a's run at both of its queries (after the
    base, after the 48th batch), every lane through Dijkstra at the end.
    Host reads per wave, source-events/s, and K3's lane form timed at the
    leg's largest edge list beside S single-lane calls, its bound and its
    lane plain version.  Returns K3's ``lanes`` record."""
    import repro_torch
    from repro_torch.core import events as ev
    from repro_torch.core import frontier as frontier_mod
    from repro_torch.graphs import generators
    from repro_torch.kernels.relax import gather as k3
    from repro_torch.kernels.relax.ref import gathered_rows_relax_lanes_ref
    t0 = time.perf_counter()
    n, bs, bd, bw = ctx["sparse"]["graph"]
    top = [int(v) for v in generators.top_in_degree_sources(n, bd, LANES)]
    sources = (0, *[v for v in top if v != 0][:LANES - 1])
    base = ev.adds(bs, bd, bw)
    batches = localized_batches(n)
    log = ev.EventLog.concatenate(
        [x for b in batches for x in (b, ev.query_marker())])
    cap = len(bs) + 8 * 48 + 64
    shapes = {}
    real = frontier_mod.gathered_rows_relax_lanes

    def recording(*args, **kw):
        shapes[args[0].shape[1]] = (args, kw)
        return real(*args, **kw)

    waves = [0]
    real_wave = frontier_mod.ladder_wave

    def counted_wave(*a, **k):
        waves[0] += 1
        return real_wave(*a, **k)

    runs = {}
    for mode, knobs in (("dense", {}), ("sparse", dict(
            frontier_mode="sparse"))):             # K3's lane form
        eng = repro_torch.make_engine(num_vertices=n, edge_capacity=cap,
                                      source=0, sources=sources, **knobs)
        eng.ingest_log(base)                       # untimed base build
        q0 = eng.query()
        fn = k3.gathered_rows_relax
        fn.launches = fn.lane_launches = 0
        waves[0] = 0
        frontier_mod.gathered_rows_relax_lanes = recording
        frontier_mod.ladder_wave = counted_wave
        try:
            with HostReads(torch, eng) as reads:
                t1 = time.perf_counter()
                res = eng.ingest_log(log)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
        finally:
            frontier_mod.gathered_rows_relax_lanes = real
            frontier_mod.ladder_wave = real_wave
        ingest_s = wall - sum(r.latency_s for r in res)
        runs[mode] = dict(results=[q0, *res], wall=wall, ingest_s=ingest_s,
                          launches=(fn.launches, fn.lane_launches),
                          reads=reads.reads, waves=waves[0])
    dense, sparse = runs["dense"], runs["sparse"]
    single, lanes_l = sparse["launches"]
    assert lanes_l > 0 and single == 0, \
        f"[6c] K3 launches {single} single-lane, {lanes_l} lane form"
    assert dense["launches"] == (0, 0) and dense["waves"] == 0
    lane_results_equal("[6c] sparse lanes vs dense lanes",
                       sparse["results"], dense["results"])
    want = ctx["sparse"]["results"]
    for i, (a, b) in enumerate(zip((sparse["results"][0],
                                    sparse["results"][-1]), want,
                                   strict=True)):
        assert np.array_equal(a.dist[0], b.dist) and np.array_equal(
            a.parent[0], b.parent), f"[6c] lane 0 vs phase 6a at query {i}"
        for key in ("rounds", "messages"):
            assert a.epoch_stats[key][0] == b.epoch_stats[key], \
                f"[6c] lane 0's {key} differ from phase 6a at query {i}"
    q = sparse["results"][-1]
    coo = eng.alloc.active_coo()
    reached = snapshot_check(n, sources, *coo, q.dist, q.parent)
    n_topo = 8 * len(batches)
    rate = LANES * n_topo / sparse["ingest_s"]
    rate6a = ctx["sparse"]["events_per_s"]
    per_wave = sparse["reads"] / sparse["waves"]
    print(f"[6c] localized stream with {LANES} lanes (sources {sources}), "
          f"sparse on K3's lane form: {len(sparse['results'])} queries "
          f"bit-identical to dense segment lanes (dist, parent, per-lane "
          f"rounds and messages), lane 0 to phase 6a's run at both of its "
          f"queries; every lane passes Dijkstra (reached {reached}); "
          f"{sparse['waves']} ladder waves, {sparse['reads']} host reads "
          f"outside the queries = {per_wave:.3f} a wave ({len(batches)} "
          f"epochs, one flag read more each); {rate:.0f} source-events/s "
          f"(S x topology events / ingest wall, queries excluded; 4 x phase "
          f"6a's sparse rate = {LANES * rate6a:.0f}; printed, not held); "
          f"dense lanes {LANES * n_topo / dense['ingest_s']:.0f}; K3 "
          f"launches: lane form {lanes_l}, single-lane {single}")

    for e, (args, kw) in sorted(shapes.items()):
        err = k3_lanes_check(torch, args, kw["num_rows"])
    e, (args, kw) = max(shapes.items())
    r = kw["num_rows"]
    times = kernel_times(
        torch, lambda: k3.gathered_rows_relax_lanes(*args, **kw), 200)
    singles = lambda: [k3.gathered_rows_relax(  # noqa: E731
        *(a[t] for a in args), **kw) for t in range(LANES)]
    singles_ms = device_ms(torch, singles)
    singles_us = host_us(torch, singles)
    plain_ms = cuda_ms(
        torch, lambda: gathered_rows_relax_lanes_ref(*args, **kw), 20)
    live = int(args[4].sum())
    nbytes = k3.wave_bytes(e, live, r, lanes=LANES)
    bound_ms, bound_by = bound(nbytes, 2 * live)
    share = bound_ms / times["device_ms"]
    print(f"[6c] K3 lane form bit-identical to its lane plain version and "
          f"to S single-lane calls at the leg's edge-list lengths "
          f"{sorted(shapes)}; at S={LANES} E={e} ({live} masked in) R={r}: "
          f"{times_text(times)}; S single-lane calls on the same lanes "
          f"{singles_ms:.4f} ms device, {singles_us:.1f} us host (ratio "
          f"{times['device_ms'] / singles_ms:.3f}); bound {bound_ms:.4f} ms "
          f"= {nbytes / 1e6:.2f} MB at 3.35 TB/s, {100 * share:.1f} % of "
          f"it; the lane plain version {plain_ms:.4f} ms; phase 6c in "
          f"{time.perf_counter() - t0:.1f} s")
    del runs, sparse, dense, eng, q
    return {"lanes": LANES, "launches": lanes_l, "single_launches": single,
            "max_abs_err": err, **times, "single_lanes_device_ms": singles_ms,
            "single_lanes_host_us": singles_us,
            "ratio_to_single_lanes": times["device_ms"] / singles_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": share, "reads_per_wave": per_wave,
            "source_events_per_s": rate,
            "shape": {"edges": e, "masked_in": live, "rows": r}}


# ------------------------------ phases 8-10: buckets and batched lanes --
LEGS = (("er", "ER dense-ELL (K1)", dict(relax_backend="ellpack")),
        ("rmat", "RMAT(20) auto (K2)", dict(relax_backend="auto")))
# phases 8 and 9 (and the replays of phases 3 and 4) run each
# 2^20 stream up to and including its 21st of 41 QUERY markers (about half
# the events: the window's fill and 11 sliding steps, deletions among
# them), to stay in the time limit
LEG_QUERIES = 21


def leg_cut(log):
    """The legs' cut of a phase 3/4 stream: the log up to and including its
    LEG_QUERIES-th QUERY marker."""
    end = int(np.nonzero(np.asarray(log.kind) == 2)[0][LEG_QUERIES - 1]) + 1
    return log[:end]


def leg_stream(c) -> tuple:
    """The legs' cut of a phase 3/4 stream, that run's results up to it,
    and the rounds run's (wall s, waves) at its last marker."""
    return (leg_cut(c["log"]), c["results"][:LEG_QUERIES],
            c["marks"][LEG_QUERIES - 1])


def buckets_legs(torch, ctx) -> None:
    """Phase 8: the 2^20 streams of phases 3 and 4 under
    ``wave_schedule="buckets"`` (bucket_width 1.0): ER on the dense ELL
    block (K1 by default), RMAT(20) under auto (K2 by default).  ``dist``
    equals the rounds run's at every query; the final snapshot passes
    Dijkstra."""
    from repro_torch.kernels.relax import fused as k2
    from repro_torch.kernels.relax import relax as k1
    for key, label, knobs in LEGS:
        c = ctx[key]
        n, source = c["n"], c["sources"][0]
        log, want, (r_wall, r_waves) = leg_stream(c)
        n_topo = topo_counts(log)[0]
        eng = engine(n, c["e"], source, wave_schedule="buckets",
                     bucket_width=1.0, **knobs)
        wall, res, (l1, l2) = run_path(
            torch, eng, log, [k1.ellpack_relax, k2.fused_sliced_relax])
        assert (l1 if key == "er" else l2) > 0, f"[8] {label}: no launch"
        assert len(res) == len(want)
        parents = 0
        for i, (a, b) in enumerate(zip(res, want)):
            assert np.array_equal(a.dist, b.dist), \
                f"[8] {label}: dist differs from the rounds run at query {i}"
            parents += int(np.array_equal(a.parent, b.parent))
        q = eng.query()
        reached = snapshot_check(n, source, *eng.alloc.active_coo(), q.dist,
                                 q.parent)
        print(f"[8] {label} under buckets (width 1.0), its first "
              f"{len(log)} events ({n_topo} topology, {len(res)} queries): "
              f"{wall:.2f} s, {n_topo / wall:.0f} topology events/s (rounds "
              f"to the same query: {r_wall:.2f} s, {n_topo / r_wall:.0f}), "
              f"waves {eng.n_rounds} (rounds {r_waves}), K1 launches {l1}, "
              f"K2 launches {l2}; dist "
              f"bit-identical to the rounds run at all {len(res)} queries "
              f"(parent too at {parents}); final snapshot passes Dijkstra "
              f"({reached} reached)")
        c["buckets"] = res     # phase 12's RMAT leg is held against it
        del eng, res, q


def lane_times(torch, name, fn, lane_args, single_args, plain_fn, nbytes,
               ops, launches, interleave) -> dict:
    """A lane form at its path's final shape: checked against its lane
    plain version (``plain_fn()``, timed once after a warm call: seconds a
    call for K2's) and S single-lane calls, timed three ways beside the
    single-lane call's device time (the ratio to S of them), with its
    bound (the share); ``interleave()``, its lane-minor copy (inside the
    lane form's time), timed apart."""
    lanes = lane_args[0].shape[0]
    plain = plain_fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    plain_fn()
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = lanes_check(torch, name, fn, lane_args, single_args, plain)
    times = kernel_times(torch, lambda: fn(*lane_args), 20)
    one_ms = device_ms(torch, lambda: fn(*single_args(0)))
    inter_ms = device_ms(torch, interleave)
    bound_ms, bound_by = bound(nbytes, ops)
    ratio = times["device_ms"] / (lanes * one_ms)
    share = bound_ms / times["device_ms"]
    print(f"[9] {name} lane form at S={lanes}: {times_text(times)}; one "
          f"lane alone {one_ms:.4f} ms device (x S = {lanes * one_ms:.4f}; "
          f"ratio {ratio:.3f} of S single-lane calls); lane-minor "
          f"interleave alone {inter_ms:.4f} ms device (inside the lane "
          f"form's time); bound {bound_ms:.4f} ms = {nbytes / 1e6:.1f} MB "
          f"at 3.35 TB/s (the layout once, the per-lane vectors S times), "
          f"{100 * share:.1f} % of it; the lane plain version "
          f"{plain_ms:.4f} ms; lane-form launches on the path {launches}")
    return {"lanes": lanes, "launches": launches, "max_abs_err": err,
            **times, "single_lane_device_ms": one_ms,
            "ratio_to_single_lanes": ratio, "interleave_device_ms": inter_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": share}


def lanes_legs(torch, ctx) -> tuple[dict, dict]:
    """Phase 9: the 2^20 streams of phases 3 and 4 with ``sources=`` the
    LANES vertices of highest in-degree: ER on the dense ELL block (K1's
    lane form), RMAT(20) under auto (K2's lane form).  Lane 0 serves phase
    3's / 4's source and equals that run at every query; every lane passes
    Dijkstra at the final query.  Returns the ``lanes`` records of K1 and
    K2 (the lane form timed at its path's final shape)."""
    from repro_torch.kernels.relax import fused as k2
    from repro_torch.kernels.relax import relax as k1
    from repro_torch.kernels.relax.ref import ellpack_relax_ref
    records = []
    for (key, label, knobs), kernel in zip(LEGS, (k1.ellpack_relax,
                                                  k2.fused_sliced_relax)):
        c = ctx[key]
        n, sources = c["n"], tuple(c["sources"])
        log, want, (r_wall, _) = leg_stream(c)
        n_topo = topo_counts(log)[0]
        eng = engine(n, c["e"], sources[0], sources=sources, **knobs)
        for fn in (k1.ellpack_relax, k2.fused_sliced_relax):
            fn.launches = fn.lane_launches = 0
        k1.lane_minor.launches = 0
        t0 = time.perf_counter()
        res = eng.ingest_log(log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lane_launches = kernel.lane_launches
        interleaves = k1.lane_minor.launches
        assert lane_launches > 0 and kernel.launches == lane_launches, \
            f"[9] {label}: {kernel.launches} launches, {lane_launches} lane"
        assert len(res) == len(want)
        for i, (a, b) in enumerate(zip(res, want)):
            assert np.array_equal(a.dist[0], b.dist) and np.array_equal(
                a.parent[0], b.parent), \
                f"[9] {label}: lane 0 differs from the single run at query {i}"
        q = eng.query()
        coo = eng.alloc.active_coo()
        reached = snapshot_check(n, sources, *coo, q.dist, q.parent)
        print(f"[9] {label} with {len(sources)} lanes (sources {sources}), "
              f"its first {len(log)} events ({n_topo} topology): {wall:.2f} "
              f"s, {len(sources) * n_topo / wall:.0f} source-events/s (S x "
              f"topology events / wall; one source to the same query: "
              f"{n_topo / r_wall:.0f} in {r_wall:.2f} s), waves "
              f"per lane {eng.n_rounds.tolist()}, lane-form launches "
              f"{lane_launches} (K1's lane-minor interleaves apart from "
              f"K2's own: {interleaves}); lane 0 bit-identical to the "
              f"single-source "
              f"run at all {len(res)} queries; every lane passes Dijkstra "
              f"(reached {reached})")
        if key == "er":   # phase 14's sharded lanes are held against them
            c["lanes"] = dict(results=res, wall=wall, n_topo=n_topo)
        del res, q
        dist = eng.state.sssp.dist
        if key == "er":
            ell = eng.backend.state
            idx, w = ell.nbr_idx, ell.nbr_w
            live = int(torch.isfinite(w).sum())
            records.append(lane_times(
                torch, "K1", k1.ellpack_relax, (dist, idx, w),
                lambda t: (dist[t], idx, w),
                lambda: ellpack_relax_ref(dist, idx, w),
                k1.wave_bytes(n, idx.shape[0], idx.shape[1], live,
                              lanes=len(sources)),
                2 * live * len(sources), lane_launches,
                lambda: k1.lane_minor(dist)))
        else:
            st = eng.backend.state
            act = torch.ones_like(dist, dtype=torch.bool)
            live_l = int(torch.isfinite(st.flat_w).sum())
            live_c = int(torch.isfinite(st.ow).sum())
            records.append(lane_times(
                torch, "K2", k2.fused_sliced_relax, (dist, act, st),
                lambda t: (dist[t], act[t], st),
                lambda: k2_plain(dist, act, st),
                k2.wave_bytes(n, st.flat_w.numel(), live_l, st.ow.numel(),
                              live_c, st.table.rows, lanes=len(sources)),
                2 * (live_l + live_c) * len(sources), lane_launches,
                lambda: k1.lane_minor(dist, act)))
        del eng, dist
    return records[0], records[1]


LANE_CHECK_FRACTION = 4   # phase 10 runs the first quarter of the events


def lanes_cross_check(torch) -> None:
    """Phase 10: LANES lanes at 2^16 on the ER recipe (its first quarter of
    events) on segment, ellpack (K1's lane form), sliced unfused (K1's
    lane form once per width run), auto (K2's lane form) and the sparse
    frontier (K3's lane form), under rounds and buckets: every lane equals
    a single-source segment engine of its source at every query, its round
    and message counts too.  Then a bucketed sparse engine's drains
    (``sparse_drain``) on K3 against the same on the plain version, one
    source and then the lanes (K3's lane form).  Returns the lane form's
    launches in this phase."""
    from repro_torch.kernels.relax import fused as k2
    from repro_torch.kernels.relax import gather as k3
    from repro_torch.kernels.relax import relax as k1
    t0 = time.perf_counter()
    n, e, sources, log = stream(16, "er")
    log = log[:len(log) // LANE_CHECK_FRACTION]
    kernels = (k1.ellpack_relax, k2.fused_sliced_relax, k3.gathered_rows_relax)
    engines = (("segment", dict(relax_backend="segment"), None),
               ("ellpack on K1 lanes", dict(relax_backend="ellpack"), 0),
               ("sliced on K1 lanes per width run",
                dict(relax_backend="sliced", ell_use_kernel=True,
                     sliced_fused=False), 0),
               ("auto on K2 lanes", dict(relax_backend="auto"), 1),
               ("sparse on K3's lane form",
                dict(relax_backend="segment", frontier_mode="sparse"), 2))
    k3_lane_launches = 0
    for sched in (dict(), dict(wave_schedule="buckets", bucket_width=1.0)):
        singles = [engine(n, e, s, **sched).ingest_log(log) for s in sources]
        counts = []
        for name, knobs, which in engines:
            for fn in kernels:
                fn.launches, fn.lane_launches = 0, 0
            eng = engine(n, e, sources[0], sources=tuple(sources), **knobs,
                         **sched)
            res = eng.ingest_log(log)
            torch.cuda.synchronize()
            launched = [fn.lane_launches for fn in kernels]
            if which is None:
                assert sum(fn.launches for fn in kernels) == 0, name
                assert sum(launched) == 0, name
            else:
                assert launched[which] > 0, f"[10] {name}: {launched}"
            if which == 2:
                assert k3.gathered_rows_relax.launches == 0, \
                    f"[10] {name}: the single-lane K3 launched"
                k3_lane_launches += launched[2]
            for i, want in enumerate(singles):
                for q, (a, b) in enumerate(zip(res, want)):
                    ok = (np.array_equal(a.dist[i], b.dist)
                          and np.array_equal(a.parent[i], b.parent)
                          and a.epoch_stats["rounds"][i]
                          == b.epoch_stats["rounds"]
                          and a.epoch_stats["messages"][i]
                          == b.epoch_stats["messages"])
                    assert ok, f"[10] {name} {sched}: lane {i} query {q}"
            counts.append(f"{name} {0 if which is None else launched[which]}")
        print(f"[10] n={n}, {len(log)} events, {len(sources)} lanes, "
              f"{sched.get('wave_schedule', 'rounds')}: every lane equals "
              f"its single-source engine at all {len(singles[0])} queries "
              f"(counters too) on " + "; ".join(counts) + " launches")
    runs = []
    for kernel in (True, False):
        eng = engine(n, e, sources[0], frontier_mode="sparse",
                     frontier_kernel=kernel, wave_schedule="buckets",
                     bucket_width=1.0)
        runs.append(run_path(torch, eng, log, [k3.gathered_rows_relax]))
    (_, got, (l3,)), (_, want, (plain,)) = runs
    assert l3 > 0 and plain == 0, (l3, plain)
    same_results("sparse_drain K3 vs plain", got, want)
    fn = k3.gathered_rows_relax
    runs = []
    for kernel in (True, False):
        fn.launches = fn.lane_launches = 0
        eng = engine(n, e, sources[0], sources=tuple(sources),
                     frontier_mode="sparse", frontier_kernel=kernel,
                     wave_schedule="buckets", bucket_width=1.0)
        res = eng.ingest_log(log)
        torch.cuda.synchronize()
        runs.append((res, fn.launches, fn.lane_launches))
    (got_l, single, lanes_l), (want_l, p_single, p_lanes) = runs
    assert lanes_l > 0 and single == 0 and p_single == p_lanes == 0, runs[0][1:]
    lane_results_equal("[10] batched sparse_drain K3 lanes vs plain",
                       got_l, want_l)
    k3_lane_launches += lanes_l
    print(f"[10] sparse_drain on K3 (launches {l3}) identical to the plain "
          f"version at all {len(got)} queries; on {len(sources)} lanes "
          f"(sparse_drain on [S, N], K3's lane form: {lanes_l} launches, "
          f"the single-lane K3 none) identical to the plain version at all "
          f"{len(got_l)} queries (dist, parent, per-lane rounds and "
          f"messages); phase 10 in {time.perf_counter() - t0:.1f} s")
    return k3_lane_launches


# --------------------- phase 12: the serving path with observability --
def same_answers(label, got, want, *, stats=True) -> None:
    """Replay answers (dist, parent, epoch stats) against a phase's query
    results, query by query."""
    assert len(got) == len(want), f"{label}: {len(got)} vs {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a.dist, b.dist), f"{label}: dist at query {i}"
        if stats:
            assert np.array_equal(a.parent, b.parent) and \
                a.epoch_stats["rounds"] == b.epoch_stats["rounds"] and \
                a.epoch_stats["messages"] == b.epoch_stats["messages"], \
                f"{label}: parent or counters at query {i}"


def snapshot_views(torch, eng, tmp: Path) -> tuple[dict, float]:
    """An instrumented engine's ``metrics_snapshot`` (timed) and the checks
    that its views agree: rounds and messages with the engine's, span
    counts (Chrome trace written and read back) with the epoch and rebuild
    counters, every histogram total with the counter it shadows, the
    Prometheus text round trip."""
    from repro_torch.obs import load_chrome_trace, span_counts_of
    from repro_torch.obs.export import parse_prometheus_text, prometheus_text
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = eng.metrics_snapshot()
    snap_s = time.perf_counter() - t0
    ct, h = snap["counters"], snap["histograms"]
    assert snap["rounds"] == eng.n_rounds
    assert snap["messages"] == eng.n_messages
    path = tmp / "spans.chrome.json"
    eng.obs.tracer.save_chrome(str(path))
    spans = span_counts_of(load_chrome_trace(str(path)))
    assert spans == snap["spans"]
    for kind, plural in (("add_epoch", "add_epochs"),
                         ("del_epoch", "del_epochs"), ("query", "queries"),
                         ("drain", "drains"), ("rebuild", "rebuilds")):
        assert spans.get(kind, 0) == ct.get(plural, 0), (kind, spans, ct)
    assert h["latency_us"]["count"] == ct["queries"]
    assert h["frontier_occupancy"]["count"] == ct["add_epochs"]
    dels = ct.get("del_epochs", 0)
    epochs = (dels + ct["drains"] if "drains" in ct
              else ct["add_epochs"] + dels)
    assert h["waves_per_epoch"]["count"] == epochs
    assert h["messages_per_epoch"]["count"] == epochs
    for kind, plural in (("add_epoch", "add_epochs"),
                         ("del_epoch", "del_epochs"), ("query", "queries")):
        assert h.get(f"{kind}_wall_us", {"count": 0})["count"] == \
            ct.get(plural, 0)
    parsed = parse_prometheus_text(prometheus_text(snap))
    for name, value in ct.items():
        if np.ndim(value) == 0:
            assert parsed[f"repro_{name}"][()] == float(value), name
    assert parsed["repro_hist_latency_us_count"][()] == ct["queries"]
    return snap, snap_s


def serving_legs(torch, ctx) -> dict:
    """Phase 12: the serving path (``replay_trace``) with observability on,
    over the cuts of phases 8-9 (``leg_stream``) and phase 6's localized
    stream.  Returns each of K1-K3's launches in its leg."""
    import tempfile

    import repro_torch
    from repro_torch.core import buckets as buckets_mod
    from repro_torch.core import events as ev
    from repro_torch.core import frontier as frontier_mod
    from repro_torch.graphs import generators
    from repro_torch.kernels.relax import fused as k2
    from repro_torch.kernels.relax import gather as k3
    from repro_torch.kernels.relax import relax as k1
    from repro_torch.obs import WatchdogConfig
    from repro_torch.serving import ServingTrace, open_trace, replay_trace
    t_phase = time.perf_counter()
    kernels = (k1.ellpack_relax, k2.fused_sliced_relax,
               k3.gathered_rows_relax)

    def replay(eng, trace, label):
        """Launch counts reset, the replay, its answers and launches."""
        for fn in kernels:
            fn.launches = 0
        seen = []
        rep = replay_trace(eng, trace, on_query=seen.append)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in kernels]
        print(f"[12] {label}: {rep.events_per_s:.0f} topology events/s "
              f"({rep.topology_events} in {rep.wall_s:.2f} s), "
              f"{rep.queries} queries; K1/K2/K3 launches {counts}")
        return rep, seen, counts

    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- ER on K1: obs on (watchdog armed) from memory, then obs off
        # from a chunked v2 file
        c = ctx["er"]
        n, e, source = c["n"], c["e"], c["sources"][0]
        log, want, _ = leg_stream(c)
        trace = ServingTrace.from_log(log)
        eng = engine(n, e, source, relax_backend="ellpack",
                     observability=True, obs_watchdog=WatchdogConfig())
        on, seen, counts = replay(eng, trace, "ER dense-ELL (K1), obs on")
        assert counts[0] > 0, "[12] the ER leg never launched K1"
        same_answers("[12] ER obs on", seen, want)
        served["ellpack_relax"] = counts[0]
        eng.obs.watchdog.stop()
        assert eng.obs.watchdog.warnings == 0, \
            "[12] the watchdog spoke on a healthy run"
        snap, snap_s = snapshot_views(torch, eng, tmp)
        assert "watchdog_warnings" not in snap["counters"]
        cw = on.cold_warm
        print(f"[12] ER ServingReport (obs on, equal to phase 3's run at "
              f"all {on.queries} queries in dist, parent, rounds and "
              f"messages): latency p50/p95/p99 "
              f"{on.latency_s['p50'] * 1e3:.3f}/"
              f"{on.latency_s['p95'] * 1e3:.3f}/"
              f"{on.latency_s['p99'] * 1e3:.3f} ms, churn mean "
              f"{on.churn_mean['any']:.6f} (dist {on.churn_mean['dist']:.6f},"
              f" parent {on.churn_mean['parent']:.6f}), cold/warm "
              f"{int(cw['cold_queries'])}/{int(cw['warm_queries'])} (cold p50"
              f" {cw['cold_p50_ms']:.3f} ms, warm p50/p99 "
              f"{cw['warm_p50_ms']:.3f}/{cw['warm_p99_ms']:.3f} ms); "
              f"metrics_snapshot {snap_s * 1e3:.3f} ms; spans "
              f"{snap['spans']}; watchdog silent")
        del eng, on, snap, seen
        path = tmp / "er.trace"
        t0 = time.perf_counter()
        trace.save(str(path), chunk_events=1 << 20)   # ChunkedTraceWriter
        write_s = time.perf_counter() - t0
        eng = engine(n, e, source, relax_backend="ellpack")
        with open_trace(str(path)) as reader:
            chunks = reader.n_chunks
            _, seen, counts = replay(eng, reader, f"ER from the v2 file "
                                     f"({chunks} chunks of 2^20 events), "
                                     f"obs off")
        assert counts[0] > 0, "[12] the v2 file's replay never launched K1"
        same_answers("[12] ER v2 file", seen, want, stats=False)
        q = seen[-1]
        reached = snapshot_check(n, source, *eng.alloc.active_coo(), q.dist,
                                 q.parent)
        print(f"[12] v2 file: written in {write_s:.2f} s "
              f"({path.stat().st_size / 1e6:.1f} MB), replayed through "
              f"open_trace: dist equal to phase 3's at all {len(seen)} "
              f"queries, its final snapshot passes Dijkstra ({reached} "
              f"reached)")
        del eng, seen, trace, q

        # ---- RMAT(20) on K2: auto, buckets, obs on
        c = ctx["rmat"]
        n, e, source = c["n"], c["e"], c["sources"][0]
        log = leg_stream(c)[0]
        waves = []
        real_drain = buckets_mod.run_drain

        def counted_drain(*a, **k):
            out = real_drain(*a, **k)
            waves.append(int(np.sum(out[2].rounds)))
            return out

        buckets_mod.run_drain = counted_drain
        try:
            eng = engine(n, e, source, relax_backend="auto",
                         wave_schedule="buckets", bucket_width=1.0,
                         observability=True)
            rep, seen, counts = replay(eng, ServingTrace.from_log(log),
                                       "RMAT(20) auto (K2), buckets, obs on")
        finally:
            buckets_mod.run_drain = real_drain
        assert counts[1] > 0, "[12] the RMAT leg never launched K2"
        served["fused_sliced_relax"] = counts[1]
        same_answers("[12] RMAT buckets", seen, c["buckets"])
        snap, snap_s = snapshot_views(torch, eng, tmp)
        ct = snap["counters"]
        assert ct["pending_push"] > 0 and ct["pending_pull"] > 0, ct
        assert ct["drain_waves"] == sum(waves) > 0, (ct["drain_waves"],
                                                      sum(waves))
        print(f"[12] RMAT: dist, parent and counters equal to phase 8's "
              f"buckets run at all {len(seen)} queries; pending at drain "
              f"entry push {ct['pending_push']} / pull {ct['pending_pull']},"
              f" drain_waves {ct['drain_waves']} = the {len(waves)} drains' "
              f"waves; rebuilds {ct.get('rebuilds', 0)}, overflow hits "
              f"{ct.get('overflow_hits', 0)}; latency p50/p99 "
              f"{rep.latency_s['p50'] * 1e3:.3f}/"
              f"{rep.latency_s['p99'] * 1e3:.3f} ms; metrics_snapshot "
              f"{snap_s * 1e3:.3f} ms")
        del eng, seen, snap

        # ---- the sparse leg on K3: phase 6's localized stream, obs off
        # then on; 96 epochs in about a second, so a per-epoch cost of the
        # hooks shows here where the ER leg's 33 epochs would hide it
        n, bs, bd, bw = generators.rmat(20, 4, seed=11)
        batches = localized_batches(n)
        trace = ServingTrace.from_log(ev.EventLog.concatenate(
            [x for b in batches for x in (b, ev.query_marker())]))
        ladder = [0]
        real_wave = frontier_mod.ladder_wave

        def counted_wave(*a, **k):
            out = real_wave(*a, **k)
            ladder[0] += out[3]
            return out

        sparse = {}
        for obs in (False, True):
            eng = repro_torch.make_engine(
                num_vertices=n, edge_capacity=len(bs) + 8 * 48 + 64,
                source=0, frontier_mode="sparse",     # K3 by default
                observability=obs)
            ladder[0] = 0
            frontier_mod.ladder_wave = counted_wave
            try:
                t0 = time.perf_counter()
                eng.ingest_log(ev.adds(bs, bd, bw))     # the base
                torch.cuda.synchronize()
                rep, seen, counts = replay(
                    eng, trace, f"localized stream, sparse (K3), obs "
                    f"{'on' if obs else 'off'} (after the base's ingest in "
                    f"{time.perf_counter() - t0:.2f} s)")
            finally:
                frontier_mod.ladder_wave = real_wave
            assert counts[2] > 0, "[12] the sparse leg never launched K3"
            if obs:
                same_answers("[12] sparse obs on vs off", seen, sparse[False][1])
            sparse[obs] = (rep, seen)
        served["gathered_rows_relax"] = counts[2]
        snap, snap_s = snapshot_views(torch, eng, tmp)
        occ = snap["counters"]["frontier_occupancy"]
        assert occ == ladder[0] > 0, (occ, ladder[0])
        q = seen[-1]
        reached = snapshot_check(n, 0, *eng.alloc.active_coo(), q.dist,
                                 q.parent)
        on, off = sparse[True][0], sparse[False][0]
        print(f"[12] sparse obs on / off: {on.events_per_s:.0f} / "
              f"{off.events_per_s:.0f} topology events/s, ratio "
              f"{on.events_per_s / off.events_per_s:.3f} over "
              f"{snap['counters']['add_epochs']} ADD epochs and "
              f"{on.queries} queries (printed, not held); bit-identical at "
              f"all queries; frontier_occupancy {occ} = the sum of the "
              f"ladder counts the waves read; latency p50 on / off "
              f"{on.latency_s['p50'] * 1e3:.3f} / "
              f"{off.latency_s['p50'] * 1e3:.3f} ms; final snapshot passes "
              f"Dijkstra ({reached} reached); metrics_snapshot "
              f"{snap_s * 1e3:.3f} ms")
        del eng, seen, q, sparse
    print(f"[12] phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return served


# --------------------------------- phase 13: the sharded engine, one card --
SHARDS = 8                 # partitions stacked on the one card
SHARD_CHECK_FRACTION = 4   # the 2^16 cross-checks run a quarter of the events
SHARD_DELTA_CAP = 256      # per-partition delta buffer: sparse and overflow
SHARD_FRONTIER_CAP = 512   # per-partition edge cap: both sparse branches


def card_mesh(torch):
    """SHARDS partitions, all on cuda:0."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((SHARDS,), ("graph",),
                     devices=[torch.device("cuda", 0)] * SHARDS)


def sharded_control_plane_seconds(n: int, e: int, log) -> float:
    """The sharded engine's host control plane alone: the same runs through
    SHARDS fresh allocators and window-local ELL planners (numpy, no device
    work), routed by dst owner as the engine routes them; one planner's
    overflow rebuilds all of them at the synchronized K."""
    from repro_torch.core import events as ev
    from repro_torch.core import ingest
    from repro_torch.core.backends.ellpack import EllPlanner
    npp = -(-n // SHARDS)
    cap = -(-(int(1.3 * e) + 64) // SHARDS)
    allocs = [ingest.make_allocator(cap) for _ in range(SHARDS)]
    planners = [EllPlanner(npp, row0=p * npp) for p in range(SHARDS)]
    t0 = time.perf_counter()
    for batch in log.runs():
        if batch.kind == ev.QUERY:
            continue
        owner = np.asarray(batch.dst, np.int64) // npp
        routed = [(p, owner == p) for p in np.unique(owner)]
        if batch.kind == ev.DEL:
            for p, sel in routed:
                allocs[p].plan_dels(batch.src[sel], batch.dst[sel])
            continue
        plans = [(p, allocs[p].plan_adds(batch.src[sel], batch.dst[sel],
                                         batch.w[sel])) for p, sel in routed]
        if any(planners[p].plan_appends(pl.dst[pl.fresh]) is None
               for p, pl in plans if len(pl.slots)):
            coo = [a.active_coo() for a in allocs]
            k = max(pl.required_k(c[1]) for pl, c in zip(planners, coo))
            for pl, c in zip(planners, coo):
                pl.rebuild_host(*c, k=k)
    return time.perf_counter() - t0


def sharded_full_width(torch, ctx) -> dict:
    """Phase 13's full-width leg: phase 8's cut of the ER stream (2^20
    vertices) through ``make_engine(relax_backend="ellpack",
    batch_deletions=True, mesh=SHARDS partitions on cuda:0)``, K1 once per
    partition and wave, its count set to 0 just before and read just after;
    bit-identical to phase 3's run at every query (dist, parent, rounds,
    messages), Dijkstra at the end; K1 on each partition's block against
    its plain version and timed; both host control planes replayed alone.
    Returns K1's sharded record."""
    from repro_torch.kernels.relax import relax as k1
    from repro_torch.kernels.relax.ref import ellpack_relax_ref
    c = ctx["er"]
    n, e, source = c["n"], c["e"], c["sources"][0]
    log, want, (r_wall, r_waves) = leg_stream(c)
    n_topo = topo_counts(log)[0]
    eng = engine(n, e, source, relax_backend="ellpack", mesh=card_mesh(torch))
    wall, res, (launches,) = run_path(torch, eng, log, [k1.ellpack_relax])
    assert launches > 0, "[13] the sharded ER leg never launched K1"
    same_results("[13] sharded ER vs phase 3", res, want)
    variants = [k1.variant(st.nbr_idx, st.nbr_w) for st in eng.bk.states]
    live = [np.concatenate(x)
            for x in zip(*(a.active_coo() for a in eng.allocs))]
    reached = snapshot_check(n, source, *live, res[-1].dist, res[-1].parent)
    fill = eng.partition_fill()
    st0 = eng.bk.states[0]
    print(f"[13] ER sharded, {SHARDS} partitions on cuda:0, its first "
          f"{len(log)} events ({n_topo} topology, {len(res)} queries): "
          f"{wall:.2f} s, {n_topo / wall:.0f} topology events/s (phase 3 to "
          f"the same query: {r_wall:.2f} s, {n_topo / r_wall:.0f}; ratio "
          f"{r_wall / wall:.3f}), query p50 {p50_ms(res):.3f} ms, epochs "
          f"{eng.n_epochs}, waves {eng.n_rounds} (phase 3: {r_waves}), K1 "
          f"launches {launches} ({launches / eng.n_rounds:.2f} a wave), "
          f"K={st0.k}, rows {st0.rows} a partition, rebuilds "
          f"{eng.bk.planners[0].rebuilds}, partition fill {fill.min()}-"
          f"{fill.max()}; variants {variants}; dist, parent, rounds and "
          f"messages bit-identical to phase 3 at all {len(res)} queries; "
          f"final snapshot passes Dijkstra ({reached} reached)")
    offers = eng.ds.all_gather(eng.dist)[0]
    err = max(compare(torch, f"K1 partition {p}",
                      k1.ellpack_relax(offers, st.nbr_idx, st.nbr_w),
                      ellpack_relax_ref(offers, st.nbr_idx, st.nbr_w))
              for p, st in enumerate(eng.bk.states))
    times = kernel_times(
        torch, lambda: k1.ellpack_relax(offers, st0.nbr_idx, st0.nbr_w), 50)
    every = kernel_times(torch, lambda: [
        k1.ellpack_relax(offers, st.nbr_idx, st.nbr_w)
        for st in eng.bk.states], 20)
    plain_ms = cuda_ms(torch, lambda: ellpack_relax_ref(
        offers, st0.nbr_idx, st0.nbr_w), 10)
    rows, k = st0.nbr_idx.shape
    live_cells = int(torch.isfinite(st0.nbr_w).sum())
    nbytes = k1.wave_bytes(offers.numel(), rows, k, live_cells)
    bound_ms, bound_by = bound(nbytes, 2 * live_cells)
    print(f"[13] K1 on each partition's block ({rows} x {k}, "
          f"N={offers.numel()}) bit-identical to its plain version; "
          f"partition 0 ({live_cells} live cells): {times_text(times)} (plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms = {nbytes / 1e6:.1f} "
          f"MB at 3.35 TB/s); all {SHARDS} blocks: {times_text(every)}")
    waves = eng.n_rounds
    c["sharded"] = res     # phase 14's lane 0 is held against it
    del eng, offers, st0, res
    single_s = c["host_s"]       # phase 3's replay of the same cut
    shard_s = sharded_control_plane_seconds(n, e, log)
    print(f"[13] host control plane alone on the cut (numpy): single "
          f"allocator + ELL planner {single_s:.2f} s (phase 3's replay), "
          f"{SHARDS} allocators + "
          f"{SHARDS} planners {shard_s:.2f} s; sharded run {wall:.2f} s, "
          f"phase 3's {r_wall:.2f} s")
    return {"launches": launches, "waves": waves,
            "launches_per_wave": launches / waves, "variants": variants,
            "max_abs_err": err, **times, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "all_partitions": every, "events_per_s": n_topo / wall,
            "phase3_events_per_s": n_topo / r_wall,
            "control_plane_s": shard_s, "single_control_plane_s": single_s}


def sharded_cross_checks(torch) -> dict:
    """Phase 13 at 2^16 (the first quarter of each recipe's events), SHARDS
    partitions on cuda:0, each leg held against a single-device engine on
    the card at the same knobs: ER on the dense ELL block (K1 per
    partition) with the delta exchange (a buffer small enough that rounds
    both overflow and stay sparse), the sparse frontier (both branches),
    buckets, the edge-balanced relabeling, a checkpoint after half the
    events restored into a fresh engine, observability on (rounds,
    messages and the per-partition vectors summed against the single
    engine's counters); RMAT(16) on the sliced layout (K1 per width run and
    partition).  Returns the sliced leg's K1 launches and waves."""
    from repro_torch.core import events as ev
    from repro_torch.core import relax as relax_mod
    from repro_torch.graphs import partition as part_mod
    from repro_torch.graphs.csr import width_runs
    from repro_torch.kernels.relax import relax as k1
    t0 = time.perf_counter()
    n, e, sources, log = stream(16, "er")
    adds = np.asarray(log.kind) == ev.ADD
    relabel = part_mod.edge_balanced_relabeling(
        n, np.asarray(log.dst)[adds], SHARDS)
    log = log[:len(log) // SHARD_CHECK_FRACTION]
    source = sources[0]
    ref = engine(n, e, source, relax_backend="ellpack", observability=True)
    want = ref.ingest_log(log)
    ref_snap = ref.metrics_snapshot()
    del ref

    def sharded(**knobs):
        return engine(n, e, source, relax_backend="ellpack",
                      mesh=card_mesh(torch), **knobs)

    def check(label, got, *, stats=True, parents=True):
        assert len(got) == len(want) > 0, label
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a.dist, b.dist), f"[13] {label}: query {i}"
            assert not parents or np.array_equal(a.parent, b.parent), \
                f"[13] {label}: parent at query {i}"
            assert not stats or a.epoch_stats == b.epoch_stats, \
                f"[13] {label}: stats at query {i}"

    # delta exchange: count the rounds that fell back to dense offers
    eng = sharded(exchange="delta", delta_cap=SHARD_DELTA_CAP)
    rounds = []
    real = eng.ds._offers_delta

    def offers_delta(dist, frontier, overflow):
        rounds.append(overflow)
        return real(dist, frontier, overflow)

    eng.ds._offers_delta = offers_delta
    check("delta", eng.ingest_log(log), stats=False)
    over = sum(rounds)
    assert 0 < over < len(rounds), f"[13] delta rounds: {over}/{len(rounds)}"
    print(f"[13] 2^16 ER, delta exchange (buffer {SHARD_DELTA_CAP}): dist "
          f"and parent equal to the single engine at all {len(want)} "
          f"queries; {over} of {len(rounds)} relaxation rounds overflowed to "
          f"dense offers, waves {eng.n_rounds} (single "
          f"{want[-1].epoch_stats['rounds']})")

    # sparse frontier: the partitions' live-offer counts, read per wave
    counts = []
    real_host = relax_mod.host

    def spy(flags):
        got = real_host(flags)
        if flags.dim() == 1 and flags.dtype != torch.bool:
            counts.extend(np.atleast_1d(got).tolist())
        return got

    relax_mod.host = spy
    try:
        got = sharded(frontier_mode="sparse",
                      frontier_cap=SHARD_FRONTIER_CAP).ingest_log(log)
    finally:
        relax_mod.host = real_host
    check("sparse", got)
    counts = np.asarray(counts)
    compact = int((counts <= SHARD_FRONTIER_CAP).sum())
    assert 0 < compact < len(counts), f"[13] sparse branches: {compact}"
    print(f"[13] sparse frontier (cap {SHARD_FRONTIER_CAP}): equal to the "
          f"single engine (dist, parent, rounds, messages); {compact} of "
          f"{len(counts)} partition waves compacted, the rest took K1")

    check("buckets", sharded(wave_schedule="buckets",
                             bucket_width=1.0).ingest_log(log), stats=False)
    check("relabel", sharded(relabel=relabel).ingest_log(log), stats=False,
          parents=False)
    half = len(log) // 2
    eng = sharded()
    first = eng.ingest_log(log[:half])
    ckpt = eng.checkpoint()
    eng = sharded()
    eng.restore(ckpt)
    check("checkpoint", first + eng.ingest_log(log[half:]), stats=False)
    eng = sharded(observability=True)
    check("observability", eng.ingest_log(log))
    snap = eng.metrics_snapshot()
    ct, rct = snap["counters"], ref_snap["counters"]
    assert (snap["rounds"], snap["messages"]) == (ref_snap["rounds"],
                                                  ref_snap["messages"])
    assert int(np.sum(ct["frontier_per_part"])) == rct["frontier"]
    for kind in ("adds", "dels"):   # a counter is absent until it counts
        assert int(np.sum(ct.get(f"{kind}_per_part", 0))) == snap[kind] \
            == ref_snap[kind], kind
    assert np.array_equal(ct["hist_waves_per_epoch"],
                          rct["hist_waves_per_epoch"])
    print(f"[13] buckets, relabel (dist), a checkpoint restored into a "
          f"fresh engine, observability: equal to the single engine; obs "
          f"rounds {snap['rounds']} messages {snap['messages']}, adds per "
          f"partition {np.asarray(ct['adds_per_part']).tolist()}, updates "
          f"per partition {np.asarray(ct['updates_per_part']).tolist()}")

    # RMAT(16) on the sliced layout: K1 once per width run and partition
    n, e, sources, log = stream(16, "rmat")
    log = log[:len(log) // SHARD_CHECK_FRACTION]
    knobs = dict(relax_backend="sliced", ell_use_kernel=True)
    single = engine(n, e, sources[0], sliced_fused=False, **knobs)
    want = single.ingest_log(log)
    eng = engine(n, e, sources[0], mesh=card_mesh(torch), **knobs)
    wall, got, (launches,) = run_path(torch, eng, log, [k1.ellpack_relax])
    assert launches > 0, "[13] the sharded sliced leg never launched K1"
    same_results("[13] sharded sliced", got, want)
    runs = len(width_runs(eng.bk.states[0].widths))
    print(f"[13] 2^16 RMAT sliced: equal to the single unfused sliced engine "
          f"at all {len(got)} queries (counters too); {wall:.2f} s, K1 "
          f"launches {launches} over {eng.n_rounds} waves "
          f"({launches / eng.n_rounds:.1f} a wave; {runs} width runs a "
          f"partition at the end); phase 13's 2^16 checks in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"sliced_launches": launches, "sliced_waves": eng.n_rounds}


# ------------- phase 14: the sharded [S, N] lanes and the paper's baselines --
BASELINE_QUERIES = (7, 14, 21)   # the ReMo baseline's query points on the cut


def lane_results_equal(label, got, want) -> None:
    """Lane stacks at every query: dist, parent and the per-lane rounds and
    messages equal."""
    assert len(got) == len(want) > 0, label
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a.dist, b.dist), f"{label}: dist at query {i}"
        assert np.array_equal(a.parent, b.parent), \
            f"{label}: parent at query {i}"
        for k in ("rounds", "messages"):
            assert np.array_equal(a.epoch_stats[k], b.epoch_stats[k]), \
                f"{label}: {k} at query {i}"


def count_waves(eng) -> list:
    """Count a sharded engine's mesh waves (relaxation, pull and drain
    waves, each for all lanes and partitions) by wrapping its
    ``_apply_wave``; marking rounds run no wave."""
    waves = []
    real = eng.ds._apply_wave

    def counted(*a, **k):
        waves.append(1)
        return real(*a, **k)

    eng.ds._apply_wave = counted
    return waves


def sharded_lanes_full_width(torch, ctx) -> tuple[dict, list]:
    """Phase 14's full-width leg: phase 8's cut of the ER stream through
    ``make_engine(sources=`` the LANES top in-degree vertices,
    ``relax_backend="ellpack", batch_deletions=True, mesh=`` SHARDS
    partitions on cuda:0), K1's lane form once per partition and wave (its
    counts set to 0 just before and read just after); every lane equal to
    phase 9's run at every query (dist, parent, per-lane rounds and
    messages), lane 0 to phase 13's; Dijkstra for every lane at the end;
    K1's lane form on each partition's block against its plain version,
    timed on one block and on all of them.  Returns K1's ``sharded_lanes``
    record and lane 0's dist at the BASELINE_QUERIES."""
    from repro_torch.kernels.relax import relax as k1
    from repro_torch.kernels.relax.ref import ellpack_relax_ref
    c = ctx["er"]
    n, e, sources = c["n"], c["e"], tuple(c["sources"])
    S = len(sources)
    log, _, _ = leg_stream(c)
    lanes = c["lanes"]
    n_topo = lanes["n_topo"]
    eng = engine(n, e, sources[0], sources=sources, relax_backend="ellpack",
                 mesh=card_mesh(torch))
    waves = count_waves(eng)
    fn = k1.ellpack_relax
    fn.launches = fn.lane_launches = k1.lane_minor.launches = 0
    t0 = time.perf_counter()
    res = eng.ingest_log(log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, lane_launches = fn.launches, fn.lane_launches
    assert lane_launches > 0 and launches == lane_launches, \
        f"[14] K1 launches {launches}, lane form {lane_launches}"
    assert launches == SHARDS * len(waves), (launches, len(waves))
    # one lane-minor copy a mesh wave, shared by the partitions' blocks
    assert k1.lane_minor.launches == len(waves), \
        f"[14] {k1.lane_minor.launches} interleaves, {len(waves)} waves"
    lane_results_equal("[14] sharded lanes vs phase 9", res, lanes["results"])
    for i, (a, b) in enumerate(zip(res, c["sharded"])):
        assert np.array_equal(a.dist[0], b.dist) and np.array_equal(
            a.parent[0], b.parent), f"[14] lane 0 vs phase 13 at query {i}"
    live = [np.concatenate(x)
            for x in zip(*(a.active_coo() for a in eng.allocs))]
    reached = snapshot_check(n, sources, *live, res[-1].dist,
                             res[-1].parent)
    rate, rate9 = S * n_topo / wall, S * n_topo / lanes["wall"]
    print(f"[14] ER sharded lanes, {SHARDS} partitions on cuda:0, {S} lanes "
          f"(sources {sources}), its first {len(log)} events ({n_topo} "
          f"topology, {len(res)} queries): {wall:.2f} s, {rate:.0f} "
          f"source-events/s (phase 9's one-device lanes: {rate9:.0f} in "
          f"{lanes['wall']:.2f} s; ratio {rate / rate9:.3f}), query p50 "
          f"{p50_ms(res):.3f} ms, waves per lane {eng.n_rounds.tolist()}, "
          f"mesh waves {len(waves)}, K1 lane-form launches {launches} "
          f"({launches / len(waves):.2f} a mesh wave, none a marking "
          f"round) on one lane-minor interleave a mesh wave; every lane "
          f"equal to phase 9 at all {len(res)} queries "
          f"(dist, parent, rounds, messages), lane 0 to phase 13; every "
          f"lane passes Dijkstra (reached {reached})")
    lane0 = [res[q - 1].dist[0] for q in BASELINE_QUERIES]
    p50 = p50_ms(res)
    del res
    offers = eng.ds.all_gather(eng.dist)[0]
    states = eng.bk.states
    variants = [k1.variant(st.nbr_idx, st.nbr_w) for st in states]
    # the path's shape: one lane-minor copy a mesh wave, every partition's
    # block relaxed on it
    minor = k1.lane_minor(offers)
    err = max(compare(torch, f"K1 lanes, partition {p}",
                      k1.ellpack_relax(offers, st.nbr_idx, st.nbr_w,
                                       offers_minor=minor),
                      ellpack_relax_ref(offers, st.nbr_idx, st.nbr_w))
              for p, st in enumerate(states))
    st0 = states[0]
    one = offers[0].contiguous()
    times = kernel_times(torch, lambda: k1.ellpack_relax(
        offers, st0.nbr_idx, st0.nbr_w, offers_minor=minor), 50)
    one_ms = device_ms(torch, lambda: k1.ellpack_relax(one, st0.nbr_idx,
                                                       st0.nbr_w))

    def all_blocks():
        m = k1.lane_minor(offers)
        return [k1.ellpack_relax(offers, st.nbr_idx, st.nbr_w,
                                 offers_minor=m) for st in states]

    every = kernel_times(torch, all_blocks, 20)
    one_every = device_ms(torch, lambda: [
        k1.ellpack_relax(one, st.nbr_idx, st.nbr_w) for st in states])
    inter_ms = device_ms(torch, lambda: k1.lane_minor(offers))
    plain_ms = cuda_ms(torch, lambda: ellpack_relax_ref(
        offers, st0.nbr_idx, st0.nbr_w), 10)
    rows, k = st0.nbr_idx.shape
    live_cells = int(torch.isfinite(st0.nbr_w).sum())
    nbytes = k1.wave_bytes(offers.shape[-1], rows, k, live_cells, lanes=S)
    bound_ms, bound_by = bound(nbytes, 2 * live_cells * S)
    ratio = times["device_ms"] / (S * one_ms)
    ratio_all = every["device_ms"] / (S * one_every)
    print(f"[14] K1's lane form on each partition's block ({rows} x {k}, "
          f"offers {tuple(offers.shape)}) bit-identical to its plain "
          f"version; variants {variants}; partition 0 ({live_cells} live "
          f"cells) on the shared lane-minor copy: {times_text(times)} "
          f"(plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s, "
          f"{100 * bound_ms / times['device_ms']:.1f} % of it; one lane "
          f"alone {one_ms:.4f} ms, ratio {ratio:.3f} of S single-lane "
          f"calls); the interleave {inter_ms:.4f} ms device, once a mesh "
          f"wave; all {SHARDS} blocks with their copy: {times_text(every)} "
          f"(one lane alone {one_every:.4f} ms, ratio {ratio_all:.3f})")
    record = {"lanes": S, "launches": launches, "mesh_waves": len(waves),
              "launches_per_wave": launches / len(waves),
              "variants": variants, "max_abs_err": err, **times,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None,
              "single_lane_device_ms": one_ms,
              "ratio_to_single_lanes": ratio,
              "interleave_device_ms": inter_ms, "all_partitions": every,
              "all_partitions_single_lane_device_ms": one_every,
              "all_partitions_ratio": ratio_all,
              "source_events_per_s": rate,
              "phase9_source_events_per_s": rate9, "query_p50_ms": p50}
    del eng, offers, states, st0
    return record, lane0


def baselines_full_width(torch, c, lane0, engine_p50) -> dict:
    """Phase 14's baselines at full width, on phase 8's cut of the ER
    stream: ReMo-from-scratch queried at the BASELINE_QUERIES (dist equal
    to the sharded lane 0's within check_tree's tolerance, Dijkstra at the
    last; one more query with randomized ties leaves dist unchanged), its
    latency p50 beside the engine's; the static solver's convert and solve
    on the cut's log (Dijkstra)."""
    from repro_torch.core.baseline import ReMoBaseline, StaticSolver
    n, e, source = c["n"], c["e"], c["sources"][0]
    log, _, _ = leg_stream(c)
    kind = np.asarray(log.kind)
    queries = np.nonzero(kind == 2)[0]
    keep = kind != 2
    keep[queries[[q - 1 for q in BASELINE_QUERIES]]] = True
    base = ReMoBaseline(n, int(1.3 * e) + 64, source)
    t0 = time.perf_counter()
    got = base.ingest_log(log[keep])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    big = lambda x: np.where(np.isinf(x), 1e30, x)   # noqa: E731
    assert len(got) == len(BASELINE_QUERIES)
    for q, r, d in zip(BASELINE_QUERIES, got, lane0):
        assert np.array_equal(np.isinf(r.dist), np.isinf(d)) and np.allclose(
            big(r.dist), big(d), atol=1e-4, rtol=1e-5), \
            f"[14] ReMo differs from the sharded lane 0 at query {q}"
    coo = base.alloc.active_coo()
    reached = snapshot_check(n, source, *coo, got[-1].dist, got[-1].parent)
    remo_p50 = p50_ms(got)
    base.randomize_ties = True
    tied = base.query()
    assert np.array_equal(tied.dist, got[-1].dist), "[14] ties moved dist"
    moved = int((tied.parent != got[-1].parent).sum())
    print(f"[14] ReMo-from-scratch over the cut ({len(log[keep])} events, "
          f"queries {BASELINE_QUERIES}): {wall:.2f} s in all; latency p50: "
          f"sharded lanes {engine_p50:.3f} ms | ReMo-from-scratch "
          f"{remo_p50:.3f} ms | speedup {remo_p50 / engine_p50:.1f}x; rounds "
          f"{[r.epoch_stats['rounds'] for r in got]}; dist equal to the "
          f"sharded lane 0 (check_tree's tolerance) at each; Dijkstra "
          f"({reached} reached); randomized ties: dist unchanged, "
          f"{moved} parents moved, {tied.latency_s * 1e3:.3f} ms")
    solver = StaticSolver(n)
    convert_s = solver.convert(log)
    rep = solver.solve(source)
    ed = solver.edges
    reached = snapshot_check(n, source, *(t.cpu().numpy() for t in (
        ed.src, ed.dst, ed.w)), rep.dist, rep.parent)
    print(f"[14] static solver on the cut's log: convert {convert_s:.2f} s "
          f"({ed.src.numel()} live edges, CSR by dst), solve "
          f"{rep.solve_s:.3f} s; Dijkstra ({reached} reached)")
    return {"remo_p50_ms": remo_p50, "engine_query_p50_ms": engine_p50,
            "remo_speedup": remo_p50 / engine_p50,
            "static_convert_s": convert_s, "static_solve_s": rep.solve_s}


def sharded_lanes_cross_checks(torch) -> dict:
    """Phase 14 at 2^16 (the ER recipe's first quarter of events), SHARDS
    partitions on cuda:0 with LANES lanes, each leg against the
    single-device lane engine on the card: the delta exchange (overflowing
    lane-rounds counted), the sparse frontier (both branches counted per
    partition and lane), buckets, a checkpoint restored into a fresh
    engine, observability (counters summed over partitions); RMAT(16) on
    the sliced layout (K1's lane form once per width run and partition,
    both variants); then the batched BSP baseline against the engine."""
    from repro_torch.core import events as ev
    from repro_torch.core import relax as relax_mod
    from repro_torch.core.backends import sliced as sliced_mod
    from repro_torch.core.baseline import BatchedBSPEngine
    from repro_torch.kernels.relax import relax as k1
    t0 = time.perf_counter()
    n, e, sources, log = stream(16, "er")
    log = log[:len(log) // SHARD_CHECK_FRACTION]
    sources = tuple(sources)
    ref = engine(n, e, sources[0], sources=sources, relax_backend="ellpack",
                 observability=True)
    want = ref.ingest_log(log)
    ref_snap = ref.metrics_snapshot()
    del ref

    def sharded(**knobs):
        return engine(n, e, sources[0], sources=sources,
                      relax_backend="ellpack", mesh=card_mesh(torch), **knobs)

    def check(label, got, *, stats=True):
        assert len(got) == len(want) > 0, label
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a.dist, b.dist), f"[14] {label}: query {i}"
            assert np.array_equal(a.parent, b.parent), \
                f"[14] {label}: parent at query {i}"
            assert not stats or all(
                np.array_equal(a.epoch_stats[k], b.epoch_stats[k])
                for k in ("rounds", "messages")), f"[14] {label}: stats {i}"

    # delta exchange: per-lane overflow flags of every round
    eng = sharded(exchange="delta", delta_cap=SHARD_DELTA_CAP)
    flags = []
    real = eng.ds._offers_delta

    def offers_delta(dist, frontier, overflow):
        flags.append(np.atleast_1d(overflow))
        return real(dist, frontier, overflow)

    eng.ds._offers_delta = offers_delta
    check("delta", eng.ingest_log(log), stats=False)
    over = sum(int(f.sum()) for f in flags)
    total = sum(len(f) for f in flags)
    mixed = sum(1 for f in flags if 0 < f.sum() < len(f))
    assert 0 < over < total, f"[14] delta lane-rounds: {over}/{total}"
    print(f"[14] 2^16 ER, {len(sources)} lanes, delta exchange (buffer "
          f"{SHARD_DELTA_CAP}): dist and parent equal to the single lane "
          f"engine at all {len(want)} queries; {over} of {total} "
          f"lane-rounds overflowed to dense offers ({mixed} of {len(flags)} "
          f"rounds picked per lane by a device select)")

    # sparse frontier: the [P, S] live-offer counts read per wave
    counts = []
    real_host = relax_mod.host

    def spy(t):
        got = real_host(t)
        if t.dim() == 2 and t.dtype != torch.bool:
            counts.append(np.asarray(got))
        return got

    relax_mod.host = spy
    try:
        got = sharded(frontier_mode="sparse",
                      frontier_cap=SHARD_FRONTIER_CAP).ingest_log(log)
    finally:
        relax_mod.host = real_host
    check("sparse", got)
    counts = np.concatenate(counts)
    compact = int((counts <= SHARD_FRONTIER_CAP).sum())
    assert 0 < compact < counts.size, f"[14] sparse branches: {compact}"
    print(f"[14] sparse frontier (cap {SHARD_FRONTIER_CAP}): equal to the "
          f"single lane engine (dist, parent, rounds, messages); {compact} "
          f"of {counts.size} (partition, lane) waves compacted, the rest "
          f"took K1's lane form")

    check("buckets", sharded(wave_schedule="buckets",
                             bucket_width=1.0).ingest_log(log), stats=False)
    half = len(log) // 2
    eng = sharded()
    first = eng.ingest_log(log[:half])
    ckpt = eng.checkpoint()
    eng = sharded()
    eng.restore(ckpt)
    check("checkpoint", first + eng.ingest_log(log[half:]), stats=False)
    eng = sharded(observability=True)
    check("observability", eng.ingest_log(log))
    snap = eng.metrics_snapshot()
    ct, rct = snap["counters"], ref_snap["counters"]
    for k in ("rounds", "messages"):
        assert np.array_equal(snap[k], ref_snap[k]), k
    assert int(np.sum(ct["frontier_per_part"])) == rct["frontier"]
    for kind in ("adds", "dels"):   # a counter is absent until it counts
        assert int(np.sum(ct.get(f"{kind}_per_part", 0))) == snap[kind] \
            == ref_snap[kind], kind
    assert np.array_equal(ct["hist_waves_per_epoch"],
                          rct["hist_waves_per_epoch"])
    print(f"[14] buckets, a checkpoint restored into a fresh engine, "
          f"observability: equal to the single lane engine; obs rounds "
          f"{np.asarray(snap['rounds']).tolist()}, adds per partition "
          f"{np.asarray(ct['adds_per_part']).tolist()}, updates per lane "
          f"{np.asarray(ct['updates_per_lane']).tolist()}")

    # RMAT(16) on the sliced layout: K1's lane form per width run and
    # partition; the variant of every launch recorded on the way
    seen = set()
    real_k1 = sliced_mod.ellpack_relax

    def k1_seen(offers, idx, w, **kw):   # kw: the shared lane-minor copy
        seen.add(k1.variant(idx, w))
        return real_k1(offers, idx, w, **kw)

    rn, re_, rsources, rlog = stream(16, "rmat")
    rlog = rlog[:len(rlog) // SHARD_CHECK_FRACTION]
    rsources = tuple(rsources)
    knobs = dict(relax_backend="sliced", ell_use_kernel=True,
                 sources=rsources)
    single = engine(rn, re_, rsources[0], sliced_fused=False, **knobs)
    rwant = single.ingest_log(rlog)
    eng = engine(rn, re_, rsources[0], mesh=card_mesh(torch), **knobs)
    sliced_mod.ellpack_relax = k1_seen
    try:
        k1.ellpack_relax.lane_launches = 0
        wall, got, (launches,) = run_path(torch, eng, rlog,
                                          [k1.ellpack_relax])
    finally:
        sliced_mod.ellpack_relax = real_k1
    lane_l = k1.ellpack_relax.lane_launches
    assert launches > 0 and lane_l == launches, (launches, lane_l)
    assert seen == {"vector", "scalar"}, f"[14] sliced variants {seen}"
    lane_results_equal("[14] sharded sliced lanes", got, rwant)
    print(f"[14] 2^16 RMAT sliced, {len(rsources)} lanes: equal to the "
          f"single unfused sliced lane engine at all {len(got)} queries "
          f"(counters too); {wall:.2f} s, K1 lane-form launches {launches} "
          f"(waves per lane {eng.n_rounds.tolist()}), variants "
          f"{sorted(seen)}")
    sliced_launches = launches

    # the batched BSP baseline, flushes of an eighth of the events each, up
    # to the last query
    kind = np.asarray(log.kind)
    end = int(np.nonzero(kind == ev.QUERY)[0][-1])
    topo = log[:end][kind[:end] != ev.QUERY]
    bsp = BatchedBSPEngine(n, int(1.3 * e) + 64, sources[0],
                           batch_size=len(topo) // 8)
    lat = []
    for a in range(0, len(topo), 4096):
        bsp.push(topo[a:a + 4096])
        got = bsp.maybe_flush()
        if got is not None:
            lat.append(got)
    lat.append(bsp.force_flush())
    final = bsp.inner.query()
    assert np.array_equal(final.dist, want[-1].dist[0]), "[14] BSP dist"
    print(f"[14] batched BSP (batches of {len(topo) // 8} events): "
          f"{len(lat)} flushes, p50 {np.median(lat) * 1e3:.1f} ms; final "
          f"dist equal to the engine's lane 0 at the last query; phase 14's "
          f"2^16 checks in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"delta_lane_rounds_overflowed": over,
            "delta_lane_rounds": total, "sparse_compacted": compact,
            "sparse_partition_lane_waves": int(counts.size),
            "sliced_launches": sliced_launches,
            "sliced_variants": sorted(seen),
            "bsp_flush_p50_ms": float(np.median(lat)) * 1e3}


# ------------- phase 15: the GNN and recsys substrate at full width --
SUB_GNN = ("graphsage-reddit", "meshgraphnet", "dimenet", "equiformer-v2")
SUB_STEPS = 3            # timed train steps a shape, after a warm one
# card against CPU (both f32, TF32 off): index_add's atomics and cuBLAS
# sum in their own orders, so results are close, not equal.  Loss and
# grad norm relative to the CPU's; Adam's first moment (the clipped
# gradient) within SUB_TOL["moment"] x the leaf's largest CPU entry, and
# at least 1e-6 x the model's largest; parameters after the step within
# 1e-6 where that gradient is significant, elsewhere within 2 lr
SUB_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "moment": 1e-3, "score": 1e-5}
F4_ARCHS = ("equiformer-v2",)   # NaN gradients at full depth: ROADMAP F4
# EquiformerV2's f32 loss at full depth moves with the summation order
# alone: the card's error against the CPU's f64 forward has ranged from
# 0.03x to 2.5x the CPU's own f32 error, so the band is ten times it
F4_BAND = 10.0
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892   # registry minibatch_lg
RETRIEVAL_CUT = 262_144  # of retrieval_cand's 1,000,000 candidates
CARD = "cuda"            # phases 15 and 18: "cpu" rehearses them on the host


def step_both(torch, model_cpu, loss_fn, batch_cpu):
    """One train step of the registry's optimizer on the CPU and on the
    card from the same initial state.  Returns the step, [(model, AdamW
    state, metrics)] for the CPU and the card, and the initial
    parameters."""
    import copy
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import steps as steps_mod
    step = steps_mod.make_train_step(loss_fn, opt_mod.AdamWConfig(), 1)
    card = copy.deepcopy(model_cpu).to(CARD)
    old = {k: p.detach().clone() for k, p in model_cpu.named_parameters()}
    out = []
    for m, dev in ((model_cpu, "cpu"), (card, CARD)):
        state = opt_mod.adamw_init(dict(m.named_parameters()))
        metrics = step(m, state, {k: v.to(dev) for k, v in batch_cpu.items()})
        out.append((m, state, {k: float(v) for k, v in metrics.items()}))
    return step, out, old


def hold_step(label, out, old) -> dict:
    """Card against CPU after one step (see SUB_TOL); a NaN anywhere fails.
    Returns the errors."""
    (cpu, cs, cm), (card, ks, km) = out
    errs = {}
    for k in ("loss", "grad_norm"):
        errs[k] = abs(km[k] - cm[k]) / abs(cm[k])
        assert errs[k] <= SUB_TOL[k], f"{label}: {k} {km[k]} vs CPU {cm[k]}"
    moments = {k: v.numpy() for k, v in cs["m"].items()}
    floor = 1e-6 * max(float(np.abs(v).max()) for v in moments.values())
    card_p = dict(card.named_parameters())
    errs["moment"] = errs["param"] = 0.0
    for k, p in cpu.named_parameters():
        g, gk = moments[k], ks["m"][k].cpu().numpy()
        gmax = float(np.abs(g).max())
        atol = max(SUB_TOL["moment"] * gmax, floor)
        err = float(np.abs(gk - g).max())
        errs["moment"] = max(errs["moment"], err / max(gmax, floor))
        assert err <= atol, f"{label}: moment {k} off by {err}"
        want, got = p.detach().numpy(), card_p[k].detach().cpu().numpy()
        big = np.abs(g) > max(1e-4 * gmax, atol)
        d = np.abs(got - want)[big]
        errs["param"] = max(errs["param"], float(d.max()) if d.size else 0.0)
        assert np.all(d <= 1e-6), f"{label}: {k} differs after the step"
        assert np.all(np.abs(got - old[k].numpy())[~big] <= 2 * cm["lr"]), \
            f"{label}: {k} moved too far"
    return errs


def hold_f4_step(torch, label, model_cpu, loss_fn, batch_cpu):
    """EquiformerV2 at full depth (ROADMAP F4): the reference's gradients
    are NaN, so its step makes every parameter NaN, and its f32 forward is
    ill-conditioned.  The card's step is held by its loss, within
    F4_BAND x the CPU's own f32 error (its f32 loss against the same
    forward in f64, the reference's explicit f32 casts kept) of that f64
    loss, and at least SUB_TOL["loss"]; and by its grad norm, NaN as the
    reference's.  Returns the card's (model, state, metrics) and errors."""
    import copy
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import steps as steps_mod
    step = steps_mod.make_train_step(loss_fn, opt_mod.AdamWConfig(), 1)
    card = copy.deepcopy(model_cpu).to(CARD)
    with torch.no_grad():
        l32 = float(loss_fn(model_cpu, batch_cpu)[0])
        l64 = float(loss_fn(model_cpu.double(), {
            k: v.double() if v.is_floating_point() else v
            for k, v in batch_cpu.items()})[0])
    state = opt_mod.adamw_init(dict(card.named_parameters()))
    m = {k: float(v) for k, v in step(card, state, {
        k: v.to(CARD) for k, v in batch_cpu.items()}).items()}
    errs = {"loss": abs(m["loss"] - l32) / abs(l32),
            "cpu_f32_vs_f64": abs(l32 - l64) / abs(l64),
            "card_vs_f64": abs(m["loss"] - l64) / abs(l64)}
    band = max(F4_BAND * errs["cpu_f32_vs_f64"], SUB_TOL["loss"])
    assert errs["card_vs_f64"] <= band, \
        f"{label}: loss {m['loss']} vs CPU f64 {l64} (f32 {l32})"
    assert np.isnan(m["grad_norm"]), f"{label}: grad norm {m['grad_norm']}"
    return step, (card, state, m), errs


def timed_steps(torch, step, model, state, batches) -> tuple:
    """``SUB_STEPS`` steps on the card, each between CUDA events, then one
    more under torch.profiler (CUDA activity).  Returns (ms per step, peak
    GB allocated during the timed steps, the profiled step's device time
    (its kernels' sum) and host wall in ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for b in batches:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step(model, state, b)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(model, state, batches[-1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    dev = sum(x.self_device_time_total for x in prof.key_averages()) / 1e3
    return ms, peak, {"device_ms": dev, "wall_ms": wall}


def busy(prof: dict) -> str:
    return (f"profiled step: device {prof['device_ms']:.3f} ms of "
            f"{prof['wall_ms']:.3f} ms wall "
            f"({prof['device_ms'] / prof['wall_ms']:.1%} busy)")


def gnn_full_width(torch, shape: str) -> list:
    """Each GNN at full CONFIG (the shape's d_feat and classes) on a shape
    of the registry: full_graph_sm's Erdős–Rényi stand-in with Cora's
    counts (node loss) or ``molecule`` (graph loss).  One step card
    against CPU (EquiformerV2: ``hold_f4_step``), then SUB_STEPS timed."""
    from functools import partial
    from repro_torch.configs import registry as reg
    info = reg.GNN_SHAPES[shape]
    recs = []
    for arch in SUB_GNN:
        t0 = time.perf_counter()
        label = f"[15] {arch} {shape}"
        node_loss, graph_loss, init_fn, pos, tri = reg._GNN_FNS[arch]
        cfg = reg._gnn_resolve_cfg(reg.ARCHES[arch], info)
        maker = reg.molecule_batch if info.get("graph") else reg.graph_batch
        batch = maker(info, info.get("d_feat", 16), needs_pos=pos,
                      needs_tri=tri, device="cpu", seed=SEED)
        loss_fn = partial(graph_loss if info.get("graph") else node_loss,
                          cfg=cfg)
        model = init_fn(cfg, torch.Generator().manual_seed(SEED), "cpu")
        if arch in F4_ARCHS:
            step, (card, state, m), errs = hold_f4_step(
                torch, label, model, loss_fn, batch)
            held = (f"card vs CPU loss {errs['loss']:.2e}; against the "
                    f"CPU's f64 forward: card {errs['card_vs_f64']:.2e}, "
                    f"CPU f32 {errs['cpu_f32_vs_f64']:.2e} (ill-conditioned"
                    f"); grad norm NaN as the reference's (ROADMAP F4)")
        else:
            step, out, old = step_both(torch, model, loss_fn, batch)
            errs = hold_step(label, out, old)
            card, state, m = out[1]
            del out, old
            held = (f"card vs CPU loss {errs['loss']:.2e}, grad norm "
                    f"{errs['grad_norm']:.2e}, moments {errs['moment']:.2e}"
                    f" of the leaf's largest, params {errs['param']:.2e}")
        del model
        cb = {k: v.to(CARD) for k, v in batch.items()}
        ms, peak, prof = timed_steps(torch, step, card, state,
                                     [cb] * SUB_STEPS)
        flops = reg._gnn_model_flops(arch, cfg, cb)
        step_ms = float(np.mean(ms))
        rec = {"arch": arch, "shape": shape, "ms": ms, "step_ms": step_ms,
               "peak_gb": peak, "model_tflops": flops / step_ms / 1e9,
               "profiled": prof,
               "loss": m["loss"], "grad_norm": m["grad_norm"], **errs,
               "seconds": time.perf_counter() - t0}
        print(f"{label} (d_in {cfg.d_in}, n_out {cfg.n_out}; "
              f"{tuple(cb['feats'].shape)} feats, {cb['src'].numel()} "
              f"edges): loss {m['loss']:.6g}, grad norm {m['grad_norm']:.6g}"
              f"; {held}; step {step_ms:.3f} ms ("
              f"{', '.join(f'{x:.3f}' for x in ms)}), peak {peak:.2f} GB, "
              f"{rec['model_tflops']:.2f} model TFLOP/s; {busy(prof)}; "
              f"{rec['seconds']:.1f} s")
        recs.append(rec)
        del card, state, cb
        torch.cuda.empty_cache()
    return recs


def reddit_minibatch(torch) -> dict:
    """GraphSAGE-Reddit ``minibatch_lg``: the ported ``NeighborSampler``
    over a stand-in with Reddit's nodes and edges (in-neighbours uniform
    from SEED: per-node counts multinomial, ids uniform), 1,024 seeds,
    fanout (15, 10), d_feat 602, 41 classes, padded to the registry's
    169,984 nodes / 168,960 edges.  The first step card against CPU, then
    SUB_STEPS timed, each on a fresh sample."""
    from functools import partial
    from repro_torch.configs import registry as reg
    from repro_torch.graphs import sampler as smp
    t0 = time.perf_counter()
    info = reg.GNN_SHAPES["minibatch_lg"]
    n, e = REDDIT_NODES, REDDIT_EDGES
    rng = np.random.default_rng(SEED)
    deg = rng.multinomial(e, np.full(n, 1.0 / n))
    dst = np.repeat(np.arange(n, dtype=np.int32), deg)
    src = rng.integers(0, n, e, dtype=np.int32)
    t_graph = time.perf_counter() - t0
    sampler = smp.NeighborSampler(n, src, dst)
    t_build = time.perf_counter() - t0 - t_graph
    del src, dst, deg
    feats = rng.standard_normal((n, info["d_feat"]), dtype=np.float32)
    labels = rng.integers(0, info["classes"], n)
    node_loss, _, init_fn, _, _ = reg._GNN_FNS["graphsage-reddit"]
    cfg = reg._gnn_resolve_cfg(reg.ARCHES["graphsage-reddit"], info)

    def sample(i):
        t = time.perf_counter()
        b = reg.sampled_batch(sampler, rng.choice(n, info["batch_nodes"],
                                                  replace=False),
                              info, feats, labels, seed=SEED + i,
                              device="cpu")
        return b, (time.perf_counter() - t) * 1e3

    batch, first_ms = sample(0)
    model = init_fn(cfg, torch.Generator().manual_seed(SEED), "cpu")
    step, out, old = step_both(torch, model, partial(node_loss, cfg=cfg),
                               batch)
    errs = hold_step("[15] graphsage-reddit minibatch_lg", out, old)
    card, state, m = out[1]
    del out, model, old
    samples = [sample(i + 1) for i in range(SUB_STEPS)]
    sample_ms = [first_ms] + [s for _, s in samples]
    cbs = [{k: v.to(CARD) for k, v in b.items()} for b, _ in samples]
    ms, peak, prof = timed_steps(torch, step, card, state, cbs)
    step_ms = float(np.mean(ms))
    flops = reg._gnn_model_flops("graphsage-reddit", cfg, cbs[0])
    live = [int(b["edge_mask"].sum()) for b in cbs]
    rec = {"arch": "graphsage-reddit", "shape": "minibatch_lg",
           "graph_s": t_graph, "sampler_build_s": t_build,
           "sample_ms": sample_ms, "ms": ms, "step_ms": step_ms,
           "peak_gb": peak, "model_tflops": flops / step_ms / 1e9,
           "live_edges": live, "loss": m["loss"], "profiled": prof, **errs,
           "seconds": time.perf_counter() - t0}
    print(f"[15] graphsage-reddit minibatch_lg: stand-in graph {n} nodes / "
          f"{e} edges made in {t_graph:.2f} s, NeighborSampler built in "
          f"{t_build:.2f} s; batch {tuple(cbs[0]['feats'].shape)} feats, "
          f"{cbs[0]['src'].numel()} edge slots ({live} live); sample + "
          f"build_batch (host) {', '.join(f'{x:.1f}' for x in sample_ms)} "
          f"ms; card vs CPU loss {errs['loss']:.2e}, grad norm "
          f"{errs['grad_norm']:.2e}, moments {errs['moment']:.2e}; step "
          f"{step_ms:.3f} ms ({', '.join(f'{x:.3f}' for x in ms)}), peak "
          f"{peak:.2f} GB, {rec['model_tflops']:.2f} model TFLOP/s; "
          f"{busy(prof)}; {rec['seconds']:.1f} s")
    del card, state, cbs, feats, sampler
    torch.cuda.empty_cache()
    return rec


def latency_ms(torch, fn, calls: int) -> list:
    """Host wall of ``calls`` calls of fn(), each synchronised, after a
    warm call; ms each."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def din_full_width(torch) -> dict:
    """DIN at full CONFIG (item table 10,485,760 x 18, 1,024 categories,
    seq_len 100): din_score at serve_p99 and one train step at batch 512
    with the full table, card against CPU from the same state; then on
    the card: train_batch (65,536) SUB_STEPS timed steps, serve_p99
    latency over 50 calls, serve_bulk (262,144) one forward, retrieval
    over RETRIEVAL_CUT candidates (checked against din_score on the same
    user and its first 512 candidates)."""
    import copy
    from functools import partial
    from repro_torch.configs import din as c_din
    from repro_torch.configs import registry as reg
    from repro_torch.models import din as din_mod
    t0 = time.perf_counter()
    cfg = c_din.CONFIG
    shapes = reg.DIN_SHAPES
    model_cpu = din_mod.init_din(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
    t_init = time.perf_counter() - t0
    serve = reg.click_batch(shapes["serve_p99"], cfg, device="cpu",
                            seed=SEED)
    serve_card = {k: v.to(CARD) for k, v in serve.items()}
    small = reg.click_batch(dict(kind="train", batch=512), cfg,
                            device="cpu", seed=SEED + 1)
    # din_score card against CPU, from the initial state
    card0 = copy.deepcopy(model_cpu).to(CARD)
    with torch.no_grad():
        want = din_mod.din_score(model_cpu, serve, cfg)
        got = din_mod.din_score(card0, serve_card, cfg)
    score_err = float((got.cpu() - want).abs().max())
    assert bool(torch.isfinite(got).all()) and score_err <= SUB_TOL["score"], \
        f"[15] din_score serve_p99 off by {score_err}"
    del card0, got
    step, out, old = step_both(torch, model_cpu,
                               partial(din_mod.din_loss, cfg=cfg), small)
    errs = hold_step("[15] din train step (batch 512, full table)", out,
                     old)
    card, state, _ = out[1]
    del out, model_cpu, old
    train = {k: v.to(CARD) for k, v in reg.click_batch(
        shapes["train_batch"], cfg, device="cpu", seed=SEED + 2).items()}
    step(card, state, train)          # warm
    ms, peak, prof = timed_steps(torch, step, card, state,
                                 [train] * SUB_STEPS)
    step_ms = float(np.mean(ms))
    train_flops = reg._din_flops(cfg, shapes["train_batch"]["batch"]) * 3
    del train
    torch.cuda.empty_cache()
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        lat = latency_ms(torch, lambda: din_mod.din_score(card, serve_card,
                                                          cfg), 50)
        serve_peak = torch.cuda.max_memory_allocated() / 2**30
        n_bulk = shapes["serve_bulk"]["batch"]
        bulk = {k: v.to(CARD) for k, v in reg.click_batch(
            shapes["serve_bulk"], cfg, device="cpu", seed=SEED + 3).items()}
        torch.cuda.reset_peak_memory_stats()
        bulk_ms = latency_ms(torch, lambda: din_mod.din_score(card, bulk,
                                                              cfg), 1)[0]
        bulk_peak = torch.cuda.max_memory_allocated() / 2**30
        out_b = din_mod.din_score(card, bulk, cfg)
        assert bool(((out_b >= 0) & (out_b <= 1)).all())
        del bulk, out_b
        torch.cuda.empty_cache()
        rinfo = dict(shapes["retrieval_cand"], n_cand=RETRIEVAL_CUT)
        rb = {k: v.to(CARD) for k, v in reg.click_batch(
            rinfo, cfg, device="cpu", seed=SEED + 4).items()}
        torch.cuda.reset_peak_memory_stats()
        r_ms = latency_ms(torch, lambda: din_mod.din_retrieval(card, rb, cfg),
                          1)[0]
        r_peak = torch.cuda.max_memory_allocated() / 2**30
        scores = din_mod.din_retrieval(card, rb, cfg)
        k = 512
        as_rows = {"target_item": rb["cand_items"][:k],
                   "target_cate": rb["cand_cates"][:k],
                   "hist_items": rb["hist_items"].expand(k, -1),
                   "hist_cates": rb["hist_cates"].expand(k, -1),
                   "hist_mask": rb["hist_mask"].expand(k, -1)}
        r_err = float((scores[:k] - din_mod.din_score(card, as_rows, cfg))
                      .abs().max())
        assert bool(torch.isfinite(scores).all()) and \
            r_err <= SUB_TOL["score"], f"[15] retrieval off by {r_err}"
        del rb, scores
    rec = {"init_s": t_init, "score_err": score_err, **errs,
           "train_ms": ms, "train_step_ms": step_ms, "train_peak_gb": peak,
           "train_model_tflops": train_flops / step_ms / 1e9,
           "train_profiled": prof,
           "serve_p50_ms": float(np.percentile(lat, 50)),
           "serve_p99_ms": float(np.percentile(lat, 99)),
           "serve_peak_gb": serve_peak,
           "bulk_ms": bulk_ms, "bulk_rows_per_s": n_bulk / bulk_ms * 1e3,
           "bulk_peak_gb": bulk_peak, "retrieval_ms": r_ms,
           "retrieval_cand_per_s": RETRIEVAL_CUT / r_ms * 1e3,
           "retrieval_peak_gb": r_peak, "retrieval_err": r_err,
           "seconds": time.perf_counter() - t0}
    print(f"[15] DIN full CONFIG (table {cfg.n_items} x {cfg.embed_dim}, "
          f"init on the host {t_init:.2f} s): din_score serve_p99 card vs "
          f"CPU {score_err:.2e}; train step at batch 512 card vs CPU loss "
          f"{errs['loss']:.2e}, grad norm {errs['grad_norm']:.2e}, moments "
          f"{errs['moment']:.2e}, params {errs['param']:.2e}; train_batch "
          f"{shapes['train_batch']['batch']}: {step_ms:.3f} ms a step "
          f"({', '.join(f'{x:.3f}' for x in ms)}), peak {peak:.2f} GB, "
          f"{rec['train_model_tflops']:.2f} model TFLOP/s, {busy(prof)}; "
          f"serve_p99 "
          f"({shapes['serve_p99']['batch']}) p50 {rec['serve_p50_ms']:.3f} "
          f"ms p99 {rec['serve_p99_ms']:.3f} ms over 50 calls, peak "
          f"{serve_peak:.2f} GB (the model and AdamW state resident); "
          f"serve_bulk "
          f"({n_bulk}) {bulk_ms:.2f} ms = {rec['bulk_rows_per_s']:.4g} rows/s"
          f", peak {bulk_peak:.2f} GB; retrieval {RETRIEVAL_CUT} candidates "
          f"(cut from 1,000,000) {r_ms:.2f} ms = "
          f"{rec['retrieval_cand_per_s']:.4g} candidates/s, peak "
          f"{r_peak:.2f} GB, equal to din_score within {r_err:.2e}; "
          f"{rec['seconds']:.1f} s")
    del card, state, serve_card
    torch.cuda.empty_cache()
    return rec


def substrate_path(torch) -> dict:
    """Phase 15: the GNN and recsys substrate at full width (module
    docstring)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    t0 = time.perf_counter()
    recs = gnn_full_width(torch, "full_graph_sm")
    recs += gnn_full_width(torch, "molecule")
    recs.append(reddit_minibatch(torch))
    din = din_full_width(torch)
    seconds = time.perf_counter() - t0
    print(f"[15] summary {json.dumps({'gnn': recs, 'din': din})}")
    print(f"[15] phase 15 in {seconds:.1f} s")
    return {"gnn": recs, "din": din, "seconds": seconds}


# ------------- phase 16: the LM substrate at published widths --
LM_ARCHS = ("qwen3-14b", "olmoe-1b-7b", "minicpm3-4b", "mistral-large-123b",
            "moonshot-v1-16b-a3b")
# card against CPU, both in the configs' bf16 compute (TF32 off): the bf16
# tolerances the CPU tests state (tests/_lm_ref.py, test_torch_cuda_lm.py)
LM_TOL = {"loss": 2e-3, "grad_norm": 1e-2, "logits": 3e-2}
LM_WIDTH_SEQ = 64          # (a): B = 1, S = 64, one layer
# (b): prefill B = 1 at S = 16,384 (cut from prefill_32k's 32 x 32,768:
# time; minicpm3-4b at 8,192, whose f32 MLA attention loop took 37.8 s at
# 16,384, to keep the script under 900 s) and decode_32k's capacity with
# the cache at 32,751 (B cut from 128: memory)
LM_SERVE = {"qwen3-14b": 4, "minicpm3-4b": 32, "olmoe-1b-7b": 8}
PREFILL_SEQ = {"qwen3-14b": 16_384, "minicpm3-4b": 8_192,
               "olmoe-1b-7b": 16_384}
DECODE_LEN = 32_751
DECODE_STEPS = 16
CHECK_PREFIX, CHECK_STEPS = 256, 8   # (b)'s consistency check, 2 layers
# (c): layers kept (cut to fit params, grads and both moments), seq 4,096,
# one sequence a microbatch (cut from train_4k's batch of 256)
LM_TRAIN = {"minicpm3-4b": 16, "olmoe-1b-7b": 4}
TRAIN_SEQ = 4096
# (d): the launcher's crash-and-resume cycle, a save every 10 steps (each
# copies the 1.4 GB of parameters and moments to the host); the resumed
# run against an uninterrupted one: losses rtol, the final checkpoint's
# leaves within this share of each leaf's largest entry (the card's
# embedding backward and cuBLAS may sum in another order between runs)
LAUNCH = dict(steps=30, fail_at=15, every=10)
LAUNCH_TOL = {"loss": 1e-4, "leaf": 1e-4}


def lm_batch(torch, cfg, B, S, seed, device, accum=1):
    """A TokenStream batch (pre-split into ``accum`` microbatches when
    accum > 1, as the train step takes it)."""
    from repro_torch.train import data as data_mod
    raw = data_mod.TokenStream(vocab_size=cfg.vocab_size, batch=B * accum,
                               seq_len=S, seed=seed).next_batch()
    out = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
    if accum > 1:
        out = {k: v.reshape((accum, B) + tuple(v.shape[1:]))
               for k, v in out.items()}
    return out


def lm_loss_and_norm(torch, model, cfg, batch):
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_mod
    loss, _ = tfm.lm_loss(model, batch, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    norm = opt_mod.global_norm(dict(enumerate(grads)))
    return float(loss.detach()), float(norm)


# (a)'s CPU side runs on a host thread with this many intra-op threads
# while (b) and (c) run: theirs is device-bound work (long kernels, the
# host far ahead), and the host keeps cores for its dispatch
CPU_REF_THREADS = 6


def lm_widths_start(torch) -> dict:
    """(a) Every LM arch at its CONFIG widths with one layer, B = 1, S =
    LM_WIDTH_SEQ: lm_loss and the global grad norm on the card now, and
    the port on the CPU from the same seeded weights (drawn on the card,
    copied to the CPU) on a host thread; ``lm_widths_finish`` holds one
    against the other."""
    import copy
    import dataclasses
    import threading
    from repro_torch.configs import registry as reg
    from repro_torch.models import transformer as tfm
    jobs = []
    for arch in LM_ARCHS:
        # one layer: mistral's sqrt remat (groups of 8) has groups of 1
        cfg = dataclasses.replace(reg.arch(arch).CONFIG, n_layers=1,
                                  remat_group=1)
        gen = torch.Generator(device=CARD).manual_seed(SEED)
        card = tfm.init_lm(cfg, gen, CARD)
        batch = lm_batch(torch, cfg, 1, LM_WIDTH_SEQ, SEED, "cpu")
        got = lm_loss_and_norm(torch, card, cfg,
                               {k: v.to(CARD) for k, v in batch.items()})
        jobs.append({"arch": arch, "cfg": cfg, "got": got, "batch": batch,
                     "params": sum(p.numel() for p in card.parameters()),
                     "cpu": copy.deepcopy(card).to("cpu")})
        del card
        torch.cuda.empty_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(min(CPU_REF_THREADS, threads))

    def work():
        for job in jobs:
            try:
                t = time.perf_counter()
                job["want"] = lm_loss_and_norm(torch, job.pop("cpu"),
                                               job["cfg"], job["batch"])
                job["cpu_s"] = time.perf_counter() - t
            except Exception as exc:    # re-raised by lm_widths_finish
                job["error"] = exc
                return

    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    return {"jobs": jobs, "worker": worker, "threads": threads}


def lm_widths_finish(torch, pending) -> list:
    pending["worker"].join()
    torch.set_num_threads(pending["threads"])
    recs = []
    for job in pending["jobs"]:
        if "error" in job:
            raise job["error"]
        arch, cfg, got, want = (job["arch"], job["cfg"], job["got"],
                                job["want"])
        errs = {k: abs(g - w) / abs(w)
                for k, g, w in zip(("loss", "grad_norm"), got, want)}
        assert np.isfinite(got).all(), f"[16a] {arch}: {got}"
        for k, e in errs.items():
            assert e <= LM_TOL[k], f"[16a] {arch}: {k} {got} vs CPU {want}"
        G = cfg.n_heads // cfg.n_kv_heads
        rec = {"arch": arch, "params": job["params"], "loss": got[0],
               "grad_norm": got[1], "cpu_loss": want[0],
               "cpu_grad_norm": want[1], "err": errs, "cpu_s": job["cpu_s"]}
        moe = (f", MoE {cfg.moe.n_experts} top {cfg.moe.top_k}"
               if cfg.moe else "")
        print(f"[16a] {arch} (d {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}, G {G}, {cfg.attn}{moe}"
              f", vocab {cfg.padded_vocab}), 1 layer, "
              f"{rec['params']:,} params: loss {got[0]:.6f} (CPU "
              f"{want[0]:.6f}, rel {errs['loss']:.2e}), grad norm "
              f"{got[1]:.6f} (CPU {want[1]:.6f}, rel "
              f"{errs['grad_norm']:.2e}); CPU step {job['cpu_s']:.1f} s "
              f"(on a host thread beside (b) and (c))")
        recs.append(rec)
    return recs


def record_routing(moe_mod, log: list):
    """Wraps ``moe.top_k`` so each call appends its chosen experts (the
    wrapper is removed by the caller)."""
    top_k = moe_mod.top_k

    def wrapped(probs, k):
        vals, idx = top_k(probs, k)
        log.append(idx.cpu())
        return vals, idx
    moe_mod.top_k = wrapped
    return top_k


def serve_check(torch, arch) -> dict:
    """(b)'s consistency check: full widths at 2 layers, bf16 weights: a
    prefill of CHECK_PREFIX tokens, then CHECK_STEPS decode steps, against
    lm_forward's logits on the whole sequence (LM_TOL["logits"] of the
    largest logit).  The MoE arch runs with a capacity that drops nothing
    (a decode step and the forward then route alike) and records each
    position's experts in both paths: MoE routing is discontinuous, so a
    position where a near-tied choice flipped between the one-token and
    the full-sequence arithmetic is counted and not held; at least half
    the positions must be held."""
    import dataclasses
    from repro_torch.configs import registry as reg
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(reg.arch(arch).CONFIG, n_layers=2)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    gen = torch.Generator(device=CARD).manual_seed(SEED + 1)
    model = tfm.init_lm(cfg, gen, CARD, dtype=torch.bfloat16)
    n = CHECK_PREFIX + CHECK_STEPS
    toks = lm_batch(torch, cfg, 1, n, SEED, CARD)["tokens"]
    fwd_log, dec_log = [], []
    orig = record_routing(moe_mod, fwd_log)
    try:
        with torch.no_grad():
            want, _ = tfm.lm_forward(model, toks, cfg)
        moe_mod.top_k = orig
        _, cache = tfm.prefill(model, toks[:, :CHECK_PREFIX], cfg, n)
        orig = record_routing(moe_mod, dec_log)
        got = []
        for s in range(CHECK_PREFIX, n):
            k0 = len(dec_log)
            logits, cache = tfm.decode_step(model, cache, toks[:, s], cfg)
            got.append((s, logits, dec_log[k0:]))
    finally:
        moe_mod.top_k = orig
    worst, flipped = 0.0, 0
    for s, logits, routed in got:
        if cfg.moe is not None:
            fwd = [fwd_log[i][s] for i in range(cfg.n_layers)]
            if any(not torch.equal(a[0], b) for a, b in zip(routed, fwd)):
                flipped += 1
                continue
        w = want[0, s].float()
        err = float((logits[0].float() - w).abs().max() / w.abs().max())
        worst = max(worst, err)
        assert err <= LM_TOL["logits"], \
            f"[16b] {arch}: decode at {s} off by {err:.3e} of the largest"
    assert flipped <= CHECK_STEPS // 2, f"[16b] {arch}: {flipped} flips"
    del model, cache
    torch.cuda.empty_cache()
    return {"worst": worst, "flipped": flipped}


def cache_fill(torch, cache, length: int, seed: int):
    """Fills the first ``length`` positions of a bf16 cache with N(0, 1)
    from a seeded generator on the card."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    for t in (cache.k, cache.v):
        for i in range(t.shape[0]):     # a layer at a time: no f32 copy
            t[i, :, :length] = torch.randn(
                t[i, :, :length].shape, generator=gen, device=CARD,
                dtype=torch.bfloat16)
    cache.length = length


def serve_full(torch, arch) -> dict:
    """(b) Serving at full CONFIG with bf16 weights (as the reference's
    serving programs cast them): prefill B = 1 at PREFILL_SEQ[arch], then
    decode_32k's cache (capacity 32,768) filled to DECODE_LEN and
    DECODE_STEPS timed steps after a warm one at batch LM_SERVE[arch];
    then the 2-layer consistency check."""
    from repro_torch.configs import registry as reg
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    cfg = reg.arch(arch).CONFIG
    B = LM_SERVE[arch]
    cap = reg.LM_SHAPES["decode_32k"]["seq"]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    model = tfm.init_lm(cfg, gen, CARD, dtype=torch.bfloat16)
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rec = {"arch": arch, "weights_gb": w_bytes / 1e9}
    # prefill: a short warm-up, then PREFILL_SEQ[arch] tokens once
    seq = PREFILL_SEQ[arch]
    tfm.prefill(model, lm_batch(torch, cfg, 1, 512, SEED, CARD)["tokens"],
                cfg, 512)
    toks = lm_batch(torch, cfg, 1, seq, SEED, CARD)["tokens"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = tfm.prefill(model, toks, cfg, seq)
    torch.cuda.synchronize()
    rec["prefill_s"] = time.perf_counter() - t
    assert bool(torch.isfinite(logits[0, -1].float()).all()), arch
    assert cache.length == seq
    rec["prefill_seq"] = seq
    rec["prefill_tok_s"] = seq / rec["prefill_s"]
    rec["prefill_tflops"] = cfg.model_flops(seq, train=False) \
        / rec["prefill_s"] / 1e12
    rec["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    del logits, cache
    torch.cuda.empty_cache()
    # decode at the 32k cache
    torch.cuda.reset_peak_memory_stats()
    cache = tfm.init_cache(cfg, B, cap, device=CARD)
    cache_fill(torch, cache, DECODE_LEN, SEED + 2)
    rec["cache_gb"] = (cache.k.numel() + cache.v.numel()) * 2 / 1e9
    step_toks = lm_batch(torch, cfg, B, DECODE_STEPS + 1, SEED + 3,
                         CARD)["tokens"]
    logits, cache = tfm.decode_step(model, cache, step_toks[:, 0], cfg)
    ms = []
    for s in range(1, DECODE_STEPS + 1):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        logits, cache = tfm.decode_step(model, cache, step_toks[:, s], cfg)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    assert cache.length == DECODE_LEN + DECODE_STEPS + 1
    assert bool(torch.isfinite(logits.float()).all()), arch
    p50 = float(np.median(ms))
    # bytes a step must move: every weight but the embedding table (B rows
    # of it), the valid cache read once, the new rows written
    per_tok = (cache.k[0, 0, 0].numel() + cache.v[0, 0, 0].numel()) * 2
    length = DECODE_LEN + DECODE_STEPS // 2
    emb = model.embed.numel() * 2
    nbytes = (w_bytes - emb + B * cfg.d_model * 2
              + cfg.n_layers * B * (length + 1) * per_tok)
    rec.update(decode_batch=B, decode_ms_p50=p50,
               decode_ms=[round(x, 3) for x in ms],
               decode_tok_s=B / (p50 / 1e3),
               decode_tflops=cfg.model_flops(B, train=False) / (p50 / 1e3)
               / 1e12,
               decode_bytes=nbytes,
               decode_hbm_share=nbytes / (p50 / 1e3) / HBM_BYTES_PER_S,
               decode_peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    del model, cache, logits
    torch.cuda.empty_cache()
    rec["check"] = serve_check(torch, arch)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[16b] {arch} bf16 weights {rec['weights_gb']:.2f} GB: prefill "
          f"1 x {seq} in {rec['prefill_s']:.3f} s "
          f"({rec['prefill_tok_s']:.0f} tokens/s, model "
          f"{rec['prefill_tflops']:.2f} TFLOP/s, peak "
          f"{rec['prefill_peak_gb']:.2f} GB); decode B {B} at "
          f"{DECODE_LEN} of {cap} (cache {rec['cache_gb']:.2f} GB): p50 "
          f"{p50:.3f} ms a step, {rec['decode_tok_s']:.1f} tokens/s, model "
          f"{rec['decode_tflops']:.3f} TFLOP/s, {nbytes / 1e9:.2f} GB a "
          f"step = {rec['decode_hbm_share']:.1%} of 3.35 TB/s, peak "
          f"{rec['decode_peak_gb']:.2f} GB; 2-layer prefill "
          f"{CHECK_PREFIX} + {CHECK_STEPS} decode steps equal lm_forward "
          f"within {rec['check']['worst']:.2e} of the largest logit "
          f"({rec['check']['flipped']} positions with a flipped route); "
          f"{rec['seconds']:.1f} s")
    return rec


def lm_timed_steps(torch, step, model, state, batches) -> tuple:
    """One step a batch, each between CUDA events; the last also under
    torch.profiler (CUDA activity: its device activities' sum against its
    wall; the steps take seconds, so the profiler's own cost is small).
    Returns (ms per step, peak GB, the profiled step's device and wall ms,
    the last step's metrics)."""
    from contextlib import nullcontext
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i, b in enumerate(batches):
        last = i == len(batches) - 1
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with (profile(activities=[ProfilerActivity.CUDA]) if last
              else nullcontext()) as prof:
            t = time.perf_counter()
            start.record()
            m = step(model, state, b)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        ms.append(start.elapsed_time(end))
    # the device activities' own durations (kernels, copies): the step
    # records ~10^5 of them, which key_averages() would take seconds to
    # group by name
    cuda = torch.autograd.DeviceType.CUDA
    dev = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda) / 1e6
    return (ms, torch.cuda.max_memory_allocated() / 2**30,
            {"device_ms": dev, "wall_ms": wall},
            {k: float(v) for k, v in m.items()})


def train_full(torch, arch) -> dict:
    """(c) Training at full widths, f32 master weights, AdamW, CONFIG's
    grad_accum with one sequence of TRAIN_SEQ a microbatch, at
    LM_TRAIN[arch] layers: a warm step, 2 timed (the second profiled)."""
    import dataclasses
    from functools import partial
    from repro_torch.configs import registry as reg
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import steps as steps_mod
    t0 = time.perf_counter()
    cfg = dataclasses.replace(reg.arch(arch).CONFIG,
                              n_layers=LM_TRAIN[arch])
    A = cfg.grad_accum
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    model = tfm.init_lm(cfg, gen, CARD)
    state = opt_mod.adamw_init(dict(model.named_parameters()))
    step = steps_mod.make_train_step(partial(tfm.lm_loss, cfg=cfg),
                                     opt_mod.AdamWConfig(), A)
    batches = [lm_batch(torch, cfg, 1, TRAIN_SEQ, SEED + i, CARD, A)
               for i in range(3)]
    m = step(model, state, batches[0])
    assert np.isfinite(float(m["loss"])) and \
        np.isfinite(float(m["grad_norm"])), f"[16c] {arch}: {m}"
    ms, peak, prof, m = lm_timed_steps(torch, step, model, state,
                                       batches[1:])
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]), arch
    tokens = A * TRAIN_SEQ
    mean = float(np.mean(ms))
    rec = {"arch": arch, "layers": cfg.n_layers, "grad_accum": A,
           "params": sum(p.numel() for p in model.parameters()),
           "ms": ms, "tok_s": tokens / (mean / 1e3),
           "tflops": cfg.model_flops(tokens) / (mean / 1e3) / 1e12,
           "peak_gb": peak, "loss": m["loss"], "grad_norm": m["grad_norm"],
           **prof}
    del model, state, batches
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    print(f"[16c] {arch} at {cfg.n_layers} layers "
          f"({rec['params']:,} params f32), {A} microbatches of 1 x "
          f"{TRAIN_SEQ}: {', '.join(f'{x:.1f}' for x in ms)} ms a step, "
          f"{rec['tok_s']:.0f} tokens/s, model {rec['tflops']:.2f} "
          f"TFLOP/s, peak {peak:.2f} GB, loss {m['loss']:.4f}, grad norm "
          f"{m['grad_norm']:.4f}; {busy(prof)}; {rec['seconds']:.1f} s")
    return rec


def launcher_cycle(torch) -> dict:
    """(d) ``python -m repro_torch.launch.train`` on the card: the 100m
    preset crashed at LAUNCH["fail_at"] (exit 17) and resumed (exit 0),
    against an uninterrupted run: the resumed steps' losses and the final
    checkpoint within LAUNCH_TOL."""
    import os
    import shutil
    import tempfile
    from repro_torch.train import checkpoint as ckpt_mod
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    procs = []

    def start(ckpt, *extra):
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen3-14b", "--preset", "100m", "--steps",
             str(LAUNCH["steps"]), "--ckpt-dir", str(tmp / ckpt),
             "--ckpt-every", str(LAUNCH["every"]), "--log-every", "1",
             "--device", CARD, *extra], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(p)
        return p

    def finish(p, rc):
        out, err = p.communicate(timeout=600)
        assert p.returncode == rc, (p.returncode, err[-3000:])
        return out, {int(ln.split()[2]): float(ln.split()[4])
                     for ln in out.splitlines()
                     if ln.startswith("[train] step ")}

    try:
        # the uninterrupted run beside the crashed one (two processes on
        # the card: their results do not depend on it, and the cycle's
        # wall is a check here, not a measurement)
        crashed, uninterrupted = (
            start("a", "--fail-at-step", str(LAUNCH["fail_at"])), start("b"))
        finish(crashed, 17)
        out, resumed = finish(start("a", "--resume"), 0)
        # the crash comes before its own step's save
        start_step = ((LAUNCH["fail_at"] - 1) // LAUNCH["every"]
                      * LAUNCH["every"])
        assert f"resumed from step {start_step}" in out, out
        _, whole = finish(uninterrupted, 0)
        assert sorted(resumed) == list(range(start_step + 1,
                                             LAUNCH["steps"] + 1))
        loss_err = max(abs(resumed[s] - whole[s]) / abs(whole[s])
                       for s in resumed)
        assert loss_err <= LAUNCH_TOL["loss"], f"[16d] losses {loss_err}"
        final = [ckpt_mod.load_leaves(str(tmp / d), LAUNCH["steps"])
                 for d in ("a", "b")]
        leaf_err = max(float(np.abs(x - y).max())
                       / max(float(np.abs(y).max()), 1e-30)
                       for x, y in zip(*final))
        assert leaf_err <= LAUNCH_TOL["leaf"], f"[16d] checkpoint {leaf_err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"loss_err": loss_err, "leaf_err": leaf_err,
           "final_loss": whole[LAUNCH["steps"]],
           "first_loss": whole[1], "leaves": len(final[0]),
           "seconds": time.perf_counter() - t0}
    print(f"[16d] launcher (qwen3-14b 100m preset) crashed at step "
          f"{LAUNCH['fail_at']} (exit 17), resumed from {start_step} (exit "
          f"0): losses {start_step + 1}..{LAUNCH['steps']} within "
          f"{loss_err:.2e} of "
          f"an uninterrupted run's, final checkpoint ({rec['leaves']} "
          f"leaves) within {leaf_err:.2e} of each leaf's largest entry; "
          f"loss {rec['first_loss']:.4f} -> {rec['final_loss']:.4f}; "
          f"{rec['seconds']:.1f} s")
    return rec


def attention_times(torch) -> dict:
    """(e) The port's flash forward at (b)'s qwen3 prefill shape (B = 1, S
    = PREFILL_SEQ["qwen3-14b"], 40 query / 8 kv heads, d 128, bf16 inputs)
    beside ``F.scaled_dot_product_attention`` on the same inputs (causal, GQA):
    printed only; neither is on a kernel path."""
    import torch.nn.functional as F
    from repro_torch.configs import registry as reg
    from repro_torch.models import flash
    cfg = reg.arch("qwen3-14b").CONFIG
    S, nq, nkv, D = (PREFILL_SEQ["qwen3-14b"], cfg.n_heads, cfg.n_kv_heads,
                     cfg.head_dim)
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    q, k, v = (torch.randn((1, S, h, D), generator=gen, device=CARD,
                           dtype=torch.bfloat16) for h in (nq, nkv, nkv))
    with torch.no_grad():
        ours = flash.flash_attention(q, k, v, True, cfg.block_k)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True).transpose(1, 2)
        err = float((ours.float() - lib.float()).abs().max())
        flash_ms = cuda_ms(torch, lambda: flash.flash_attention(
            q, k, v, True, cfg.block_k), 2)
        sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 5)
    # the scan computes every (query, key) pair in f32, masked or not
    scan_flop = 2.0 * S * S * nq * 2 * D
    causal_flop = scan_flop / 2
    rec = {"flash_ms": flash_ms, "sdpa_ms": sdpa_ms, "max_abs_diff": err,
           "flash_tflops": scan_flop / (flash_ms / 1e3) / 1e12,
           "sdpa_tflops": causal_flop / (sdpa_ms / 1e3) / 1e12}
    print(f"[16e] attention at qwen3's prefill shape (1 x {S}, {nq}/{nkv} "
          f"heads, d {D}, bf16 in): the port's flash forward (f32 scan, "
          f"block {cfg.block_k}) {flash_ms:.2f} ms ({rec['flash_tflops']:.1f}"
          f" TFLOP/s of the {scan_flop / 1e12:.1f} TFLOP it computes), "
          f"F.scaled_dot_product_attention {sdpa_ms:.2f} ms "
          f"({rec['sdpa_tflops']:.1f} TFLOP/s of the causal "
          f"{causal_flop / 1e12:.1f}); ratio {flash_ms / sdpa_ms:.1f}x; "
          f"outputs within {err:.2e}")
    del q, k, v, ours, lib
    torch.cuda.empty_cache()
    return rec


def lm_path(torch) -> dict:
    """Phase 16: the LM substrate at published widths (module
    docstring)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    t0 = time.perf_counter()
    pending = lm_widths_start(torch)
    rec = {"serve": [serve_full(torch, a) for a in LM_SERVE],
           "train": [train_full(torch, a) for a in LM_TRAIN]}
    rec["widths"] = lm_widths_finish(torch, pending)
    rec["launcher"] = launcher_cycle(torch)
    rec["attention"] = attention_times(torch)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[16] summary {json.dumps(rec)}")
    print(f"[16] phase 16 in {rec['seconds']:.1f} s")
    return rec


# ------------------ phase 17: the dry run, and the dry run against the card --
DRYRUN_OUT = ROOT / "build" / "dryrun"
DRYRUN_JOBS = 8          # worker processes of the dry run: the host's cores
CARD_SHARE = 0.8         # a cell runs on the card if its dry-run peak fits
CARD_REPEATS = 3         # timed runs after a warm one; the fastest is held


def dryrun_all() -> dict:
    """Phase 17(a): the dry run of every cell on both production meshes,
    on ``meta`` (one line a cell): every cell ok or SKIP.  Returns the
    single mesh's records by (arch, shape)."""
    import shutil
    from repro_torch.configs import registry as reg
    from repro_torch.launch import dryrun
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    t0 = time.perf_counter()
    rc = dryrun.main(["--all", "--mesh", "both", "--out", str(DRYRUN_OUT),
                      "--jobs", str(DRYRUN_JOBS)])
    cells = [c for c in reg.all_cells() if not c.skip]
    recs, bad = {}, []
    for mesh in dryrun.MESHES:
        for c in cells:
            path = DRYRUN_OUT / mesh / f"{c.arch}__{c.shape}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            if not (rec.get("ok") or rec.get("skipped")):
                bad.append(f"{mesh} {c.arch} {c.shape}: "
                           f"{rec.get('error', 'no record')[-2000:]}")
            if mesh == "single":
                recs[(c.arch, c.shape)] = rec
    if rc != 0 or bad:
        raise AssertionError(f"[17a] dry run failed (exit {rc}):\n"
                             + "\n".join(bad))
    print(f"[17a] {2 * len(cells)} records ok in "
          f"{time.perf_counter() - t0:.1f} s ({DRYRUN_JOBS} workers)")
    return recs


def card_cell(torch, cell, prog, meta_mesh) -> dict:
    """One cell on the card against its dry run on a meta (1, 1) mesh."""
    from repro_torch.configs import registry as reg
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report, trace_analysis as ta
    t0 = time.perf_counter()
    args = prog.fill(SEED)
    real = sum(ta.storages(args).values())
    fill_s = time.perf_counter() - t0
    sssp = prog.exchange is not None
    torch.cuda.synchronize()
    if sssp:      # the warm run, with its host reads kept for the trace
        res, reads = ta.record_reads(prog.fn, *args)
    else:
        res, reads = prog.fn(*args), None
    torch.cuda.synchronize()
    del res
    ms, above, rounds = [], [], None
    for _ in range(CARD_REPEATS):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = prog.fn(*args)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        above.append(torch.cuda.max_memory_allocated() - base)
        if sssp:
            rounds = res[2]
        del res
    mprog = reg.build_program(cell.arch, cell.shape, meta_mesh)
    traced = dryrun.trace_program(mprog, answers=reads)
    mem = dryrun.memory_record(mprog, traced)
    rf = report.roofline_from_trace(traced.cost, 1)
    label = f"[17b] {cell.arch} {cell.shape}"
    if mem["argument_bytes"] != real:
        raise AssertionError(f"{label}: predicted argument bytes "
                             f"{mem['argument_bytes']} != filled {real}")
    if sssp and traced.outputs[2] != rounds:
        raise AssertionError(f"{label}: the trace ran {traced.outputs[2]} "
                             f"rounds, the card {rounds}")
    best = min(ms) / 1e3
    if best < rf.bound_s:
        raise AssertionError(f"{label}: the card took {best:.6g} s under "
                             f"the bound {rf.bound_s:.6g} s: the count is "
                             f"wrong")
    rec = {"arch": cell.arch, "shape": cell.shape, "bound_s": rf.bound_s,
           "dominant": rf.dominant, "compute_s": rf.compute_s,
           "memory_s": rf.memory_s, "measured_s": best,
           "ms": ms, "share": rf.bound_s / best,
           "argument_bytes": real, "temp_bytes": mem["temp_bytes"],
           "peak_above_args": max(above),
           "predicted_peak_gb": mem["peak_per_device_gb"],
           "rounds": rounds, "fill_s": fill_s,
           "seconds": time.perf_counter() - t0}
    print(f"{label}: bound {rf.bound_s * 1e3:.4f} ms ({rf.dominant}; "
          f"compute {rf.compute_s * 1e3:.4f}, memory "
          f"{rf.memory_s * 1e3:.4f}), measured {best * 1e3:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in ms)}), roofline share "
          f"{rec['share']:.2%}; arguments {real} bytes = predicted; "
          f"peak above the arguments {max(above) / 2**30:.3f} GiB against "
          f"predicted temp {mem['temp_bytes'] / 2**30:.3f} GiB"
          + (f"; {rounds} rounds" if sssp else "")
          + f"; fill {fill_s:.1f} s, cell {rec['seconds']:.1f} s")
    return rec


def dryrun_on_card(torch, records) -> list:
    """Phase 17(b) (module docstring)."""
    from repro_torch.configs import registry as reg
    from repro_torch.launch.mesh import make_mesh
    cap = torch.cuda.get_device_properties(0).total_memory
    axes = ("data", "model")
    meta_mesh = make_mesh((1, 1), axes, devices=["meta"])
    card = make_mesh((1, 1), axes, devices=[torch.device("cuda", 0)])
    out = []
    for c in reg.all_cells():
        if c.skip:
            continue
        peak = records[(c.arch, c.shape)]["trace_cost"]["peak_live_bytes"]
        label = f"[17b] {c.arch} {c.shape}"
        if peak > CARD_SHARE * cap:
            print(f"{label}: left out: its dry-run peak on one device "
                  f"{peak / 2**30:.1f} GiB > {CARD_SHARE} x "
                  f"{cap / 2**30:.1f} GiB")
            continue
        prog = reg.build_program(c.arch, c.shape, card)
        if prog.fill is None:
            print(f"{label}: left out: the registry has no seeded fill of "
                  f"its inputs at this size (registry._GNN_FILLS)")
            continue
        torch.cuda.empty_cache()
        out.append(card_cell(torch, c, prog, meta_mesh))
        del prog
    torch.cuda.empty_cache()
    return out


def tools_path(torch) -> dict:
    """Phase 17: the dry run (a) and the dry run against the card (b)."""
    t0 = time.perf_counter()
    records = dryrun_all()
    cells = dryrun_on_card(torch, records)
    rec = {"cells": cells, "seconds": time.perf_counter() - t0}
    print(f"[17] summary {json.dumps(rec)}")
    print(f"[17] {card_line()}; phase 17 in {rec['seconds']:.1f} s")
    return rec


# ------------------------------------------ phase 7: the K4 and K5 paths --
DIN_ITEMS, DIN_DIM, DIN_SLOTS = 10 * 1024 * 1024, 18, 100   # configs/din.py


def minibatch_lg_block(rng):
    """GraphSAGE-Reddit ``minibatch_lg``'s aggregation block in the
    sampler's padded subgraph (``subgraph_capacity(1024, (15, 10))`` =
    169,984 slots): rows are the 1,024 seeds and their 15,360 hop-1 nodes.
    A seed's 15 cells point at distinct hop-1 slots, a hop-1 node's first
    10 at distinct hop-2 slots and its other 5 are masked -1s, in seeded
    random order.  Returns (slots, idx)."""
    b, (f1, f2) = 1024, (15, 10)
    hop1 = b * f1
    idx = np.full((b + hop1, f1), -1, np.int32)
    idx[:b] = (b + rng.permutation(hop1)).reshape(b, f1)
    idx[b:, :f2] = (b + hop1 + rng.permutation(hop1 * f2)).reshape(hop1, f2)
    return b * (1 + f1 + f1 * f2), idx


def din_bags(rng, bags: int):
    """DIN histories: lengths U[25, 100] (``train/data.py``'s recipe),
    item ids uniform over the table, -1 after each history."""
    idx = rng.integers(0, DIN_ITEMS, (bags, DIN_SLOTS)).astype(np.int32)
    lens = rng.integers(DIN_SLOTS // 4, DIN_SLOTS + 1, bags)
    idx[np.arange(DIN_SLOTS)[None, :] >= lens[:, None]] = -1
    return idx


def gather_shape(torch, label, fns, leaf, rest, live, agg, counters):
    """One phase-7 shape.  ``fns`` = (entry point, kernel wrapper, plain
    version).  The entry point runs forward and backward on the kernel
    route (``use_kernel=None``), every count in ``counters`` set to 0 just
    before and read just after, then on the plain route; outputs bit for
    bit, gradients within GRAD_RTOL of the largest entry.  Then the kernel,
    its plain version and ``F.embedding_bag`` over the live indices are
    timed with CUDA events, and the bound is counted on this run's data:
    the distinct live rows, the output, and for K4 the mask and the live
    cells' indices (a masked cell's index is not needed), for K5 every
    index (a padding slot is found by reading it).  Beside the
    back-to-back CUDA-event time: device time and host time per call, of
    the kernel and of ``F.embedding_bag``."""
    import torch.nn.functional as F
    entry, kernel, plain_fn = fns
    dt = "f32" if leaf.dtype == torch.float32 else "bf16"
    rows, width = live.shape[0], leaf.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    w = torch.randn((rows, width), generator=gen, device="cuda").to(leaf.dtype)
    for c in counters:
        c.launches = 0
    x = leaf.detach().requires_grad_(True)
    out = entry(x, *rest, agg)
    (g,) = torch.autograd.grad(out, x, w)
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    x = leaf.detach().requires_grad_(True)
    plain = entry(x, *rest, agg, False)
    (pg,) = torch.autograd.grad(plain, x, w)
    err = same_bits(torch, label, out, plain)
    scale = float(pg.float().abs().max())
    grad_err = float((g.float() - pg.float()).abs().max()) / scale
    assert grad_err <= GRAD_RTOL[dt], f"{label}: gradient off by {grad_err}"
    del x, out, g, plain, pg, w

    flat = rest[0][live].long()              # live indices, in row order
    offsets = torch.zeros(rows, dtype=torch.long, device="cuda")
    offsets[1:] = live.sum(1).cumsum(0)[:-1]
    run_kernel = lambda: kernel(leaf, *rest, agg=agg)   # noqa: E731
    run_library = lambda: F.embedding_bag(              # noqa: E731
        flat, leaf, offsets, mode=agg)
    ms = cuda_ms(torch, run_kernel, 20)
    plain_ms = cuda_ms(torch, lambda: plain_fn(leaf, *rest, agg=agg), 3)
    library_ms = cuda_ms(torch, run_library, 20)
    dev_ms, lib_dev_ms = device_ms(torch, run_kernel), device_ms(
        torch, run_library)
    h_us, lib_h_us = host_us(torch, run_kernel), host_us(torch, run_library)
    distinct = int(torch.unique(flat).numel())
    elt = leaf.element_size()
    index_bytes = (rest[1].numel() + 4 * flat.numel() if len(rest) == 2
                   else 4 * rest[0].numel())
    nbytes = distinct * width * elt + rows * width * elt + index_bytes
    ops = flat.numel() * width + (rows * width if agg == "mean" else 0)
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"[7] {label}: R={rows} K={live.shape[1]} width={width} "
          f"({flat.numel()} live cells, {distinct} distinct rows), {agg}: "
          f"{ms:.4f} ms back to back (plain {plain_ms:.4f} ms, "
          f"F.embedding_bag {library_ms:.4f} ms, bound {bound_ms:.4f} ms = "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s); device time per call "
          f"{dev_ms:.4f} ms (F.embedding_bag {lib_dev_ms:.4f} ms); host time "
          f"per call {h_us:.1f} us (F.embedding_bag {lib_h_us:.1f} us); "
          f"output bit-identical, gradient within {grad_err:.2e} of the "
          f"largest entry; launches {launches}")
    return launches, {"shape": label, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms, "device_ms": dev_ms,
                      "library_device_ms": lib_dev_ms, "host_us": h_us,
                      "library_host_us": lib_h_us, "max_abs_err": err,
                      "grad_rel_err": grad_err,
                      "live_cells": flat.numel(), "distinct_rows": distinct}


def gather_entry(name, source, replaces, shapes):
    """A ``kernels`` record: launches summed over the shapes, the largest
    error, the times of the first (headline) shape, and every shape's
    numbers."""
    head = shapes[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(x["launches"] for x in shapes),
            "max_abs_err": max(x["max_abs_err"] for x in shapes),
            **{k: head[k] for k in (
                "ms", "device_ms", "host_us", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
            "check": "bit-identical", "headline": head["shape"],
            "shapes": shapes}


def aggregation_path(torch):
    """Phase 7: ``neighbor_reduce`` (K4) at GraphSAGE-Reddit's widths and
    ``bag_lookup`` (K5) at DIN's, forward and backward."""
    from repro_torch.kernels.embed_bag.embed_bag import embedding_bag
    from repro_torch.kernels.embed_bag.ops import bag_lookup
    from repro_torch.kernels.embed_bag.ref import embedding_bag_ref
    from repro_torch.kernels.spmm.ops import neighbor_reduce
    from repro_torch.kernels.spmm.ref import spmm_ell_ref
    from repro_torch.kernels.spmm.spmm import spmm_ell
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    counters = [spmm_ell, embedding_bag]
    shapes = {0: [], 1: []}

    def run(which, label, leaf, rest, live, agg):
        fns = ((neighbor_reduce, spmm_ell, spmm_ell_ref) if which == 0 else
               (bag_lookup, embedding_bag, embedding_bag_ref))
        launches, rec = gather_shape(torch, label, fns, leaf, rest, live,
                                     agg, counters)
        assert launches[which] > 0 and launches[1 - which] == 0, \
            f"{label}: launches {launches}"
        shapes[which].append({**rec, "launches": launches[which]})

    s, idx = minibatch_lg_block(rng)
    idx = torch.from_numpy(idx).cuda()
    feats = torch.randn((s, 602), generator=gen, device="cuda")
    for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        run(0, f"K4 GraphSAGE-Reddit minibatch_lg {dt}", feats.to(dtype),
            (idx, idx >= 0), idx >= 0, "mean")
    # Reddit's nodes, the paper's sample size 25; neighbour ids uniform
    # over the nodes (a stand-in, as benchmarks/run.py draws them), so
    # rows are reused less from L2 than Reddit's skewed degrees would
    n = 232_965
    idx = torch.from_numpy(rng.integers(0, n, (n, 25)).astype(np.int32))
    idx = idx.cuda()
    feats = torch.randn((n, 128), generator=gen, device="cuda")
    live = torch.ones_like(idx, dtype=torch.bool)
    run(0, "K4 Reddit full-graph layer (uniform ids) f32", feats,
        (idx, live), live,
        "mean")
    del feats, idx, live
    table = torch.randn((DIN_ITEMS, DIN_DIM), generator=gen, device="cuda")
    for bags, shape in ((65_536, "train_batch"), (512, "serve_p99")):
        idx = torch.from_numpy(din_bags(rng, bags)).cuda()
        for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            run(1, f"K5 DIN {shape} {dt}", table.to(dtype), (idx,),
                idx >= 0, "sum")
    print(f"[7] phase 7 in {time.perf_counter() - t0:.1f} s")
    return [gather_entry(
                "spmm_ell", "src/repro_torch/kernels/spmm/csrc/spmm_ell.cu",
                "src/repro/kernels/spmm/spmm.py:55", shapes[0]),
            gather_entry(
                "embedding_bag",
                "src/repro_torch/kernels/embed_bag/csrc/embedding_bag.cu",
                "src/repro/kernels/embed_bag/embed_bag.py:49", shapes[1])]


STRAGGLER_BOUNDS = (1, 4)   # phase 18's max_rounds; the last one's
# sequence also runs on the plain versions, issue by issue (the first one's
# many one-wave issues would double the phase's time)


def straggler_layouts(torch, ctx) -> list:
    """Phase 18's layouts, built on the card from the streams phases 3, 4
    and 6 ran: the ER(20) stream's edges as a dense ELL block (K1), the
    RMAT(20) stream's as the sliced hybrid layout (K2), phase 6's base
    graph as the sparse frontier's OUT sidecar and pool (K3); each with its
    epoch ``run(state, frontier, kernel, **kw) -> (state, stats)``, its
    source and its 4 lanes (phase 9's on the streams, phase 6c's on the
    base)."""
    from repro_torch.core import frontier as frontier_mod
    from repro_torch.core.backends import ellpack, sliced
    from repro_torch.core.state import EdgePool
    from repro_torch.graphs import csr, generators
    from repro_torch.kernels.relax import fused, gather, relax

    def dev(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(CARD)
                for a in arrays]

    def adds(log):
        add = log.kind == 0
        return log.src[add], log.dst[add], log.w[add]

    out = []
    c = ctx["er"]
    src, dst, w = adds(c["log"])
    k = csr.next_pow2(int(np.bincount(dst, minlength=c["n"]).max()))
    idx, ww, _ = ellpack.EllPlanner(c["n"], init_k=k).rebuild_host(src, dst,
                                                                   w)
    idx, ww = dev(idx, ww)

    def ell_run(s, f, kernel, **kw):
        return ellpack.ell_relax_until_converged(s, idx, ww, f,
                                                 use_kernel=kernel, **kw)

    out.append(("K1", f"ER stream (n={c['n']}) as a dense ELL block",
                relax.ellpack_relax, c["n"],
                c["sources"], ell_run, f"{len(src)} edges, K={k}"))
    c = ctx["rmat"]
    src, dst, w = adds(c["log"])
    pl = sliced.SlicedEllPlanner(c["n"])
    st = sliced.SlicedEllState.from_host(pl, pl.rebuild_host(src, dst, w),
                                         CARD)

    def sliced_run(s, f, kernel, **kw):
        return sliced.sliced_relax_until_converged(
            s, st, f, num_vertices=pl.n, use_fused=kernel, **kw)

    out.append(("K2", f"RMAT stream (n={c['n']}) as the sliced layout",
                fused.fused_sliced_relax, c["n"],
                c["sources"], sliced_run,
                f"{len(src)} edges, {len(st.widths)} slices"))
    n, bs, bd, bw = ctx["sparse"]["graph"]
    side = frontier_mod.OutAdjacency(n, CARD)
    side.state = sliced.SlicedEllState.from_host(
        side.planner, side.planner.rebuild_host(bd, bs, bw), CARD,
        with_blocks=False)                       # rows are the sources
    pool = EdgePool(*dev(bs.astype(np.int32), bd.astype(np.int32),
                         bw.astype(np.float32), np.ones(len(bs), bool)))
    caps = frontier_mod.capacity_ladder(n)

    def sparse_run(s, f, kernel, **kw):
        return frontier_mod.sparse_relax_until_converged(
            s, pool, side.state, f, num_vertices=n, caps=caps,
            use_kernel=kernel, **kw)[:2]

    top = [int(v) for v in generators.top_in_degree_sources(n, bd, LANES)]
    out.append(("K3", f"phase 6's base (n={n}), sparse",
                gather.gathered_rows_relax, n, [0, *[v for v in top if v != 0][:LANES - 1]], sparse_run,
                f"{len(bs)} edges, ladder {caps}"))
    return out


def straggler_path(torch, ctx) -> dict:
    """Phase 18: the straggler bound.  On each of ``straggler_layouts``,
    for one source and for its 4 lanes (the lane forms): the first ADD
    epoch from the source(s) over the whole edge set, unbounded, then with
    ``max_rounds`` 1 and 4 re-issued with ``dist < dist before`` as the
    frontier until nothing improves: at most ``max_rounds`` waves an
    issue, more than one issue, and the sequence's end bit-identical to
    the unbounded epoch; under the last bound every issue on the kernel
    also against the same issue on the plain versions (``use_kernel=
    False``; K2's plain composition), bit for bit.  The kernels' counts are set to 0 just before each kernel
    sequence and read just after (the plain runs must launch none).
    Returns each kernel's ``bounded`` record."""
    from repro_torch.core.state import SSSPState
    t0 = time.perf_counter()
    layouts = straggler_layouts(torch, ctx)
    print(f"[18] layouts built in {time.perf_counter() - t0:.1f} s: "
          + "; ".join(f"{name} {label} ({what})"
                      for name, label, _, _, _, _, what in layouts))
    records = {}
    for name, label, kfn, n, sources, run, _ in layouts:
        rec = {"launches": 0, "max_rounds": {}}
        for lanes in (1, LANES):
            srcs = tuple(sources[:lanes])
            s0 = (SSSPState.init(n, srcs[0], CARD) if lanes == 1
                  else SSSPState.init_batched(n, srcs, CARD))
            f0 = torch.zeros(n, dtype=torch.bool, device=CARD)
            f0[list(srcs)] = True
            want, wst = run(s0, f0, True)
            for bound_ in STRAGGLER_BOUNDS:
                s, f, issues, waves = s0, f0, 0, 0
                kfn.launches = kfn.lane_launches = 0
                while True:
                    got, st = run(s, f, True, max_rounds=bound_)
                    if bound_ == STRAGGLER_BOUNDS[-1]:
                        counted = kfn.launches + kfn.lane_launches
                        plain, pst = run(s, f, False, max_rounds=bound_)
                        assert kfn.launches + kfn.lane_launches == counted, \
                            f"[18] {name}: the plain version launched"
                        same = (torch.equal(got.dist, plain.dist)
                                and torch.equal(got.parent, plain.parent)
                                and torch.equal(st.messages, pst.messages)
                                and np.array_equal(st.rounds, pst.rounds))
                        assert same, f"[18] {name} S={lanes} max_rounds=" \
                            f"{bound_}: issue {issues} differs from the plain"
                    assert np.max(st.rounds) <= bound_
                    issues += 1
                    waves += int(np.max(st.rounds))
                    improved = got.dist < s.dist
                    s = got
                    if not bool(improved.any()):
                        break
                    f = improved
                assert issues > 1, f"[18] {name}: the bound never bit"
                assert torch.equal(s.dist, want.dist) and torch.equal(
                    s.parent, want.parent), \
                    f"[18] {name} S={lanes} max_rounds={bound_}: the " \
                    f"re-issued epochs differ from the unbounded one"
                # K1's and K2's lane forms count into both counters
                launches = kfn.lane_launches if lanes > 1 else kfn.launches
                assert launches > 0, f"[18] {name}: no launch"
                rec["launches"] += launches
                rec["max_rounds"][f"S{lanes}_{bound_}"] = dict(
                    issues=issues, waves=waves, launches=launches,
                    unbounded_waves=int(np.max(wst.rounds)))
        records[name] = rec
        print(f"[18] {name} {label}: one source and S = {LANES} lanes, "
              f"max_rounds {STRAGGLER_BOUNDS} re-issued bit-identical to the "
              f"unbounded epoch, and under {STRAGGLER_BOUNDS[-1]} to the "
              f"plain versions at every issue; "
              + ", ".join(f"{k}: {v['issues']} issues, {v['waves']} waves "
                          f"(unbounded {v['unbounded_waves']}), {name} "
                          f"launches {v['launches']}"
                          for k, v in rec["max_rounds"].items()))
    print(f"[18] phase 18 in {time.perf_counter() - t0:.1f} s")
    return records


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.embed_bag import embed_bag
    from repro_torch.kernels.relax import fused, gather, relax
    from repro_torch.kernels.spmm import spmm

    # ---- 1. card, build
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    for b in build.load_all([relax.SOURCE, fused.SOURCE, gather.SOURCE,
                             spmm.SOURCE, embed_bag.SOURCE]):
        regs = [ln.split(":")[-1].strip() for ln in b.log.splitlines()
                if "registers" in ln]
        print(f"[1] {b.path.name}: nvcc {b.seconds:.2f} s; ptxas {regs}")
    print(f"[1] all kernels built in {time.perf_counter() - t0:.2f} s")
    # ---- 2. kernels vs plain versions at edge cases
    kernel_edge_cases(torch)

    # ---- 3.-6. the paths, each with its kernels' counts
    ctx = {}
    kernels = [dense_ell_path(torch, ctx), hub_path(torch, ctx)]
    hub_cross_check(torch)
    kernels.append(sparse_path(torch, ctx))
    sparse_cross_check(torch)
    kernels[2]["lanes"] = sparse_lanes_path(torch, ctx)

    # ---- 8.-10. the bucketed schedule and batched lanes
    buckets_legs(torch, ctx)
    k1_lanes, k2_lanes = lanes_legs(torch, ctx)
    kernels[0]["lanes"], kernels[1]["lanes"] = k1_lanes, k2_lanes
    kernels[2]["lanes"]["cross_check_launches"] = lanes_cross_check(torch)

    # ---- 18. the straggler bound on K1, K2 and K3
    bounded = straggler_path(torch, ctx)
    for k, name in zip(kernels, ("K1", "K2", "K3")):
        k["bounded"] = bounded[name]

    # ---- 12. the serving path with observability
    served = serving_legs(torch, ctx)
    for k in kernels:
        k["serving_launches"] = served[k["name"]]

    # ---- 13. the sharded engine, SHARDS partitions on the card
    t13 = time.perf_counter()
    sharded = sharded_full_width(torch, ctx)
    sharded.update(sharded_cross_checks(torch))
    kernels[0]["sharded_launches"] = sharded["launches"]
    kernels[0]["sharded"] = sharded
    print(f"[13] phase 13 in {time.perf_counter() - t13:.1f} s")

    # ---- 14. the sharded lanes and the paper's baselines
    t14 = time.perf_counter()
    lanes, lane0 = sharded_lanes_full_width(torch, ctx)
    lanes.update(baselines_full_width(torch, ctx["er"], lane0,
                                      lanes["query_p50_ms"]))
    del ctx, lane0
    lanes.update(sharded_lanes_cross_checks(torch))
    kernels[0]["sharded_lanes"] = lanes
    print(f"[14] phase 14 in {time.perf_counter() - t14:.1f} s")

    # ---- 15. the GNN and recsys substrate at full width (no kernel)
    substrate_path(torch)

    # ---- 16. the LM substrate at published widths (no kernel)
    lm_path(torch)

    # ---- 17. the dry run, and the dry run against the card (no kernel)
    tools_path(torch)

    # ---- 7. the neighbour-aggregation and embedding-bag entry points
    kernels.extend(aggregation_path(torch))

    # ---- 11. result lines
    print(f"[11] the whole script in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
