#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit; build kernel K1 (``ellpack_relax``)
     from the repository's CUDA source with nvcc, print the build time;
  2. K1 against its plain torch version on the card, bit for bit, at edge
     cases (K = 1, non-power-of-two K, K > 32, +inf rows, weight ties) and
     at the main path's shape;
  3. the main path: ``repro_torch.make_engine(relax_backend="ellpack",
     batch_deletions=True)`` over the ER sliding-window ADD/DEL/QUERY
     stream at 2^20 vertices and 2^23 edges (queries every window/10),
     with K1's launch counter reset just before and read just after; the
     final snapshot is checked against scipy's Dijkstra on the allocator's
     live edges (check_tree's tolerances) plus a vectorized parent-tightness
     check; K1 and its plain version are then timed on the final ELL block,
     the host control plane is timed alone, and the run is repeated under
     torch.profiler for its device time;
  4. the same recipe at 2^16 vertices twice, with K1 and with the plain
     version: identical (dist, parent, stats) at every query;
  5. the card line, a JSON ``kernels`` line, and as the last line
     ``{"ok": true, "device": {...}}``.

It exits non-zero before printing any result when torch sees no CUDA
device.  It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 7
EDGE_FACTOR = 8          # examples/streaming_sssp.py's RMAT edge factor
WINDOW_FRAC, DELTA = 0.3, 0.3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def stream(log2_n: int):
    """The main-path recipe at 2^log2_n vertices: ER graph with edge factor
    8, sliding window 0.3·E with delta 0.3, a QUERY every window/10."""
    from repro_torch.core import events as ev
    from repro_torch.graphs import generators, window as win
    n = 1 << log2_n
    n, src, dst, w = generators.erdos_renyi(n, EDGE_FACTOR * n, seed=SEED)
    window = int(len(src) * WINDOW_FRAC)
    log = win.sliding_window_stream(src, dst, w, window=window, delta=DELTA,
                                    seed=0)
    log = ev.interleave_queries(log, window // 10)
    source = int(generators.top_in_degree_sources(n, dst)[0])
    return n, len(src), source, log


def engine(n: int, e: int, source: int, **knobs):
    import repro_torch
    return repro_torch.make_engine(
        num_vertices=n, edge_capacity=int(1.3 * e) + 64, source=source,
        relax_backend="ellpack", batch_deletions=True, **knobs)


def control_plane_seconds(n: int, e: int, log) -> float:
    """The host control plane alone: the same runs through a fresh slot
    allocator and ELL planner (numpy, no device work), grouped as the
    engine groups them under batch_deletions=True."""
    from repro_torch.core import events as ev
    from repro_torch.core import ingest
    from repro_torch.core.backends.ellpack import EllPlanner
    alloc = ingest.make_allocator(int(1.3 * e) + 64)
    planner = EllPlanner(n)
    t0 = time.perf_counter()
    for batch in log.runs():
        if batch.kind == ev.ADD:
            plan = alloc.plan_adds(batch.src, batch.dst, batch.w)
            if planner.plan_appends(plan.dst[plan.fresh]) is None:
                planner.rebuild_host(*alloc.active_coo())
        elif batch.kind == ev.DEL:
            alloc.plan_dels(batch.src, batch.dst)
    return time.perf_counter() - t0


def device_profile(torch, n: int, e: int, source: int, log):
    """The main path driven again under torch.profiler (CUDA activity
    only): total device time in seconds and the top device ops as
    (name, seconds, count).  Device work is the same as in the timed run;
    the profiler only slows the host."""
    from torch.profiler import ProfilerActivity, profile
    eng = engine(n, e, source)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.ingest_log(log)
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda x: -x.self_device_time_total)
    total = sum(x.self_device_time_total for x in ops) / 1e6
    return total, [(x.key[:48], x.self_device_time_total / 1e6, x.count)
                   for x in ops[:5]]


def k1_case(torch, seed: int, n: int, rows: int, k: int, ties: bool):
    g = torch.Generator().manual_seed(seed)
    if ties:
        offers = torch.randint(0, 4, (n,), generator=g).float()
        w = torch.randint(1, 4, (rows, k), generator=g).float()
    else:
        offers = 4 * torch.rand(n, generator=g)
        w = 0.5 + 1.5 * torch.rand(rows, k, generator=g)
    offers[torch.rand(n, generator=g) < 0.3] = float("inf")
    idx = torch.randint(0, n, (rows, k), generator=g, dtype=torch.int32)
    w[torch.rand(rows, k, generator=g) < 0.2] = float("inf")
    w[0] = float("inf")                      # an all-tombstone row
    return [t.cuda() for t in (offers, idx, w)]


def k1_compare(torch, kernel, ref, offers, idx, w) -> float:
    """Kernel vs plain version on the same inputs: +inf pattern and arg
    must be equal, returns max |best difference| (must be 0)."""
    kb, ka = kernel(offers, idx, w)
    rb, ra = ref(offers, idx, w)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(kb), torch.isinf(rb)), "K1 +inf pattern"
    assert torch.equal(ka, ra), "K1 arg differs from the plain version"
    fin = torch.isfinite(rb)
    err = float((kb[fin] - rb[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert err == 0.0, f"K1 best differs by {err}"
    return err


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


def snapshot_check(n, source, src, dst, w, dist, parent, atol=1e-4):
    """check_tree's contract, vectorized: distances within (atol, rtol
    1e-5) of an f64 Dijkstra; every reached non-source vertex's parent edge
    exists and is tight; unreached vertices have no parent."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    g = csr_matrix((w.astype(np.float64), (src, dst)), shape=(n, n))
    ref = dijkstra(g, directed=True, indices=source)
    got = dist.astype(np.float64)
    big = lambda x: np.where(np.isinf(x), 1e30, x)   # noqa: E731
    assert np.allclose(big(ref), big(got), atol=atol, rtol=1e-5), \
        "dist differs from Dijkstra"
    reached = np.isfinite(ref)
    v = np.nonzero(reached & (np.arange(n) != source))[0]
    assert (parent[~reached] == -1).all(), "unreached vertex has a parent"
    p = parent[v].astype(np.int64)
    assert (p >= 0).all(), "reached vertex lacks a parent"
    keys = (src.astype(np.int64) << 32) | dst.astype(np.int64)
    order = np.argsort(keys)
    want = (p << 32) | v
    pos = np.clip(np.searchsorted(keys[order], want), 0, len(keys) - 1)
    assert (keys[order][pos] == want).all(), "parent edge not in the graph"
    wt = w[order][pos].astype(np.float64)
    slack = np.abs(got[p] + wt - got[v])
    assert (slack < np.maximum(atol, 1e-5 * np.maximum(1.0, np.abs(got[v])))
            ).all(), "tree edge not tight"
    return int(reached.sum())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.relax import relax as k1
    from repro_torch.kernels.relax.ref import ellpack_relax_ref

    # ---- 1. card, build
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    built = k1.load()
    regs = [ln.strip() for ln in built.log.splitlines() if "registers" in ln]
    print(f"[1] K1 built in {built.seconds:.2f} s -> {built.path.name}; "
          f"ptxas: {regs[:1]}")

    # ---- 2. K1 vs plain version at edge cases and the main shape
    cases = [(50, 8, 1), (300, 256, 3), (5000, 4096, 8), (5000, 4096, 17),
             (64, 256, 32), (70000, 65536, 33), (1000, 512, 40),
             (1 << 20, 1 << 20, 32)]
    for i, (n, rows, k) in enumerate(cases):
        for ties in (False, True):
            k1_compare(torch, k1.ellpack_relax, ellpack_relax_ref,
                       *k1_case(torch, i, n, rows, k, ties))
    print(f"[2] K1 bit-identical to the plain version on {2 * len(cases)} "
          f"cases (K in {sorted({c[2] for c in cases})})")

    # ---- 3. the main path at 2^20 vertices / 2^23 edges
    t0 = time.perf_counter()
    n, e, source, log = stream(20)
    n_topo = int((log.kind != 2).sum())
    n_dels = int((log.kind == 1).sum())
    print(f"[3] stream: n={n} edges={e} events={len(log)} (topology "
          f"{n_topo}, dels {n_dels}) source={source}; built in "
          f"{time.perf_counter() - t0:.1f} s")
    eng = engine(n, e, source)
    lat: list[float] = []
    k1.ellpack_relax.launches = 0
    t0 = time.perf_counter()
    eng.ingest_log(log, on_query=lambda r: lat.append(r.latency_s))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.ellpack_relax.launches
    assert launches > 0, "the main path never launched K1"
    ell = eng.backend.state
    print(f"[3] main path: {wall:.2f} s, {n_topo / wall:.0f} topology "
          f"events/s, {len(lat)} queries, query p50 "
          f"{np.median(lat) * 1e3:.3f} ms, epochs {eng.n_epochs}, waves "
          f"{eng.n_rounds}, messages {eng.n_messages}, K={ell.k} "
          f"(rows {ell.rows}, rebuilds {eng.backend.planner.rebuilds}), "
          f"K1 launches {launches}")
    q = eng.query()
    reached = snapshot_check(n, source, *eng.alloc.active_coo(), q.dist,
                             q.parent)
    print(f"[3] final snapshot passes the Dijkstra check ({reached} reached)")

    # per-wave host sync: one bool(frontier.any()) read per wave
    f = torch.rand(n, device="cuda") < 0.01
    for _ in range(10):
        bool(f.any())
    t1 = time.perf_counter()
    for _ in range(200):
        bool(f.any())
    sync_us = (time.perf_counter() - t1) / 200 * 1e6
    print(f"[3] host sync bool(frontier.any()) at N={n}: {sync_us:.1f} us; "
          f"x {eng.n_rounds} waves = {sync_us * eng.n_rounds / 1e6:.3f} s "
          f"of the {wall:.2f} s run")

    # K1 at the main path's final shapes: offers = final distances
    offers = eng.state.sssp.dist
    nbr_idx, nbr_w = ell.nbr_idx, ell.nbr_w
    err = k1_compare(torch, k1.ellpack_relax, ellpack_relax_ref, offers,
                     nbr_idx, nbr_w)
    ms = cuda_ms(torch, lambda: k1.ellpack_relax(offers, nbr_idx, nbr_w), 50)
    plain_ms = cuda_ms(torch, lambda: ellpack_relax_ref(offers, nbr_idx,
                                                        nbr_w), 10)
    rows, k = nbr_idx.shape
    nbytes = offers.numel() * 4 + rows * k * 8 + rows * 8
    ops = 2 * rows * k
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[3] K1 at R={rows} K={k} N={offers.numel()}: {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s); K1 device time on the "
          f"main path ~ {launches * ms / 1e3:.2f} s of {wall:.2f} s")
    del eng, offers, nbr_idx, nbr_w, ell
    host_s = control_plane_seconds(n, e, log)
    print(f"[3] host control plane alone (allocator + ELL planner, numpy): "
          f"{host_s:.2f} s of the {wall:.2f} s run")
    dev_s, top = device_profile(torch, n, e, source, log)
    print(f"[3] device time (profiled re-run): {dev_s:.3f} s = "
          f"{100 * dev_s / wall:.1f} % of the {wall:.2f} s run; top: "
          + "; ".join(f"{name} {sec:.3f} s x{cnt}" for name, sec, cnt in top))

    # ---- 4. kernel vs plain engines at 2^16, identical at every query
    n, e, source, log = stream(16)
    runs = {}
    for use_kernel in (True, False):
        k1.ellpack_relax.launches = 0
        eng = engine(n, e, source, ell_use_kernel=use_kernel)
        runs[use_kernel] = (eng.ingest_log(log), k1.ellpack_relax.launches)
    (res_k, l_k), (res_p, l_p) = runs[True], runs[False]
    assert l_k > 0 and l_p == 0, (l_k, l_p)
    assert len(res_k) == len(res_p) > 0
    for a, b in zip(res_k, res_p):
        assert np.array_equal(a.dist, b.dist), "kernel/plain dist differ"
        assert np.array_equal(a.parent, b.parent), "kernel/plain parent differ"
        assert a.epoch_stats == b.epoch_stats, "kernel/plain stats differ"
    print(f"[4] n={n}: kernel and plain engines identical at all "
          f"{len(res_k)} queries (K1 launches {l_k}; stats "
          f"{res_k[-1].epoch_stats})")

    # ---- 5. result lines
    kernels = [{
        "name": "ellpack_relax", "route": "cuda",
        "source": "src/repro_torch/kernels/relax/csrc/ellpack_relax.cu",
        "replaces": "src/repro/kernels/relax/relax.py:49",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "check": "bit-identical",
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
