#!/usr/bin/env python3
"""Time the sparse frontier's epochs, one source against S = 4 lanes, on
one NVIDIA GPU, so that two versions of the port can be compared in one
call of the card.

    PYTHONPATH=src python3 bench_sparse_lanes.py TAG   # from a tree's root

It builds ``chip_smoke.py``'s localized stream at 2^20 (``rmat(20, 4,
seed=11)`` as the base, then 48 batches of 8 fresh edges in a 1k window)
and, twice in turns, a single-source engine (source 0) and a 4-lane one
(``sources=`` vertex 0 and the three other vertices of highest in-degree
in the base), both ``frontier_mode="sparse"`` with the card's default
kernels.  After each engine's untimed base ingest it times the first 36
batches (host wall over a synchronised run: ms an epoch, and the waves)
and runs the last 12 under torch.profiler (CPU and CUDA activity: the
device time of those epochs and its largest ops).  It prints one line a
run and then ``BENCH {json}``.  To compare a parent commit, unpack it
into a git-ignored directory and run both in one call of the card, in
turns: parent, change, change, parent.
"""
import json
import os
import sys
import time

import numpy as np


def main(tag: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("bench_sparse_lanes.py: needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import repro_torch
    from repro_torch.core import events as ev
    from repro_torch.graphs import generators

    n, bs, bd, bw = generators.rmat(20, 4, seed=11)
    top = [int(v) for v in generators.top_in_degree_sources(n, bd, 4)]
    lanes = (0, *[v for v in top if v != 0][:3])
    batches = cs.localized_batches(n)
    cap = len(bs) + 8 * 48 + 64
    out = {"tag": tag, "card": cs.card_line(), "sources": lanes, "runs": []}
    for label, kw in (("single", {}), ("lanes", dict(sources=lanes))) * 2:
        eng = repro_torch.make_engine(num_vertices=n, edge_capacity=cap,
                                      source=0, frontier_mode="sparse", **kw)
        eng.ingest_log(ev.adds(bs, bd, bw))
        torch.cuda.synchronize()
        r0 = np.asarray(eng.n_rounds).copy()
        t0 = time.perf_counter()
        eng.ingest_log(batches[:36])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        waves = (np.asarray(eng.n_rounds) - r0).tolist()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.ingest_log(batches[36:])
            torch.cuda.synchronize()
        ka = prof.key_averages()
        dev_ms = sum(x.self_device_time_total for x in ka) / 1e3
        top_ops = sorted(ka, key=lambda x: -x.self_device_time_total)[:5]
        run = {"engine": label, "epoch_ms": wall / 36 * 1e3, "waves": waves,
               "device_ms_12_epochs": dev_ms,
               "top_device_ms": {x.key[:48]: x.self_device_time_total / 1e3
                                 for x in top_ops}}
        out["runs"].append(run)
        print(f"[{tag}] {label}: {run['epoch_ms']:.2f} ms an epoch over 36 "
              f"epochs, waves {waves}; 12 profiled epochs {dev_ms:.2f} ms "
              f"device; top " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in run["top_device_ms"].items()))
        del eng
    print("BENCH " + json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
