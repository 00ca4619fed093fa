"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed one precision below the
configuration's float32 (bfloat16), judged by the same comparison as a
run's answers.  It has to come out not correct.

    python3 portbench/control.py --workload kron20.micro4k --seeds 11,12,13

For each seed it makes the cell's graph and stream at the cell's own size,
takes the answers a run checks (``harness.CHECK_SAMPLE`` query points
spread over ``--batches`` batches after the warm-up, each lane of the
traffic in turn, and every lane at the last point) and prints, per seed,
what the comparison reads for the control and, as a witness, for the
float32 reference itself (0 and 0).  The benchmark's own runs never run
it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def answer_points(strm, traffic: dict, batches: int, k: int) -> list[int]:
    """``k`` stream positions after whole batches, spread over the first
    ``batches`` batches past the warm-up, and the last of them."""
    import numpy as np
    per = int(traffic["batch_events"])
    first = strm.base + per * int(traffic["warmup_batches"])
    last = min(batches, (len(strm) - first) // per)
    steps = np.unique(np.linspace(1, last, k + 1).astype(np.int64))
    return [first + per * int(s) for s in steps]


def readings(config: dict, traffic: dict, seed: int, device: str,
             batches: int) -> dict:
    import torch
    from portbench import graphs, harness, reference, stream
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    strm = stream.sliding_window(graphs.generate(config, gen), traffic, gen)
    lanes = int(traffic["lanes"])
    sources = harness.top_sources(strm, lanes, "instance_seed" in config)
    points = answer_points(strm, traffic, batches, harness.CHECK_SAMPLE)
    asked = [(p, sources[i % lanes]) for i, p in enumerate(points[:-1])]
    asked += [(points[-1], s) for s in sources]
    out = {"control": {"dist_wrong": 0, "parent_wrong": 0},
           "reference": {"dist_wrong": 0, "parent_wrong": 0},
           "answers": len(asked)}
    n = strm.edges.n
    for p, s in asked:
        arcs = strm.live_arcs(p)
        ref_dist, ref_parent = reference.bellman_ford(n, *arcs, s)
        low = reference.bellman_ford(n, *arcs, s, dtype=torch.bfloat16)
        for name, (d, par) in (("control", low),
                               ("reference", (ref_dist, ref_parent))):
            got = reference.judge(n, arcs, s, d.cpu().numpy(),
                                  par.cpu().numpy(), ref_dist=ref_dist)
            for key, val in got.items():
                out[name][key] += val
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=1000,
                    help="batches a run's window reaches")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("error: the control runs on the card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(cell["config"], cell["traffic"], seed, "cuda",
                       args.batches)
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
