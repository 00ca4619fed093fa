#!/usr/bin/env python3
"""Time kernels K1 and K2, single-lane and lane forms, at path-like shapes
on one NVIDIA GPU, so that two versions of the port can be compared in
one call of the card.

    PYTHONPATH=src python3 bench_lane_forms.py TAG     # from a tree's root

It runs ``chip_smoke.py``'s ER and RMAT(20) streams (2^20 vertices) to
their BENCH_QUERIES-th query (11 by default) with 4 lanes (``sources=``
the top in-degree vertices) — dense ELL (K1) and ``auto`` (K2) — holds
each lane form against single-lane calls on the final state, then prints
one line ``BENCH {json}`` of device times per call in ms (20 calls
captured in a CUDA graph and replayed, ``chip_smoke.device_ms``): K1
single-lane and at S = 4, 8, 16 on the final ELL block and at S = 4 on its
first 131,072 rows (one partition's block of an 8-way mesh); K2
single-lane and at S = 4, 8 on the final sliced layout with every source
active, with its per-launch split (torch.profiler).  Where the tree has
the lane-minor interleave (``relax.lane_minor``) it also times that, and
K1 on a copy made beforehand (``offers_minor=``).  To compare a parent
commit, unpack it into a git-ignored directory and run both in one call
of the card, in turns: parent, change, change, parent.
"""
import json
import os
import sys

import numpy as np


def main(tag: str) -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_lane_forms.py: needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from repro_torch.kernels.relax import fused as k2
    from repro_torch.kernels.relax import relax as k1

    queries = int(os.environ.get("BENCH_QUERIES", "11"))
    out = {"tag": tag, "card": cs.card_line()}

    def cut(log):
        end = int(np.nonzero(np.asarray(log.kind) == 2)[0][queries - 1]) + 1
        return log[:end]

    def dev(fn):
        return round(cs.device_ms(torch, fn), 5)

    def lanes_equal(got, one):
        for t in range(got[0].shape[0]):
            b, a = one(t)
            assert torch.equal(got[0][t], b) and torch.equal(got[1][t], a)

    n, e, sources, log = cs.stream(20, "er")
    eng = cs.engine(n, e, sources[0], sources=tuple(sources),
                    relax_backend="ellpack")
    eng.ingest_log(cut(log))
    torch.cuda.synchronize()
    dist = eng.state.sssp.dist.contiguous()
    idx, w = eng.backend.state.nbr_idx, eng.backend.state.nbr_w
    lanes_equal(k1.ellpack_relax(dist, idx, w),
                lambda t: k1.ellpack_relax(dist[t].contiguous(), idx, w))
    one = dist[0].contiguous()
    d8 = torch.cat([dist, dist.flip(1)]).contiguous()
    d16 = torch.cat([d8, d8.roll(12345, 1)]).contiguous()
    bi, bw = idx[:131072], w[:131072]
    out["k1_single"] = dev(lambda: k1.ellpack_relax(one, idx, w))
    out["k1_lanes4"] = dev(lambda: k1.ellpack_relax(dist, idx, w))
    out["k1_lanes8"] = dev(lambda: k1.ellpack_relax(d8, idx, w))
    out["k1_lanes16"] = dev(lambda: k1.ellpack_relax(d16, idx, w))
    out["k1_block_single"] = dev(lambda: k1.ellpack_relax(one, bi, bw))
    out["k1_block_lanes4"] = dev(lambda: k1.ellpack_relax(dist, bi, bw))
    if hasattr(k1, "lane_minor"):
        m = k1.lane_minor(dist)
        out["k1_interleave4"] = dev(lambda: k1.lane_minor(dist))
        out["k1_block_lanes4_shared"] = dev(
            lambda: k1.ellpack_relax(dist, bi, bw, offers_minor=m))
        out["k1_lanes4_shared"] = dev(
            lambda: k1.ellpack_relax(dist, idx, w, offers_minor=m))
    del eng

    n, e, sources, log = cs.stream(20, "rmat")
    eng = cs.engine(n, e, sources[0], sources=tuple(sources),
                    relax_backend="auto")
    eng.ingest_log(cut(log))
    torch.cuda.synchronize()
    dist = eng.state.sssp.dist.contiguous()
    st = eng.backend.state
    act = torch.ones_like(dist, dtype=torch.bool)
    lanes_equal(k2.fused_sliced_relax(dist, act, st),
                lambda t: k2.fused_sliced_relax(dist[t].contiguous(),
                                                act[t].contiguous(), st))
    one, a1 = dist[0].contiguous(), act[0].contiguous()
    d8 = torch.cat([dist, dist.flip(1)]).contiguous()
    a8 = torch.ones_like(d8, dtype=torch.bool)
    out["k2_single"] = dev(lambda: k2.fused_sliced_relax(one, a1, st))
    out["k2_lanes4"] = dev(lambda: k2.fused_sliced_relax(dist, act, st))
    out["k2_lanes8"] = dev(lambda: k2.fused_sliced_relax(d8, a8, st))
    if hasattr(k1, "lane_minor"):
        out["k2_interleave4"] = dev(lambda: k1.lane_minor(dist, act))
    out["k2_split4"] = [(name[:40], round(ms, 5)) for name, ms in
                        cs.per_launch_ms(torch, lambda: k2.fused_sliced_relax(
                            dist, act, st))]
    print("BENCH " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
