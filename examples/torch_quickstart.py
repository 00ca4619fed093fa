"""Quickstart: the SSSP-Del engine of the PyTorch port on a small dynamic
graph (the twin of ``examples/quickstart.py``).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Builds a graph edge by edge, deletes a tree edge (triggering the paper's
invalidation + recomputation epochs), queries the shortest-path tree on
demand, and cross-checks every answer against a textbook Dijkstra oracle.
The engine runs on the card unless ``--device cpu`` is given.

``repro_torch.make_engine`` is the one public entry point for both
engines: the same call with ``partitions=P`` (or ``mesh=``) returns the
sharded engine instead — ``edge_capacity`` is always the total pool
budget.
"""
import argparse

import numpy as np

import repro_torch
from repro_torch.core import events as ev
from repro_torch.core import oracle


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default: the card)")
    args = p.parse_args(argv)
    #          1.0      1.0
    #   0 ────────► 1 ────────► 2
    #   │                       ▲
    #   └────────── 5.0 ────────┘         (plus a later shortcut 0->3->2)
    eng = repro_torch.make_engine(num_vertices=8, edge_capacity=64,
                                  source=0, device=args.device)
    log = ev.EventLog.concatenate([
        ev.adds([0, 1, 0], [1, 2, 2], [1.0, 1.0, 5.0]),
        ev.query_marker(),                 # tree: 0->1->2 (dist 2)
        ev.dels([1], [2]),                 # delete the tree edge 1->2
        ev.query_marker(),                 # 2 must fall back to dist 5
        ev.adds([0, 3], [3, 2], [1.0, 1.0]),
        ev.query_marker(),                 # new shortcut: 0->3->2 (dist 2)
    ])
    results = eng.ingest_log(log)
    for i, r in enumerate(results):
        print(f"query {i}: dist={np.round(r.dist[:4], 1)} "
              f"parent={r.parent[:4]} latency={r.latency_s*1e3:.2f}ms")

    # oracle check on the final state
    e = eng.state.edges
    act = e.active.cpu().numpy()
    dist_ref, _ = oracle.dijkstra(8, e.src.cpu().numpy()[act],
                                  e.dst.cpu().numpy()[act],
                                  e.w.cpu().numpy()[act], 0)
    assert np.allclose(np.nan_to_num(results[-1].dist, posinf=-1),
                       np.nan_to_num(dist_ref, posinf=-1))
    print("oracle check: OK")

    assert results[0].dist[2] == 2.0   # via 0->1->2
    assert results[1].dist[2] == 5.0   # direct 0->2 after deletion
    assert results[2].dist[2] == 2.0   # via the new 0->3->2
    print("dynamic deletions + re-additions: OK")


if __name__ == "__main__":
    main()
