"""The GAP Benchmark Suite's synthetic graphs, made on the device from a
seed (Beamer, Asanovic and Patterson, arXiv:1508.03619, §3).

* ``kron`` — the Graph500 Kronecker generator: each of ``2^scale *
  edge_factor`` edge draws picks one quadrant per bit with probabilities
  (a, b, c, 1 - a - b - c); vertex ids are then permuted at random, as
  Graph500 does, so that hubs do not sit at low ids.
* ``urand`` — both endpoints of each draw uniform over the vertices.

Both graphs are undirected: self-loops and duplicate edges are removed,
each remaining edge gets one integer weight uniform in [weight_min,
weight_max] (GAP's SSSP weights), and the edges come out in a seeded
random order — the stream's arrival order.  Everything runs in a few large
torch calls on the generator's device, so the same seed gives the same
edges bit for bit on that device.

Rewritten from ``repro_torch.graphs.generators`` (host numpy, directed
R-MAT and Erdos-Renyi) for the card; the benchmark imports nothing of the
program to make its inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Edges(NamedTuple):
    n: int               # vertices
    u: torch.Tensor      # i64[U] one endpoint of each undirected edge
    v: torch.Tensor      # i64[U] the other (u < v)
    w: torch.Tensor      # f32[U] integer-valued weight


def _kron_draws(cfg: dict, gen: torch.Generator) -> tuple[torch.Tensor, ...]:
    scale, dev = int(cfg["scale"]), gen.device
    m = (1 << scale) * int(cfg["edge_factor"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    u = torch.zeros(m, dtype=torch.int64, device=dev)
    v = torch.zeros(m, dtype=torch.int64, device=dev)
    for bit in range(scale):
        r = torch.rand(m, generator=gen, device=dev)
        u |= (r >= a + b).long() << bit                 # quadrant c or d
        v |= ((r >= a) & (r < a + b) | (r >= a + b + c)).long() << bit
    perm = torch.randperm(1 << scale, generator=gen, device=dev)
    return perm[u], perm[v]


def _urand_draws(cfg: dict, gen: torch.Generator) -> tuple[torch.Tensor, ...]:
    n, dev = 1 << int(cfg["scale"]), gen.device
    m = n * int(cfg["edge_factor"])
    u = torch.randint(0, n, (m,), generator=gen, device=dev)
    v = torch.randint(0, n, (m,), generator=gen, device=dev)
    return u, v


GENERATORS = {"kron": _kron_draws, "urand": _urand_draws}


def generate(cfg: dict, gen: torch.Generator) -> Edges:
    """The configuration's undirected simple graph, in arrival order."""
    n = 1 << int(cfg["scale"])
    u, v = GENERATORS[cfg["generator"]](cfg, gen)
    keep = u != v
    lo, hi = torch.minimum(u[keep], v[keep]), torch.maximum(u[keep], v[keep])
    key = torch.unique(lo * n + hi)              # sorted, no duplicates
    key = key[torch.randperm(len(key), generator=gen, device=gen.device)]
    w = torch.randint(int(cfg["weight_min"]), int(cfg["weight_max"]) + 1,
                      (len(key),), generator=gen, device=gen.device)
    return Edges(n, key // n, key % n, w.to(torch.float32))
