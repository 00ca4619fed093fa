"""The 10th DIMACS Implementation Challenge's random geometric graph
``rgg_n_2_<scale>_s0`` (Holtgrewe, Sanders and Schulz, IPDPS 2010;
SuiteSparse ``DIMACS10``), made on the device from a seed: the field's
generated stand-in for a road network.

* ``n = 2^scale`` points uniform in the unit square, ``torch.rand(n, 2)``
  in float32 (x, y), in draw order, drawn from the configuration's
  ``instance_seed`` and not from the run's: like the published graph (the
  ``s0`` of its name), one instance serves every run, whose seed sets the
  arrival order alone, as for a graph file kept in the repository;
* an undirected edge between two points whose squared distance
  ``dx * dx + dy * dy``, in float32, is below ``r^2`` (rounded once to
  float32), with ``r = radius_c * sqrt(ln n / n)``;
* the points binned into a g x g grid, ``g = floor(1 / (r * SLACK))``, so
  a cell's side is at least r (with room for rounding) and every edge joins
  a cell to itself or to one of its eight neighbours.  Each point is paired
  with the later points of its own cell and every point of the four cells
  of the half stencil ``STENCIL``, so each pair of points that may be close
  is looked at once and nothing is O(n^2);
* vertex ids in the grid's row-major cell order (row = y), then draw order
  within a cell, so ``u < v`` on every pair as made;
* each edge's weight its length in integer units, ``ceil(255 d / r)``
  clamped to [1, 255] with ``d = sqrt(dx * dx + dy * dy)`` (the DIMACS10
  graphs carry none);
* the arrival order a ``randperm`` of the edges from the run's seed.

Every step is a few large torch calls on ``gen.device``, so the same seeds
give the same edges bit for bit on that device.  ``generate`` is what the
harness calls (``graphs.generate``); ``points`` gives the vertices'
coordinates in id order, for the tests.
"""
from __future__ import annotations

import math

import torch

from portbench.graphs import Edges

SLACK = 1.0 + 2.0 ** -10       # a cell's side over r, at least
STENCIL = ((1, 0), (-1, 1), (0, 1), (1, 1))   # (dx, dy): the cells after
WEIGHT_MAX = 255


def radius(n: int, radius_c: float) -> float:
    """The connection radius ``radius_c * sqrt(ln n / n)``."""
    return radius_c * math.sqrt(math.log(n) / n)


def grid_cells(r: float) -> int:
    """Cells a side: the most whose side is at least ``r * SLACK``."""
    return max(1, math.floor(1.0 / (r * SLACK)))


def _cells(xy: torch.Tensor, g: int) -> torch.Tensor:
    """i64[n, 2] grid column and row of each point (float64, so a point's
    cell never rounds across a boundary)."""
    return torch.floor(xy.double() * g).long().clamp_(0, g - 1)


def points(cfg: dict, gen: torch.Generator
           ) -> tuple[torch.Tensor, float, int]:
    """(f32[n, 2] the points in vertex-id order, r, g), drawn on
    ``gen``'s device from the configuration's ``instance_seed``."""
    n = 1 << int(cfg["scale"])
    draw = torch.Generator(device=gen.device)
    draw.manual_seed(int(cfg["instance_seed"]))
    xy = torch.rand(n, 2, generator=draw, device=gen.device)
    r = radius(n, float(cfg["radius_c"]))
    g = grid_cells(r)
    cell = _cells(xy, g)
    order = torch.sort(cell[:, 1] * g + cell[:, 0], stable=True).indices
    return xy[order], r, g


def generate(cfg: dict, gen: torch.Generator) -> Edges:
    xy, r, g = points(cfg, gen)
    n, dev = len(xy), xy.device
    cell = _cells(xy, g)
    key = cell[:, 1] * g + cell[:, 0]             # non-decreasing in id
    count = torch.bincount(key, minlength=g * g)
    start = torch.cumsum(count, 0) - count
    ids = torch.arange(n, device=dev)
    r2 = torch.tensor(r * r, dtype=torch.float32, device=dev)
    per_r = torch.tensor(WEIGHT_MAX / r, dtype=torch.float32, device=dev)
    us, vs, ws = [], [], []
    for dx, dy in ((0, 0),) + STENCIL:
        if (dx, dy) == (0, 0):                     # the later points here
            first = ids + 1
            k = start[key] + count[key] - first
        else:
            cx, cy = cell[:, 0] + dx, cell[:, 1] + dy
            inside = (cx >= 0) & (cx < g) & (cy < g)
            nkey = torch.where(inside, cy * g + cx, 0)
            first = start[nkey]
            k = torch.where(inside, count[nkey], 0)
        i = torch.repeat_interleave(ids, k)
        before = torch.cumsum(k, 0) - k
        j = first[i] + torch.arange(len(i), device=dev) - before[i]
        ddx = xy[i, 0] - xy[j, 0]
        ddy = xy[i, 1] - xy[j, 1]
        d2 = ddx * ddx + ddy * ddy
        near = d2 < r2
        us.append(i[near])
        vs.append(j[near])
        ws.append(torch.ceil(torch.sqrt(d2[near]) * per_r).clamp_(
            1, WEIGHT_MAX))
    u, v, w = torch.cat(us), torch.cat(vs), torch.cat(ws)
    order = torch.randperm(len(u), generator=gen, device=dev)
    return Edges(n, u[order], v[order], w[order])
