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

Any other ``generator`` name is a file of its own,
``generators/<generator>.py``, found by name as ``metrics/<name>.py`` is:
its ``generate(cfg, gen) -> Edges`` builds the graph on ``gen.device``
from ``gen`` alone (or from a seed the configuration fixes, or reads a
graph file kept in the repository: the run's seed then sets only the
arrival order), and the order it returns is the arrival order.  Every
graph, built in or from a file, passes ``check_edges`` before use.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import NamedTuple

import torch

GENERATORS_DIR = Path(__file__).resolve().parent / "generators"


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


def _load_generator(name: str):
    """``generators/<name>.py``'s ``generate``; ends the run, naming what
    there is, when no such file exists."""
    path = GENERATORS_DIR / f"{name}.py"
    if not path.is_file():
        files = sorted(p.stem for p in GENERATORS_DIR.glob("*.py"))
        raise SystemExit(f"unknown generator {name!r}; built in: "
                         f"{sorted(GENERATORS)}; files in {GENERATORS_DIR}: "
                         f"{files}")
    spec = importlib.util.spec_from_file_location(
        "portbench_generator_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate


def _gap_graph(cfg: dict, gen: torch.Generator) -> Edges:
    n = 1 << int(cfg["scale"])
    u, v = GENERATORS[cfg["generator"]](cfg, gen)
    keep = u != v
    lo, hi = torch.minimum(u[keep], v[keep]), torch.maximum(u[keep], v[keep])
    key = torch.unique(lo * n + hi)              # sorted, no duplicates
    key = key[torch.randperm(len(key), generator=gen, device=gen.device)]
    w = torch.randint(int(cfg["weight_min"]), int(cfg["weight_max"]) + 1,
                      (len(key),), generator=gen, device=gen.device)
    return Edges(n, key // n, key % n, w.to(torch.float32))


def generate(cfg: dict, gen: torch.Generator) -> Edges:
    """The configuration's undirected simple graph, in arrival order,
    checked."""
    name = cfg["generator"]
    make = _gap_graph if name in GENERATORS else _load_generator(name)
    return check_edges(make(cfg, gen))


def check_edges(edges: Edges) -> Edges:
    """``edges`` if they hold the rules every graph keeps, else a
    ``ValueError`` naming the first rule broken: ``u`` and ``v`` int64 with
    ``0 <= u < v < n``, no edge twice; ``w`` float32 on the same device,
    integer-valued (finite) and ``>= 1``.  One read of the device's
    verdicts."""
    n, u, v, w = edges
    shape = {"u": tuple(u.shape), "v": tuple(v.shape), "w": tuple(w.shape)}
    if len(set(shape.values())) != 1 or len(shape["u"]) != 1:
        raise ValueError(f"edges: u, v and w are not one length: {shape}")
    for name, t, dtype in (("u", u, torch.int64), ("v", v, torch.int64),
                           ("w", w, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"edges: {name} is {t.dtype}, not {dtype}")
        if t.device != u.device:
            raise ValueError(f"edges: {name} is on {t.device}, not on "
                             f"{u.device} with u")
    if not len(u):
        return edges
    key = torch.sort(u * n + v).values
    broken = torch.stack([
        (u < 0).any(), (u >= v).any(), (v >= n).any(),
        (key[1:] == key[:-1]).any(),
        ~torch.isfinite(w).all() | (w != w.round()).any(), (w < 1).any()])
    rules = ("0 <= u", "u < v", "v < n", "no edge twice",
             "w integer-valued", "w >= 1")
    for rule, bad in zip(rules, broken.tolist()):
        if bad:
            raise ValueError(f"edges: rule {rule!r} broken (n={n})")
    return edges
