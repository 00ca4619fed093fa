"""The DIMACS random geometric graph (``generators/rgg.py``) on the CPU:
its edges against every pair of points, its ids against the grid's order,
its edge count against the formula's; the control and the depth of the
cell at its test size; and each configuration's test size."""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import control, graphs, harness, stream  # noqa: E402
from test_portbench_harness import TEST_SCALE, tiny  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = json.loads(
    (ROOT / "portbench/configs/dimacs-rgg20.json").read_text())
SCALES_SEEDS = [(8, 3), (8, 2**31 + 11), (10, 3), (10, 2**31 + 11)]


def _rgg():
    spec = importlib.util.spec_from_file_location(
        "portbench_generator_rgg", graphs.GENERATORS_DIR / "rgg.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rgg = _rgg()


def seeded(seed: int) -> torch.Generator:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def config(scale: int, instance: int) -> dict:
    return dict(CONFIG, scale=scale, instance_seed=instance)


def brute_force(xy: torch.Tensor, radius_c: float) -> tuple[torch.Tensor,
                                                             ...]:
    """(u, v, w) of every pair u < v of points closer than r, in (u, v)
    order: all pairs tried, in the generator's float32 arithmetic."""
    n = len(xy)
    r = radius_c * math.sqrt(math.log(n) / n)
    u, v = torch.triu_indices(n, n, offset=1)
    dx = xy[u, 0] - xy[v, 0]
    dy = xy[u, 1] - xy[v, 1]
    d2 = dx * dx + dy * dy
    near = d2 < torch.tensor(r * r, dtype=torch.float32)
    w = torch.ceil(torch.sqrt(d2[near])
                   * torch.tensor(255 / r, dtype=torch.float32))
    return u[near], v[near], w.clamp(1, 255)


def by_key(edges: graphs.Edges) -> tuple[torch.Tensor, ...]:
    order = torch.argsort(edges.u * edges.n + edges.v)
    return edges.u[order], edges.v[order], edges.w[order]


@pytest.mark.parametrize("scale,seed", SCALES_SEEDS)
def test_edges_are_every_pair_closer_than_r(scale, seed):
    cfg = config(scale, seed)
    edges = graphs.generate(cfg, seeded(5))       # check_edges too
    xy, _, _ = rgg.points(cfg, seeded(6))
    assert edges.n == len(xy) == 2**scale
    got = by_key(edges)
    want = brute_force(xy, CONFIG["radius_c"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert edges.w.min() >= 1 and edges.w.max() <= 255


@pytest.mark.parametrize("scale,seed", SCALES_SEEDS)
def test_ids_follow_the_grid_then_the_draw(scale, seed):
    """Vertex ids in the order of a row-major grid of cells of side at
    least r, and in draw order within a cell."""
    n = 2**scale
    raw = torch.rand(n, 2, generator=seeded(seed))
    r = CONFIG["radius_c"] * math.sqrt(math.log(n) / n)
    g = rgg.grid_cells(r)
    assert 1 / g >= r and 1 / (g + 1) < r * rgg.SLACK
    cell = torch.floor(raw.double() * g).long().clamp(0, g - 1)
    order = torch.sort(cell[:, 1] * g + cell[:, 0], stable=True).indices
    xy, r_got, g_got = rgg.points(config(scale, seed), seeded(5))
    assert (r_got, g_got) == (r, g)
    assert torch.equal(xy, raw[order])


@pytest.mark.parametrize("scale,seed", SCALES_SEEDS[:1] + SCALES_SEEDS[2:3])
def test_the_same_seeds_give_the_same_edges_bit_for_bit(scale, seed):
    """The instance seed draws the graph, the run's seed its order."""
    a = graphs.generate(config(scale, 0), seeded(seed))
    b = graphs.generate(config(scale, 0), seeded(seed))
    c = graphs.generate(config(scale, 0), seeded(seed + 1))
    d = graphs.generate(config(scale, 1), seeded(seed))
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    assert not torch.equal(a.u, c.u)
    for x, y in zip(by_key(a), by_key(c)):
        assert torch.equal(x, y)
    assert len(a.u) != len(d.u) or not torch.equal(by_key(a)[0],
                                                   by_key(d)[0])


def expected_edges(n: int, r: float) -> tuple[float, float]:
    """Mean and standard deviation of the edge count of n uniform points
    in the unit square joined below r.  A pair is an edge with p = pi r^2
    - 8 r^3 / 3 + r^4 / 2; two pairs that share a point covary by the
    variance of the disk's area inside the square, A = pi r^2 - D(x) -
    D(y), D the segment cut off by one side (corners, where the two
    segments overlap, left out of the variance)."""
    p = math.pi * r * r - 8 * r**3 / 3 + r**4 / 2
    pairs = n * (n - 1) / 2
    t = np.linspace(0.0, r, 20001)
    seg = r * r * np.arccos(t / r) - t * np.sqrt(r * r - t * t)

    def integral(f):
        return float(np.sum((f[1:] + f[:-1]) / 2 * np.diff(t)))

    mean_d = 2 * integral(seg)
    assert mean_d == pytest.approx(4 * r**3 / 3, rel=1e-6)
    var_area = 2 * (2 * integral(seg * seg) - mean_d**2)
    var = pairs * p * (1 - p) + n * (n - 1) * (n - 2) * var_area
    return pairs * p, math.sqrt(var)


@pytest.mark.parametrize("scale,seed", SCALES_SEEDS)
def test_the_edge_count_is_the_formulas(scale, seed):
    n = 2**scale
    mean, sd = expected_edges(n, rgg.radius(n, CONFIG["radius_c"]))
    got = len(graphs.generate(config(scale, seed), seeded(5)).u)
    assert abs(got - mean) < 4 * sd, (got, mean, sd)


def test_the_published_count_is_the_formulas():
    """The published rgg_n_2_20_s0 lies within 4 sigma of the formula at
    scale 20, so the generator's distribution is the source's."""
    n = 2**20
    mean, sd = expected_edges(n, rgg.radius(n, CONFIG["radius_c"]))
    assert abs(CONFIG["published_edges"] - mean) < 4 * sd, (mean, sd)


# ------------------------------------------------------ the test cell --
def test_a_fixed_graph_fixes_its_sources():
    """The configuration fixes its graph (``instance_seed``), so its
    sources are the whole graph's top degrees: the same on every seed,
    whatever the seed's base window holds."""
    cfg, traffic = tiny("rgg20.micro4k")
    assert "instance_seed" in cfg
    got = []
    for seed in (5, 6, 2**31 + 7):
        gen = seeded(seed)
        strm = stream.sliding_window(graphs.generate(cfg, gen), traffic, gen)
        top = harness.top_sources(strm, 2, whole_graph=True)
        deg = torch.bincount(torch.cat([strm.edges.u, strm.edges.v]),
                             minlength=strm.edges.n)
        assert int(deg[top[0]]) == int(deg.max()) >= int(deg[top[1]])
        got.append(top)
    assert got[0] == got[1] == got[2]


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_bfloat16_control_is_judged_wrong_on_the_rgg_cell(seed):
    """The control at the cell's test size."""
    config_, traffic = tiny("rgg20.micro4k")
    got = control.readings(config_, traffic, seed, "cpu", batches=40)
    assert got["reference"] == {"dist_wrong": 0, "parent_wrong": 0}
    assert got["control"]["dist_wrong"] > 0


# ------------------------------------------------- each cell's test size --
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_tiny_takes_the_configurations_own_test_scale(workload):
    """The configuration's ``test_scale``, and 8 where it has none."""
    config_, _ = tiny(workload)
    own = harness.load_cell(workload)["config"].get("test_scale")
    assert config_["scale"] == (8 if own is None else own) > 0
    assert TEST_SCALE == 8


def test_the_tiny_rgg_cell_runs_deeper_trees_than_urand():
    """The cell's reason to be: at the test sizes its batches take several
    times urand's waves, every epoch on the dense frontier."""
    waves = {}
    for workload in ("rgg20.micro4k", "urand20.micro4k"):
        config_, traffic = tiny(workload)
        res = harness.run_cell(config_, traffic, seed=5, seconds=120,
                               trace=True, device="cpu")
        run = res["run"]
        assert res["checks"]["dist_wrong"] == 0
        assert res["checks"]["parent_wrong"] == 0
        assert run.counters.get("frontier_occupancy", 0) == 0, workload
        waves[workload] = run.waves / run.batches
    assert waves["rgg20.micro4k"] > 3 * waves["urand20.micro4k"], waves
