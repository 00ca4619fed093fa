"""The plain reference, the comparison that decides ``correct``, its
control, the work formula and the device-trace reduction, on the CPU."""
from __future__ import annotations

import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import control, devtrace, reference, work  # noqa: E402

INF = float("inf")


def brute_force(n, arcs, source):
    """Shortest distances by trying every simple path (tiny graphs)."""
    w = {(int(a), int(b)): float(c) for a, b, c in zip(*arcs)}
    best = [INF] * n
    best[source] = 0.0
    for length in range(1, n):
        for path in itertools.permutations(range(n), length + 1):
            if path[0] != source:
                continue
            hops = list(zip(path, path[1:]))
            if all(h in w for h in hops):
                best[path[-1]] = min(best[path[-1]], sum(w[h] for h in hops))
    return np.array(best, np.float32)


def tiny_graph(seed, n=6, m=12):
    rng = np.random.default_rng(seed)
    pairs = {(int(a), int(b)) for a, b in rng.integers(0, n, (m, 2))
             if a != b}
    src, dst = map(np.array, zip(*sorted(pairs)))
    w = rng.integers(1, 256, len(src)).astype(np.float32)
    return n, tuple(torch.as_tensor(x) for x in (src, dst, w))


@pytest.mark.parametrize("seed", range(6))
def test_reference_against_brute_force(seed):
    n, arcs = tiny_graph(seed)
    dist, parent = reference.bellman_ford(n, *arcs, 0)
    np.testing.assert_array_equal(dist.numpy(), brute_force(n, arcs, 0))
    got = reference.judge(n, arcs, 0, dist.numpy(), parent.numpy())
    assert got == {"dist_wrong": 0, "parent_wrong": 0}


def line_graph():
    """0 -1-> 1 -2-> 2, 0 -3-> 2 (a tie at 2), and 3 unreachable."""
    arcs = (torch.tensor([0, 1, 0]), torch.tensor([1, 2, 2]),
            torch.tensor([1.0, 2.0, 3.0]))
    return 4, arcs


@pytest.mark.parametrize("far,raises", [
    (2**24 - 1, False), (2**24, True), (2**24 + 2, True)])
def test_float32_reference_refuses_distances_past_exactness(far, raises):
    """A path 0 -> 1 -> 2 whose far end lies just below, at and just above
    2^24: below it every sum is exact and comes back as such; from it on,
    float32 sums round and the reference raises."""
    arcs = (torch.tensor([0, 1]), torch.tensor([1, 2]),
            torch.tensor([2.0**23, far - 2.0**23]))
    if raises:
        with pytest.raises(ValueError, match="2\\^24"):
            reference.bellman_ford(3, *arcs, 0)
    else:
        dist, _ = reference.bellman_ford(3, *arcs, 0)
        assert dist.tolist() == [0.0, 2.0**23, far]
    # the control's precision is meant to round: it never raises
    reference.bellman_ford(3, *arcs, 0, dtype=torch.bfloat16)


def test_judge_accepts_either_tied_parent_and_counts_faults():
    n, arcs = line_graph()
    dist = np.array([0, 1, 3, INF], np.float32)
    for p2 in (0, 1):      # both arcs into 2 are tight
        par = np.array([-1, 0, p2, -1])
        assert reference.judge(n, arcs, 0, dist, par) == {
            "dist_wrong": 0, "parent_wrong": 0}
    bad = np.array([-1, 0, 3, -1])            # not an arc
    assert reference.judge(n, arcs, 0, dist, bad)["parent_wrong"] == 1
    loose = np.array([-1, 0, 1, 0])           # unreached with a parent
    assert reference.judge(n, arcs, 0, dist, loose)["parent_wrong"] == 1
    root = np.array([2, 0, 1, -1])            # the source with a parent
    assert reference.judge(n, arcs, 0, dist, root)["parent_wrong"] == 1
    off = dist.copy()
    off[2] += 1                               # a corrupted distance
    got = reference.judge(n, arcs, 0, off, np.array([-1, 0, 1, -1]))
    assert got["dist_wrong"] == 1
    reach = dist.copy()
    reach[3] = 7                              # unreached reported reached
    assert reference.judge(n, arcs, 0, reach,
                           np.array([-1, 0, 1, -1]))["dist_wrong"] == 1


def test_judge_on_a_graph_with_no_arcs():
    arcs = (torch.zeros(0, dtype=torch.int64),) * 2 + (torch.zeros(0),)
    dist = np.array([0, INF], np.float32)
    assert reference.judge(2, arcs, 0, dist, np.array([-1, -1])) == {
        "dist_wrong": 0, "parent_wrong": 0}
    assert reference.judge(2, arcs, 0, dist, np.array([-1, 0]))[
        "parent_wrong"] == 1


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_bfloat16_control_is_judged_wrong(seed):
    """The control: the reference one precision below float32 in the
    program's place, over a cell's recipe at a tiny scale, on three seeds."""
    cfg = json.loads((ROOT / "portbench/configs/gap-kron20.json").read_text())
    traffic = json.loads(
        (ROOT / "portbench/traffic/micro4k.json").read_text())
    cfg["scale"] = 9
    traffic.update(batch_events=64, block_edges=24, warmup_batches=4)
    got = control.readings(cfg, traffic, seed, "cpu", batches=100)
    assert got["reference"] == {"dist_wrong": 0, "parent_wrong": 0}
    assert got["control"]["dist_wrong"] > 0


def test_wave_bytes_against_hand_counts():
    # 10 live arcs x 8 B + 4 vertices x 4 B (offsets) + per lane 4 x 12 B
    assert work.wave_bytes(10, 4, 1) == 80 + 16 + 48
    assert work.wave_bytes(10, 4, 16) == 80 + 16 + 16 * 48
    least = 3 * work.wave_bytes(1e6, 1 << 20, 1) / 3.35e12
    assert work.roofline_pct(3, 1e6, 1 << 20, 1, least) == pytest.approx(100)
    assert work.roofline_pct(3, 1e6, 1 << 20, 1, 4 * least) == pytest.approx(
        25)
    assert work.roofline_pct(0, 1e6, 8, 1, 1.0) is None
    assert work.roofline_pct(2, 1e6, 8, 1, 0.0) is None


def test_device_trace_union_gaps_and_idle_by_span():
    ops = [("void (anonymous namespace)::k2_ell_pass(float const*)", 10, 20),
           ("k2_coo_pass", 15, 30),                 # overlaps: counted once
           ("Memcpy HtoD (Pageable -> Device)", 50, 60),
           ("k2_ell_pass", 95, 120)]                # runs past the window
    dt = devtrace.DeviceTrace(ops, 0, 100)
    assert dt.window_s == 100e-9
    assert dt.busy_s == pytest.approx((20 + 10 + 5) * 1e-9)
    assert dt.count("k2_ell_pass") == 2
    assert dt.seconds("k2_ell_pass", "k2_coo_pass") == pytest.approx(
        (10 + 15 + 25) * 1e-9)
    assert dt.seconds(devtrace.H2D) == pytest.approx(10e-9)
    # idle: [0, 10), [30, 50), [60, 95)
    assert dt.idle_in(np.array([[0, 100]])) == pytest.approx(65e-9)
    assert dt.idle_in(np.array([[5, 12], [40, 70]])) == pytest.approx(
        (5 + 10 + 10) * 1e-9)
    assert dt.top_ops(1)[0] == ["k2_ell_pass", 35e-9]
    assert devtrace.short_name(
        "void (anonymous namespace)::k2_ell_lanes<8, false>(float const*)"
    ) == "k2_ell_lanes<8, false>"
