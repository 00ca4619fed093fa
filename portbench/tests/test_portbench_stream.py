"""The benchmark's inputs: the GAP graphs and the sliding-window stream
made from a seed, checked on the CPU at a tiny scale."""
from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import graphs, harness, stream  # noqa: E402

KRON = {"generator": "kron", "scale": 9, "edge_factor": 16, "a": 0.57,
        "b": 0.19, "c": 0.19, "weight_min": 1, "weight_max": 255}
URAND = {"generator": "urand", "scale": 9, "edge_factor": 16,
         "weight_min": 1, "weight_max": 255}
TRAFFIC = {"window_frac": 0.3, "delta": 0.3, "block_edges": 40}


def make(config: dict, seed: int, traffic: dict = TRAFFIC
         ) -> stream.Stream:
    gen = torch.Generator().manual_seed(seed)
    return stream.sliding_window(graphs.generate(config, gen), traffic, gen)


def recipe(U: int, W: int, B: int, dies: np.ndarray) -> list[tuple]:
    """The window recipe as a plain loop over blocks (the program's
    ``sliding_window_stream`` with the deaths given): (kind, edge)."""
    out, next_del = [], 0
    for a in range(0, U, B):
        b = min(a + B, U)
        out += [(stream.ADD, e) for e in range(a, b)]
        hi = max(0, b - W)
        out += [(stream.DEL, d) for d in range(next_del, hi) if dies[d]]
        next_del = max(next_del, hi)
    return out


@pytest.mark.parametrize("config", [KRON, URAND], ids=["kron", "urand"])
def test_same_seed_same_stream_other_seed_other(config):
    a, b, c = make(config, 5), make(config, 5), make(config, 6)
    for name in ("kind", "src", "dst", "w"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.base == b.base
    assert not (len(a) == len(c) and np.array_equal(a.src, c.src))


@pytest.mark.parametrize("config", [KRON, URAND], ids=["kron", "urand"])
def test_graph_is_simple_undirected_with_integer_weights(config):
    gen = torch.Generator().manual_seed(3)
    e = graphs.generate(config, gen)
    assert e.n == 1 << config["scale"]
    assert bool((e.u < e.v).all()) and bool((e.v < e.n).all())
    assert len(torch.unique(e.u * e.n + e.v)) == len(e.u)
    assert bool((e.w == e.w.round()).all())
    assert int(e.w.min()) >= 1 and int(e.w.max()) <= 255
    # about edge_factor draws a vertex survive as distinct edges
    assert len(e.u) > 0.5 * config["edge_factor"] * e.n


def test_kron_is_skewed_and_urand_is_not():
    deg = {}
    for name, cfg in (("kron", KRON), ("urand", URAND)):
        e = graphs.generate(cfg, torch.Generator().manual_seed(4))
        d = torch.bincount(torch.cat([e.u, e.v]), minlength=e.n).float()
        deg[name] = float(d.max() / d.mean())
    assert deg["kron"] > 5 * deg["urand"]


@pytest.mark.parametrize("block", [40, 7, 1000])
def test_closed_form_matches_the_recipe_loop(block):
    s = make(KRON, 9, dict(TRAFFIC, block_edges=block))
    U = len(s.edges.u)
    W = s.base // 2
    dies = (s.del_at != stream.NEVER).numpy()
    want = recipe(U, W, block, dies)
    assert len(s) == 2 * len(want)
    u, v = s.edges.u.numpy(), s.edges.v.numpy()
    kinds = np.array([k for k, _ in want], np.uint8)
    edge = np.array([e for _, e in want])
    np.testing.assert_array_equal(s.kind[0::2], kinds)
    np.testing.assert_array_equal(s.src[0::2], u[edge])
    np.testing.assert_array_equal(s.dst[0::2], v[edge])


def test_arcs_of_an_edge_stay_together_within_a_batch():
    s = make(URAND, 2)
    assert s.base % 2 == 0
    np.testing.assert_array_equal(s.kind[0::2], s.kind[1::2])
    np.testing.assert_array_equal(s.src[0::2], s.dst[1::2])
    np.testing.assert_array_equal(s.dst[0::2], s.src[1::2])
    np.testing.assert_array_equal(s.w[0::2], s.w[1::2])
    # base and batches cut between pairs: both even
    assert all(x % 2 == 0 for x in (s.base, 4096, 64))
    assert (s.kind[:s.base] == stream.ADD).all()
    assert (s.kind[s.base:] == stream.DEL).any()


@pytest.mark.parametrize("config", [KRON, URAND], ids=["kron", "urand"])
def test_no_duplicate_arc_and_every_del_names_a_live_arc(config):
    s = make(config, 8)
    live: dict[tuple[int, int], float] = {}
    checkpoints = {s.base, s.base + 640, len(s) // 2 * 2, len(s)}
    for i, (k, a, b, w) in enumerate(zip(s.kind, s.src, s.dst, s.w)):
        if i in checkpoints:
            _same_arcs(s.live_arcs(i), live)
        key = (int(a), int(b))
        if k == stream.ADD:
            assert key not in live
            live[key] = float(w)
        else:
            assert key in live
            del live[key]
    _same_arcs(s.live_arcs(len(s)), live)
    counts = s.live_counts(np.array([s.base, len(s)]))
    assert counts[0] == s.base and counts[1] == len(live)


def _same_arcs(arcs, live: dict) -> None:
    src, dst, w = (t.numpy() for t in arcs)
    got = {(int(a), int(b)): float(c) for a, b, c in zip(src, dst, w)}
    assert got == live


def test_live_arcs_refuses_to_split_an_edge():
    s = make(URAND, 1)
    with pytest.raises(ValueError):
        s.live_arcs(s.base + 1)


def test_top_sources_are_the_highest_degree_vertices_of_the_base():
    s = make(KRON, 12)
    src, _, _ = s.live_arcs(s.base)
    deg = np.bincount(src.numpy(), minlength=s.edges.n)
    top = harness.top_sources(s, 4)
    assert len(set(top)) == 4
    assert sorted(deg[top], reverse=True) == sorted(deg, reverse=True)[:4]


# the edges (u, v, w) and the stream (kind, src, dst, w) of the two GAP
# generators at scale 9, pinned from the harness before generator files
# existed: the built-ins keep their draws from the seed, bit for bit
PINNED = {
    ("kron", 5): ("48783cc84725b653", "45ca84fcc6206fb4"),
    ("kron", 2**31 + 7): ("353f312a3b6af446", "3e7347e05dd62d39"),
    ("urand", 5): ("7cb23a28362f9355", "371ee111c4db8a00"),
    ("urand", 2**31 + 7): ("a37e74ca41eddf1a", "308f934ea42b5513"),
}


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_built_in_graphs_and_streams_match_their_pinned_digests(name, seed):
    s = make({"kron": KRON, "urand": URAND}[name], seed)
    e = s.edges
    got = (digest([e.u.numpy(), e.v.numpy(), e.w.numpy()]),
           digest([s.kind, s.src, s.dst, s.w]))
    assert got == PINNED[name, seed]


def _edges(**change) -> graphs.Edges:
    """A valid 4-vertex graph with one part replaced."""
    parts = dict(n=4, u=torch.tensor([0, 1, 0]), v=torch.tensor([1, 2, 3]),
                 w=torch.tensor([1.0, 7.0, 255.0]))
    parts.update(change)
    return graphs.Edges(**parts)


BROKEN = {
    "int64": dict(u=torch.tensor([0, 1, 0], dtype=torch.int32)),
    "float32": dict(w=torch.tensor([1.0, 7.0, 255.0], dtype=torch.float64)),
    "not one length": dict(w=torch.tensor([1.0, 7.0])),
    "is on meta": dict(w=torch.empty(3, device="meta")),
    "0 <= u": dict(u=torch.tensor([-1, 1, 0])),
    "u < v": dict(u=torch.tensor([0, 2, 0])),
    "v < n": dict(v=torch.tensor([1, 2, 4])),
    "no edge twice": dict(u=torch.tensor([0, 1, 0]),
                          v=torch.tensor([1, 2, 1])),
    "w integer-valued": dict(w=torch.tensor([1.0, 7.5, 255.0])),
    "w >= 1": dict(w=torch.tensor([1.0, 0.0, 255.0])),
}


@pytest.mark.parametrize("rule", sorted(BROKEN))
def test_check_edges_names_the_rule_a_graph_breaks(rule):
    good = _edges()
    assert graphs.check_edges(good) is good
    with pytest.raises(ValueError, match=rule):
        graphs.check_edges(_edges(**BROKEN[rule]))


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_check_edges_refuses_a_weight_that_is_not_finite(bad):
    with pytest.raises(ValueError, match="w integer-valued"):
        graphs.check_edges(_edges(w=torch.tensor([1.0, bad, 255.0])))


def test_an_unknown_generator_names_the_built_ins_and_the_files(
        monkeypatch, tmp_path):
    (tmp_path / "ring.py").write_text("")
    monkeypatch.setattr(graphs, "GENERATORS_DIR", tmp_path)
    with pytest.raises(SystemExit, match=r"'kron', 'urand'.*\['ring'\]"):
        graphs.generate(dict(URAND, generator="nosuch"),
                        torch.Generator().manual_seed(1))
