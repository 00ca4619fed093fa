"""The port's host graph substrate — ``graphs/sampler.py`` (neighbour
sampler, ``build_batch``) and ``graphs/triplets.py`` — against the JAX
package's copies: every array identical for the same seed (tolerance 0;
both are numpy), zero-degree seeds, positions, and the triplet budget's
cap (uniform downsample) and padding included."""
import numpy as np
import pytest

from repro.graphs import sampler as jsmp
from repro.graphs import triplets as jtri
from repro_torch.graphs import generators as gen
from repro_torch.graphs import sampler as smp
from repro_torch.graphs import triplets as tri


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
        return
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("fanout", [(5, 3), (2,), (4, 3, 2)])
@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_and_batch_equal_reference(fanout, seed):
    n, src, dst, _ = gen.erdos_renyi(300, 1500, seed=seed)
    # a few zero-in-degree vertices among the seeds
    keep = dst >= 5
    src, dst = src[keep], dst[keep]
    seeds = np.array([0, 3, 9, 17, 250, 4])
    sub = smp.NeighborSampler(n, src, dst).sample(seeds, fanout, seed=seed)
    ref = jsmp.NeighborSampler(n, src, dst).sample(seeds, fanout, seed=seed)
    for f in ("node_ids", "src", "dst", "edge_mask", "node_mask",
              "seed_slots"):
        _same(getattr(sub, f), getattr(ref, f))
    assert smp.subgraph_capacity(6, fanout) == jsmp.subgraph_capacity(
        6, fanout) == (len(sub.node_ids), len(sub.src))
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    _same(smp.build_batch(sub, feats, labels, pos),
          jsmp.build_batch(ref, feats, labels, pos))
    _same(smp.build_batch(sub, feats, labels),
          jsmp.build_batch(ref, feats, labels))
    # zero-degree seeds sample nothing
    assert not sub.edge_mask[:len(seeds) * fanout[0]].reshape(
        len(seeds), -1)[[0, 1, 5]].any()


def test_sampler_all_zero_degree():
    src, dst = np.array([0, 1]), np.array([1, 2])
    sub = smp.NeighborSampler(4, src, dst).sample(np.array([0, 3]), (2,))
    ref = jsmp.NeighborSampler(4, src, dst).sample(np.array([0, 3]), (2,))
    assert not sub.edge_mask.any()
    _same(sub.node_ids, ref.node_ids)


@pytest.mark.parametrize("budget", [None, 64, 4096])
@pytest.mark.parametrize("cap", [0, 3, 8])
def test_triplets_equal_reference(budget, cap):
    n, src, dst, _ = gen.erdos_renyi(40, 400, seed=2)
    got = tri.build_triplets(n, src, dst, budget=budget, per_edge_cap=cap,
                             seed=5)
    want = jtri.build_triplets(n, src, dst, budget=budget, per_edge_cap=cap,
                               seed=5)
    for g, w in zip(got, want):
        _same(g, w)
    if budget == 64:   # capped: every slot real
        assert got[2].all()
    if budget == 4096:  # padded past the real triplets
        assert not got[2].all()


def test_triplet_semantics_and_budget():
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 3])
    t_kj, t_ji, mask = tri.build_triplets(4, src, dst, budget=8,
                                          per_edge_cap=4)
    assert sorted(zip(t_kj[mask].tolist(), t_ji[mask].tolist())) == [
        (0, 1), (1, 2)]
    for e in (0, 1, 1000, 10**9):
        assert tri.triplet_budget(e) == jtri.triplet_budget(e)
        assert tri.triplet_budget(e, 8.0, 100) == jtri.triplet_budget(
            e, 8.0, 100)
