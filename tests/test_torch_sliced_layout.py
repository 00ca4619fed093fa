"""Smaller names of the reference's surface in their port twins, held
against the reference: ``graphs/csr.py::csr_to_sliced_ell`` (the
list-of-blocks sliced ELL, per-slice K) on its edge cases and seeded
round trips, ``core/oracle.py::edges_of_pool`` and
``graphs/generators.py::power_law_hubs`` in both orientations and by
default (fault F6: the port built the ``"in"`` graph whatever it was
asked, where the reference's default is ``"out"``).
"""
import numpy as np
import pytest
import torch

from repro.core import oracle as joracle
from repro.graphs import csr as jcsr
from repro.graphs import generators as jgen
from repro_torch.core import oracle
from repro_torch.graphs import csr, generators


def _same_blocks(got, want):
    assert len(got) == len(want)
    for (r0, idx, ww), (jr0, jidx, jww) in zip(got, want):
        assert r0 == jr0
        assert idx.dtype == jidx.dtype and ww.dtype == jww.dtype
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(ww, jww)


def _decode(blocks):
    """The (src, dst, w) edges the blocks encode: every finite cell."""
    out = []
    for r0, idx, ww in blocks:
        rows, kpos = np.nonzero(np.isfinite(ww))
        out += [(int(idx[r, k]), int(r0 + r), float(ww[r, k]))
                for r, k in zip(rows, kpos)]
    return sorted(out)


def _blocks(n, src, dst, w, slice_rows):
    indptr, cols, ws, _ = csr.coo_to_csr(n, src, dst, w)
    got = csr.csr_to_sliced_ell(n, indptr, cols, ws, slice_rows=slice_rows)
    jindptr, jcols, jws, _ = jcsr.coo_to_csr(n, src, dst, w)
    want = jcsr.csr_to_sliced_ell(n, jindptr, jcols, jws,
                                  slice_rows=slice_rows)
    _same_blocks(got, want)
    return got


def test_sliced_ell_empty_rows():
    # rows 0, 2, 4 have in-edges; 1, 3, 5..7 are empty
    src = np.array([1, 3, 5], np.int64)
    dst = np.array([0, 2, 4], np.int64)
    w = np.array([1.0, 2.0, 3.0], np.float32)
    blocks = _blocks(8, src, dst, w, 4)
    assert [b[0] for b in blocks] == [0, 4]
    assert [b[1].shape for b in blocks] == [(4, 1), (4, 1)]
    assert np.isinf(blocks[1][2][1:]).all()
    assert _decode(blocks) == [(1, 0, 1.0), (3, 2, 2.0), (5, 4, 3.0)]


@pytest.mark.parametrize("n", [0, 5])
def test_sliced_ell_empty_graph(n):
    e = np.zeros(0, np.int64)
    blocks = _blocks(n, e, e, np.zeros(0, np.float32), 4)
    assert len(blocks) == -(-n // 4)
    assert all(b[1].shape[1] == 1 and np.isinf(b[2]).all() for b in blocks)


def test_sliced_ell_one_slice():
    """n <= slice_rows: one block, padded to the largest degree."""
    src = np.array([0, 1, 2, 3, 4, 0], np.int64)
    dst = np.array([5, 5, 5, 1, 1, 2], np.int64)
    w = np.arange(1, 7, dtype=np.float32)
    blocks = _blocks(6, src, dst, w, 256)
    assert len(blocks) == 1 and blocks[0][1].shape == (6, 3)
    assert _decode(blocks) == sorted(zip(src.tolist(), dst.tolist(),
                                         w.tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slice_rows", [8, 32])
def test_sliced_ell_round_trips(seed, slice_rows):
    """Seeded hub graphs: every edge encoded once, every other cell inert,
    each slice as wide as its largest in-degree."""
    n, src, dst, w = jgen.power_law_hubs(100, 600, n_hubs=2, seed=seed,
                                         orientation="in")
    w = np.random.default_rng(seed).uniform(0.5, 2, len(src)).astype(
        np.float32)
    blocks = _blocks(n, src, dst, w, slice_rows)
    assert _decode(blocks) == sorted(
        (int(s), int(d), float(x)) for s, d, x in zip(src, dst, w))
    deg = np.bincount(dst, minlength=n)
    for r0, idx, _ in blocks:
        assert idx.shape[1] == max(1, deg[r0:r0 + slice_rows].max())


def test_edges_of_pool_matches_reference():
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 40, (2, 64)).astype(np.int32)
    w = rng.uniform(0.5, 2, 64).astype(np.float32)
    act = rng.random(64) < 0.6
    want = joracle.edges_of_pool(src, dst, w, act)
    for pool in ((src, dst, w, act),
                 [torch.from_numpy(a) for a in (src, dst, w, act)]):
        got = oracle.edges_of_pool(*pool)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(want[0]) == act.sum()


@pytest.mark.parametrize("orientation", [None, "out", "in"])
@pytest.mark.parametrize("n,m,n_hubs,seed", [(64, 640, 4, 7),
                                             (300, 2500, 3, 5)])
def test_power_law_hubs_matches_reference(n, m, n_hubs, seed, orientation):
    """F6: each orientation, and the default, equals the reference's."""
    kw = {} if orientation is None else {"orientation": orientation}
    got = generators.power_law_hubs(n, m, n_hubs=n_hubs, seed=seed, **kw)
    want = jgen.power_law_hubs(n, m, n_hubs=n_hubs, seed=seed, **kw)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the hub mass sits on the side the orientation names
    hub_side = got[2] if orientation == "in" else got[1]
    other = got[1] if orientation == "in" else got[2]
    assert np.bincount(hub_side).max() > 2 * np.bincount(other).max()


def test_power_law_hubs_orientations_share_one_stream():
    _, s_out, d_out, _ = generators.power_law_hubs(64, 640, seed=7)
    _, s_in, d_in, _ = generators.power_law_hubs(64, 640, seed=7,
                                                 orientation="in")
    assert {(a, b) for a, b in zip(s_out, d_out)} != {
        (a, b) for a, b in zip(s_in, d_in)}
    # the same draws with the roles swapped (before self-loops and
    # duplicates drop): the same edges reversed
    assert {(a, b) for a, b in zip(s_out, d_out)} == {
        (b, a) for a, b in zip(s_in, d_in)}
    with pytest.raises(ValueError, match="orientation"):
        generators.power_law_hubs(64, 640, orientation="both")
