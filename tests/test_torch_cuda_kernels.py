"""The port's CUDA kernels on the card: kernels K1 (``ellpack_relax``, both
variants), K2
(``fused_sliced_relax``), K3 (``gathered_rows_relax``), K4 (``spmm_ell``)
and K5 (``embedding_bag``) against their plain torch versions, K1's, K2's
and K3's lane forms (S trees in one launch sequence) against S single-lane
kernel calls and the lane plain versions, and engines on the kernels
against the same engines on the plain versions (dense ELL on K1; sliced on
K2 and on K1 per run of slices; the sparse frontier on K3; batched
multi-source and bucketed engines on the lane forms, the batched sparse
frontier on K3's), and observability on the kernels'
engines (bit-identical to it off), the card's histogram bucketing and the
one-copy counter snapshot; K1 on each partition's block of the sharded
engine's ELL and sliced layouts, and the sharded engine (P = 4 partitions
stacked on the card) against the single-device engine on the card; K1's
lane form on each partition's block of a sharded lane engine, and that
engine (P = 8 on the card) against itself on the CPU.
Every test here needs a CUDA device and skips without one (decided
inside the test).  Tolerance: 0 — bit-identical — except the gradients of
``neighbor_reduce`` and ``bag_lookup``, whose backward scatters with
``index_add_``: on the card its atomics add in no fixed order, so the
kernel route's gradient is held against the plain route's within rtol =
atol = 1e-5 in f32 and one bf16 rounding (rtol 2^-7) in bf16.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only the port's requirements:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import make_engine
from repro_torch.core import events as ev
from repro_torch.graphs import generators, window
from repro_torch.graphs import csr
from repro_torch.kernels.embed_bag.embed_bag import embedding_bag
from repro_torch.kernels.embed_bag.ops import bag_lookup
from repro_torch.kernels.embed_bag.ref import embedding_bag_ref
from repro_torch.kernels.relax.fused import ChunkTable, fused_sliced_relax
from repro_torch.kernels.relax.gather import (gathered_rows_relax,
                                              gathered_rows_relax_lanes)
from repro_torch.kernels.relax.ref import (ellpack_relax_ref,
                                           fused_sliced_relax_ref,
                                           gathered_rows_relax_lanes_ref,
                                           gathered_rows_relax_ref,
                                           lane_minor_ref, lane_minor_shape)
from repro_torch.kernels.relax.relax import (LaneMinorOnce, ellpack_relax,
                                             lane_minor, variant)
from repro_torch.kernels.spmm.ops import neighbor_reduce
from repro_torch.kernels.spmm.ref import spmm_ell_ref
from repro_torch.kernels.spmm.spmm import spmm_ell

# (n offers, rows, K): K = 1, non-power-of-two K, K = 32, K > 32
SHAPES = [(50, 8, 1), (300, 256, 5), (64, 256, 32), (1000, 512, 40),
          (70000, 65536, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, n, rows, k, ties, device, tail=False):
    """offers with +inf entries and an ELL block whose row 0 is all
    tombstones; the other +inf cells are scattered, or with ``tail`` laid
    out as the ELL planner lays them out: a live head of fill[r] cells
    with tombstones among them, then never-written cells (idx 0, w +inf)
    to the row's end."""
    rng = np.random.default_rng(seed)
    if ties:
        offers = rng.integers(0, 4, n).astype(np.float32)
        w = rng.integers(1, 4, (rows, k)).astype(np.float32)
    else:
        offers = (4 * rng.random(n)).astype(np.float32)
        w = (0.5 + 1.5 * rng.random((rows, k))).astype(np.float32)
    offers[rng.random(n) < 0.3] = np.inf
    idx = rng.integers(0, n, (rows, k)).astype(np.int32)
    if tail:
        past = np.arange(k)[None, :] >= rng.integers(0, k + 1, rows)[:, None]
        w[past], idx[past] = np.inf, 0
        w[~past & (rng.random((rows, k)) < 0.15)] = np.inf
    else:
        w[rng.random((rows, k)) < 0.2] = np.inf
    w[0] = np.inf                                  # an all-tombstone row
    return [torch.from_numpy(a).to(device) for a in (offers, idx, w)]


def _k1_equal(offers, idx, w):
    before = ellpack_relax.launches
    best, arg = ellpack_relax(offers, idx, w)
    torch.cuda.synchronize()
    assert ellpack_relax.launches == before + 1
    rb, ra = ellpack_relax_ref(offers, idx, w)
    assert torch.equal(best, rb) and torch.equal(arg, ra)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,rows,k", SHAPES)
def test_k1_matches_plain_version(cuda, n, rows, k, ties):
    offers, idx, w = _case(n + k, n, rows, k, ties, cuda)
    before = ellpack_relax.launches
    best, arg = ellpack_relax(offers, idx, w)
    torch.cuda.synchronize()
    assert ellpack_relax.launches == before + 1
    rb, ra = ellpack_relax_ref(offers, idx, w)
    assert torch.equal(best, rb) and torch.equal(arg, ra)


# (n offers, rows, K): K = 4, 5, 64, 128 (a warp's 32 lanes of 4 cells),
# 130 (past a warp: the scalar variant loops); K = 32 at rows that are not
# a multiple of the 64 rows a block holds (3, 4,097)
K1_SHAPES = [(700, 130, 4), (300, 256, 5), (900, 99, 64), (900, 70, 128),
             (900, 33, 130), (300, 3, 32), (5000, 4097, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,rows,k", K1_SHAPES)
def test_k1_row_tail_padding_and_widths_match_plain_version(cuda, n, rows, k,
                                                             ties, tail):
    """Scattered +inf cells and the ELL planner's row-tail padding."""
    _k1_equal(*_case(n + rows + k, n, rows, k, ties, cuda, tail))


@pytest.mark.cuda
@pytest.mark.parametrize("offset,k,want", [
    (3, 32, "scalar"), (4, 32, "vector"), (1, 4, "scalar"),
    (2, 36, "scalar"), (5, 1, "scalar"), (0, 64, "vector")])
def test_k1_views_at_a_cell_offset(cuda, offset, k, want):
    """A block viewed at a cell offset of a flat buffer, as
    ``sliced_gather_min`` passes one run of slices: an offset that is not
    a multiple of 4 takes the scalar variant."""
    offers, idx, w = _case(offset + k, 500, 300, k, True, cuda, tail=True)
    flat_i = idx.new_zeros(offset + idx.numel())
    flat_w = w.new_zeros(offset + w.numel())
    flat_i[offset:], flat_w[offset:] = idx.reshape(-1), w.reshape(-1)
    vi, vw = flat_i[offset:].view(300, k), flat_w[offset:].view(300, k)
    assert variant(vi, vw) == want
    _k1_equal(offers, vi, vw)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 63, 4097])
def test_k1_all_inf_rows(cuda, rows):
    """Every weight +inf, then every offer +inf: best +inf and arg -1 in
    every row, at row counts that end inside a block."""
    offers, idx, w = _case(rows, 400, rows, 32, False, cuda, tail=True)
    _k1_equal(offers, idx, torch.full_like(w, float("inf")))
    _k1_equal(torch.full_like(offers, float("inf")), idx, w)
    best, arg = ellpack_relax(offers, idx, torch.full_like(w, float("inf")))
    assert bool(torch.isinf(best).all()) and bool((arg == -1).all())


@pytest.mark.cuda
def test_k1_refuses_wrong_dtype_on_the_card(cuda):
    offers, idx, w = _case(1, 50, 8, 3, False, cuda)
    with pytest.raises(ValueError, match="expected"):
        ellpack_relax(offers.double(), idx, w)


# (widths, slice_rows, n <= rows, overflow capacity, tie weights, active
# fraction):
# ragged run groups, mixed widths, ties, an empty overflow lane; a width-1
# slice beside width-32 ones; slice_rows 8 at width 2 (16 cells, fewer
# than a warp); runs that end inside a 1,024-cell chunk (1,280 rows at
# width 1, 264 rows at width 4); slices wider than a warp (hub_k 64)
K2_SHAPES = [((2, 2, 2), 8, 20, 8, False, 1.0),
             ((2,) * 40, 8, 300, 16, False, 0.5),
             ((1, 1, 4, 4, 4, 2, 8), 16, 100, 8, False, 1.0),
             ((2, 2, 4, 4), 16, 60, 32, True, 0.7),
             ((4, 32, 16, 2, 1, 8), 256, 1500, 4096, True, 0.6),
             ((2, 4), 8, 14, 0, False, 1.0),
             ((32, 32, 1, 32), 64, 250, 64, True, 0.8),
             ((2,), 8, 8, 4, False, 1.0),
             ((1,) * 5, 256, 1200, 128, False, 0.9),
             ((4,) * 33, 8, 260, 32, True, 1.0),
             ((64, 2, 64, 128), 16, 64, 16, True, 0.7)]


def _k2_case(seed, widths, slice_rows, n, ocap, ties, active_frac, device):
    """Random cells (60 % live, so +inf tombstones fall between live cells)
    and overflow entries (70 % live) over a random offers vector."""
    rng = np.random.default_rng(seed)
    L = slice_rows * sum(widths)
    wpool = np.asarray([0.5, 1.0] if ties else rng.uniform(0.1, 2.0, 8),
                       np.float32)
    flat_idx = rng.integers(0, n, L).astype(np.int32)
    flat_w = np.where(rng.random(L) < 0.6, rng.choice(wpool, L),
                      np.inf).astype(np.float32)
    osrc = rng.integers(0, n, ocap).astype(np.int32)
    odst = rng.integers(0, n, ocap).astype(np.int32)
    ow = np.where(rng.random(ocap) < 0.7, rng.choice(wpool, ocap),
                  np.inf).astype(np.float32)
    dist = np.where(rng.random(n) < 0.8, rng.uniform(0.0, 4.0, n),
                    np.inf).astype(np.float32)
    if ties:
        dist = np.floor(dist)
    active = rng.random(n) < active_frac
    t = [torch.from_numpy(a).to(device) for a in
         (dist, active, flat_idx, flat_w, osrc, odst, ow)]
    return t[:2], _layout(*t[2:], widths, slice_rows)


def _layout(flat_idx, flat_w, osrc, odst, ow, widths, slice_rows):
    """The layout object K2's wrapper reads (the fields a SlicedEllState
    holds for it), with the chunk table of its widths."""
    return SimpleNamespace(
        flat_idx=flat_idx, flat_w=flat_w, osrc=osrc, odst=odst, ow=ow,
        widths=widths, slice_rows=slice_rows,
        table=ChunkTable.build(widths, slice_rows, flat_w.device))


def _k2_ref(dist, active, lay):
    return fused_sliced_relax_ref(dist, active, lay.flat_idx, lay.flat_w,
                                  lay.osrc, lay.odst, lay.ow,
                                  widths=lay.widths,
                                  slice_rows=lay.slice_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,slice_rows,n,ocap,ties,active_frac",
                         K2_SHAPES)
def test_k2_matches_plain_version(cuda, widths, slice_rows, n, ocap, ties,
                                  active_frac):
    (dist, active), lay = _k2_case(n + ocap, widths, slice_rows, n, ocap,
                                   ties, active_frac, cuda)
    before = fused_sliced_relax.launches
    best, arg = fused_sliced_relax(dist, active, lay)
    torch.cuda.synchronize()
    assert fused_sliced_relax.launches == before + 1
    rb, ra = _k2_ref(dist, active, lay)
    assert torch.equal(best, rb) and torch.equal(arg, ra)


@pytest.mark.cuda
def test_k2_tombstones_padding_slices_and_dead_rows(cuda):
    """Rows whose live cells have +inf tombstones between them, a slice of
    padding only, rows with no live cell and a row count that ends inside
    a chunk, with every offer active and with none."""
    widths, slice_rows, n = (8, 4, 32, 1, 8), 64, 300
    (dist, active), lay = _k2_case(9, widths, slice_rows, n, 32, True, 1.0,
                                   cuda)
    flat_w = lay.flat_w.cpu().numpy()
    _, rowk, base, _ = csr.sliced_geometry(list(widths), slice_rows)
    for r in range(len(base)):
        cells = flat_w[base[r]:base[r] + rowk[r]]
        if r % 3 == 0:                       # live, +inf, live, +inf, ...
            cells[1::2] = np.inf
        elif r % 3 == 1 and rowk[r] > 2:     # live cells at both ends
            cells[1:-1] = np.inf
        elif r % 7 == 2:                     # no live cell at all
            cells[:] = np.inf
    flat_w[base[slice_rows]:base[2 * slice_rows]] = np.inf   # a dead slice
    lay.flat_w = torch.from_numpy(flat_w).to(cuda)
    for act in (active, torch.zeros_like(active)):
        best, arg = fused_sliced_relax(dist, act, lay)
        rb, ra = _k2_ref(dist, act, lay)
        assert torch.equal(best, rb) and torch.equal(arg, ra)


@pytest.mark.cuda
def test_k2_refuses_a_table_of_another_layout(cuda):
    """A layout holding a chunk table made for other widths — of the same
    size ((1, 4, 8, 32, 8) reorders the runs) or not — raises before any
    launch."""
    widths, slice_rows = (8, 4, 32, 1, 8), 64
    (dist, active), lay = _k2_case(3, widths, slice_rows, 300, 32, False,
                                   1.0, cuda)
    before = fused_sliced_relax.launches
    for other in ((8, 4, 32, 1, 8, 1), (1,) * 5, (32,) * 5, (1, 4, 8, 32, 8)):
        lay.table = ChunkTable.build(other, slice_rows, cuda)
        with pytest.raises(ValueError, match="another layout"):
            fused_sliced_relax(dist, active, lay)
    assert fused_sliced_relax.launches == before


# ------------------------------------------------- K1 and K2 lane forms --
# one lane, powers of two and not, one lane group (<= 8) and two (9, 16)
LANES = [1, 3, 4, 5, 8, 9, 16]


def _lanes_of(offers, s, seed, ties=False):
    """S lanes of offers over one block: lane 0 is ``offers``, the others
    are redrawn (+inf entries kept), and lane 1 is all +inf."""
    rng = np.random.default_rng(seed)
    n = offers.shape[0]
    out = offers.unsqueeze(0).repeat(s, 1)
    for t in range(1, s):
        v = (rng.integers(0, 4, n) if ties else 4 * rng.random(n))
        v = np.where(rng.random(n) < 0.3, np.inf, v).astype(np.float32)
        out[t] = torch.from_numpy(v).to(offers.device)
    if s > 1:
        out[1] = float("inf")
    return out


def _k1_lanes_equal(offers, idx, w):
    """One lane-form launch equals the lane plain version and, lane by
    lane, a single-lane kernel call on that lane's offers."""
    before = (ellpack_relax.launches, ellpack_relax.lane_launches)
    best, arg = ellpack_relax(offers, idx, w)
    torch.cuda.synchronize()
    assert (ellpack_relax.launches, ellpack_relax.lane_launches) == (
        before[0] + 1, before[1] + 1)
    assert best.shape == arg.shape == (offers.shape[0], idx.shape[0])
    rb, ra = ellpack_relax_ref(offers, idx, w)
    assert torch.equal(best, rb) and torch.equal(arg, ra)
    for t in range(offers.shape[0]):
        b1, a1 = ellpack_relax(offers[t].contiguous(), idx, w)
        assert torch.equal(best[t], b1) and torch.equal(arg[t], a1)
    return best, arg


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("n,rows,k,offset,want", [
    (5000, 4097, 32, 0, "vector"), (300, 256, 5, 0, "scalar"),
    (900, 70, 128, 0, "vector"), (900, 33, 130, 0, "scalar"),
    (500, 300, 32, 3, "scalar"), (1 << 16, 1 << 16, 32, 0, "vector")])
def test_k1_lanes_match_single_lane_calls(cuda, lanes, n, rows, k, offset,
                                          want):
    """K1's lane form, both variants (a view at an odd cell offset takes
    the scalar one): +inf rows, ties, an all-+inf lane."""
    offers, idx, w = _case(n + k + lanes, n, rows, k, True, cuda, tail=True)
    if offset:
        flat_i = idx.new_zeros(offset + idx.numel())
        flat_w = w.new_zeros(offset + w.numel())
        flat_i[offset:], flat_w[offset:] = idx.reshape(-1), w.reshape(-1)
        idx = flat_i[offset:].view(rows, k)
        w = flat_w[offset:].view(rows, k)
    assert variant(idx, w) == want
    best, arg = _k1_lanes_equal(_lanes_of(offers, lanes, lanes, ties=True),
                                idx, w)
    if lanes > 1:
        assert bool(torch.isinf(best[1]).all()) and bool((arg[1] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("case", [0, 3, 4, 5, 6, 10])
def test_k2_lanes_match_single_lane_calls(cuda, lanes, case):
    """K2's lane form at the K2_SHAPES geometries (ties; an empty overflow
    lane, case 5; hub rows wider than a warp, case 10): each lane its own
    dist and active mask (lane 1 all inactive, lane 2 all +inf), against
    the lane plain version and S single-lane kernel calls."""
    widths, slice_rows, n, ocap, ties, frac = K2_SHAPES[case]
    (dist, active), lay = _k2_case(case + lanes, widths, slice_rows, n,
                                   ocap, ties, frac, cuda)
    rng = np.random.default_rng(lanes)
    dist = _lanes_of(dist, lanes, case, ties=ties)
    if lanes > 2:
        dist[2] = float("inf")
    act = torch.from_numpy(rng.random((lanes, n)) < frac).to(cuda)
    act[0] = active
    if lanes > 1:
        act[1] = False
    before = (fused_sliced_relax.launches, fused_sliced_relax.lane_launches)
    best, arg = fused_sliced_relax(dist, act, lay)
    torch.cuda.synchronize()
    assert (fused_sliced_relax.launches, fused_sliced_relax.lane_launches) \
        == (before[0] + 1, before[1] + 1)
    rb, ra = _k2_ref(dist, act, lay)
    assert torch.equal(best, rb) and torch.equal(arg, ra)
    for t in range(lanes):
        b1, a1 = fused_sliced_relax(dist[t].contiguous(),
                                    act[t].contiguous(), lay)
        assert torch.equal(best[t], b1) and torch.equal(arg[t], a1)
    if lanes > 1:
        assert bool(torch.isinf(best[1]).all())
        assert bool((arg[1] == 2**31 - 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3, 4, 9, 16])
def test_k1_lane_minor_copy_made_by_the_caller(cuda, lanes):
    """``lane_minor`` on the card equals its plain version (+inf past the
    last lane and where a mask is False; a view of the offers for one
    lane), and K1's lane form on a caller-made copy (both variants)
    equals the call that makes its own; a copy of another shape, dtype or
    alignment raises before any launch."""
    offers, idx, w = _case(lanes, 3000, 700, 32, True, cuda, tail=True)
    offers = _lanes_of(offers, lanes, lanes, ties=True)
    active = torch.from_numpy(
        np.random.default_rng(lanes).random(offers.shape) < 0.6).to(cuda)
    before = lane_minor.launches
    minor = lane_minor(offers)
    masked = lane_minor(offers, active)
    torch.cuda.synchronize()
    assert lane_minor.launches == before + (1 if lanes == 1 else 2)
    assert minor.shape == lane_minor_shape(lanes, offers.shape[1])
    assert torch.equal(minor, lane_minor_ref(offers))
    assert torch.equal(masked, lane_minor_ref(offers, active))
    if lanes == 1:
        assert minor.data_ptr() == offers.data_ptr()
    flat_i, flat_w = idx.new_zeros(3 + idx.numel()), w.new_zeros(3 + w.numel())
    flat_i[3:], flat_w[3:] = idx.reshape(-1), w.reshape(-1)
    for bi, bw in ((idx, w), (flat_i[3:].view(idx.shape),
                              flat_w[3:].view(w.shape))):
        launches = ellpack_relax.launches
        got = ellpack_relax(offers, bi, bw, offers_minor=minor)
        own = ellpack_relax(offers, bi, bw)
        assert ellpack_relax.launches == launches + 2
        assert all(map(torch.equal, got, own))
        assert all(map(torch.equal, got, ellpack_relax_ref(offers, bi, bw)))
    g, n, k = minor.shape
    bad = [torch.full((g, n + 1, k), 1.0, device=cuda), minor.double(),
           torch.empty(minor.numel() + 1, device=cuda)[1:].view(minor.shape)]
    launches = ellpack_relax.launches
    for b in bad:
        with pytest.raises(ValueError, match="offers_minor"):
            ellpack_relax(offers, idx, w, offers_minor=b)
    assert ellpack_relax.launches == launches


@pytest.mark.cuda
def test_lane_forms_repeated_and_in_a_cuda_graph(cuda):
    """K1's and K2's lane forms called twice in a row, then captured in a
    CUDA graph and replayed on new inputs written in place: every result
    equals the lane plain version of the inputs of the moment (K2's key
    scratch is reset for every lane in every call)."""
    offers, idx, w = _case(7, 3000, 2048, 32, True, cuda, tail=True)
    offers = _lanes_of(offers, 4, 7, ties=True)
    (dist, active), lay = _k2_case(8, *K2_SHAPES[4][:5], 1.0, cuda)
    dist = _lanes_of(dist, 4, 8, ties=True)
    active = active.unsqueeze(0).repeat(4, 1)
    for _ in range(2):
        _k1_lanes_equal(offers, idx, w)
        got = fused_sliced_relax(dist, active, lay)
        assert all(map(torch.equal, got, _k2_ref(dist, active, lay)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ellpack_relax(offers, idx, w)
        fused_sliced_relax(dist, active, lay)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        k1 = ellpack_relax(offers, idx, w)
        k2 = fused_sliced_relax(dist, active, lay)
    rng = np.random.default_rng(9)
    for seed in (10, 11):
        offers.copy_(_lanes_of(offers[0].flip(0), 4, seed, ties=True))
        dist.copy_(_lanes_of(dist[3].flip(0), 4, seed, ties=True))
        active.copy_(torch.from_numpy(rng.random(active.shape) < 0.6))
        graph.replay()
        torch.cuda.synchronize()
        assert all(map(torch.equal, k1, ellpack_relax_ref(offers, idx, w)))
        assert all(map(torch.equal, k2, _k2_ref(dist, active, lay)))


def _k3_case(seed, e, n, ties, mask_frac, device, hub=False, dup=False):
    """E slots over n rows; ``hub`` sends every slot to one row, ``dup``
    makes the second half of the slots a copy of the first."""
    rng = np.random.default_rng(seed)
    if ties:
        wd = rng.integers(0, 3, e).astype(np.float32)
        w = rng.integers(1, 3, e).astype(np.float32)
    else:
        wd = rng.uniform(0, 3, e).astype(np.float32)
        w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    wd[rng.random(e) < 0.1] = np.inf
    w[rng.random(e) < 0.1] = np.inf
    src = rng.integers(0, n, e).astype(np.int32)
    nbr = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < mask_frac
    if hub:
        nbr[:] = n // 2
    if dup:
        h = e // 2
        for a in (wd, src, nbr, w, mask):
            a[h:2 * h] = a[:h]
    return [torch.from_numpy(a).to(device) for a in (wd, src, nbr, w, mask)]


def _k3_equal(args, n):
    before = gathered_rows_relax.launches
    best, arg = gathered_rows_relax(*args, num_rows=n)
    torch.cuda.synchronize()
    assert gathered_rows_relax.launches == before + 1
    rb, ra = gathered_rows_relax_ref(*args, num_rows=n)
    assert torch.equal(best, rb) and torch.equal(arg, ra)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,ties,mask_frac", [
    (85, 40, False, 0.7), (300, 17, True, 1.0), (64, 64, False, 0.0),
    (0, 12, False, 0.7), (1 << 20, 1 << 16, True, 0.8)])
def test_k3_matches_plain_version(cuda, e, n, ties, mask_frac):
    args = _k3_case(e + n, e, n, ties, mask_frac, cuda)
    before = gathered_rows_relax.launches
    best, arg = gathered_rows_relax(*args, num_rows=n)
    torch.cuda.synchronize()
    assert gathered_rows_relax.launches == before + 1
    rb, ra = gathered_rows_relax_ref(*args, num_rows=n)
    assert torch.equal(best, rb) and torch.equal(arg, ra)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,kw", [
    (0, 1 << 20, {}), (4096, 5000, dict(mask_frac=0.0)),
    (4096, 5000, dict(hub=True)), (4096, 5000, dict(hub=True, ties=True)),
    (3000, 300, dict(dup=True, ties=True)), (300, 1, dict(ties=True)),
    (16_384, 1 << 20, {})], ids=["E=0", "all masked", "hub row",
                                 "hub row, ties", "duplicate slots", "R=1",
                                 "the sparse path's shape"])
def test_k3_edge_cases(cuda, e, n, kw):
    """E = 0, every slot masked out, one hub row hit by every slot,
    duplicate (src, nbr, w) slots, R = 1, and E = 16,384 over 2^20 rows;
    each twice in a row, so a key left by the first call would show in the
    second."""
    kw = {"ties": False, "mask_frac": 0.8, **kw}
    ties, mask_frac = kw.pop("ties"), kw.pop("mask_frac")
    args = _k3_case(e + n, e, n, ties, mask_frac, cuda, **kw)
    _k3_equal(args, n)
    _k3_equal(args, n)


@pytest.mark.cuda
def test_k3_calls_do_not_leak_into_later_calls(cuda):
    """Two inputs over the same rows, back to back and then in the other
    order: each result equals the plain version of its own inputs."""
    a = _k3_case(1, 5000, 700, True, 0.9, cuda)
    b = _k3_case(2, 800, 700, True, 0.5, cuda)
    for args in (a, b, a, b, b, a):
        _k3_equal(args, 700)


@pytest.mark.cuda
def test_k3_in_a_cuda_graph(cuda):
    """A K3 call captured in a CUDA graph and replayed, then replayed again
    after the inputs were overwritten in place: each replay equals the
    plain version of the inputs of the moment."""
    n = 5000
    args = _k3_case(3, 4096, n, True, 0.8, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gathered_rows_relax(*args, num_rows=n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        best, arg = gathered_rows_relax(*args, num_rows=n)
    for seed in (4, 5):
        for t, new in zip(args, _k3_case(seed, 4096, n, True, 0.8, cuda)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        rb, ra = gathered_rows_relax_ref(*args, num_rows=n)
        assert torch.equal(best, rb) and torch.equal(arg, ra)


@pytest.mark.cuda
def test_k2_k3_refuse_wrong_dtype_on_the_card(cuda):
    (dist, active), lay = _k2_case(1, (2, 2), 8, 16, 8, False, 1.0, cuda)
    with pytest.raises(ValueError, match="active"):
        fused_sliced_relax(dist, active.to(torch.uint8), lay)
    args = _k3_case(1, 16, 8, False, 1.0, cuda)
    args[1] = args[1].long()
    with pytest.raises(ValueError, match="src_ids"):
        gathered_rows_relax(*args, num_rows=8)


def _k3_lanes(seed, lanes, e, n, device):
    """[S, E] edge lists with ties: lane 1 all masked, lane 2 every slot on
    one hub row, lane 3 a copy of lane 0 (the same rows and keys in two
    lanes), the others drawn apart."""
    rows = []
    for t in range(lanes):
        rows.append(rows[0] if t == 3 else _k3_case(
            seed + t, e, n, True, 0.0 if t == 1 else 0.8, device,
            hub=t == 2))
    return [torch.stack(col).contiguous() for col in zip(*rows)]


def _k3_lanes_equal(args, n):
    """One lane-form call (counted as a lane launch, not a single one)
    equals the lane plain version and, lane by lane, a single-lane kernel
    call on that lane's edge list."""
    before = (gathered_rows_relax.launches,
              gathered_rows_relax.lane_launches)
    best, arg = gathered_rows_relax_lanes(*args, num_rows=n)
    torch.cuda.synchronize()
    assert (gathered_rows_relax.launches,
            gathered_rows_relax.lane_launches) == (before[0], before[1] + 1)
    assert best.shape == arg.shape == (args[0].shape[0], n)
    rb, ra = gathered_rows_relax_lanes_ref(*args, num_rows=n)
    assert torch.equal(best, rb) and torch.equal(arg, ra)
    for t in range(args[0].shape[0]):
        b1, a1 = gathered_rows_relax(*(x[t] for x in args), num_rows=n)
        assert torch.equal(best[t], b1) and torch.equal(arg[t], a1)


K3_LANES = [1, 3, 4, 5, 8, 9, 16]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", K3_LANES)
@pytest.mark.parametrize("e,n", [(0, 12), (85, 40), (300, 1), (4096, 5000),
                                 (16_384, 1 << 20)],
                         ids=["E=0", "small", "R=1", "mid",
                              "the sparse path's shape"])
def test_k3_lanes_match_plain_version_and_single_lanes(cuda, lanes, e, n):
    """K3's lane form on ragged lanes (an all-masked lane, a hub row, two
    equal lanes), E = 0, R = 1 and the sparse path's E = 16,384 over 2^20
    rows, twice in a row: bit-identical to the lane plain version and to S
    single-lane calls."""
    args = _k3_lanes(lanes + e + n, lanes, e, n, cuda)
    _k3_lanes_equal(args, n)
    _k3_lanes_equal(args, n)


@pytest.mark.cuda
def test_k3_lanes_in_a_cuda_graph(cuda):
    """A lane-form call captured in a CUDA graph, replayed on new inputs
    written in place: each replay equals the lane plain version."""
    n = 5000
    args = _k3_lanes(20, 5, 4096, n, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gathered_rows_relax_lanes(*args, num_rows=n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        best, arg = gathered_rows_relax_lanes(*args, num_rows=n)
    for seed in (21, 22):
        for t, new in zip(args, _k3_lanes(seed, 5, 4096, n, cuda)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        rb, ra = gathered_rows_relax_lanes_ref(*args, num_rows=n)
        assert torch.equal(best, rb) and torch.equal(arg, ra)


@pytest.mark.cuda
def test_k3_lanes_refuse_bad_arguments(cuda):
    """Mismatched [S, E] shapes, a wrong dtype, 1-D arrays and tensors
    split between the CPU and the card raise before any launch."""
    args = _k3_lanes(30, 3, 64, 50, cuda)
    before = gathered_rows_relax.lane_launches
    short = [*args[:3], args[3][:, :-1].contiguous(), args[4]]
    with pytest.raises(ValueError, match="one shape"):
        gathered_rows_relax_lanes(*short, num_rows=50)
    with pytest.raises(ValueError, match="src_ids"):
        gathered_rows_relax_lanes(args[0], args[1].long(), *args[2:],
                                  num_rows=50)
    with pytest.raises(ValueError, match="2-D"):
        gathered_rows_relax_lanes(*(x[0] for x in args), num_rows=50)
    with pytest.raises(ValueError, match="CUDA device"):
        gathered_rows_relax_lanes(args[0].cpu(), *args[1:], num_rows=50)
    with pytest.raises(ValueError, match="CUDA device"):
        gathered_rows_relax_lanes(*args[:4], args[4].cpu(), num_rows=50)
    assert gathered_rows_relax.lane_launches == before


def _same_bits(got, want):
    """The same NaN positions and equal bits everywhere else."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    ints = torch.int32 if got.dtype == torch.float32 else torch.int16
    assert torch.equal(got[~nan].view(ints), want[~nan].view(ints))


# (s, r, k, f, integer features): K = 1, K past a warp, F not a multiple
# of 4, F = 1, F over one 128-feature chunk; ties with integer features;
# K not a multiple of the rows in flight (37 at 16 lanes, 17 at 4 lanes)
K4_SHAPES = [(40, 64, 1, 32, False), (300, 96, 40, 18, False),
             (16, 128, 12, 24, True), (10, 8, 5, 1, True),
             (1000, 512, 15, 602, False), (500, 256, 37, 64, False),
             (200, 128, 17, 16, True)]


def _k4_case(seed, s, r, k, f, ties, dtype, device):
    """All-masked first rows, -1 in masked cells, a duplicate index in
    each row's second cell."""
    rng = np.random.default_rng(seed)
    feats = (rng.integers(-3, 4, (s, f)) if ties
             else rng.standard_normal((s, f))).astype(np.float32)
    idx = rng.integers(0, s, (r, k)).astype(np.int32)
    if k > 1:
        idx[:, 1] = idx[:, 0]
    mask = rng.random((r, k)) < 0.7
    mask[:3] = False
    idx[~mask] = -1
    return (torch.from_numpy(feats).to(device, dtype),
            torch.from_numpy(idx).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
@pytest.mark.parametrize("s,r,k,f,ties", K4_SHAPES)
def test_k4_matches_plain_version(cuda, s, r, k, f, ties, agg, dtype):
    args = _k4_case(s + k + f, s, r, k, f, ties, dtype, cuda)
    before = spmm_ell.launches
    out = spmm_ell(*args, agg=agg)
    torch.cuda.synchronize()
    assert spmm_ell.launches == before + 1
    _same_bits(out, spmm_ell_ref(*args, agg))


@pytest.mark.cuda
def test_k4_max_propagates_nan(cuda):
    feats, idx, mask = _k4_case(3, 50, 64, 9, 40, False, torch.float32, cuda)
    feats[idx[mask][:5].long(), 7] = float("nan")
    out = spmm_ell(feats, idx, mask, agg="max")
    assert bool(out.isnan().any())
    _same_bits(out, spmm_ell_ref(feats, idx, mask, "max"))


# (v, b, l, d, tail): DIN's D = 18, L = 1, L past a warp, D over one
# chunk; with tail padding after each bag's history as well: DIN's
# serve_p99 widths (512 bags of 100 slots), L = 37 and L = 1 (not
# multiples of the 16 rows in flight), one bag
K5_SHAPES = [(500, 64, 100, 18, False), (40, 24, 1, 32, False),
             (300, 8, 45, 130, False), (30, 10, 7, 1, False),
             (10_000, 512, 100, 18, True), (300, 64, 37, 18, True),
             (50, 16, 1, 18, True), (100, 1, 100, 18, True)]


def _k5_case(seed, v, b, l, d, dtype, device, tail=False):
    """A quarter of the slots padding and, past two bags, the first two
    bags all padding and the third one row repeated; with ``tail``, also
    -1 after a random length in [1, L] in every bag."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    idx[rng.random((b, l)) < 0.25] = -1
    if tail:
        lens = rng.integers(1, l + 1, b)
        idx[np.arange(l)[None, :] >= lens[:, None]] = -1
    if b > 2:
        idx[:2] = -1
        idx[2] = 5
    return torch.from_numpy(table).to(device, dtype), torch.from_numpy(
        idx).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("agg", ["sum", "mean"])
@pytest.mark.parametrize("v,b,l,d,tail", K5_SHAPES)
def test_k5_matches_plain_version(cuda, v, b, l, d, tail, agg, dtype):
    table, idx = _k5_case(v + l + d, v, b, l, d, dtype, cuda, tail)
    before = embedding_bag.launches
    out = embedding_bag(table, idx, agg=agg)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    _same_bits(out, embedding_bag_ref(table, idx, agg=agg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_clamp_a_live_index_past_the_end(cuda, dtype):
    """A live index >= S (K4) or >= V (K5) reads the last row, as the plain
    versions clamp it; a negative live cell of K4 reads row 0."""
    feats, idx, mask = _k4_case(4, 50, 64, 9, 40, False, dtype, cuda)
    mask[5:, :3] = True
    idx[5:, 0], idx[5:, 1], idx[5:, 2] = 50, 1 << 30, -7
    for agg in ("sum", "mean", "max"):
        _same_bits(spmm_ell(feats, idx, mask, agg=agg),
                   spmm_ell_ref(feats, idx, mask, agg))
    table, bags = _k5_case(5, 30, 8, 45, 18, dtype, cuda)
    bags[3:, 0], bags[3:, 7] = 30, (1 << 31) - 1
    for agg in ("sum", "mean"):
        _same_bits(embedding_bag(table, bags, agg=agg),
                   embedding_bag_ref(table, bags, agg=agg))


def _grads(entry, leaf, rest, agg, w):
    """d(leaf) through ``entry`` on the kernel (None) and the plain
    (False) route, with the forward outputs, which must be equal."""
    outs = []
    for use_kernel in (None, False):
        x = leaf.detach().requires_grad_(True)
        out = entry(x, *rest, agg, use_kernel)
        (g,) = torch.autograd.grad(out, x, w.to(out.dtype))
        outs.append((out.detach(), g))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_gradients_match_plain_route(cuda, dtype):
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(
        rtol=2**-7, atol=1e-5)
    before = (spmm_ell.launches, embedding_bag.launches)
    for agg in ("sum", "mean", "max"):
        feats, idx, mask = _k4_case(7, 300, 512, 15, 64, agg == "max",
                                    dtype, cuda)
        w = torch.randn(512, 64, device=cuda)
        (ko, kg), (po, pg) = _grads(neighbor_reduce, feats, (idx, mask),
                                    agg, w)
        _same_bits(ko, po)
        torch.testing.assert_close(kg, pg, **tol)
    for agg in ("sum", "mean"):
        table, idx = _k5_case(8, 700, 256, 100, 18, dtype, cuda)
        w = torch.randn(256, 18, device=cuda)
        (ko, kg), (po, pg) = _grads(bag_lookup, table, (idx,), agg, w)
        _same_bits(ko, po)
        torch.testing.assert_close(kg, pg, **tol)
    assert (spmm_ell.launches, embedding_bag.launches) == (before[0] + 3,
                                                           before[1] + 2)


@pytest.mark.cuda
def test_k4_k5_refuse_device_mix_and_wrong_dtype(cuda):
    feats, idx, mask = _k4_case(1, 20, 16, 4, 8, False, torch.float32, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        spmm_ell(feats, idx.cpu(), mask)
    with pytest.raises(ValueError, match="expected"):
        spmm_ell(feats.double(), idx, mask)
    with pytest.raises(ValueError, match="expected"):
        spmm_ell(feats, idx.long(), mask)
    table, bags = _k5_case(2, 30, 8, 5, 18, torch.float32, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        embedding_bag(table.cpu(), bags)
    with pytest.raises(ValueError, match="expected"):
        embedding_bag(table.half(), bags)


def _er_stream():
    n, src, dst, w = generators.erdos_renyi(1 << 10, 8 << 10, seed=7)
    win = int(0.3 * len(src))
    log = ev.interleave_queries(window.sliding_window_stream(
        src, dst, w, window=win, delta=0.3, seed=0), win // 10)
    return n, len(src) + 64, log


def _rmat_stream():
    n, src, dst, w = generators.rmat(11, 8, seed=7)
    win = int(0.3 * len(src))
    log = ev.interleave_queries(window.sliding_window_stream(
        src, dst, w, window=win, delta=0.3, seed=0), win // 10)
    return n, len(src) + 64, log


def _same_runs(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        assert a.epoch_stats == b.epoch_stats


def _run(stream, kernel, **knobs):
    n, cap, log = stream
    before = kernel.launches
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      batch_deletions=True, **knobs)
    return eng.ingest_log(log), kernel.launches - before


@pytest.mark.cuda
def test_engine_on_k1_matches_engine_on_plain_version(cuda):
    stream = _er_stream()
    got, launched = _run(stream, ellpack_relax, relax_backend="ellpack",
                         ell_use_kernel=True)
    want, plain = _run(stream, ellpack_relax, relax_backend="ellpack",
                       ell_use_kernel=False)
    assert launched > 0 and plain == 0
    _same_runs(got, want)


@pytest.mark.cuda
def test_sliced_engines_on_k2_and_k1_match_plain_version(cuda):
    """RMAT hubs, small slices and hub threshold: the fused wave on K2 (the
    default on the card: no kernel flag set), the unfused wave on K1 per
    run of slices, and the plain wave agree."""
    stream = _rmat_stream()
    kw = dict(relax_backend="sliced", sliced_slice_rows=32, sliced_hub_k=8)
    want, plain = _run(stream, fused_sliced_relax, ell_use_kernel=False,
                       sliced_fused=False, **kw)
    fused, k2 = _run(stream, fused_sliced_relax, **kw)
    unfused, k1 = _run(stream, ellpack_relax, ell_use_kernel=True,
                       sliced_fused=False, **kw)
    assert k2 > 0 and k1 > 0 and plain == 0
    _same_runs(fused, want)
    _same_runs(unfused, want)


@pytest.mark.cuda
def test_auto_engine_launches_k2_by_default(cuda):
    """relax_backend="auto" with no kernel flag: the RMAT stream's first
    rebuild falls back to sliced, whose waves run on K2; the result equals
    the plain engine's."""
    stream = _rmat_stream()
    kw = dict(sliced_slice_rows=32, sliced_hub_k=8)
    n, cap, log = stream
    before = fused_sliced_relax.launches
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      batch_deletions=True, relax_backend="auto", **kw)
    got = eng.ingest_log(log)
    assert eng.backend_name == "sliced"
    assert fused_sliced_relax.launches > before
    want, plain = _run(stream, fused_sliced_relax, relax_backend="auto",
                       ell_use_kernel=False, sliced_fused=False, **kw)
    assert plain == 0
    _same_runs(got, want)


@pytest.mark.cuda
def test_sparse_engine_on_k3_matches_plain_version(cuda):
    """The sparse frontier with no kernel flag runs K3 on the card; with
    frontier_kernel=False it runs the plain version; both agree."""
    stream = _rmat_stream()
    kw = dict(frontier_mode="sparse", frontier_cap=64)
    got, launched = _run(stream, gathered_rows_relax, **kw)
    want, plain = _run(stream, gathered_rows_relax, frontier_kernel=False,
                       **kw)
    assert launched > 0 and plain == 0
    _same_runs(got, want)


def _same_lane_runs(got, want):
    """Query results of batched engines: arrays and per-lane counters."""
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        assert a.epoch_stats.keys() == b.epoch_stats.keys()
        for k in a.epoch_stats:
            np.testing.assert_array_equal(a.epoch_stats[k], b.epoch_stats[k])


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["rounds", "buckets"])
@pytest.mark.parametrize("backend,knobs,kernel", [
    ("ellpack", dict(ell_init_k=2), ellpack_relax),
    ("sliced", dict(sliced_slice_rows=32, sliced_hub_k=8), fused_sliced_relax),
    ("sliced", dict(sliced_slice_rows=32, sliced_hub_k=8,
                    sliced_fused=False, ell_use_kernel=True), ellpack_relax)],
    ids=["ellpack-K1", "sliced-K2", "sliced-K1-runs"])
def test_batched_engines_on_lane_forms_match_plain_version(
        cuda, schedule, backend, knobs, kernel):
    """Three lanes (``sources=``) on the card's kernels launch the lane
    forms and equal the same engine on the plain versions, lane for lane
    and counter for counter, under both schedules."""
    n, cap, log = _rmat_stream()
    kw = dict(relax_backend=backend, sources=(3, 17, 40), **knobs)
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=1.0)
    before = kernel.lane_launches
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      batch_deletions=True, **kw)
    got = eng.ingest_log(log)
    assert kernel.lane_launches > before
    plain = {**kw, "ell_use_kernel": False}
    if backend == "sliced":
        plain["sliced_fused"] = False
    before = (ellpack_relax.launches, fused_sliced_relax.launches)
    ref = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      batch_deletions=True, **plain)
    want = ref.ingest_log(log)
    assert (ellpack_relax.launches, fused_sliced_relax.launches) == before
    _same_lane_runs(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["rounds", "buckets"])
def test_batched_sparse_engine_on_k3_lane_form_matches_plain_version(
        cuda, schedule):
    """Three lanes on the sparse frontier with no kernel flag launch K3's
    lane form and never the single-lane kernel, and equal the same engine
    on the plain version, lane for lane and counter for counter."""
    n, cap, log = _rmat_stream()
    kw = dict(frontier_mode="sparse", frontier_cap=64, sources=(3, 17, 40))
    if schedule == "buckets":
        kw.update(wave_schedule="buckets", bucket_width=1.0)
    before = (gathered_rows_relax.launches,
              gathered_rows_relax.lane_launches)
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      batch_deletions=True, **kw)
    got = eng.ingest_log(log)
    assert gathered_rows_relax.launches == before[0]
    assert gathered_rows_relax.lane_launches > before[1]
    before = gathered_rows_relax.lane_launches
    ref = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      batch_deletions=True, frontier_kernel=False, **kw)
    want = ref.ingest_log(log)
    assert gathered_rows_relax.lane_launches == before
    _same_lane_runs(got, want)


# ----------------------------------------------------------- observability --
@pytest.mark.cuda
@pytest.mark.parametrize("kernel,knobs", [
    (ellpack_relax, dict(relax_backend="ellpack", ell_init_k=2)),
    (fused_sliced_relax, dict(relax_backend="auto", sliced_slice_rows=32,
                              sliced_hub_k=8, wave_schedule="buckets",
                              bucket_width=1.0)),
    (gathered_rows_relax, dict(frontier_mode="sparse", frontier_cap=64))],
    ids=["K1", "K2-auto-buckets", "K3-sparse"])
def test_obs_engines_on_kernels_match_obs_off(cuda, kernel, knobs):
    """observability=True on the card's kernels changes no route and no
    result: the same launches, the same answers and counters as with it
    off; its snapshot agrees with the engine's own figures."""
    stream = _rmat_stream()
    want, off = _run(stream, kernel, **knobs)
    n, cap, log = stream
    before = kernel.launches
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      batch_deletions=True, observability=True, **knobs)
    got = eng.ingest_log(log)
    assert kernel.launches - before == off > 0
    _same_runs(got, want)
    snap = eng.metrics_snapshot()
    ct, sp, h = snap["counters"], snap["spans"], snap["histograms"]
    assert snap["rounds"] == eng.n_rounds and snap["messages"] == \
        eng.n_messages
    assert sp["add_epoch"] == ct["add_epochs"] == \
        h["frontier_occupancy"]["count"]
    assert sp["query"] == ct["queries"] == len(got)
    assert sp.get("rebuild", 0) == ct.get("rebuilds", 0)
    if kernel is gathered_rows_relax:
        assert ct["frontier_occupancy"] > 0
    if knobs.get("wave_schedule") == "buckets":
        assert ct["drain_waves"] > 0 and ct["pending_push"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int64, torch.int32])
def test_device_bucketing_on_the_card_equals_host_twin(cuda, dtype):
    """The histogram bucketing of CUDA tensors lands every sample where
    the host twin ``bucket_index_np`` does: 0, 0.3, 1, 2^k - 1, 2^k,
    2^k + 1 (k <= 24), NaN, negatives, +-inf."""
    from repro_torch.obs import hist
    vals = [0.0, 0.3, 1.0] + [float(v) for k in range(1, 25)
                              for v in (2**k - 1, 2**k, 2**k + 1)]
    if dtype.is_floating_point:
        vals += [float("nan"), -7.0, -float("inf")]
    else:
        vals = [v for v in vals if v.is_integer()] + [-7.0]
    t = torch.tensor(vals, dtype=torch.float64).to(dtype)
    got = hist.bucket_index(t.to(cuda)).cpu().tolist()
    assert got == [hist.bucket_index_np(float(v)) for v in t.tolist()]
    assert hist.bucket_index(torch.tensor([float("inf")], device=cuda)
                             ).item() == hist.NUM_BUCKETS - 1
    counts = hist.one_hot(t.to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(
        counts, sum(hist.one_hot_np(float(v)) for v in t.tolist()))


@pytest.mark.cuda
def test_counter_snapshot_is_one_copy_from_the_card(cuda, monkeypatch):
    """A bucketed engine's registry (pending counts, message histograms,
    on the card) comes back to the host in one device->host copy."""
    n, cap, log = _rmat_stream()
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      observability=True, wave_schedule="buckets",
                      relax_backend="ellpack")
    eng.ingest_log(log)
    eng.obs.flush_histograms()
    assert any(isinstance(v, torch.Tensor) and v.is_cuda
               for v in eng.obs.counters._dev.values())
    reads = []
    for meth in ("to", "cpu", "item", "tolist", "__int__", "__float__",
                 "__bool__", "__index__", "__array__"):
        real = getattr(torch.Tensor, meth)

        def counted(self, *a, _real=real, _m=meth, **k):
            out = _real(self, *a, **k)
            if self.is_cuda and not (isinstance(out, torch.Tensor)
                                     and out.is_cuda):
                reads.append(_m)
            return out

        monkeypatch.setattr(torch.Tensor, meth, counted)
    snap = eng.obs.counters.snapshot()
    monkeypatch.undo()
    assert reads == ["to"], reads
    assert snap["pending_push"] > 0


# ----------------------------------------------------------- sharded engine --
def _er12_stream():
    n, src, dst, w = generators.erdos_renyi(1 << 12, 8 << 12, seed=7)
    win = int(0.3 * len(src))
    log = ev.interleave_queries(window.sliding_window_stream(
        src, dst, w, window=win, delta=0.3, seed=0), win // 10)
    return n, len(src) + 64, log


def _card_mesh(p):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((p,), ("graph",), devices=[torch.device("cuda:0")] * p)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,init_k", [("ellpack", 2), ("ellpack", 8),
                                            ("sliced", 1)])
def test_k1_on_each_partition_block_of_a_sharded_layout(cuda, backend,
                                                        init_k):
    """K1 on every partition's own block (dense ELL: the whole block;
    sliced: each width run, a view at its cell offset) against the gathered
    offers, bit for bit; the variant follows ``variant``'s rule — each
    dense block is its own contiguous tensor, so it takes "vector" wherever
    K % 4 == 0."""
    n, cap, log = _er12_stream()
    knobs = (dict(ell_init_k=init_k) if backend == "ellpack" else
             dict(sliced_slice_rows=64, sliced_hub_k=8, sliced_init_k=init_k))
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      mesh=_card_mesh(4), relax_backend=backend,
                      batch_deletions=True, **knobs)
    eng.ingest_log(log[:len(log) // 2])
    offers = eng.ds.all_gather(eng.dist)
    seen = set()
    for p, st in enumerate(eng.bk.states):
        if backend == "ellpack":
            blocks = [(st.nbr_idx, st.nbr_w)]
            assert variant(*blocks[0]) == ("vector" if st.k % 4 == 0
                                           else "scalar")
        else:
            blocks, off = [], 0
            for k, cnt in csr.width_runs(st.widths):
                rows = st.slice_rows * cnt
                blocks.append((st.flat_idx[off:off + rows * k].view(rows, k),
                               st.flat_w[off:off + rows * k].view(rows, k)))
                off += rows * k
        for idx, w in blocks:
            seen.add(variant(idx, w))
            _k1_equal(offers[p], idx, w)
    assert seen


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    dict(relax_backend="ellpack"),
    dict(relax_backend="sliced", exchange="delta", delta_cap=64,
         sliced_slice_rows=64, sliced_hub_k=8),
    dict(relax_backend="ellpack", wave_schedule="buckets", bucket_width=1.0,
         frontier_mode="sparse", frontier_cap=64)])
def test_sharded_engine_on_the_card_matches_single_device(cuda, knobs):
    """The sharded engine at P = 4 on one card (K1 per partition and wave)
    equals the single-device engine on the card at every query — (dist,
    parent) always, the stats too under the allgather rounds schedule."""
    n, cap, log = _er12_stream()
    before = ellpack_relax.launches
    eng = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      mesh=_card_mesh(4), batch_deletions=True, **knobs)
    got = eng.ingest_log(log)
    assert ellpack_relax.launches > before
    single = {k: v for k, v in knobs.items()
              if k not in ("exchange", "delta_cap", "frontier_mode",
                           "frontier_cap")}
    ref = make_engine(num_vertices=n, edge_capacity=cap, source=3,
                      batch_deletions=True, **single)
    want = ref.ingest_log(log)
    if "exchange" in knobs or "wave_schedule" in knobs:
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.dist, b.dist)
            np.testing.assert_array_equal(a.parent, b.parent)
    else:
        _same_runs(got, want)


# ----------------------------------------------------- sharded [S, N] lanes --
def _sharded_lanes(device, p, knobs, log_frac=1):
    """The sharded lane engine (sources 3, 17, 40, 101) over the 2^12 ER
    stream's first 1/log_frac, on ``device``: P partitions there."""
    from repro_torch.launch.mesh import make_mesh
    n, cap, log = _er12_stream()
    mesh = make_mesh((p,), ("graph",), devices=[torch.device(device)] * p)
    eng = make_engine(num_vertices=n, edge_capacity=cap,
                      sources=(3, 17, 40, 101), mesh=mesh, device=device,
                      batch_deletions=True, **knobs)
    return eng, eng.ingest_log(log[:len(log) // log_frac])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4, 5, 8, 16])
@pytest.mark.parametrize("backend,init_k", [("ellpack", 2), ("ellpack", 8),
                                            ("sliced", 1)])
def test_k1_lanes_on_each_partition_block_of_a_sharded_layout(
        cuda, lanes, backend, init_k):
    """K1's lane form on every partition's own block (R = rows a partition
    < N offers; sliced: each width run, a view at its cell offset, the
    scalar variant where that offset is not 16-byte aligned) against the
    gathered [S, N] offers of a sharded lane engine, bit for bit: the lane
    plain version and S single-lane calls; and on the one lane-minor copy
    the sharded wave shares between partitions (``LaneMinorOnce``)."""
    knobs = (dict(relax_backend="ellpack", ell_init_k=init_k)
             if backend == "ellpack" else
             dict(relax_backend="sliced", sliced_slice_rows=64,
                  sliced_hub_k=8, sliced_init_k=init_k))
    eng, _ = _sharded_lanes("cuda", 8, knobs, log_frac=2)
    gathered = eng.ds.all_gather(eng.dist)[0]
    offers = _lanes_of(gathered[0], lanes, lanes)
    offers[:min(lanes, 4)] = gathered[:min(lanes, 4)]
    seen = set()
    once = LaneMinorOnce()
    first = once(offers)
    for st in eng.bk.states:
        if backend == "ellpack":
            blocks = [(st.nbr_idx, st.nbr_w)]
            assert variant(*blocks[0]) == ("vector" if st.k % 4 == 0
                                           else "scalar")
        else:
            blocks, off = [], 0
            for k, cnt in csr.width_runs(st.widths):
                rows = st.slice_rows * cnt
                blocks.append((st.flat_idx[off:off + rows * k].view(rows, k),
                               st.flat_w[off:off + rows * k].view(rows, k)))
                off += rows * k
        for idx, w in blocks:
            assert idx.shape[0] < offers.shape[1]
            seen.add(variant(idx, w))
            best, arg = _k1_lanes_equal(offers, idx, w)
            shared = once(offers)     # the one copy of every partition
            assert shared is first
            got = ellpack_relax(offers, idx, w, offers_minor=shared)
            assert torch.equal(got[0], best) and torch.equal(got[1], arg)
    assert seen


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    dict(relax_backend="ellpack"),
    dict(relax_backend="sliced", exchange="delta", delta_cap=64,
         sliced_slice_rows=64, sliced_hub_k=8),
    dict(relax_backend="ellpack", wave_schedule="buckets", bucket_width=1.0,
         frontier_mode="sparse", frontier_cap=64)])
def test_sharded_lane_engine_on_the_card_matches_cpu(cuda, knobs):
    """The sharded lane engine at P = 8 on one card (K1's lane form once
    per partition and wave) equals the same engine on the CPU (the plain
    versions) at every query: dist, parent and the per-lane counters."""
    before = ellpack_relax.lane_launches
    eng, got = _sharded_lanes("cuda", 8, knobs)
    assert ellpack_relax.lane_launches > before
    _, want = _sharded_lanes("cpu", 8, knobs)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.parent, b.parent)
        for k in ("rounds", "messages"):
            np.testing.assert_array_equal(a.epoch_stats[k],
                                          b.epoch_stats[k])


# ------------------------------------------------- the straggler bound --
def _bounded_case(rend, lanes, device):
    """A layout for ``rend`` on ``device`` and the epoch it runs, with a
    source (or ``lanes`` sources) and its ADD frontier."""
    from repro_torch.core import frontier, ingest
    from repro_torch.core.backends import ellpack as ell
    from repro_torch.core.backends import sliced as sl
    from repro_torch.core.state import EdgePool, SSSPState
    if rend == "ellpack":
        n, src, dst, w = generators.erdos_renyi(4096, 40000, seed=4)
    else:
        n, src, dst, w = generators.power_law_hubs(4096, 40000, n_hubs=4,
                                                   seed=5, orientation="in")
    alloc = ingest.make_allocator(len(src))
    plan = alloc.plan_adds(src, dst, w)
    src, dst, w = alloc.active_coo()
    if rend == "ellpack":
        idx, ew, _ = ell.EllPlanner(n, init_k=1).rebuild_host(src, dst, w)
        idx, ew = (torch.from_numpy(a).to(device) for a in (idx, ew))

        def epoch(s, f, kernel, **kw):
            return ell.ell_relax_until_converged(s, idx, ew, f,
                                                 use_kernel=kernel, **kw)
    elif rend.startswith("sliced"):
        pl = sl.SlicedEllPlanner(n, slice_rows=64, hub_k=16)
        st = sl.SlicedEllState.from_host(pl, pl.rebuild_host(src, dst, w),
                                         device)
        fused = rend == "sliced_fused"

        def epoch(s, f, kernel, **kw):
            return sl.sliced_relax_until_converged(
                s, st, f, num_vertices=n, use_kernel=kernel and not fused,
                use_fused=fused and kernel, **kw)
    else:
        out = frontier.OutAdjacency(n, device, hub_k=16)
        out.apply_adds(plan, alloc)
        act = np.ones(len(src), bool)
        pool = EdgePool(*(torch.from_numpy(a).to(device) for a in (
            src.astype(np.int32), dst.astype(np.int32),
            w.astype(np.float32), act)))
        caps = frontier.capacity_ladder(n, 256)

        def epoch(s, f, kernel, **kw):
            return frontier.sparse_relax_until_converged(
                s, pool, out.state, f, num_vertices=n, caps=caps,
                use_kernel=kernel, **kw)[:2]
    sources = (0, 1, 2, 3)[:lanes] if lanes else (0,)
    s = (SSSPState.init_batched(n, sources, device) if lanes
         else SSSPState.init(n, 0, device))
    f = torch.zeros(n, dtype=torch.bool, device=device)
    f[list(sources)] = True
    return epoch, s, f


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [0, 4])
@pytest.mark.parametrize("rend,kernel_fn", [
    ("ellpack", ellpack_relax), ("sliced", ellpack_relax),
    ("sliced_fused", fused_sliced_relax), ("sparse", gathered_rows_relax)])
def test_bounded_epochs_on_kernels_match_plain_version(cuda, rend,
                                                       kernel_fn, lanes):
    """``max_rounds`` 1 and 4, re-issued with ``dist < dist before`` until
    nothing improves: on K1 (dense ELL, and once per width run), K2 and K3
    and their lane forms, every issue bit-identical to the plain versions
    on the card, and the sequence to the unbounded epoch."""
    epoch, s0, f0 = _bounded_case(rend, lanes, cuda)
    want, wst = epoch(s0, f0, False)
    for max_rounds in (1, 4):
        s, f, issued = s0, f0, 0
        kernel_fn.launches = kernel_fn.lane_launches = 0
        while True:
            got, st = epoch(s, f, True, max_rounds=max_rounds)
            plain, pst = epoch(s, f, False, max_rounds=max_rounds)
            for a, b in ((got.dist, plain.dist), (got.parent, plain.parent),
                         (st.messages, pst.messages)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            np.testing.assert_array_equal(st.rounds, pst.rounds)
            assert np.max(st.rounds) <= max_rounds
            issued += 1
            improved = got.dist < s.dist
            s = got
            if not bool(improved.any()):
                break
            f = improved
        assert issued > 1
        assert (kernel_fn.lane_launches if lanes else kernel_fn.launches) > 0
        torch.testing.assert_close(s.dist, want.dist, rtol=0, atol=0)
        torch.testing.assert_close(s.parent, want.parent, rtol=0, atol=0)
