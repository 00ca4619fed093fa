"""Kernel K2 (the fused hybrid sliced-ELL + overflow-COO wave): the port's
plain version ``fused_sliced_relax_ref`` and the ``fused_sliced_relax``
wrapper on CPU tensors against the JAX package's unfused composition
``combine_lanes(sliced_gather_min, overflow_min)`` — the function the JAX
kernel is pinned to (the JAX kernel itself does not run on the installed
jax: its float ``CostEstimate`` is refused).  Cases: those of
test_fused_relax.py (ragged run groups, mixed widths, pervasive ties),
random active masks, empty and zero-capacity overflow lanes, a hand-built
tie across the lanes; plus the copied ``slice_run_groups`` and
``fused_cost``.

Inputs are made from seeds with numpy and fed to both packages.  Tolerance:
0 — ``best`` and ``arg`` bit-identical.  The CUDA kernel is held against
the plain version on the card by test_torch_cuda_kernels.py.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.backends.sliced import (combine_lanes, overflow_min,
                                        sliced_gather_min)
from repro.graphs import csr as jcsr
from repro.kernels.relax import fused as jfused
from repro_torch.graphs import csr
from repro_torch.kernels.relax import fused
from repro_torch.kernels.relax.ref import fused_sliced_relax_ref

INF = np.float32(np.inf)

# (widths, slice_rows, n, overflow capacity, tie weights): test_fused_relax.py
CASES = [
    ((2, 2, 2), 8, 20, 8, False),
    ((2,) * 40, 8, 300, 16, False),
    ((1, 1, 4, 4, 4, 2, 8), 16, 100, 8, False),
    ((2, 2, 4, 4), 16, 60, 32, True),
]


def _layout(widths, slice_rows, n, ocap, seed, ties):
    """test_fused_relax.py's random layout: empty cells/entries carry +inf,
    live ones random in-neighbours; 20 % of the offers are +inf."""
    rng = np.random.default_rng(seed)
    L = slice_rows * sum(widths)
    wpool = np.asarray([0.5, 1.0] if ties else rng.uniform(0.1, 2.0, 8),
                       np.float32)
    flat_idx = rng.integers(0, n, L).astype(np.int32)
    flat_w = np.where(rng.random(L) < 0.6, rng.choice(wpool, L),
                      INF).astype(np.float32)
    osrc = rng.integers(0, n, ocap).astype(np.int32)
    odst = rng.integers(0, n, ocap).astype(np.int32)
    ow = np.where(rng.random(ocap) < 0.7, rng.choice(wpool, ocap),
                  INF).astype(np.float32)
    dist = np.where(rng.random(n) < 0.8, rng.uniform(0.0, 4.0, n),
                    INF).astype(np.float32)
    return dist, flat_idx, flat_w, osrc, odst, ow


@functools.partial(jax.jit, static_argnames=("widths", "slice_rows"))
def _jax_composition(offers, flat_idx, flat_w, osrc, odst, ow, *, widths,
                     slice_rows):
    best, arg = sliced_gather_min(offers, flat_idx, flat_w, widths=widths,
                                  slice_rows=slice_rows)
    obest, oarg = overflow_min(offers, osrc, odst, ow,
                               len(widths) * slice_rows)
    return combine_lanes(best, arg, obest, oarg)


def _jax_unfused(offers, flat_idx, flat_w, osrc, odst, ow, widths,
                 slice_rows):
    b, a = _jax_composition(
        *[jnp.asarray(a) for a in (offers, flat_idx, flat_w, osrc, odst, ow)],
        widths=widths, slice_rows=slice_rows)
    return np.asarray(b), np.asarray(a)


def _flat_layout(flat_idx, flat_w, osrc, odst, ow, widths, slice_rows,
                 table=None):
    """The layout object K2's wrapper reads (a ``SlicedEllState`` holds the
    same fields), with the table of its own widths unless one is given."""
    return SimpleNamespace(
        flat_idx=flat_idx, flat_w=flat_w, osrc=osrc, odst=odst, ow=ow,
        widths=widths, slice_rows=slice_rows,
        table=table or fused.ChunkTable.build(widths, slice_rows, "cpu"))


def _port(dist, active, flat_idx, flat_w, osrc, odst, ow, widths,
          slice_rows):
    """The plain version, and the wrapper on CPU tensors (which must take
    it); both must agree."""
    t = [torch.from_numpy(np.asarray(a)) for a in
         (dist, active, flat_idx, flat_w, osrc, odst, ow)]
    b, a = fused_sliced_relax_ref(*t, widths=widths, slice_rows=slice_rows)
    before = fused.fused_sliced_relax.launches
    wb, wa = fused.fused_sliced_relax(t[0], t[1],
                                      _flat_layout(*t[2:], widths, slice_rows))
    assert fused.fused_sliced_relax.launches == before   # CPU: no launch
    assert torch.equal(b, wb) and torch.equal(a, wa)
    assert b.dtype == torch.float32 and a.dtype == torch.int32
    return b.numpy(), a.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("widths,slice_rows,n,ocap,ties", CASES)
def test_plain_version_matches_jax_unfused_composition(widths, slice_rows, n,
                                                       ocap, ties):
    dist, *lay = _layout(widths, slice_rows, n, ocap, seed=n + ocap,
                         ties=ties)
    active = np.ones(n, bool)
    _assert_same(_port(dist, active, *lay, widths, slice_rows),
                 _jax_unfused(dist, *lay, widths, slice_rows))


@pytest.mark.parametrize("widths,slice_rows,n,ocap,ties", CASES)
def test_active_mask_is_the_masked_offers(widths, slice_rows, n, ocap, ties):
    """The in-kernel ``where(active, dist, inf)``: random, all-False and
    all-True masks equal pre-masked offers fed to the JAX composition."""
    dist, *lay = _layout(widths, slice_rows, n, ocap, seed=7, ties=ties)
    rng = np.random.default_rng(11)
    for active in (rng.random(n) < 0.5, np.zeros(n, bool), np.ones(n, bool)):
        offers = np.where(active, dist, INF)
        _assert_same(_port(dist, active, *lay, widths, slice_rows),
                     _jax_unfused(offers, *lay, widths, slice_rows))


def test_empty_and_zero_capacity_overflow_lane():
    """An all-tombstoned lane contributes nothing; a zero-length lane (the
    reference pads it to one dead entry) gives the same rows; INT_MAX where
    no candidate is finite."""
    widths, slice_rows, n = (2, 4), 8, 14
    dist, fi, fw, osrc, odst, ow = _layout(widths, slice_rows, n, 8, seed=3,
                                           ties=False)
    active = np.ones(n, bool)
    dead = np.full_like(ow, INF)
    want = _jax_unfused(dist, fi, fw, osrc, odst, dead, widths, slice_rows)
    _assert_same(_port(dist, active, fi, fw, osrc, odst, dead, widths,
                       slice_rows), want)
    z = np.zeros(0, np.int32)
    _assert_same(_port(dist, active, fi, fw, z, z, np.zeros(0, np.float32),
                       widths, slice_rows), want)
    assert (want[1][~np.isfinite(want[0])] == 2**31 - 1).all()


def test_tie_across_the_two_lanes_breaks_to_the_smaller_id():
    """Row 1: the overflow lane wins strictly; row 2: the lanes tie and the
    smaller source id (in the overflow lane) wins; row 3: the lanes tie and
    the smaller id is in the ELL lane; rows without entries stay +inf."""
    widths, slice_rows, n = (2,), 8, 8
    dist = np.zeros(n, np.float32)
    flat_idx = np.zeros(16, np.int32)
    flat_w = np.full(16, INF, np.float32)
    flat_idx[2], flat_w[2] = 5, 1.0      # row 1 <- 5
    flat_idx[4], flat_w[4] = 6, 2.0      # row 2 <- 6
    flat_idx[6], flat_w[6] = 1, 3.0      # row 3 <- 1
    osrc = np.asarray([7, 3, 4], np.int32)
    odst = np.asarray([1, 2, 3], np.int32)
    ow = np.asarray([0.5, 2.0, 3.0], np.float32)
    b, a = _port(dist, np.ones(n, bool), flat_idx, flat_w, osrc, odst, ow,
                 widths, slice_rows)
    assert (b[1], a[1]) == (np.float32(0.5), 7)
    assert (b[2], a[2]) == (np.float32(2.0), 3)
    assert (b[3], a[3]) == (np.float32(3.0), 1)
    assert np.isinf(b[4:]).all() and (a[4:] == 2**31 - 1).all()
    _assert_same((b, a), _jax_unfused(dist, flat_idx, flat_w, osrc, odst, ow,
                                      widths, slice_rows))


@pytest.mark.parametrize("widths,sr", [((2,) * 40, 8),
                                       ((1, 1, 4, 4, 4, 2, 8), 16),
                                       ((4,), 512), ((2, 2), 256),
                                       ((4,) * 64, 8)])
def test_slice_run_groups_and_fused_cost_match_reference(widths, sr):
    assert fused.slice_run_groups(widths, sr) == \
        jfused.slice_run_groups(widths, sr)
    for n, ocap in ((len(widths) * sr, 8), (1000, 0), (7, 1 << 20)):
        assert fused.fused_cost(widths, sr, n, ocap) == \
            jfused.fused_cost(widths, sr, n, ocap)


def test_wave_bytes_reads_each_input_once():
    """The card's bound counts the overflow triplet once per wave, where
    the TPU model (``fused_cost``) charges it once per run; indices count
    only where the weight is finite."""
    widths, sr, n, ocap = (2, 2, 4, 4, 8), 16, 80, 64
    L, R = sr * sum(widths), len(widths) * sr
    assert fused.wave_bytes(n, L, L, ocap, ocap, R) == \
        5 * n + 8 * L + 12 * ocap + 8 * R
    assert fused.wave_bytes(n, L, 10, ocap, 3, R) == \
        5 * n + 4 * L + 4 * 10 + 4 * ocap + 8 * 3 + 8 * R
    runs = len(csr.width_runs(widths))
    assert fused.fused_cost(widths, sr, n, ocap)["bytes"] == \
        fused.wave_bytes(n, L, L, ocap, ocap, R) \
        + (runs - 1) * (5 * n + 12 * ocap)


@pytest.mark.parametrize("widths,sr", [((2, 2, 2), 8), ((1, 4, 4, 2), 16)])
def test_sliced_geometry_matches_reference(widths, sr):
    for got, want in zip(csr.sliced_geometry(list(widths), sr),
                         jcsr.sliced_geometry(list(widths), sr)):
        np.testing.assert_array_equal(got, want)


# (widths, slice_rows) of the card tests' K2 shapes
# (test_torch_cuda_kernels.py K2_SHAPES)
K2_GEOMETRIES = [((2, 2, 2), 8), ((2,) * 40, 8), ((1, 1, 4, 4, 4, 2, 8), 16),
                 ((2, 2, 4, 4), 16), ((4, 32, 16, 2, 1, 8), 256), ((2, 4), 8),
                 ((32, 32, 1, 32), 64), ((2,), 8), ((1,) * 5, 256),
                 ((4,) * 33, 8), ((64, 2, 64, 128), 16)]


@pytest.mark.parametrize("widths,sr", K2_GEOMETRIES)
def test_block_table_covers_the_sliced_geometry(widths, sr):
    """The CUDA kernel's chunk table, by brute force against
    ``sliced_geometry``: every cell of the flat buffer lies in exactly one
    chunk, inside the row the chunk assigns it to (base[r] <= cell <
    base[r] + rowk[r], rowk[r] = 2^log2k), every row is in exactly one
    chunk, and a chunk holds whole rows, at most max(BLOCK_CELLS, k)
    cells."""
    table = fused.block_table(widths, sr)
    assert table.dtype == np.int32 and table.ndim == 1
    _, rowk, base, cells = csr.sliced_geometry(list(widths), sr)
    cover = np.zeros(cells, np.int64)
    rows = np.zeros(len(rowk), np.int64)
    for cell0, row0, log2k, n in table.reshape(-1, 4):
        k = 1 << int(log2k)
        assert 0 < n <= max(fused.BLOCK_CELLS, k) and n % k == 0
        c = cell0 + np.arange(n)
        r = row0 + np.arange(n) // k
        assert (rowk[r] == k).all()
        assert ((base[r] <= c) & (c < base[r] + rowk[r])).all()
        cover[c] += 1
        rows[row0:row0 + n // k] += 1
    assert (cover == 1).all() and (rows == 1).all()


@pytest.mark.parametrize("widths,sr", [((2, 2, 2), 8), ((4, 32, 1), 16)])
def test_wrapper_refuses_a_table_of_another_layout(widths, sr):
    """The wrapper takes the chunk table and its sizes from the layout
    object and holds them to it, on the CPU as on the card: a layout
    holding a table made for other widths — of the same size or not — or
    for another slice height, a layout with no table, and a flat buffer of
    another length raise."""
    n = 40
    L = sr * sum(widths)
    t = [torch.zeros(n), torch.ones(n, dtype=torch.bool),
         torch.zeros(L, dtype=torch.int32), torch.full((L,), INF),
         torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
         torch.full((4,), INF)]
    lay = _flat_layout(*t[2:], widths, sr)
    fused.fused_sliced_relax(t[0], t[1], lay)
    # an equal tuple that is not the layout's own object is still its table
    equal = _flat_layout(*t[2:], tuple(list(widths)), sr, table=lay.table)
    fused.fused_sliced_relax(t[0], t[1], equal)
    others = [((1,) + widths, sr), ((1, 2) * len(widths), sr),
              (widths, 64 * sr)]
    if widths[::-1] != widths:   # the same size, another layout
        others.append((widths[::-1], sr))
    for ow, osr in others:
        bad = _flat_layout(*t[2:], widths, sr,
                           table=fused.ChunkTable.build(ow, osr, "cpu"))
        with pytest.raises(ValueError, match="another layout"):
            fused.fused_sliced_relax(t[0], t[1], bad)
    lay.table = None
    with pytest.raises(ValueError, match="table"):
        fused.fused_sliced_relax(t[0], t[1], lay)
    short = _flat_layout(t[2][:-1], t[3][:-1], *t[4:], widths, sr)
    with pytest.raises(ValueError, match="cells"):
        fused.fused_sliced_relax(t[0], t[1], short)
