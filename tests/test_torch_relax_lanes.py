"""Kernels K1 and K2 over S lanes, on the CPU: their plain versions (and
the wrappers, which take them for CPU tensors) with a leading lane axis —
``offers`` / ``dist`` / ``active`` (S, N), S trees over one shared layout —
give, lane for lane, what S single-lane calls give, and what the JAX
reference's plain versions give under ``jax.vmap`` (the reference batches
its lanes that way).  Cases: +inf rows, ties, an all-+inf lane, a lane
whose ``active`` is all False, S in {1, 3, 4}.  Also the lane form's byte
model: the shared layout counts once, the per-lane vectors S times.

Inputs are made from seeds with numpy.  Tolerance: 0.  The CUDA lane forms
are held against these on the card by test_torch_cuda_kernels.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.relax.ref import ellpack_relax_ref as jax_ellpack_ref
from repro_torch.kernels.relax import fused, relax
from repro_torch.kernels.relax.ref import (ellpack_relax_ref,
                                           fused_sliced_relax_ref)

LANES = [1, 3, 4]
INF = np.float32(np.inf)


def _offers(rng, s, n, ties):
    """S lanes of offers; lane 1 (where there is one) all +inf."""
    v = (rng.integers(0, 4, (s, n)) if ties
         else 4 * rng.random((s, n))).astype(np.float32)
    v[rng.random((s, n)) < 0.3] = INF
    if s > 1:
        v[1] = INF
    return v


def _block(rng, n, rows, k, ties):
    w = (rng.integers(1, 4, (rows, k)) if ties
         else 0.5 + 1.5 * rng.random((rows, k))).astype(np.float32)
    w[rng.random((rows, k)) < 0.3] = INF
    w[0] = INF                                   # an all-tombstone row
    return rng.integers(0, n, (rows, k)).astype(np.int32), w


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("n,rows,k,ties", [(50, 8, 1, False),
                                          (300, 256, 5, True),
                                          (500, 130, 32, True),
                                          (90, 40, 64, False)])
def test_k1_lanes_match_single_lane_calls(n, rows, k, ties, lanes):
    rng = np.random.default_rng(n + k + lanes)
    offers = _offers(rng, lanes, n, ties)
    idx, w = _block(rng, n, rows, k, ties)
    t_off, t_idx, t_w = map(torch.from_numpy, (offers, idx, w))
    before = relax.ellpack_relax.launches
    best, arg = relax.ellpack_relax(t_off, t_idx, t_w)     # CPU: plain
    assert relax.ellpack_relax.launches == before
    assert best.shape == arg.shape == (lanes, rows)
    rb, ra = ellpack_relax_ref(t_off, t_idx, t_w)
    assert torch.equal(best, rb) and torch.equal(arg, ra)
    for t in range(lanes):
        b1, a1 = ellpack_relax_ref(t_off[t], t_idx, t_w)
        assert torch.equal(best[t], b1) and torch.equal(arg[t], a1)
    jb, ja = jax.vmap(jax_ellpack_ref, in_axes=(0, None, None))(
        jnp.asarray(offers), jnp.asarray(idx), jnp.asarray(w))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(arg.numpy(), np.asarray(ja))
    if lanes > 1:
        assert bool(torch.isinf(best[1]).all()) and bool((arg[1] == -1).all())


def _layout(rng, widths, slice_rows, n, ocap, ties):
    L = slice_rows * sum(widths)
    wpool = np.asarray([0.5, 1.0] if ties else rng.uniform(0.1, 2.0, 8),
                       np.float32)
    flat_w = np.where(rng.random(L) < 0.6, rng.choice(wpool, L),
                      INF).astype(np.float32)
    ow = np.where(rng.random(ocap) < 0.7, rng.choice(wpool, ocap),
                  INF).astype(np.float32)
    arrays = [torch.from_numpy(a) for a in (
        rng.integers(0, n, L).astype(np.int32), flat_w,
        rng.integers(0, n, ocap).astype(np.int32),
        rng.integers(0, n, ocap).astype(np.int32), ow)]
    return SimpleNamespace(
        flat_idx=arrays[0], flat_w=arrays[1], osrc=arrays[2],
        odst=arrays[3], ow=arrays[4], widths=widths, slice_rows=slice_rows,
        table=fused.ChunkTable.build(widths, slice_rows, "cpu"))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("widths,slice_rows,n,ocap,ties", [
    ((2, 2, 2), 8, 20, 8, False), ((1, 1, 4, 4, 4, 2, 8), 16, 100, 8, False),
    ((2, 2, 4, 4), 16, 60, 32, True), ((2, 4), 8, 14, 0, False)])
def test_k2_lanes_match_single_lane_calls(widths, slice_rows, n, ocap, ties,
                                          lanes):
    rng = np.random.default_rng(n + ocap + lanes)
    lay = _layout(rng, widths, slice_rows, n, ocap, ties)
    dist = torch.from_numpy(_offers(rng, lanes, n, ties))
    active = torch.from_numpy(rng.random((lanes, n)) < 0.7)
    if lanes > 2:
        active[2] = False                 # a lane with nothing active
    before = fused.fused_sliced_relax.launches
    best, arg = fused.fused_sliced_relax(dist, active, lay)   # CPU: plain
    assert fused.fused_sliced_relax.launches == before
    rows = len(widths) * slice_rows
    assert best.shape == arg.shape == (lanes, rows)
    for t in range(lanes):
        b1, a1 = fused_sliced_relax_ref(
            dist[t], active[t], lay.flat_idx, lay.flat_w, lay.osrc, lay.odst,
            lay.ow, widths=widths, slice_rows=slice_rows)
        assert torch.equal(best[t], b1) and torch.equal(arg[t], a1)
    for t in (1, 2)[:max(0, lanes - 1)]:   # all +inf, nothing active
        assert bool(torch.isinf(best[t]).all())
        assert bool((arg[t] == 2**31 - 1).all())


def test_lane_byte_models_count_the_layout_once():
    """``wave_bytes(lanes=S)``: the shared block / layout once, the offers
    (dist + active) and best + arg S times."""
    n, rows, k, live = 1000, 512, 32, 4000
    one = relax.wave_bytes(n, rows, k, live)
    for s in (2, 4, 8):
        assert relax.wave_bytes(n, rows, k, live, lanes=s) == \
            one + (s - 1) * (4 * n + 8 * rows)
    L, live_l, c, live_c = 9000, 2000, 512, 100
    one = fused.wave_bytes(n, L, live_l, c, live_c, rows)
    for s in (2, 4, 8):
        assert fused.wave_bytes(n, L, live_l, c, live_c, rows, lanes=s) == \
            one + (s - 1) * (5 * n + 8 * rows)
