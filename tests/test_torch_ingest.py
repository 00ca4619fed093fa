"""Ingestion layer of the port against ``repro.core.ingest``: the copied
allocators (dict and columnar) and ``pad_pow2`` on randomized add / del /
duplicate / checkpoint-restore sequences, and the torch ``apply_adds`` /
``apply_dels`` against the jitted reference applies.

Inputs are made from seeds with numpy and fed to both packages.  Tolerance:
0 — plans, slot maps, free-stack ORDER (it decides every future slot
choice), host mirrors and device pools must be bit-identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ingest as jax_ingest
from repro.core.state import EdgePool as JaxPool
from repro_torch.core import ingest
from repro_torch.core.state import EdgePool


def _same_state(a, b):
    assert a.slot_of == b.slot_of
    assert a.free == b.free          # ORDER matters
    for col in ("msrc", "mdst", "mw", "mactive"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))


def _same_plan(p, q):
    for f in ("slots", "src", "dst", "w", "fresh"):
        np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
        assert getattr(p, f).dtype == getattr(q, f).dtype


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("dup", ["ignore", "min"])
@pytest.mark.parametrize("impl", ["columnar", "dict"])
def test_allocator_copy_matches_reference(impl, dup, seed):
    rng = np.random.default_rng(seed)
    # a few huge ids keep the packed-key/hash path honest
    ids = np.array([0, 1, 2, 3, 5, 8, 13, 100, 10**6, (1 << 31) - 1],
                   dtype=np.int64)
    cap = len(ids) * len(ids) + 16
    mine = ingest.make_allocator(cap, dup, impl=impl)
    ref = jax_ingest.make_allocator(cap, dup, impl=impl)
    for _ in range(60):
        op = rng.random()
        k = int(rng.integers(1, 9))
        src = ids[rng.integers(0, len(ids), k)]
        dst = ids[rng.integers(0, len(ids), k)]
        if op < 0.55:
            w = rng.uniform(0.1, 4.0, k).astype(np.float32)
            _same_plan(mine.plan_adds(src, dst, w), ref.plan_adds(src, dst, w))
        elif op < 0.9:
            for a, b in zip(mine.plan_dels(src, dst), ref.plan_dels(src, dst)):
                np.testing.assert_array_equal(a, b)
        else:   # checkpoint-restore: both rebuilt from their pool mirrors
            mine = ingest.allocator_cls(impl).from_pool(
                cap, dup, mine.msrc, mine.mdst, mine.mw, mine.mactive)
            ref = jax_ingest.allocator_cls(impl).from_pool(
                cap, dup, ref.msrc, ref.mdst, ref.mw, ref.mactive)
        _same_state(mine, ref)


def test_allocator_table_growth_matches_reference():
    """Churn past several index doublings/compactions of the columnar
    table: slot-assignment order never departs from the reference's."""
    cap = 5000
    mine = ingest.make_allocator(cap)
    ref = jax_ingest.make_allocator(cap)
    rng = np.random.default_rng(0)
    for _ in range(6):
        src, dst = rng.integers(0, 3000, 600), rng.integers(0, 3000, 600)
        w = rng.uniform(0.1, 1.0, 600).astype(np.float32)
        _same_plan(mine.plan_adds(src, dst, w), ref.plan_adds(src, dst, w))
        ds, dd = rng.integers(0, 3000, 300), rng.integers(0, 3000, 300)
        np.testing.assert_array_equal(mine.plan_dels(ds, dd)[0],
                                      ref.plan_dels(ds, dd)[0])
    assert mine._tsize > 1024
    _same_state(mine, ref)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023])
def test_pad_pow2_matches_reference(n):
    a = np.arange(n, dtype=np.int32)
    b = np.arange(n, dtype=np.float32) * 0.5
    for x, y in zip(ingest.pad_pow2(a, b), jax_ingest.pad_pow2(a, b)):
        np.testing.assert_array_equal(x, y)


def test_unknown_alloc_impl_raises():
    with pytest.raises(ValueError, match="valid values"):
        ingest.make_allocator(8, impl="btree")


def test_apply_adds_and_dels_match_reference():
    """Padded (pow2-repeated) batches through the in-place torch applies
    and the reference's functional ones give the same pool, batch by
    batch, including slot reuse after deletions."""
    cap = 64
    rng = np.random.default_rng(5)
    alloc = ingest.make_allocator(cap)
    pool = EdgePool.empty(cap, "cpu")
    jpool = JaxPool.empty(cap)
    for step in range(8):
        m = int(rng.integers(1, 12))
        plan = alloc.plan_adds(rng.integers(0, 20, m), rng.integers(0, 20, m),
                               rng.uniform(0.5, 2.0, m).astype(np.float32))
        if len(plan.slots):
            padded = ingest.pad_pow2(plan.slots, plan.src, plan.dst, plan.w)
            ingest.apply_adds(pool, *map(torch.from_numpy, padded))
            jpool = jax_ingest.apply_adds(jpool, *map(jnp.asarray, padded))
        d = int(rng.integers(1, 6))
        slots, _, _ = alloc.plan_dels(rng.integers(0, 20, d),
                                      rng.integers(0, 20, d))
        if len(slots):
            (slots_p,) = ingest.pad_pow2(slots)
            ingest.apply_dels(pool, torch.from_numpy(slots_p))
            jpool = jax_ingest.apply_dels(jpool, jnp.asarray(slots_p))
        for f in ("src", "dst", "w", "active"):
            got, want = getattr(pool, f).numpy(), np.asarray(getattr(jpool, f))
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        np.testing.assert_array_equal(pool.active.numpy(), alloc.mactive)
