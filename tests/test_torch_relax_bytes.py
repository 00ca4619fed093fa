"""The byte models of kernels K1 (``relax.wave_bytes``) and K3
(``gather.wave_bytes``), the bounds ``chip_smoke.py`` reports, against a
brute-force count on small random blocks: every input element read once
where the kernel's function needs it, every output element written once.
K1 needs the offers vector, every weight, and the index of a cell only
where its weight is finite; K3 needs every mask byte, and src_dist,
src_ids, nbr and w of a slot only where it is masked in.  Also the rule
``relax.variant`` gives for K1's two variants.  Counts are exact
integers: tolerance 0.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.relax import gather, relax


def _k1_block(seed, n, rows, k, tail):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, (rows, k)).astype(np.float32)
    if tail:   # the ELL planner's layout: a live head, then +inf
        past = np.arange(k)[None, :] >= rng.integers(0, k + 1, rows)[:, None]
        w[past] = np.inf
    w[rng.random((rows, k)) < 0.2] = np.inf
    offers = rng.uniform(0, 4, n).astype(np.float32)
    return offers, w


def _k1_brute(offers, w):
    nbytes = offers.size * offers.itemsize          # the offers vector
    for row in w:
        for cell in row:
            nbytes += 4                             # its weight
            if np.isfinite(cell):
                nbytes += 4                         # its index
        nbytes += 4 + 4                             # best, arg
    return nbytes


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("seed,n,rows,k", [
    (0, 50, 8, 1), (1, 300, 64, 5), (2, 64, 40, 32), (3, 1000, 17, 40),
    (4, 9, 3, 128)])
def test_k1_wave_bytes_is_the_brute_force_count(seed, n, rows, k, tail):
    offers, w = _k1_block(seed, n, rows, k, tail)
    live = int(np.isfinite(w).sum())
    assert relax.wave_bytes(n, rows, k, live) == _k1_brute(offers, w)


def test_k1_wave_bytes_at_the_er_final_block():
    """The ER path's final block (R = N = 2^20, K = 32) with the 6,625,825
    live cells the chip run counted: 173.3 MB."""
    n = 1 << 20
    assert relax.wave_bytes(n, n, 32, 6_625_825) == 173_303_940


def _k3_slots(seed, e, mask_frac):
    rng = np.random.default_rng(seed)
    return rng.random(e) < mask_frac


def _k3_brute(mask, rows):
    nbytes = 0
    for m in mask:
        nbytes += 1                                  # its mask byte
        if m:
            nbytes += 4 * 4                          # src_dist, src_ids, nbr, w
    return nbytes + rows * (4 + 4)                   # best, arg


@pytest.mark.parametrize("seed,e,rows,mask_frac", [
    (0, 0, 12, 0.7), (1, 85, 40, 0.7), (2, 300, 17, 1.0), (3, 64, 64, 0.0),
    (4, 1000, 1, 0.5)])
def test_k3_wave_bytes_is_the_brute_force_count(seed, e, rows, mask_frac):
    mask = _k3_slots(seed, e, mask_frac)
    assert gather.wave_bytes(e, int(mask.sum()), rows) == \
        _k3_brute(mask, rows)


def test_k3_wave_bytes_is_mostly_the_outputs_on_the_sparse_path():
    """E = 16,384 slots (the low rung) over R = 2^20 rows: the 8R bytes of
    best and arg are over 99 % of the bound even with every slot in."""
    e, r = 16_384, 1 << 20
    assert gather.wave_bytes(e, e, r) == 17 * e + 8 * r
    assert 8 * r / gather.wave_bytes(e, e, r) > 0.96


@pytest.mark.parametrize("offset,k,want", [
    (0, 32, "vector"), (4, 32, "vector"), (8, 4, "vector"),
    (3, 32, "scalar"), (2, 8, "scalar"), (0, 5, "scalar"), (0, 2, "scalar"),
    (1, 1, "scalar")])
def test_k1_variant_rule(offset, k, want):
    """K % 4 == 0 and both blocks on a 16-byte boundary take the vector
    variant; anything else, e.g. a view at an odd cell offset as
    ``sliced_gather_min`` passes one, the scalar variant."""
    flat_i = torch.zeros(offset + 6 * k + 16, dtype=torch.int32)
    flat_w = torch.zeros(offset + 6 * k + 16)
    assert flat_i.data_ptr() % 16 == 0 and flat_w.data_ptr() % 16 == 0
    vi = flat_i[offset:offset + 6 * k].view(6, k)
    vw = flat_w[offset:offset + 6 * k].view(6, k)
    assert relax.variant(vi, vw) == want
    if offset % 4 == 0 and k % 4 == 0:
        # one block unaligned is enough for the scalar variant
        assert relax.variant(vi, flat_w[offset + 1:offset + 1 + 6 * k]
                             .view(6, k)) == "scalar"
