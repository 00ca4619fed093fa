"""By-destination ELL builders (host-side numpy), copied from
``repro.graphs.csr`` — what the dense-ELL and sliced backends' rebuilds use.

For every dst row the ELL block holds a padded list of (in-neighbor id,
weight); padding entries point at row 0 with +inf weight so they never win a
min.  All builders are fancy-indexed scatters, so a rebuild is O(E) numpy
work plus one host->device transfer.
"""
from __future__ import annotations

import numpy as np

PAD_W = np.float32(np.inf)


def coo_to_csr(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
               *, by: str = "dst"):
    """Sort COO by row (dst or src); returns (indptr, cols, w_sorted, perm)."""
    rows = dst if by == "dst" else src
    cols = src if by == "dst" else dst
    perm = np.argsort(rows, kind="stable")
    rows_s, cols_s, w_s = rows[perm], cols[perm], w[perm]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows_s + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, cols_s, w_s, perm


def _csr_positions(indptr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(row, column-within-row) for every CSR entry, vectorized."""
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(len(deg)), deg)
    kpos = np.arange(indptr[-1]) - np.repeat(indptr[:-1], deg)
    return rows, kpos


def csr_to_ell(n: int, indptr: np.ndarray, cols: np.ndarray, w: np.ndarray,
               *, k: int | None = None, pad_col: int = 0, n_rows: int | None = None):
    """Dense ELLPACK (n_rows, K) from CSR; K defaults to max row degree.

    Returns (nbr_idx i32[n_rows,K], nbr_w f32[n_rows,K]); pad weight +inf.
    Rows longer than K are truncated.  ``n_rows >= n`` pads extra all-inf
    rows at the bottom (the planner's row padding).
    """
    deg = np.diff(indptr)
    kmax = int(deg.max()) if n and len(cols) else 0
    K = kmax if k is None else k
    K = max(K, 1)
    R = n if n_rows is None else n_rows
    assert R >= n, (R, n)
    idx = np.full((R, K), pad_col, np.int32)
    ww = np.full((R, K), PAD_W, np.float32)
    rows, kpos = _csr_positions(indptr)
    keep = kpos < K
    idx[rows[keep], kpos[keep]] = cols[keep]
    ww[rows[keep], kpos[keep]] = w[keep]
    return idx, ww


def csr_to_sliced_ell(n: int, indptr: np.ndarray, cols: np.ndarray,
                      w: np.ndarray, *, slice_rows: int = 256):
    """Sliced ELLPACK: rows grouped into slices of ``slice_rows``; each slice
    padded to its own max degree.  Returns a list of
    (row_offset, nbr_idx [s,Ks], nbr_w [s,Ks]) — far less padding than
    global ELL on power-law graphs."""
    rows, kpos = _csr_positions(indptr)
    out = []
    for r0 in range(0, n, slice_rows):
        r1 = min(r0 + slice_rows, n)
        deg = np.diff(indptr[r0:r1 + 1])
        Ks = max(1, int(deg.max()) if len(deg) else 1)
        idx = np.zeros((r1 - r0, Ks), np.int32)
        ww = np.full((r1 - r0, Ks), PAD_W, np.float32)
        a, b = indptr[r0], indptr[r1]
        idx[rows[a:b] - r0, kpos[a:b]] = cols[a:b]
        ww[rows[a:b] - r0, kpos[a:b]] = w[a:b]
        out.append((r0, idx, ww))
    return out


def next_pow2(x: int) -> int:
    """Smallest power of two >= x."""
    m = 1
    while m < x:
        m <<= 1
    return m


def ell_from_coo(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                 *, k: int, n_rows: int | None = None, row0: int = 0):
    """By-destination ELL directly from COO: (nbr_idx, nbr_w, fill).

    ``fill`` is the per-row occupancy (== in-degree; the incremental
    maintenance path treats it as a high-water mark).  Requires
    ``k >= max in-degree``.  ``row0`` builds the vertex window
    ``[row0, row0 + n)`` from globally addressed ``dst``.
    """
    dst = np.asarray(dst, np.int64) - row0
    assert not len(dst) or (dst.min() >= 0 and dst.max() < n), \
        f"dst outside window [row0={row0}, row0+{n})"
    indptr, cols, ws, _ = coo_to_csr(n, np.asarray(src), dst,
                                     np.asarray(w), by="dst")
    deg = np.diff(indptr)
    assert int(deg.max(initial=0)) <= k, (int(deg.max(initial=0)), k)
    idx, ww = csr_to_ell(n, indptr, cols, ws, k=k, n_rows=n_rows)
    R = n if n_rows is None else n_rows
    fill = np.zeros(R, np.int32)
    fill[:n] = deg
    return idx, ww, fill


def slice_offsets(widths: list[int] | tuple[int, ...],
                  slice_rows: int) -> np.ndarray:
    """i64[S+1]: slice s's cells start at ``offsets[s]`` of the flat
    sliced-ELL buffer (``sliced_geometry``'s first output)."""
    return slice_rows * np.r_[0, np.cumsum(np.asarray(widths, np.int64))]


def sliced_geometry(widths: list[int], slice_rows: int):
    """Cell addressing of the flat sliced-ELL layout: returns
    ``(offsets i64[S+1], rowk i32[R], base i64[R], total_cells)`` where row
    r's cells occupy ``[base[r], base[r] + rowk[r])``.

    This is THE addressing rule — shared by ``sliced_ell_from_coo`` (rebuild
    placement) and the engine planner (incremental append positions); the
    two must agree bit-for-bit or the device state silently corrupts.
    """
    wid = np.asarray(widths, np.int64)
    offsets = slice_offsets(widths, slice_rows)
    rowk = np.repeat(wid, slice_rows).astype(np.int32)
    R = len(widths) * slice_rows
    base = (np.repeat(offsets[:-1], slice_rows)
            + (np.arange(R) % slice_rows) * rowk).astype(np.int64)
    return offsets, rowk, base, int(offsets[-1])


def width_runs(widths: tuple[int, ...] | list[int]) -> list[tuple[int, int]]:
    """Maximal runs of equal-width slices, ``(k, n_slices)`` in row order:
    each is one contiguous row-major ``(rows, k)`` block of the flat
    buffer — one TPU ``pallas_call`` of K2, one K1 launch of the unfused
    wave."""
    runs: list[list[int]] = []
    for k in widths:
        if runs and runs[-1][0] == k:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
    return [(k, cnt) for k, cnt in runs]


def sliced_ell_from_coo(
    n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray, *,
    slice_rows: int = 256, hub_k: int = 32, n_rows: int | None = None,
    widths: list[int] | None = None, overflow_capacity: int | None = None,
    row0: int = 0,
):
    """Hub-aware hybrid layout: flat sliced-ELL + COO overflow (by dst).

    Rows are grouped into slices of ``slice_rows`` consecutive ids; each
    slice is padded to its own pow2 width ``K_s`` (the slice's max in-degree
    capped at ``hub_k``).  Rows with in-degree > hub_k are *hubs*: their
    first ``hub_k`` in-neighbors (CSR order) stay in the slice, the surplus
    spills into the COO overflow segment.  The ELL cells are flattened into
    one 1-D buffer (slice s at offset ``slice_rows * sum(widths[:s])``, row-
    major within the slice).

    Returns ``(flat_idx i32[L], flat_w f32[L], fill i32[R], widths,
    osrc i32[C], odst i32[C], ow f32[C], n_overflow)`` with
    ``L = slice_rows * sum(widths)``, ``R = n_rows`` (ceil of n to a slice
    multiple), ``C = overflow_capacity`` (pow2, >= surplus edge count).
    Empty/padding cells carry idx 0 / w +inf; padded overflow entries carry
    src=dst=0 / w=+inf — neither can win a min.  ``widths`` and
    ``overflow_capacity`` override the tight defaults (the planner passes
    its monotone-grown values); ``row0`` builds the vertex window
    ``[row0, row0 + n)`` from globally addressed ``dst``.
    """
    assert slice_rows >= 1 and slice_rows == next_pow2(slice_rows), slice_rows
    hub_k = next_pow2(max(hub_k, 1))
    dst = np.asarray(dst, np.int64) - row0
    assert not len(dst) or (dst.min() >= 0 and dst.max() < n), \
        f"dst outside window [row0={row0}, row0+{n})"
    indptr, cols, ws, _ = coo_to_csr(n, np.asarray(src), dst,
                                     np.asarray(w), by="dst")
    R = -(-max(n, 1) // slice_rows) * slice_rows if n_rows is None else n_rows
    assert R >= n and R % slice_rows == 0, (R, n, slice_rows)
    n_slices = R // slice_rows
    deg = np.zeros(R, np.int64)
    deg[:n] = np.diff(indptr)
    capped = np.minimum(deg, hub_k)
    slice_max = capped.reshape(n_slices, slice_rows).max(axis=1)
    if widths is None:
        widths = [next_pow2(int(max(k, 1))) for k in slice_max]
    widths = [int(k) for k in widths]
    assert len(widths) == n_slices, (len(widths), n_slices)
    assert all(k == next_pow2(k) and k <= hub_k for k in widths), widths
    assert all(int(m) <= k for m, k in zip(slice_max, widths)), \
        (slice_max.tolist(), widths)

    _, _, base, L = sliced_geometry(widths, slice_rows)
    flat_idx = np.zeros(L, np.int32)
    flat_w = np.full(L, PAD_W, np.float32)
    rows, kpos = _csr_positions(indptr)
    keep = kpos < hub_k
    pos = base[rows[keep]] + kpos[keep]
    flat_idx[pos] = cols[keep]
    flat_w[pos] = ws[keep]

    o_src, o_dst, o_w = cols[~keep], rows[~keep], ws[~keep]
    n_over = len(o_src)
    C = (next_pow2(max(2 * n_over, 8)) if overflow_capacity is None
         else overflow_capacity)
    assert C >= n_over, (C, n_over)
    osrc = np.zeros(C, np.int32)
    odst = np.zeros(C, np.int32)
    ow = np.full(C, PAD_W, np.float32)
    osrc[:n_over] = o_src
    odst[:n_over] = o_dst
    ow[:n_over] = o_w

    fill = capped.astype(np.int32)
    return flat_idx, flat_w, fill, widths, osrc, odst, ow, n_over
