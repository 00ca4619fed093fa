"""By-destination ELL builders (host-side numpy), copied from
``repro.graphs.csr`` — only what the dense-ELL backend's rebuild uses.

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
