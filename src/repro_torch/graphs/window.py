"""Sliding-window event stream generation (paper §5.1.3), copied from
``repro.graphs.window``.

Given an ordered edge list (timestamps == arrival indices), window size
``W`` and deletion probability ``delta``: upon emitting the ADD with index
T, edges with index < T - W are deleted with probability ``delta`` (each
considered once, when they first fall out of the window).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import events as ev


def sliding_window_stream(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    *,
    window: int,
    delta: float,
    seed: int = 0,
    query_every: int = 0,
) -> ev.EventLog:
    """Build the interleaved ADD/DEL (and optional QUERY) log."""
    rng = np.random.default_rng(seed)
    n = len(src)
    kinds: list[np.ndarray] = []
    srcs: list[np.ndarray] = []
    dsts: list[np.ndarray] = []
    ws: list[np.ndarray] = []

    # decide once, per edge, whether it dies when it exits the window
    dies = rng.random(n) < delta

    # Emit in chunks so DELs interleave at the right positions but the log
    # stays vectorized: process in blocks of `window // 8` (>=1) adds.
    block = max(1, window // 8)
    next_del = 0  # first edge index not yet considered for deletion
    emitted_q = 0
    for a in range(0, n, block):
        b = min(a + block, n)
        kinds.append(np.full(b - a, ev.ADD, np.uint8))
        srcs.append(src[a:b]); dsts.append(dst[a:b]); ws.append(w[a:b].astype(np.float32))
        # edges now outside the window: indices < b - window
        out_hi = max(0, b - window)
        if out_hi > next_del:
            sel = np.arange(next_del, out_hi)
            sel = sel[dies[sel]]
            if len(sel):
                kinds.append(np.full(len(sel), ev.DEL, np.uint8))
                srcs.append(src[sel]); dsts.append(dst[sel])
                ws.append(np.zeros(len(sel), np.float32))
            next_del = out_hi
        if query_every:
            done = b
            while (done - emitted_q * query_every) >= query_every:
                kinds.append(np.array([ev.QUERY], np.uint8))
                srcs.append(np.array([-1], np.int64))
                dsts.append(np.array([-1], np.int64))
                ws.append(np.array([0.0], np.float32))
                emitted_q += 1
    return ev.EventLog(
        np.concatenate(kinds), np.concatenate(srcs).astype(np.int64),
        np.concatenate(dsts).astype(np.int64), np.concatenate(ws))
