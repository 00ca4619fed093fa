"""The work a relaxation wave needs, counted the same whatever implements
it, and the card's peak.  Frozen: the kernel rooflines of every later
check are taken against these numbers.

A wave over ``e_live`` live arcs, ``n`` vertices and ``lanes`` trees reads
each live arc once (a 4-byte tail index and a 4-byte weight), the row
offsets once (4 bytes a vertex), each tree's offers (4 bytes a vertex),
and writes each tree's best distance and argmin (8 bytes a vertex).  It
does no floating-point work worth counting, so its least time is its bytes
over the card's memory bandwidth.  ``e_live`` is the benchmark's own count
of live arcs, never the program's padded layout.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (HBM3), data sheet: 3.35 TB/s at 700 W.
HBM_BYTES_PER_S = 3.35e12


def wave_bytes(e_live: float, n: int, lanes: int) -> float:
    return 8.0 * e_live + 4.0 * n + 12.0 * n * lanes


def roofline_pct(waves: int, e_live: float, n: int, lanes: int,
                 device_s: float) -> float | None:
    """Least time of ``waves`` waves over the device time they took, in %;
    None where nothing ran."""
    if waves <= 0 or device_s <= 0:
        return None
    least = waves * wave_bytes(e_live, n, lanes) / HBM_BYTES_PER_S
    return 100.0 * least / device_s
