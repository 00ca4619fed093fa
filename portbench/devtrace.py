"""The device's side of a traced run, from ``torch.profiler``'s CUDA
activity: every kernel, copy and memset the card ran inside the measured
window, on the profiler's clock (Unix-epoch nanoseconds), with the host
spans of the same window mapped onto it.

``busy_s`` is the union of those intervals, so overlapping work is counted
once; an idle gap is a stretch of the window that no interval covers.
"""
from __future__ import annotations

import re

import numpy as np

SYNC = "Sync"      # the CUDA side's sync records, which are not work
H2D = "Memcpy HtoD"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):       # the first '(' outside template <>
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut][:100]


class DeviceTrace:
    def __init__(self, ops: list[tuple[str, int, int]], t0_ns: int,
                 t1_ns: int):
        """``ops``: (name, start_ns, end_ns) of every device activity;
        [t0_ns, t1_ns) the measured window on the same clock."""
        self.t0, self.t1 = t0_ns, t1_ns
        self.by_name: dict[str, list[int]] = {}     # name -> [count, ns]
        for name, a, b in ops:
            rec = self.by_name.setdefault(name, [0, 0])
            rec[0] += 1
            rec[1] += b - a
        self.start = np.array([o[1] for o in ops], np.int64)
        self.end = np.array([o[2] for o in ops], np.int64)
        # the busy intervals: the union of the ops, clipped to the window
        s = np.clip(self.start, t0_ns, t1_ns)
        e = np.clip(self.end, t0_ns, t1_ns)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        reach = np.maximum.accumulate(e) if len(e) else e
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > reach[:-1]
        starts = s[new]
        ends = np.maximum.reduceat(e, np.flatnonzero(new)) if len(s) else e
        self.busy = (starts, ends)
        # the idle gaps between them
        g0 = np.concatenate([[t0_ns], ends])
        g1 = np.concatenate([starts, [t1_ns]])
        keep = g1 > g0
        self.gaps = (g0[keep], g1[keep])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return float(np.sum(self.busy[1] - self.busy[0])) / 1e9

    def _sum(self, patterns: tuple[str, ...], field: int) -> int:
        return sum(rec[field] for name, rec in self.by_name.items()
                   if any(p in name for p in patterns))

    def count(self, *patterns: str) -> int:
        """Ops whose name holds one of ``patterns``."""
        return self._sum(patterns, 0)

    def seconds(self, *patterns: str) -> float:
        """Their summed device time."""
        return self._sum(patterns, 1) / 1e9

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device ops that took most time, summed by name."""
        tot: dict[str, int] = {}
        for name, (_, ns) in self.by_name.items():
            key = short_name(name)
            tot[key] = tot.get(key, 0) + ns
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in best]

    def idle_in(self, spans: np.ndarray) -> float:
        """Idle seconds inside ``spans`` (an [k, 2] array of disjoint
        [start, end) intervals on the trace's clock)."""
        g0, g1 = self.gaps
        if not len(g0) or not len(spans):
            return 0.0
        before = np.concatenate([[0], np.cumsum(g1 - g0)])

        def covered(t):      # idle time in (-inf, t]
            i = np.searchsorted(g0, t, side="right") - 1
            j = np.clip(i, 0, None)
            part = np.clip(t - g0[j], 0, g1[j] - g0[j])
            return np.where(i >= 0, before[j] + part, 0)

        spans = np.asarray(spans, np.int64)
        return float(np.sum(covered(spans[:, 1]) - covered(spans[:, 0]))) / 1e9


def from_profiler(prof, t0_ns: int, t1_ns: int) -> DeviceTrace:
    """The window's device activity from a stopped ``torch.profiler``."""
    from torch.autograd import DeviceType
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and SYNC not in e.name():
            start = e.start_ns()
            ops.append((e.name(), start, start + e.duration_ns()))
    return DeviceTrace(ops, t0_ns, t1_ns)
