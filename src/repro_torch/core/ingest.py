"""Event ingestion: host-side slot planning + device-side batched applies
(torch rendering of ``repro.core.ingest``).

A light control plane (``SlotAllocator`` / ``ColumnarSlotAllocator``, host
numpy) plans where each topology event lands; the data plane applies whole
batches to the device edge pool.  The device never sees hash maps — only
dense ``(slots, src, dst, w)`` tensors.

The allocators and ``pad_pow2`` are verbatim numpy copies of the
reference's: slot order and free-stack order decide every downstream
layout, so they must stay bit-identical (pinned by
tests/test_torch_ingest.py).  The allocator also keeps a host **mirror** of
the pool (src/dst/w/active as numpy arrays); the ELL rebuild path builds its
device layout from the mirror without ever reading device memory back.

Duplicate policy: adds of an already-present edge are dropped
(``on_duplicate="ignore"``) or treated as weight-*decrease* updates
(``"min"``; increases are dropped).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.state import EdgePool


class PlannedAdds(NamedTuple):
    slots: np.ndarray  # i32[m] pool slots to write
    src: np.ndarray    # i32[m]
    dst: np.ndarray    # i32[m]
    w: np.ndarray      # f32[m]
    fresh: np.ndarray  # bool[m]; False = weight-decrease of an existing edge


_MAX_ID = np.int64(1) << 31


def _check_ids(src: np.ndarray, dst: np.ndarray) -> None:
    """Both allocators pack (u, v) into one int64 key as (u << 32) | v; a
    negative or ≥ 2**31 id would silently alias another edge, so reject it
    loudly instead."""
    for name, a in (("src", src), ("dst", dst)):
        if len(a) == 0:
            continue
        lo, hi = a.min(), a.max()
        if lo < 0 or hi >= _MAX_ID:
            bad = int(lo) if lo < 0 else int(hi)
            raise ValueError(
                f"vertex id {bad} in {name} is outside [0, 2**31): packed "
                "(src << 32) | dst keys are int64, ids beyond 31 bits would "
                "silently alias another edge")


def _coalesce_adds(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   on_duplicate: str):
    """Collapse within-batch duplicate (u, v) rows to one row each, in
    first-occurrence order; "min" keeps the smallest weight among the
    duplicates.  Returns (uu i32, vv i32, ww f32, keys i64)."""
    key = (src << 32) | dst
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    if len(uniq) != len(src) and on_duplicate == "min":
        wmin = np.full(len(uniq), np.inf, np.float32)
        np.minimum.at(wmin, inv, w)
    else:
        wmin = w[first]
    order = np.argsort(first, kind="stable")
    uu = (uniq >> 32).astype(np.int32)[order]
    vv = (uniq & 0xFFFFFFFF).astype(np.int32)[order]
    return uu, vv, wmin[order], uniq[order]


class SlotAllocator:
    """Host-side (u,v) -> slot map + free list over the fixed edge pool.

    Also maintains the host mirror of the pool (``m*`` arrays) so layout
    rebuilds (CSR/ELL) never require a device readback.
    """

    def __init__(self, capacity: int, on_duplicate: str = "ignore"):
        assert on_duplicate in ("ignore", "min")
        self.capacity = capacity
        self.slot_of: dict[tuple[int, int], int] = {}
        self.free: list[int] = list(range(capacity - 1, -1, -1))
        self.on_duplicate = on_duplicate
        self.msrc = np.zeros(capacity, np.int32)
        self.mdst = np.zeros(capacity, np.int32)
        self.mw = np.zeros(capacity, np.float32)
        self.mactive = np.zeros(capacity, np.bool_)

    @classmethod
    def from_pool(cls, capacity: int, on_duplicate: str, src: np.ndarray,
                  dst: np.ndarray, w: np.ndarray, active: np.ndarray
                  ) -> "SlotAllocator":
        """Rebuild planner state from a checkpointed pool snapshot."""
        a = cls(capacity, on_duplicate)
        act = np.asarray(active, bool)
        a.msrc[:] = src; a.mdst[:] = dst; a.mw[:] = w; a.mactive[:] = act
        live = np.nonzero(act)[0]
        a.slot_of = {(int(src[i]), int(dst[i])): int(i) for i in live}
        a.free = [i for i in range(capacity - 1, -1, -1) if not act[i]]
        return a

    def active_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, w) of the live edges, from the host mirror."""
        act = self.mactive
        return self.msrc[act], self.mdst[act], self.mw[act]

    # ------------------------------------------------------------------ adds
    def plan_adds(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray
                  ) -> PlannedAdds:
        """Plan a batch of insertions; returns the accepted writes."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        w = np.asarray(w, np.float32)
        m = len(src)
        if m == 0:
            return self._empty_adds()
        _check_ids(src, dst)
        uu, vv, ww, _ = _coalesce_adds(src, dst, w, self.on_duplicate)

        # Collision probe against the live-edge map (the only dict use).
        slot_of = self.slot_of
        hit = np.fromiter(
            ((int(u), int(v)) in slot_of for u, v in zip(uu, vv)),
            np.bool_, count=len(uu))

        out: list[tuple[np.ndarray, ...]] = []
        new_u, new_v, new_w = uu[~hit], vv[~hit], ww[~hit]
        k = len(new_u)
        if k:
            if k > len(self.free):
                raise RuntimeError("edge pool capacity exhausted")
            new_slots = np.asarray(self.free[-k:][::-1], np.int32)
            del self.free[-k:]
            slot_of.update(zip(zip(new_u.tolist(), new_v.tolist()),
                               new_slots.tolist()))
            self.msrc[new_slots] = new_u
            self.mdst[new_slots] = new_v
            self.mw[new_slots] = new_w
            self.mactive[new_slots] = True
            out.append((new_slots, new_u, new_v, new_w,
                        np.ones(k, np.bool_)))

        if hit.any() and self.on_duplicate == "min":
            du, dv, dw = uu[hit], vv[hit], ww[hit]
            dslots = np.fromiter(
                (slot_of[(int(u), int(v))] for u, v in zip(du, dv)),
                np.int32, count=len(du))
            better = dw < self.mw[dslots]  # weight increases are dropped
            if better.any():
                dslots, du, dv, dw = (dslots[better], du[better],
                                      dv[better], dw[better])
                self.mw[dslots] = dw
                out.append((dslots, du, dv, dw,
                            np.zeros(len(dslots), np.bool_)))

        if not out:
            return self._empty_adds()
        return PlannedAdds(*(np.concatenate(parts) for parts in zip(*out)))

    @staticmethod
    def _empty_adds() -> PlannedAdds:
        z32 = np.empty(0, np.int32)
        return PlannedAdds(z32, z32, z32, np.empty(0, np.float32),
                           np.empty(0, np.bool_))

    # ------------------------------------------------------------------ dels
    def plan_dels(self, src: np.ndarray, dst: np.ndarray):
        """Returns (slots, src, dst) for deletions of edges that exist.
        Deleting a non-existent edge (or the same edge twice in one batch)
        is a no-op."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        _check_ids(src, dst)
        pop = self.slot_of.pop
        found = [(s, int(u), int(v))
                 for u, v in zip(src.tolist(), dst.tolist())
                 if (s := pop((u, v), None)) is not None]
        if not found:
            z32 = np.empty(0, np.int32)
            return z32, z32.copy(), z32.copy()
        slots = np.asarray([f[0] for f in found], np.int32)
        ps = np.asarray([f[1] for f in found], np.int32)
        pd = np.asarray([f[2] for f in found], np.int32)
        self.free.extend(slots.tolist())
        self.mactive[slots] = False
        return slots, ps, pd


# open-addressing sentinels: packed keys are always ≥ 0 (ids < 2**31)
_EMPTY = np.int64(-1)
_DELETED = np.int64(-2)
# Fibonacci multiplicative hash constant (2**64 / φ)
_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


class ColumnarSlotAllocator:
    """Columnar control plane: the (u, v) -> slot map as an open-addressing
    numpy hash table, the free list as an i32 stack.  Same contract and
    bit-identical outputs to :class:`SlotAllocator` (same slot-assignment
    order, same duplicate/deletion semantics), but a batch of m events costs
    a few vectorized probe rounds instead of m Python dict operations —
    this is what keeps host memory and ingest latency flat at E ≥ 10M.

    The index table stores only packed int64 keys + i32 slots; when it fills
    past ~3/4 (live keys + deletion tombstones) it doubles and rehashes the
    *live* keys straight out of the column mirror — the old table is dropped
    before the new one is populated, so growth never holds two copies of the
    mirror columns (they are fixed-capacity and never copied at all).
    """

    def __init__(self, capacity: int, on_duplicate: str = "ignore"):
        assert on_duplicate in ("ignore", "min")
        self.capacity = capacity
        self.on_duplicate = on_duplicate
        self.msrc = np.zeros(capacity, np.int32)
        self.mdst = np.zeros(capacity, np.int32)
        self.mw = np.zeros(capacity, np.float32)
        self.mactive = np.zeros(capacity, np.bool_)
        # free stack: same bottom-to-top order as the dict reference's list
        # (pops come off the top = high indices, batch-reversed)
        self._free = np.arange(capacity - 1, -1, -1, dtype=np.int32)
        self._ntop = capacity
        self._tsize = 0
        self._rebuild(0)

    @classmethod
    def from_pool(cls, capacity: int, on_duplicate: str, src: np.ndarray,
                  dst: np.ndarray, w: np.ndarray, active: np.ndarray
                  ) -> "ColumnarSlotAllocator":
        """Rebuild planner state from a checkpointed pool snapshot."""
        a = cls(capacity, on_duplicate)
        act = np.asarray(active, bool)
        a.msrc[:] = src; a.mdst[:] = dst; a.mw[:] = w; a.mactive[:] = act
        idx = np.arange(capacity - 1, -1, -1, dtype=np.int32)
        fr = idx[~act[idx]]
        a._free[:len(fr)] = fr
        a._ntop = len(fr)
        a._rebuild(int(act.sum()))
        return a

    def active_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, w) of the live edges, from the host mirror."""
        act = self.mactive
        return self.msrc[act], self.mdst[act], self.mw[act]

    # ------------------------------------------------------- debug/test views
    @property
    def slot_of(self) -> dict[tuple[int, int], int]:
        """Dict view of the live map (O(capacity); tests/debug only)."""
        live = np.nonzero(self.mactive)[0]
        return {(int(self.msrc[i]), int(self.mdst[i])): int(i) for i in live}

    @property
    def free(self) -> list[int]:
        """List view of the free stack, same order as the dict reference's
        ``free`` list (tests/debug only)."""
        return self._free[:self._ntop].tolist()

    # -------------------------------------------------------- open addressing
    def _probe0(self, keys: np.ndarray) -> np.ndarray:
        h = keys.astype(np.uint64) * _HASH_MULT
        return (h >> np.uint64(self._shift)).astype(np.int64)

    def _rebuild(self, min_live: int) -> None:
        """(Re)build the index table sized for ``min_live`` keys at ≤ 1/2
        load, rehashing live keys from the mirror and dropping tombstones."""
        size = max(16, self._tsize)
        while (min_live + 1) * 2 > size:
            size <<= 1
        self._tkeys = np.full(size, _EMPTY, np.int64)  # old table freed here
        self._tvals = np.zeros(size, np.int32)
        self._tsize = size
        self._shift = 65 - size.bit_length()  # 64 - log2(size)
        self._used = 0  # non-EMPTY cells (live + tombstones)
        live = np.nonzero(self.mactive)[0].astype(np.int32)
        self._live = len(live)
        if len(live):
            keys = ((self.msrc[live].astype(np.int64) << 32)
                    | self.mdst[live].astype(np.int64))
            self._insert(keys, live)

    def _lookup(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched probe for distinct keys.  Returns (slots i32, cells i64)
        with -1 where absent.  Each probe round is pure array work; the loop
        runs for the longest collision chain only."""
        n = len(keys)
        slots = np.full(n, -1, np.int32)
        cells = np.full(n, -1, np.int64)
        if n == 0 or self._used == 0:
            return slots, cells
        mask = self._tsize - 1
        pos = self._probe0(keys)
        idx = np.arange(n)
        while len(idx):
            p = pos[idx]
            tk = self._tkeys[p]
            found = tk == keys[idx]
            if found.any():
                slots[idx[found]] = self._tvals[p[found]]
                cells[idx[found]] = p[found]
            idx = idx[~(found | (tk == _EMPTY))]  # EMPTY terminates: absent
            pos[idx] = (pos[idx] + 1) & mask
        return slots, cells

    def _insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Batched insert of distinct keys known to be absent.  First free
        cell (EMPTY or tombstone) on the chain wins; same-cell contention
        within the batch is resolved one probe round at a time."""
        mask = self._tsize - 1
        pos = self._probe0(keys)
        idx = np.arange(len(keys))
        while len(idx):
            p = pos[idx]
            tk = self._tkeys[p]
            freec = (tk == _EMPTY) | (tk == _DELETED)
            if freec.any():
                cand = idx[freec]
                pc = p[freec]
                # one winner per contended cell (first in batch order)
                _, firsts = np.unique(pc, return_index=True)
                win = cand[firsts]
                wp = pc[firsts]
                self._used += int((self._tkeys[wp] == _EMPTY).sum())
                self._tkeys[wp] = keys[win]
                self._tvals[wp] = vals[win]
                keep = np.ones(len(idx), bool)
                keep[np.searchsorted(idx, win)] = False
                idx = idx[keep]
            pos[idx] = (pos[idx] + 1) & mask

    def _ensure_headroom(self, k: int) -> None:
        """Grow/compact before inserting k keys: keep live load ≤ 1/2 and
        live+tombstone load ≤ 3/4 so every probe chain hits an EMPTY cell."""
        if ((self._live + k) * 2 > self._tsize
                or (self._used + k) * 4 > self._tsize * 3):
            self._rebuild(self._live + k)

    # ------------------------------------------------------------------ adds
    def plan_adds(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray
                  ) -> PlannedAdds:
        """Plan a batch of insertions; returns the accepted writes."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        w = np.asarray(w, np.float32)
        if len(src) == 0:
            return SlotAllocator._empty_adds()
        _check_ids(src, dst)
        uu, vv, ww, keys = _coalesce_adds(src, dst, w, self.on_duplicate)

        slots, _ = self._lookup(keys)
        hit = slots >= 0

        out: list[tuple[np.ndarray, ...]] = []
        new_u, new_v, new_w = uu[~hit], vv[~hit], ww[~hit]
        k = len(new_u)
        if k:
            if k > self._ntop:
                raise RuntimeError("edge pool capacity exhausted")
            new_slots = self._free[self._ntop - k:self._ntop][::-1].copy()
            self._ntop -= k
            self._ensure_headroom(k)
            self._insert(keys[~hit], new_slots)
            self._live += k
            self.msrc[new_slots] = new_u
            self.mdst[new_slots] = new_v
            self.mw[new_slots] = new_w
            self.mactive[new_slots] = True
            out.append((new_slots, new_u, new_v, new_w,
                        np.ones(k, np.bool_)))

        if hit.any() and self.on_duplicate == "min":
            dslots, du, dv, dw = slots[hit], uu[hit], vv[hit], ww[hit]
            better = dw < self.mw[dslots]  # weight increases are dropped
            if better.any():
                dslots, du, dv, dw = (dslots[better], du[better],
                                      dv[better], dw[better])
                self.mw[dslots] = dw
                out.append((dslots, du, dv, dw,
                            np.zeros(len(dslots), np.bool_)))

        if not out:
            return SlotAllocator._empty_adds()
        return PlannedAdds(*(np.concatenate(parts) for parts in zip(*out)))

    # ------------------------------------------------------------------ dels
    def plan_dels(self, src: np.ndarray, dst: np.ndarray):
        """Returns (slots, src, dst) for deletions of edges that exist.
        Deleting a non-existent edge (or the same edge twice in one batch)
        is a no-op — identical semantics to the dict reference."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        _check_ids(src, dst)
        z32 = np.empty(0, np.int32)
        if len(src) == 0:
            return z32, z32.copy(), z32.copy()
        # in-batch duplicate dels collapse to the first occurrence
        key = (src << 32) | dst
        uniq, first = np.unique(key, return_index=True)
        keys = uniq[np.argsort(first, kind="stable")]
        slots, cells = self._lookup(keys)
        found = slots >= 0
        if not found.any():
            return z32, z32.copy(), z32.copy()
        fslots = slots[found]
        fkeys = keys[found]
        self._tkeys[cells[found]] = _DELETED  # tombstone; _used unchanged
        self._live -= len(fslots)
        self._free[self._ntop:self._ntop + len(fslots)] = fslots
        self._ntop += len(fslots)
        self.mactive[fslots] = False
        return (fslots, (fkeys >> 32).astype(np.int32),
                (fkeys & 0xFFFFFFFF).astype(np.int32))


ALLOC_IMPLS = ("columnar", "dict")


def allocator_cls(impl: str = "columnar"):
    """Resolve an ``alloc_impl`` config knob to an allocator class."""
    if impl not in ALLOC_IMPLS:
        raise ValueError(
            f"unknown alloc_impl {impl!r}; valid values: {ALLOC_IMPLS}")
    return ColumnarSlotAllocator if impl == "columnar" else SlotAllocator


def make_allocator(capacity: int, on_duplicate: str = "ignore",
                   impl: str = "columnar"):
    """Construct the configured control-plane implementation."""
    return allocator_cls(impl)(capacity, on_duplicate)


def pad_pow2(*arrays: np.ndarray) -> tuple[np.ndarray, ...]:
    """Pad batch arrays to the next power of two by REPEATING the last
    element (idempotent for slot writes: re-setting the same slot to the
    same value is a no-op).  Keeps the number of distinct batch shapes at
    O(log max_batch) — the reference needs that for its jit caches; here it
    keeps the caching allocator's block sizes few and the patch ops on the
    same padded batches the reference's see.

    Contract (uniform across all input lengths): returns a fresh tuple of
    arrays, all of length ``next_pow2(n)``; a zero-length or already-pow2
    batch passes through with the *same* array objects (no copy).  All
    inputs must share the same leading length.
    """
    n = len(arrays[0])
    assert all(len(a) == n for a in arrays), [len(a) for a in arrays]
    if n == 0:
        return tuple(arrays)
    m = 1
    while m < n:
        m <<= 1
    if m == n:
        return tuple(arrays)
    return tuple(np.concatenate([a, np.repeat(a[-1:], m - n, axis=0)])
                 for a in arrays)


def apply_adds(edges: EdgePool, slots: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, w: torch.Tensor) -> EdgePool:
    """Write a batch of insertions into their slots, in place.  pad_pow2
    repeats write the same value to the same slot, so the scatter is
    idempotent whatever order the device applies it in."""
    s = slots.long()
    edges.src[s] = src
    edges.dst[s] = dst
    edges.w[s] = w
    edges.active[s] = True
    return edges


def apply_dels(edges: EdgePool, slots: torch.Tensor) -> EdgePool:
    """Deactivate a batch of slots, in place. src/dst stay in-range."""
    edges.active[slots.long()] = False
    return edges
