"""RelaxBackend protocol — one relaxation backend = layout state + host
planner + patch ops + wave computation + rebuild policy + checkpoint
participation (torch rendering of ``repro.core.backends.base``, single-device
side).

``SSSPDelEngine`` holds ONE ``RelaxBackend`` and calls ``apply_adds`` /
``apply_dels`` / ``relax`` / ``delete`` / ``drain`` / ``restore`` (and the
``*_batched`` forms on a multi-source engine) — no per-backend branching in
the ingest path.  The equivalence contract travels with the protocol: every
backend's wave evaluates the same candidate set (all live in-edges of each
row, offers masked by the frontier) with the same smallest-src-id
tie-break, so ``(dist, parent)`` and the round/message counters are
bit-identical across backends and against the reference.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, ClassVar

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.core.buckets import PendingState
    from repro_torch.core.delete import DeleteStats
    from repro_torch.core.distributed import DistributedSSSP, ShardWave
    from repro_torch.core.ingest import PlannedAdds
    from repro_torch.core.relax import RelaxStats
    from repro_torch.core.state import EdgePool, SSSPState


BACKENDS: dict[str, type["RelaxBackend"]] = {}
SHARDED_BACKENDS: dict[str, type["ShardedBackend"]] = {}


def register(cls: type["RelaxBackend"]) -> type["RelaxBackend"]:
    BACKENDS[cls.name] = cls
    return cls


def register_sharded(cls: type["ShardedBackend"]) -> type["ShardedBackend"]:
    SHARDED_BACKENDS[cls.name] = cls
    return cls


# Knobs that only make sense for a particular backend: setting one away from
# its dataclass default while selecting a different backend is a config bug.
# ``ell_use_kernel`` is the one shared knob: both ELL-layout backends
# (ellpack, sliced) consume it.
_SLICED_KNOBS = ("sliced_slice_rows", "sliced_hub_k", "sliced_init_k",
                 "sliced_fused")
_ELLPACK_KNOBS = ("ell_block_rows", "ell_init_k")
_ELL_SHARED_KNOBS = ("ell_use_kernel",)

# ``relax_backend="auto"``: start on the dense ELL layout and fall back to
# the sliced/hybrid layout when a rebuild's ``K*N`` cell allocation blows
# past ``ELL_BLOWUP_RATIO`` times the live edge count — the power-law-hub
# pathology.  Both layouts' knobs are therefore legitimate under "auto".
AUTO_BACKEND = "auto"
ELL_BLOWUP_RATIO = 16

WAVE_SCHEDULES = ("rounds", "buckets")
FRONTIER_MODES = ("dense", "sparse", "auto")

# Kernel switches whose default is None here (the kernel iff the device is
# CUDA) but False in the reference: an explicit False is as unset as None,
# so every configuration the reference accepts is accepted.
_OFF_IS_UNSET = ("sliced_fused", "frontier_kernel")


def validate_backend_config(cfg: Any) -> None:
    """Raise ``ValueError`` at construction time for an unknown
    backend/schedule/frontier mode, a bad ``bucket_width``, or backend,
    schedule or frontier knobs that do not apply to the selected backend,
    schedule or mode (the reference's rules and messages).  Shared by
    ``EngineConfig`` and ``ShardedEngineConfig``."""
    name = cfg.relax_backend
    if name not in BACKENDS and name != AUTO_BACKEND:
        raise ValueError(f"unknown relax_backend {name!r}; valid backends: "
                         f"{sorted(BACKENDS) + [AUTO_BACKEND]}")
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    schedule = cfg.wave_schedule
    if schedule not in WAVE_SCHEDULES:
        raise ValueError(
            f"unknown wave_schedule {schedule!r}; valid schedules: "
            f"{list(WAVE_SCHEDULES)}")
    width = cfg.bucket_width
    # the string check must precede the numeric compare (a str/float ``>``
    # would raise the wrong exception type)
    if isinstance(width, str):
        if width != "auto":
            raise ValueError(
                f"bucket_width must be > 0 or 'auto'; got {width!r}")
    elif not width > 0:   # also rejects NaN
        raise ValueError(
            f"bucket_width must be > 0 (inf = one bucket); got {width!r}")
    if schedule == "rounds" and width != defaults["bucket_width"]:
        raise ValueError(
            f"bucket_width={width!r} configures the buckets schedule; "
            f"remove it or select wave_schedule='buckets'")
    mode = cfg.frontier_mode
    if mode not in FRONTIER_MODES:
        raise ValueError(f"unknown frontier_mode {mode!r}; valid modes: "
                         f"{list(FRONTIER_MODES)}")
    if cfg.frontier_cap < 0:
        raise ValueError(f"frontier_cap must be >= 0 (0 = derive); got "
                         f"{cfg.frontier_cap}")

    def is_set(k: str) -> bool:
        # a knob the config does not have (the sharded config has no
        # sliced_fused / frontier_kernel) is unset
        if k not in defaults:
            return False
        v = getattr(cfg, k)
        return v != defaults[k] and not (k in _OFF_IS_UNSET and v is False)

    if mode == "dense":
        for k in ("frontier_cap", "frontier_kernel"):
            if is_set(k):
                raise ValueError(
                    f"{k}={getattr(cfg, k)!r} configures the sparse "
                    f"frontier path; remove it or select "
                    f"frontier_mode='sparse'/'auto'")
    misapplied: list[tuple[tuple[str, ...], str]] = []
    if name not in ("sliced", AUTO_BACKEND):
        misapplied.append((_SLICED_KNOBS, "sliced"))
    if name not in ("ellpack", AUTO_BACKEND):
        misapplied.append((_ELLPACK_KNOBS, "dense-ELL"))
    if name == "segment":
        misapplied.append((_ELL_SHARED_KNOBS, "ELL-layout"))
    for knobs, layout in misapplied:
        for k in knobs:
            if is_set(k):
                raise ValueError(
                    f"{k}={getattr(cfg, k)!r} is a backend knob that does "
                    f"not apply to relax_backend={name!r} (it configures "
                    f"the {layout} layout); remove it or select the "
                    f"matching backend")


class RelaxBackend:
    """One relaxation backend for the single-device engine.

    Owns the device layout state (if any), the host planner that assigns
    incremental patch positions, the patch ops (ADD append / DEL tombstone /
    min-update), the epoch wave computation, and the rebuild policy.  Layout
    state is a derived view and is never serialized — ``restore`` rebuilds
    it from the edge-pool mirror (``SlotAllocator``).

    Lanes: every epoch takes one tree or a stack of S trees (``[S, N]``
    dist/parent, ``[S]`` source) over the ONE shared layout, so the
    ``*_batched`` methods — the reference's jit(vmap(epoch)) entry points —
    are the same epochs here (a backend whose lane form differs overrides
    them).  Frontiers of ADD epochs are shared ``[N]`` masks (ADD tails are
    source-independent); deletion seeds and pending sets are per lane.
    """

    name: ClassVar[str]

    def __init__(self, cfg: Any, num_vertices: int, *,
                 use_kernel: bool = False,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.n = num_vertices
        self.use_kernel = use_kernel
        self.device = torch.device(device)

    def apply_adds(self, plan: "PlannedAdds", alloc: Any) -> None:
        """Patch the layout for one planned ADD batch (or rebuild from the
        alloc's host mirror, which already contains the batch).  No-op for
        layouts derived per-epoch."""

    def apply_dels(self, rows: np.ndarray, src: np.ndarray) -> None:
        """Tombstone deleted edges (padded batch; located on device)."""

    def relax(self, sssp: "SSSPState", edges: "EdgePool",
              frontier: torch.Tensor) -> tuple["SSSPState", "RelaxStats"]:
        raise NotImplementedError

    def delete(self, sssp: "SSSPState", edges: "EdgePool",
               seed: torch.Tensor) -> tuple["SSSPState", "DeleteStats"]:
        raise NotImplementedError

    def drain(self, sssp: "SSSPState", edges: "EdgePool",
              pend: "PendingState", *, bucket_width: float
              ) -> tuple["SSSPState", "PendingState", "RelaxStats"]:
        """Settle the bucketed schedule's pending set (core/buckets.py
        ``run_drain``: one pull into the invalidated set, then
        threshold-paced push waves), returning an empty pending set."""
        raise NotImplementedError

    # --- batched multi-source epochs: the same lane-generic epochs
    def relax_batched(self, sssp: "SSSPState", edges: "EdgePool",
                      frontier: torch.Tensor
                      ) -> tuple["SSSPState", "RelaxStats"]:
        return self.relax(sssp, edges, frontier)

    def delete_batched(self, sssp: "SSSPState", edges: "EdgePool",
                       seed: torch.Tensor
                       ) -> tuple["SSSPState", "DeleteStats"]:
        return self.delete(sssp, edges, seed)

    def drain_batched(self, sssp: "SSSPState", edges: "EdgePool",
                      pend: "PendingState", *, bucket_width: float
                      ) -> tuple["SSSPState", "PendingState", "RelaxStats"]:
        return self.drain(sssp, edges, pend, bucket_width=bucket_width)

    def restore(self, alloc: Any) -> None:
        """Rebuild layout state from the pool mirror after a restore."""

    def layout_counters(self) -> dict[str, int]:
        """Monotone host-side layout event totals for the obs layer
        (DESIGN.md §10): rebuilds and overflow-lane placements so far.
        The engine diffs successive calls (``EngineObs.note_layout``);
        totals reset when "auto" swaps layouts, and the deltas clamp.
        Segment has no planner and reports nothing; the ELL-family
        planners carry ``rebuilds``, the sliced one also ``spills``."""
        return {}

    def invariants(self) -> dict[str, bool]:
        """Occupancy invariants of the device layout (diagnostics/tests),
        as Python bools; none for a backend without a derived layout."""
        return {}


def make_backend(name: str, cfg: Any, *, use_kernel: bool = False,
                 device: torch.device | str = "cpu",
                 **options: Any) -> RelaxBackend:
    """Construct backend ``name``; ``options`` are that backend's own
    constructor flags (``defer_blowup`` of ``ellpack``, ``use_fused`` of
    ``sliced``)."""
    if name not in BACKENDS:
        raise ValueError(f"unknown relax_backend {name!r}; valid backends: "
                         f"{sorted(BACKENDS)}")
    return BACKENDS[name](cfg, cfg.num_vertices, use_kernel=use_kernel,
                          device=device, **options)


# ------------------------------------------------------------ sharded side --
class ShardedBackend:
    """Sharded coordinator for one backend (the sharded engine's side of the
    protocol): one shard-local planner per partition and one layout block
    per partition, each block its own tensors on the partition's device.

    dst-owner edge placement makes every partition's in-edges local, so
    partition ``p``'s layout rows are exactly its vertex window
    ``[p*npp, (p+1)*npp)`` (the planners' ``row0``).  Geometry — the ELL
    width K, the sliced widths and overflow capacity — is synchronized
    across partitions at rebuild time, and any partition's overflow
    rebuilds ALL of them from the per-partition host mirrors, as in the
    reference (whose shard_map needs one block shape); so rebuild events
    and layouts equal the reference's partition for partition.

    The reference concatenates the blocks into globally sharded arrays and
    patches them with masked scatters inside its jitted epochs.  Here the
    host routes every patch to its partition and writes exact local
    indices in place — ADD patches in ``stage_adds`` before the epoch, DEL
    tombstones in ``shard_del_patch`` inside it — so there is nothing to
    hand back (the reference's ``update_del_arrays``).
    """

    name: ClassVar[str]

    def __init__(self, cfg: Any, ds: "DistributedSSSP", allocs: list, *,
                 use_kernel: bool = False):
        self.cfg = cfg
        self.ds = ds
        self.allocs = allocs
        self.use_kernel = use_kernel
        self.P, self.npp = ds.P, ds.npp

    def stage_adds(self, plans: list[tuple[int, "PlannedAdds"]]) -> None:
        """Patch the layout for one ADD batch (per-partition plans, global
        ids), rebuilding all partitions from the mirrors on any partition's
        overflow."""

    def shard_del_patch(self, p: int, dst: np.ndarray,
                        src: np.ndarray) -> None:
        """Tombstone partition ``p``'s deleted edges (global ids, padded) in
        its layout block, in place; a no-op without a layout."""

    def shard_wave(self, p: int, pool: Any) -> "ShardWave":
        """Partition ``p``'s wave: ``wave(offers) -> (best f32[npp], arg
        i32[npp])`` — per owned row, the min over its live in-edges of
        ``offers[src] + w`` and the smallest minimizing global src id.
        ``offers`` is the gathered global vector on the partition's device
        (+inf for sources that offer nothing); ``pool`` is the partition's
        COO pool slice."""
        raise NotImplementedError

    def restore(self) -> None:
        """Rebuild every partition's layout from the per-partition
        mirrors."""

    def layout_counters(self) -> dict[str, int]:
        """Sharded twin of ``RelaxBackend.layout_counters``.  Rebuilds are
        coupled (every planner advances together), so the max over the
        planners counts rebuild events; overflow-lane placements are per
        partition and sum."""
        pls = getattr(self, "planners", None) or []
        return {
            "rebuilds": max((int(getattr(p, "rebuilds", 0)) for p in pls),
                            default=0),
            "overflow_hits": sum(int(getattr(p, "spills", 0)) for p in pls),
        }

    def invariants(self) -> dict[str, bool]:
        """The layout's occupancy invariants, held in every partition."""
        return {}


def make_sharded_backend(name: str, cfg: Any, ds: "DistributedSSSP",
                         allocs: list, *,
                         use_kernel: bool = False) -> ShardedBackend:
    if name not in SHARDED_BACKENDS:
        raise ValueError(f"unknown relax_backend {name!r}; valid backends: "
                         f"{sorted(SHARDED_BACKENDS)}")
    return SHARDED_BACKENDS[name](cfg, ds, allocs, use_kernel=use_kernel)


def rank_within_rows(rows: np.ndarray) -> np.ndarray:
    """Rank of each batch entry among the entries targeting the same row,
    in stable batch order — the cell-offset assignment of the ELL planner
    (kpos candidate = fill[row] + rank)."""
    m = len(rows)
    order = np.argsort(rows, kind="stable")
    sr = rows[order]
    starts = np.nonzero(np.r_[True, sr[1:] != sr[:-1]])[0]
    sizes = np.diff(np.r_[starts, m])
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m) - np.repeat(starts, sizes)
    return rank
