"""RelaxBackend protocol — one relaxation backend = layout state + host
planner + patch ops + wave computation + rebuild policy + checkpoint
participation (torch rendering of ``repro.core.backends.base``, single-device
side).

``SSSPDelEngine`` holds ONE ``RelaxBackend`` and calls ``apply_adds`` /
``apply_dels`` / ``relax`` / ``delete`` / ``restore`` — no per-backend
branching in the ingest path.  The equivalence contract travels with the
protocol: every backend's wave evaluates the same candidate set (all live
in-edges of each row, offers masked by the frontier) with the same
smallest-src-id tie-break, so ``(dist, parent)`` and the round/message
counters are bit-identical across backends and against the reference.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, ClassVar

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.core.delete import DeleteStats
    from repro_torch.core.ingest import PlannedAdds
    from repro_torch.core.relax import RelaxStats
    from repro_torch.core.state import EdgePool, SSSPState


BACKENDS: dict[str, type["RelaxBackend"]] = {}


def register(cls: type["RelaxBackend"]) -> type["RelaxBackend"]:
    BACKENDS[cls.name] = cls
    return cls


# A dense-ELL rebuild whose ``K*N`` cell allocation exceeds this many times
# the live edge count warns of the power-law-hub pathology.
ELL_BLOWUP_RATIO = 16

# Reference options that later slices of the port bring over: selecting one
# raises instead of silently running something else.
NOT_YET_PORTED = {
    "relax_backend": ("sliced", "auto"),
    "wave_schedule": ("buckets",),
    "frontier_mode": ("sparse", "auto"),
}
_ELLPACK_KNOBS = ("ell_block_rows", "ell_init_k", "ell_use_kernel")


def validate_backend_config(cfg: Any) -> None:
    """Raise ``ValueError`` at construction time for an unknown or not yet
    ported backend/schedule/frontier mode, or for dense-ELL knobs set while
    another backend is selected."""
    for knob, later in NOT_YET_PORTED.items():
        val = getattr(cfg, knob)
        if val in later:
            raise ValueError(f"{knob}={val!r} is not yet ported to "
                             f"repro_torch")
    name = cfg.relax_backend
    if name not in BACKENDS:
        raise ValueError(f"unknown relax_backend {name!r}; valid backends: "
                         f"{sorted(BACKENDS)}")
    if cfg.wave_schedule != "rounds":
        raise ValueError(f"unknown wave_schedule {cfg.wave_schedule!r}")
    if cfg.frontier_mode != "dense":
        raise ValueError(f"unknown frontier_mode {cfg.frontier_mode!r}")
    if name != "ellpack":
        defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
        for k in _ELLPACK_KNOBS:
            if getattr(cfg, k) != defaults[k]:
                raise ValueError(
                    f"{k}={getattr(cfg, k)!r} is a backend knob that does "
                    f"not apply to relax_backend={name!r} (it configures "
                    f"the dense-ELL layout); remove it or select the "
                    f"matching backend")


class RelaxBackend:
    """One relaxation backend for the single-device engine.

    Owns the device layout state (if any), the host planner that assigns
    incremental patch positions, the patch ops (ADD append / DEL tombstone /
    min-update), the epoch wave computation, and the rebuild policy.  Layout
    state is a derived view and is never serialized — ``restore`` rebuilds
    it from the edge-pool mirror (``SlotAllocator``).
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

    def restore(self, alloc: Any) -> None:
        """Rebuild layout state from the pool mirror after a restore."""


def make_backend(name: str, cfg: Any, *, use_kernel: bool = False,
                 device: torch.device | str = "cpu") -> RelaxBackend:
    if name not in BACKENDS:
        raise ValueError(f"unknown relax_backend {name!r}; valid backends: "
                         f"{sorted(BACKENDS)}")
    return BACKENDS[name](cfg, cfg.num_vertices, use_kernel=use_kernel,
                          device=device)


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
