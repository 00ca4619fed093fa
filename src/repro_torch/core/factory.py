"""``make_engine`` — the one front door to the port's two engines:

    eng = make_engine(num_vertices=n, edge_capacity=m, source=0)  # one device
    eng = make_engine(num_vertices=n, edge_capacity=m, source=0,
                      relax_backend="ellpack", device="cpu")
    eng = make_engine(num_vertices=n, edge_capacity=m, source=0,
                      relax_backend="auto",                # K1, then K2
                      frontier_mode="sparse")              # K3
    eng = make_engine(num_vertices=n, edge_capacity=m,
                      wave_schedule="buckets", bucket_width="auto")
    eng = make_engine(num_vertices=n, edge_capacity=m,
                      sources=(0, 5, 9))     # [S, N] lanes, one layout
    eng = make_engine(num_vertices=n, edge_capacity=m, source=0,
                      partitions=2)          # sharded, one partition a card
    eng = make_engine(num_vertices=n, edge_capacity=m, source=0,
                      mesh=make_mesh((8,), ("graph",),
                                     devices=[torch.device("cuda:0")] * 8),
                      relax_backend="ellpack")   # 8 partitions on one card
    eng = make_engine(num_vertices=n, edge_capacity=m, sources=(0, 5, 9),
                      partitions=2)          # sharded [S, N] lanes

Selection rule (the reference's): ``mesh=`` or ``partitions=`` builds the
sharded engine (``partitions=P`` makes a one-axis mesh over the first P
visible devices of the config's ``device`` type; ``mesh`` wins when both
are given and P must then match its size).  ``edge_capacity`` is always the
TOTAL edge budget — the sharded path gives each partition
``ceil(edge_capacity / P)`` slots.  ``relabel`` (sharded only) passes the
edge-balanced relabeling triple to ``ShardedSSSPDelEngine``.

Every other keyword must be a field of the selected config
(``EngineConfig`` / ``ShardedEngineConfig``); anything else raises a
ValueError listing the valid knobs: the backend and its layout knobs, the
kernel switches (``ell_use_kernel``, and on one device ``sliced_fused`` and
``frontier_kernel``; they default to the kernel on a CUDA device and the
plain torch version on the CPU; pass False to run the plain version on the
card), the frontier (``frontier_mode``, ``frontier_cap``), the schedule
(``wave_schedule``, ``bucket_width``), ``sources`` (lanes on either
engine), ``batch_deletions``, ``use_doubling``,
``on_duplicate``, ``alloc_impl``, ``device``, the sharded engine's
``exchange`` / ``delta_cap``, and the telemetry knobs (``observability``,
``obs_flight_capacity``, ``obs_watchdog``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.engine import EngineConfig, SSSPDelEngine

_FIXED = ("num_vertices", "edge_capacity", "edges_per_part", "source",
          "sources")


def _valid_knobs(cfg_cls) -> tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(cfg_cls)
                 if f.name not in _FIXED)


def make_engine(*, num_vertices: int, edge_capacity: int, source: int = 0,
                sources: tuple[int, ...] | None = None,
                partitions: int | None = None, mesh: Any | None = None,
                relabel: Any | None = None, **knobs):
    """Build a ready single-device or sharded engine (see module
    docstring)."""
    if mesh is None and partitions is None:
        if relabel is not None:
            raise ValueError(
                "relabel= requires the sharded engine; pass mesh= or "
                "partitions= to select it")
        valid = _valid_knobs(EngineConfig)
        bad = sorted(set(knobs) - set(valid))
        if bad:
            raise ValueError(
                f"unknown engine knob(s) {bad} for the single-host "
                f"engine; valid knobs: {valid}")
        return SSSPDelEngine(EngineConfig(
            num_vertices=num_vertices, edge_capacity=edge_capacity,
            source=source, sources=sources, **knobs))

    from repro_torch.core.dist_engine import (ShardedEngineConfig,
                                              ShardedSSSPDelEngine)
    from repro_torch.launch import mesh as mesh_mod
    if mesh is None:
        kind = torch.device(knobs.get("device", "cuda")).type
        avail = mesh_mod.visible_devices(kind)
        if not 1 <= partitions <= len(avail):
            raise ValueError(
                f"partitions={partitions} but only {len(avail)} device(s) "
                f"are visible; pass mesh= for an explicit layout")
        mesh = mesh_mod.make_mesh((partitions,), ("graph",),
                                  devices=avail[:partitions])
    P = mesh.size
    if partitions is not None and partitions != P:
        raise ValueError(
            f"partitions={partitions} does not match mesh size {P}; pass "
            "only one of mesh= / partitions=")
    valid = _valid_knobs(ShardedEngineConfig)
    bad = sorted(set(knobs) - set(valid))
    if bad:
        raise ValueError(
            f"unknown engine knob(s) {bad} for the sharded engine; "
            f"valid knobs: {valid}")
    cfg = ShardedEngineConfig(
        num_vertices=num_vertices,
        edges_per_part=-(-edge_capacity // P),  # total budget / P, ceil
        source=source, sources=sources, **knobs)
    return ShardedSSSPDelEngine(cfg, mesh=mesh, relabel=relabel)
