"""``make_engine`` — the front door to the port's engine (single host):

    eng = make_engine(num_vertices=n, edge_capacity=m, source=0)
    eng = make_engine(num_vertices=n, edge_capacity=m, source=0,
                      relax_backend="ellpack", device="cpu")
    eng = make_engine(num_vertices=n, edge_capacity=m, source=0,
                      relax_backend="auto",                # K1, then K2
                      frontier_mode="sparse")              # K3
    eng = make_engine(num_vertices=n, edge_capacity=m,
                      wave_schedule="buckets", bucket_width="auto")
    eng = make_engine(num_vertices=n, edge_capacity=m,
                      sources=(0, 5, 9))     # [S, N] lanes, one layout

Every keyword must be a field of ``EngineConfig``; anything else raises a
ValueError listing the valid knobs: the backend and its layout knobs, the
kernel switches (``ell_use_kernel``, ``sliced_fused``, ``frontier_kernel``,
which default to the kernel on a CUDA device and the plain torch version
on the CPU; pass False to run the plain version on the card), the
frontier (``frontier_mode``, ``frontier_cap``), the schedule
(``wave_schedule``, ``bucket_width``), ``sources``, ``batch_deletions``,
``use_doubling``, ``on_duplicate``, ``alloc_impl``, ``device`` and the
telemetry knobs (``observability``, ``obs_flight_capacity``,
``obs_watchdog``).  The sharded engine (``partitions=`` / ``mesh=`` in the
reference) is not yet ported.

    eng = make_engine(num_vertices=n, edge_capacity=m, observability=True,
                      obs_watchdog=WatchdogConfig())
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.engine import EngineConfig, SSSPDelEngine

_SHARDED = ("partitions", "mesh", "relabel")


def make_engine(*, num_vertices: int, edge_capacity: int, source: int = 0,
                **knobs) -> SSSPDelEngine:
    """Build a ready single-host engine (see module docstring)."""
    sharded = sorted(set(knobs) & set(_SHARDED))
    if sharded:
        raise ValueError(f"{sharded}: the sharded engine is not yet ported "
                         f"to repro_torch")
    valid = tuple(f.name for f in dataclasses.fields(EngineConfig)
                  if f.name not in ("num_vertices", "edge_capacity",
                                    "source"))
    bad = sorted(set(knobs) - set(valid))
    if bad:
        raise ValueError(f"unknown engine knob(s) {bad}; valid knobs: "
                         f"{valid}")
    return SSSPDelEngine(EngineConfig(
        num_vertices=num_vertices, edge_capacity=edge_capacity,
        source=source, **knobs))
