"""``make_engine`` — the front door to the port's engine (single host):

    eng = make_engine(num_vertices=n, edge_capacity=m, source=0)
    eng = make_engine(num_vertices=n, edge_capacity=m, source=0,
                      relax_backend="ellpack", device="cpu")

Every keyword must be a field of ``EngineConfig``; anything else raises a
ValueError listing the valid knobs.  The sharded engine (``partitions=`` /
``mesh=`` in the reference) is not yet ported.
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
