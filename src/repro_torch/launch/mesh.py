"""Partition meshes for the sharded engine (torch rendering of
``repro.launch.mesh``).

The reference is single-controller SPMD: one Python process drives
``shard_map`` over a ``jax.sharding.Mesh`` of P devices.  The port keeps
that model without ``torch.distributed``: a ``Mesh`` here is a shape, its
axis names and the list of P ``torch.device``s that hold the partitions,
flattened in row-major axis order, and one process drives all of them.
The list may repeat a device: ``devices=[cuda:0] * 8`` puts eight
partitions on one card (the counterpart of the reference's forced host
devices), ``[cpu] * 8`` on the CPU.  NCCL refuses two ranks on one GPU,
so a process per partition could not stack partitions on one card.

    mesh = make_mesh((8,), ("graph",), devices=[torch.device("cuda:0")] * 8)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=[torch.device("cpu")] * 8)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

__all__ = ["Mesh", "graph_axes", "make_mesh", "make_production_mesh",
           "make_test_mesh", "visible_devices"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` maps each axis name to its size, in axis order (as
    ``jax.sharding.Mesh.shape``); ``devices`` holds one device per
    partition, row-major over the axes."""

    shape: dict[str, int]
    axis_names: tuple[str, ...]
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _normalize(dev: torch.device | str) -> torch.device:
    """``cuda`` without an index names the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(kind: str) -> list[torch.device]:
    """Every visible device of type ``kind``: the CUDA cards torch sees, or
    the one CPU device (as the reference's CPU backend has one device)."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"device type must be 'cuda' or 'cpu'; got {kind!r}")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A mesh of ``prod(shape)`` partitions.  ``devices=None`` takes the
    first ``prod(shape)`` visible CUDA cards (a ValueError when there are
    fewer); an explicit list may repeat a device."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} must "
                         f"pair up, with distinct names")
    size = math.prod(shape)
    if devices is None:
        avail = visible_devices("cuda")
        if len(avail) < size:
            raise ValueError(f"a mesh of {size} partitions needs {size} "
                             f"visible CUDA device(s); {len(avail)} are "
                             f"visible — pass devices= to stack partitions "
                             f"on fewer")
        devices = avail[:size]
    devices = tuple(_normalize(d) for d in devices)
    if len(devices) != size:
        raise ValueError(f"mesh of shape {shape} has {size} partitions; got "
                         f"{len(devices)} devices")
    return Mesh(shape=dict(zip(axes, shape)), axis_names=axes,
                devices=devices)


def make_test_mesh(shape: Sequence[int] | None = None,
                   axes: Sequence[str] | None = None, *,
                   device: torch.device | str = "cuda") -> Mesh:
    """A mesh over the visible devices of ``device``'s type (tests / local
    runs): every visible CUDA card, or the one CPU partition when the
    caller asks for the CPU.  With no ``shape``, ``(1, n)`` over
    ``("data", "model")`` for n > 1 devices, else ``(1, 1)``."""
    devs = visible_devices(torch.device(device).type)
    n = len(devs)
    if shape is None:
        shape, axes = (1, n) if n > 1 else (1, 1), ("data", "model")
    return make_mesh(shape, axes, devices=devs[:math.prod(shape)])


def graph_axes(mesh: Mesh) -> tuple[str, ...]:
    """The SSSP engine flattens every mesh axis into one vertex partition."""
    return tuple(mesh.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, every partition on ``meta``
    (shapes only, for the dry run).  Single pod: (data=16, model=16) = 256
    partitions; multi-pod: (pod=2, data=16, model=16) = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=["meta"] * math.prod(shape))
