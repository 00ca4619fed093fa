"""Counter registry (DESIGN.md §10.1, §10.5); torch rendering of
``repro.obs.counters``.

Extends the lazy-stats discipline from two hardwired counters (rounds,
messages) to an open set of named counters.  Two kinds live in one
registry:

  * **device counters** — ``add(name, value)`` folds a device tensor (a
    scalar, or an ``[S]`` per-lane vector) into a lazily accumulated
    tensor with a plain ``+``: no host read, the value is whatever the
    epoch already computed or a cheap eager reduction over state the
    engine already holds.  ``peak`` folds with ``maximum`` instead
    (high-water marks).
  * **host counters** — ``inc(name, n)`` for numbers that are born on the
    host (planned batch sizes, planner rebuild totals, the port's host
    round counts); ``n`` may be an int or a numpy array and accumulates by
    ``+`` as well.

Vector counters carry an optional **dimension** tag (§10.5): passing
``dim="lane"`` on a write names the axis the vector indexes, and
``attribution()`` groups the snapshot's tagged counters by dimension.

``snapshot()`` is the ONLY read-back point: the device counters are
flattened, concatenated and copied to the host in ONE device->host copy
(one per device, should counters live on several), then split on the
host.  A disabled registry no-ops every write.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["CounterRegistry"]


class CounterRegistry:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._dev: dict[str, Any] = {}
        self._host: dict[str, Any] = {}
        self._dims: dict[str, str] = {}

    def _tag(self, name: str, dim: str | None) -> None:
        if dim is not None:
            self._dims[name] = dim

    # ------------------------------------------------------- device counters
    def add(self, name: str, value, dim: str | None = None) -> None:
        """Lazily accumulate a device value — shape-agnostic (scalar, [S]
        per-lane); never reads it back."""
        if not self.enabled:
            return
        self._tag(name, dim)
        cur = self._dev.get(name)
        self._dev[name] = value if cur is None else cur + value

    def peak(self, name: str, value, dim: str | None = None) -> None:
        """High-water-mark fold (elementwise maximum) of a device tensor or
        a numpy value."""
        if not self.enabled:
            return
        self._tag(name, dim)
        cur = self._dev.get(name)
        if cur is None:
            self._dev[name] = value
        elif isinstance(cur, torch.Tensor) or isinstance(value, torch.Tensor):
            dev = (cur if isinstance(cur, torch.Tensor) else value).device
            self._dev[name] = torch.maximum(torch.as_tensor(cur, device=dev),
                                            torch.as_tensor(value, device=dev))
        else:
            self._dev[name] = np.maximum(cur, value)

    # --------------------------------------------------------- host counters
    def inc(self, name: str, n=1, dim: str | None = None) -> None:
        """Host-side accumulate; ``n`` may be an int or a numpy array (e.g.
        an [S] per-lane tally) — both fold with ``+``."""
        if not self.enabled:
            return
        self._tag(name, dim)
        self._host[name] = self._host.get(name, 0) + n

    # --------------------------------------------------------------- readout
    def names(self) -> list[str]:
        return sorted(set(self._host) | set(self._dev))

    def dims(self) -> dict[str, str]:
        """Copy of the name -> dimension tag map (§10.5)."""
        return dict(self._dims)

    def _device_values(self) -> dict[str, np.ndarray]:
        """Every device counter as a host array: the tensors of one device
        flattened into one buffer (i64, or f64 if any counter is floating)
        and copied to the host at once, then split and reshaped."""
        by_device: dict[torch.device, list[tuple[str, torch.Tensor]]] = {}
        out: dict[str, np.ndarray] = {}
        for k, v in self._dev.items():
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append((k, v))
            else:
                out[k] = np.asarray(v)
        for items in by_device.values():
            dtype = (torch.float64
                     if any(t.is_floating_point() for _, t in items)
                     else torch.int64)
            flat = torch.cat([t.detach().reshape(-1).to(dtype)
                              for _, t in items])
            host = flat.to("cpu", copy=True).numpy()   # the one copy
            at = 0
            for k, t in items:
                out[k] = host[at:at + t.numel()].reshape(tuple(t.shape))
                at += t.numel()
        return out

    def snapshot(self) -> dict[str, Any]:
        """Drain every counter to host values — ONE device->host copy of
        the device counters; ints for scalars, numpy arrays for vector
        counters, host and device counts of one name summed."""
        out: dict[str, Any] = {
            k: (int(v) if np.ndim(v) == 0 else np.asarray(v))
            for k, v in self._host.items()}
        for k, v in self._device_values().items():
            got = int(v) if np.ndim(v) == 0 else np.asarray(v)
            out[k] = out[k] + got if k in out else got
        return out

    def attribution(self, snap: dict[str, Any] | None = None
                    ) -> dict[str, dict[str, Any]]:
        """Group a snapshot's dimension-tagged counters by dimension:
        ``{"lane": {"queries_per_lane": [S] array, ...}}``.  Pass the
        snapshot already taken for this readout to avoid a second read;
        with ``snap=None`` one is taken here."""
        if not self._dims:
            return {}
        if snap is None:
            snap = self.snapshot()
        out: dict[str, dict[str, Any]] = {}
        for name, dim in self._dims.items():
            if name in snap:
                out.setdefault(dim, {})[name] = snap[name]
        return out
