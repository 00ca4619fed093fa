"""Stall / divergence watchdog (DESIGN.md §10.8), copied from
``repro.obs.watchdog`` (numpy and a thread; nothing here touches a tensor).

A dynamic-SSSP engine has two silent failure modes the flat counters
cannot surface while they are happening: an epoch that *hangs* (a
collective deadlock, a runaway fixpoint loop — the host is
blocked inside the dispatch and nothing prints), and an epoch that
*diverges* (wave counts or frontier occupancy climbing past anything the
workload should produce — the run finishes, eventually, but the operator
learns nothing until the final report).

The watchdog covers both with host-side sampling only — it never touches
device values, so the §2.4 discipline is untouched:

  * **stall**: ``EngineObs.epoch`` arms the watchdog on entry and disarms
    on exit.  A lazy daemon thread samples the armed region's wall clock;
    past ``stall_timeout_s`` it emits a structured ``watchdog`` record
    through the FlightRecorder, bumps ``watchdog_stalls``, and triggers
    the recorder's existing one-shot stderr dump (§10.3) so the operator
    gets the last-N-epochs postmortem *while the process is still hung*.
    One firing per armed region — a slow-but-progressing run produces one
    warning per offending epoch, not a warning storm.
  * **slow epoch / frontier blowup**: synchronous post-epoch checks of
    the measured wall time against ``max_epoch_wall_s`` and the epoch's
    frontier attribute against ``max_frontier``.
  * **divergence review**: ``review(counters)`` — called from
    ``metrics_snapshot()`` with the snapshot already in hand — checks the
    waves-per-epoch histogram's top occupied bucket against
    ``max_drain_waves``.  Review findings therefore land in the *next*
    snapshot's counters; the FlightRecorder record is immediate.

All thresholds are opt-out by default-off (0 / inf): a default-config
watchdog only watches for multi-second stalls, which is why the gated
benches can run with it armed and assert silence.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time
from typing import Any, TYPE_CHECKING

import numpy as np

from repro_torch.obs import hist as hist_mod

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.obs import EngineObs

__all__ = ["Watchdog", "WatchdogConfig"]


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Thresholds; 0 / inf disables the corresponding check."""
    stall_timeout_s: float = 30.0    # armed epoch older than this -> stall
    max_epoch_wall_s: float = math.inf  # finished epoch slower than this
    max_frontier: int = 0            # ADD-epoch frontier larger than this
    max_drain_waves: int = 0         # waves-hist top bucket lo >= this
    poll_interval_s: float = 0.0     # 0 -> derived from stall_timeout_s


class Watchdog:
    """One instance per :class:`EngineObs`; all state is host-side."""

    def __init__(self, cfg: WatchdogConfig, obs: "EngineObs"):
        self.cfg = cfg
        self.obs = obs
        self.warnings = 0
        # armed region: (token, kind, t0) — written by the engine thread,
        # read by the sampler; tuple swap is atomic under the GIL
        self._armed: tuple[int, str, float] | None = None
        self._token = 0
        self._fired_token = -1
        self._reviewed_waves = False
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ arm/disarm
    def arm(self, kind: str) -> None:
        self._token += 1
        self._armed = (self._token, kind, time.perf_counter())
        if (self._thread is None
                and math.isfinite(self.cfg.stall_timeout_s)
                and self.cfg.stall_timeout_s > 0):
            self._thread = threading.Thread(
                target=self._sample_loop, name="repro_torch-obs-watchdog",
                daemon=True)
            self._thread.start()

    def disarm(self) -> None:
        self._armed = None

    # ------------------------------------------------------ synchronous checks
    def observe(self, kind: str, wall_s: float, attrs: dict) -> None:
        """Post-epoch threshold checks (engine thread, after a successful
        epoch)."""
        if 0 < self.cfg.max_epoch_wall_s < wall_s:
            self._warn("slow_epoch", epoch=kind, wall_s=round(wall_s, 6),
                       limit_s=self.cfg.max_epoch_wall_s)
        frontier = attrs.get("frontier")
        if (frontier is not None and self.cfg.max_frontier > 0
                and frontier > self.cfg.max_frontier):
            self._warn("frontier_blowup", epoch=kind, frontier=int(frontier),
                       limit=self.cfg.max_frontier)

    def review(self, counters: dict[str, Any]) -> None:
        """Divergence review over a counter snapshot (§10.8): flags a
        waves-per-epoch histogram whose top occupied bucket starts at or
        above ``max_drain_waves``.  Fires at most once per watchdog — the
        histogram is cumulative, so the finding would otherwise repeat on
        every later snapshot."""
        if self.cfg.max_drain_waves <= 0 or self._reviewed_waves:
            return
        counts = counters.get(hist_mod.HIST_PREFIX + "waves_per_epoch")
        if counts is None:
            return
        c = np.asarray(counts).reshape(-1)
        nz = np.nonzero(c)[0]
        if nz.size == 0:
            return
        top_lo = hist_mod.bucket_lo(int(nz[-1]))
        if top_lo >= self.cfg.max_drain_waves:
            self._reviewed_waves = True
            self._warn("wave_divergence", top_bucket_lo=top_lo,
                       limit=self.cfg.max_drain_waves)

    # ---------------------------------------------------------------- sampler
    def _sample_loop(self) -> None:
        poll = self.cfg.poll_interval_s
        if poll <= 0:
            poll = min(1.0, self.cfg.stall_timeout_s / 4.0)
        while not self._stop.wait(poll):
            armed = self._armed
            if armed is None:
                continue
            token, kind, t0 = armed
            elapsed = time.perf_counter() - t0
            if elapsed > self.cfg.stall_timeout_s and token != self._fired_token:
                self._fired_token = token
                self._warn("stall", epoch=kind, elapsed_s=round(elapsed, 3),
                           limit_s=self.cfg.stall_timeout_s)
                # the one-shot postmortem (§10.3) — the engine thread is
                # blocked inside the dispatch, so this is the only chance
                # the operator gets to see the last recorded epochs
                self.obs.dump_on_error(
                    TimeoutError(f"watchdog: {kind} armed for "
                                 f"{elapsed:.1f}s"))

    def stop(self) -> None:
        """Tear down the sampler thread (tests / engine close)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # ----------------------------------------------------------------- output
    def _warn(self, reason: str, **fields) -> None:
        self.warnings += 1
        self.obs.recorder.record("watchdog", reason=reason, **fields)
        self.obs.counters.inc("watchdog_warnings")
        if reason == "stall":
            self.obs.counters.inc("watchdog_stalls")
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[repro_torch.obs.watchdog] {reason}: {detail}",
              file=sys.stderr, flush=True)
