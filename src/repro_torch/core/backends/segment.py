"""Segment backend — the portable COO scatter-min relaxation (torch
rendering of ``repro.core.backends.segment``).

The layout IS the edge pool: no derived device state, no planner, no patch
ops — ``apply_adds`` / ``apply_dels`` are no-ops and the epochs run straight
over ``core/relax.py`` / ``core/delete.py`` / ``core/buckets.py`` (lane
stacks included).  It runs no kernel; in the port it is the other
backends' cross-check.
"""
from __future__ import annotations

from repro_torch.core import buckets
from repro_torch.core import delete as del_mod
from repro_torch.core import relax
from repro_torch.core.backends.base import RelaxBackend, register


@register
class SegmentBackend(RelaxBackend):
    """No derived layout: epochs scatter-min over the flat COO pool."""

    name = "segment"

    def relax(self, sssp, edges, frontier):
        return relax.relax_until_converged(
            sssp, edges, frontier, num_vertices=self.n)

    def delete(self, sssp, edges, seed):
        return del_mod.invalidate_and_recompute(
            sssp, edges, seed, num_vertices=self.n,
            use_doubling=self.cfg.use_doubling)

    def drain(self, sssp, edges, pend, *, bucket_width):
        return buckets.segment_drain(sssp, edges, pend, num_vertices=self.n,
                                     bucket_width=bucket_width)
