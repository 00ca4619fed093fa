"""Segment backend — the portable COO scatter-min relaxation (torch
rendering of ``repro.core.backends.segment``).

The layout IS the edge pool: no derived device state, no planner, no patch
ops — ``apply_adds`` / ``apply_dels`` are no-ops and the epochs run straight
over ``core/relax.py`` / ``core/delete.py`` / ``core/buckets.py`` (lane
stacks included).  It runs no kernel; in the port it is the other
backends' cross-check.

The sharded wave (``shard_segment_wave``) is the partition-local rendering
of ``relax.relax_round``'s candidate evaluation: a segment-min over the
partition's in-edge pool slice with the smallest-src-id tie-break — the
one segment-min of ``DistributedSSSP``'s static epochs and of the sharded
engine's segment backend.
"""
from __future__ import annotations

import torch

from repro_torch.core import buckets
from repro_torch.core import delete as del_mod
from repro_torch.core import relax
from repro_torch.core.backends.base import (RelaxBackend, ShardedBackend,
                                            register, register_sharded)
from repro_torch.core.relax import BIG, segment_min
from repro_torch.core.state import INF

# the reference's vmapped lane-stack epochs: relax.py's and delete.py's take
# [S, N] lanes themselves
segment_relax_batched = relax.relax_until_converged
segment_delete_batched = del_mod.invalidate_and_recompute


def shard_segment_wave(esrc: torch.Tensor, edst: torch.Tensor,
                       ew: torch.Tensor, eact: torch.Tensor, row0: int,
                       npp: int):
    """Local segment-min wave over one partition's in-edge pool slice.

    ``wave(offers) -> (best, arg)``: per owned row, the min of
    ``offers[src] + w`` over live in-edges and the smallest minimizing
    global src id (``2**31-1`` when no live candidate); ``[S, N]`` offers
    (a lane stack) give ``[S, npp]``.  Frontier masking is
    carried by ``offers`` (+inf for non-offering sources), which makes the
    same wave serve relaxation rounds, delta rounds and the deletion pull.
    Inactive slots keep ``dst`` inside the window (the padding-row
    invariant, ``distributed.inactive_dst_layout``)."""
    dl = (edst - row0).long()

    def wave(offers):
        cand = torch.where(eact, offers[..., esrc] + ew, INF)
        best = segment_min(cand, dl, npp, INF)
        hit = (cand == best[..., dl]) & (cand < INF)
        arg = segment_min(torch.where(hit, esrc, BIG), dl, npp, BIG)
        return best, arg

    return wave


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


@register_sharded
class ShardedSegment(ShardedBackend):
    """Sharded coordinator with nothing to coordinate: the pool patched by
    the epochs is the layout, so every hook is a no-op."""

    name = "segment"

    def shard_wave(self, p, pool):
        return shard_segment_wave(pool.src, pool.dst, pool.w, pool.active,
                                  p * self.npp, self.npp)
