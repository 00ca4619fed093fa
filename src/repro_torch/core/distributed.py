"""Distributed SSSP-Del over a vertex-partitioned mesh, driven by one
controller (torch rendering of ``repro.core.distributed``).

Shared-nothing mapping (paper §3):

  * vertices are range-partitioned over the mesh's flattened axes: every
    partition owns ``npp = N/P`` contiguous vertices and their SSSP state,
    its own ``dist`` / ``parent`` tensors on its device;
  * edges live with the partition of their **dst** (each partition owns up
    to ``Epp`` in-edge slots, its own COO pool tensors), so the per-round
    scatter-min is local;
  * the partition-local candidate evaluation is a pluggable *wave*: a
    ``MeshWave`` takes the P gathered offers vectors (dist masked to the
    offering set) and returns each partition's ``(best, arg)`` for its
    owned rows, with the shared smallest-src-id tie-break;
  * the only cross-partition traffic is the paper's "messages": ``dist[src]``
    offers, through two explicit collectives, ``all_gather`` and ``psum``.
    ``"allgather"`` gathers the masked dist vector every round;
    ``"delta"`` gathers only a fixed-size (index, value) buffer per
    partition for the vertices that improved last round, and falls back to
    a dense gather on a round where any partition overflows its buffer.

The reference is single-controller SPMD: ``shard_map`` over P devices,
every loop a ``lax.while_loop`` whose condition is a ``psum``.  Here one
Python process drives the P partitions in turn, and each loop reads its
condition back to the host once per round — ONE small tensor for all P
partitions: the psum'd improvement count, and under ``"delta"`` also
whether any partition overflows its buffer next round (both known at the
end of the round), so the port's rounds, and the dense-or-sparse choice of
each delta round, are the reference's.  Collectives are copies and sums:
``all_gather`` builds one gathered tensor per distinct device and shares it
between the partitions on that device; ``psum`` stacks the partitions'
values on the controller's device (``devices[0]``) and sums them.

Counters follow the port's single-device engine: rounds are host integers,
messages (improvements summed over partitions) a device scalar.

Lanes: every round, marking and drain body also takes a stack of S trees
— each partition holds ``[S, npp]`` dist, parent and masks over its one
pool slice (the reference's ``*_ms`` bodies, written with a leading source
axis).  The collectives gather and sum along the vertex axis, the read of
each round is then one ``[S]`` flag vector (``[2, S]`` with the delta
overflow flags), and a lane counts a round only while its own condition
held, as the reference's per-lane ``go`` gates freeze a finished lane.
Under ``"delta"`` each lane packs its own buffer; a round where some lanes
overflow computes both offers and picks per lane with a device select,
as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import relax
from repro_torch.core.backends.segment import shard_segment_wave
from repro_torch.core.buckets import bucket_limit
from repro_torch.core.state import INF, NO_PARENT, EdgePool
from repro_torch.launch.mesh import Mesh

__all__ = ["DistConfig", "DistributedSSSP", "MeshWave", "ShardWave",
           "inactive_dst_layout", "mesh_wave", "per_partition_occupancy"]

BIG = relax.BIG   # "no candidate" key of the smallest-src-id pass
Parts = list[torch.Tensor]   # one tensor per partition, on its device
ShardWave = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
MeshWave = Callable[[Parts], list[tuple[torch.Tensor, torch.Tensor]]]


def inactive_dst_layout(P: int, npp: int, epp: int) -> np.ndarray:
    """dst ids for an all-inactive (or padding) pool slot range: every slot
    points at its owner partition's first row, keeping the local segment
    ids ``dst - row0`` inside [0, npp).  The one source of the padding-row
    invariant (``place_edges``, the sharded engine's empty pools)."""
    return np.repeat(np.arange(P, dtype=np.int64) * npp, epp).astype(np.int32)


def per_partition_occupancy(mask: Parts, device: torch.device
                            ) -> torch.Tensor:
    """Live counts of a partitioned bool vertex mask for the obs counter
    registry: each partition sums the window it owns, no collective and no
    host read, giving an i32[P] vector on ``device``; a lane stack
    (``[S, npp]`` parts) gives the per-lane totals, i32[S]."""
    sums = torch.stack([m.sum(-1, dtype=torch.int32).to(device)
                        for m in mask])
    return sums.sum(0, dtype=torch.int32) if mask[0].dim() == 2 else sums


def mesh_wave(waves: Sequence[ShardWave]) -> MeshWave:
    """The mesh wave of per-partition waves: partition p's wave on its own
    gathered offers."""
    return lambda offers: [w(o) for w, o in zip(waves, offers)]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    num_vertices: int        # padded: divisible by P
    edges_per_part: int      # static per-partition edge capacity
    mesh_axes: tuple[str, ...]  # axes to flatten into the vertex partition
    exchange: str = "allgather"  # or "delta"
    delta_cap: int = 4096    # per-part (idx,val) slots for "delta" exchange
    max_rounds: int = 0      # 0 = run to fixpoint; >0 = straggler bound


class DistributedSSSP:
    """The partitioned state's collectives, rounds and epochs for one mesh."""

    def __init__(self, mesh: Mesh, cfg: DistConfig):
        self.mesh = mesh
        self.cfg = cfg
        self.P = math.prod(mesh.shape[a] for a in cfg.mesh_axes)
        if self.P != mesh.size:
            raise ValueError(f"mesh_axes {cfg.mesh_axes} flatten to "
                             f"{self.P} partitions of a {mesh.size}-device "
                             f"mesh; the port flattens every axis")
        if cfg.num_vertices % self.P:
            raise ValueError(f"num_vertices {cfg.num_vertices} must divide "
                             f"P={self.P}")
        self.npp = cfg.num_vertices // self.P
        self.devices = list(mesh.devices)
        self.dev0 = self.devices[0]
        self.local_ids = [
            torch.arange(p * self.npp, (p + 1) * self.npp,
                         dtype=torch.int32, device=d)
            for p, d in enumerate(self.devices)]

    # ------------------------------------------------------------ collectives
    def on_each_device(self, fn: Callable, *gathered: Parts) -> list:
        """``fn`` of the gathered tensors, computed once per distinct device
        and shared by the partitions on it."""
        cache: dict[torch.device, object] = {}
        out = []
        for p, dev in enumerate(self.devices):
            if dev not in cache:
                cache[dev] = fn(*(g[p] for g in gathered))
            out.append(cache[dev])
        return out

    def all_gather(self, parts: Parts) -> Parts:
        """The partitions' tensors concatenated in partition order along
        their last axis (the reference's tiled ``all_gather``; a lane stack
        gathers each lane), one copy per distinct device."""
        cache: dict[torch.device, torch.Tensor] = {}
        out = []
        for dev in self.devices:
            if dev not in cache:
                cache[dev] = torch.cat([t.to(dev) for t in parts], dim=-1)
            out.append(cache[dev])
        return out

    def psum(self, parts: Parts) -> torch.Tensor:
        """The sum over partitions (per lane for ``[S]`` parts), on the
        controller's device."""
        return torch.stack([t.to(self.dev0) for t in parts]).sum(0)

    def _counts(self, mask: Parts) -> Parts:
        return [m.sum(-1) for m in mask]

    def _read(self, *flags: torch.Tensor) -> tuple:
        """Replicated flags (0-d, or ``[S]`` for lanes) read back in ONE
        host sync: a bool each, or a bool[S] array each."""
        got = relax.host(torch.stack(flags) if len(flags) > 1 else flags[0])
        if len(flags) == 1:
            got = [got]
        return tuple(g if np.ndim(g) else bool(g) for g in got)

    def _go(self, mask: Parts, check_overflow: bool) -> tuple:
        """(any partition's mask set, any partition's mask over the delta
        buffer), per lane for a lane stack — one read; the second is False
        unless asked for."""
        counts = self._counts(mask)
        total = self.psum(counts) > 0
        if not check_overflow:
            return self._read(total)[0], False
        cap = self.cfg.delta_cap
        over = self.psum([c > cap for c in counts]) > 0
        return self._read(total, over)

    # ---------------------------------------------------------- host helpers
    def shard(self, a: np.ndarray) -> Parts:
        """A global partition-major host array (``[..., N]``: a lane stack
        splits its last axis) as P per-partition tensors (copies: the
        partitions never alias the caller's array)."""
        a = np.asarray(a)
        k = a.shape[-1] // self.P
        return [torch.tensor(a[..., p * k:(p + 1) * k], device=dev)
                for p, dev in enumerate(self.devices)]

    def to_host(self, parts: Parts) -> np.ndarray:
        """The partitions' tensors concatenated on the host along their
        last axis, each copied straight into its slice, with no gathered
        copy on the device (on the card, right after an epoch, gathering
        first made the query's readback several times slower)."""
        lead = parts[0].shape[:-1]
        out = torch.empty((*lead, sum(t.shape[-1] for t in parts)),
                          dtype=parts[0].dtype)
        at = 0
        for t in parts:
            out[..., at:at + t.shape[-1]].copy_(t)
            at += t.shape[-1]
        return out.numpy()

    def place_edges(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
        """Host-side: bucket edges by dst partition, pad each bucket to Epp.

        Returns (src, dst, w, active) of shape (P*Epp,) in partition-major
        order: a stable owner sort plus a per-owner rank gives each edge its
        flat position (the reference's vectorized placement)."""
        P_, npp, epp = self.P, self.npp, self.cfg.edges_per_part
        owner = np.minimum(np.asarray(dst, np.int64) // npp, P_ - 1)
        counts = np.bincount(owner, minlength=P_)
        if len(owner) and counts.max() > epp:
            raise ValueError(f"partition overflow: max {counts.max()} > Epp "
                             f"{epp} — raise edges_per_part or rebalance")
        order = np.argsort(owner, kind="stable")
        owner_s = owner[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(order)) - starts[owner_s]
        pos = owner_s * epp + rank
        out_src = np.zeros(P_ * epp, np.int32)
        out_dst = inactive_dst_layout(P_, npp, epp)
        out_w = np.zeros(P_ * epp, np.float32)
        out_act = np.zeros(P_ * epp, np.bool_)
        out_src[pos] = src[order]
        out_dst[pos] = dst[order]
        out_w[pos] = w[order]
        out_act[pos] = True
        return out_src, out_dst, out_w, out_act

    def init_vertex_arrays(self, source: int) -> tuple[Parts, Parts]:
        n = self.cfg.num_vertices
        dist = np.full(n, np.inf, np.float32)
        dist[source] = 0.0
        return self.shard(dist), self.shard(np.full(n, -1, np.int32))

    def init_vertex_arrays_ms(self, sources: Sequence[int]
                              ) -> tuple[Parts, Parts]:
        """Stacked ``[S, N]`` state, partitioned along the vertex axis (lane
        ``i`` is ``init_vertex_arrays(sources[i])``)."""
        n, s = self.cfg.num_vertices, len(sources)
        dist = np.full((s, n), np.inf, np.float32)
        dist[np.arange(s), np.asarray(sources)] = 0.0
        return self.shard(dist), self.shard(np.full((s, n), -1, np.int32))

    def put_edges(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                  active: np.ndarray) -> list[EdgePool]:
        """Partition-major pool arrays as one ``EdgePool`` per partition."""
        return [EdgePool(*parts) for parts in zip(
            self.shard(np.asarray(src, np.int32)),
            self.shard(np.asarray(dst, np.int32)),
            self.shard(np.asarray(w, np.float32)),
            self.shard(np.asarray(active, np.bool_)))]

    def frontier_of(self, vertices: np.ndarray) -> Parts:
        f = np.zeros(self.cfg.num_vertices, np.bool_)
        f[vertices[vertices >= 0]] = True
        return self.shard(f)

    def segment_waves(self, pools: Sequence[EdgePool]) -> MeshWave:
        """The segment-min mesh wave over the pool slices."""
        return mesh_wave([
            shard_segment_wave(e.src, e.dst, e.w, e.active, p * self.npp,
                               self.npp) for p, e in enumerate(pools)])

    # ---------------------------------------------------------------- rounds
    def _apply_wave(self, dist: Parts, parent: Parts, wave: MeshWave,
                    offers: Parts, only: Parts | None = None
                    ) -> tuple[Parts, Parts, Parts]:
        """Every round's tail: the mesh wave on the assembled offers, its
        improvements (restricted to ``only`` where given) folded into
        (dist, parent)."""
        nd, npa, imp = [], [], []
        for p, (best, arg) in enumerate(wave(offers)):
            improved = best < dist[p]
            if only is not None:
                improved = improved & only[p]
            nd.append(torch.where(improved, best, dist[p]))
            npa.append(torch.where(improved, arg, parent[p]))
            imp.append(improved)
        return nd, npa, imp

    def _offers_allgather(self, dist: Parts, frontier: Parts) -> Parts:
        """Dense exchange: sources outside the frontier offer +inf."""
        return self.all_gather([torch.where(f, d, INF)
                                for d, f in zip(dist, frontier)])

    def _pack(self, p: int, mask: torch.Tensor, vals: torch.Tensor | None
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Partition p's delta buffer (one per lane): the (global id, value)
        of its set vertices, set ones first (a stable sort), ``delta_cap``
        slots, empty slots -1 / +inf."""
        order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
        take = order[..., :self.cfg.delta_cap]
        sel = mask.gather(-1, take)
        idx = torch.where(sel, self.local_ids[p][take], -1)
        if vals is None:
            return idx, None
        return idx, torch.where(sel, vals.gather(-1, take), INF)

    def _scatter_offers(self, idx: torch.Tensor, val: torch.Tensor
                        ) -> torch.Tensor:
        """The global offers vector a gathered delta buffer spells (per
        lane): +inf but at its ids."""
        n = self.cfg.num_vertices
        base = torch.full((*idx.shape[:-1], n), INF, dtype=torch.float32,
                          device=idx.device)
        return base.scatter_reduce_(-1, idx.clamp(0, n - 1).long(),
                                    torch.where(idx >= 0, val, INF), "amin")

    def _mark_ids(self, idx: torch.Tensor) -> torch.Tensor:
        """bool[N] (per lane) set at a gathered id buffer's ids (-1 =
        empty)."""
        n = self.cfg.num_vertices
        base = torch.zeros((*idx.shape[:-1], n), dtype=torch.uint8,
                           device=idx.device)
        return base.scatter_reduce_(-1, idx.clamp(0, n - 1).long(),
                                    (idx >= 0).to(torch.uint8), "amax"
                                    ).bool()

    @staticmethod
    def _per_lane(overflow, dense: Callable[[], list],
                  sparse: Callable[[], list]) -> list:
        """``dense()`` where ``overflow`` (a bool, or bool[S] per lane),
        ``sparse()`` elsewhere — one per partition of a tensor or a tuple
        of them, each ``[S, ...]``: one of the two when every lane agrees,
        else both and a per-lane device select (the reference's
        ``where(overflow[:, None], dense, sparse)``; the host flags are
        copied to the device, not read)."""
        if np.all(overflow):
            return dense()
        if not np.any(overflow):
            return sparse()
        flags = torch.as_tensor(np.asarray(overflow)[:, None])

        def pick(a, b):
            if isinstance(a, tuple):
                return tuple(map(pick, a, b))
            return torch.where(flags.to(a.device), a, b)

        return list(map(pick, dense(), sparse()))

    def _offers_delta(self, dist: Parts, frontier: Parts, overflow) -> Parts:
        """Delta exchange: each partition packs its frontier's (id, dist)
        into its buffer and the small buffers are gathered; a round (a lane)
        where any partition overflows gathers the dense dist instead —
        every source offers then, a superset of the frontier (exact; it
        costs one wave's extra work, and moves the reference's round counts
        the same way)."""
        def sparse():
            packs = [self._pack(p, f, d)
                     for p, (f, d) in enumerate(zip(frontier, dist))]
            return self.on_each_device(
                self._scatter_offers, self.all_gather([i for i, _ in packs]),
                self.all_gather([v for _, v in packs]))

        return self._per_lane(overflow, lambda: self.all_gather(dist), sparse)

    def _relax_body(self, dist: Parts, parent: Parts, frontier: Parts,
                    wave: MeshWave):
        """Relaxation rounds to fixpoint (or ``max_rounds``) with the given
        mesh wave.  Returns (dist, parent, rounds, messages); messages count
        DistanceUpdate deliveries — improvements summed over partitions —
        and a lane stack counts both per lane.  The reference bounds each
        lane by its own ``rounds < max_rounds``; the lanes still going
        share the wave count (a lane whose frontier empties stays empty),
        so ``max(rounds) >= max_rounds`` stops every lane where its own
        bound would."""
        delta = self.cfg.exchange == "delta"
        rounds = relax.no_rounds(dist[0])
        msgs = torch.zeros(dist[0].shape[:-1], dtype=torch.int64,
                           device=self.dev0)
        go, overflow = self._go(frontier, delta)
        while np.any(go) and not (self.cfg.max_rounds
                                  and np.max(rounds) >= self.cfg.max_rounds):
            offers = (self._offers_delta(dist, frontier, overflow) if delta
                      else self._offers_allgather(dist, frontier))
            dist, parent, frontier = self._apply_wave(dist, parent, wave,
                                                      offers)
            msgs = msgs + self.psum(self._counts(frontier))
            rounds = rounds + go
            go, overflow = self._go(frontier, delta)
        return dist, parent, rounds, msgs

    # ---------------------------------------------------------- invalidation
    # ``gate`` (True, or bool[S] per lane) lets through the lanes that
    # seeded: a gated-out lane has an empty seed, whose marking stays empty,
    # so the whole stack steps together and only the counts are per lane.
    def _mark_loop(self, step, gate=True):
        """Run ``step() -> grew`` (a device flag, per lane) while a lane
        grows, counting each lane's rounds while its own ``grew & gate``
        held; one read a round."""
        live = gate
        rounds = 0 if np.ndim(gate) == 0 else np.zeros(len(gate), np.int64)
        while np.any(live):
            grew = step()
            rounds = rounds + live
            live = live & self._read(grew)[0]
        return rounds

    def _invalidate_doubling(self, parent: Parts, seed: Parts, gate=True
                             ) -> tuple[Parts, int]:
        """Pointer-doubling subtree marking with dense all_gathers of the
        (aff, ptr) vectors on every step — O(log depth) rounds."""
        aff, ptr = list(seed), list(parent)

        def step():
            aff_full, par_full = self.all_gather(aff), self.all_gather(ptr)
            grew = []
            for p in range(self.P):
                valid = ptr[p] >= 0
                safe = ptr[p].clamp(min=0).long()
                a = aff[p] | (valid & aff_full[p].gather(-1, safe))
                n = torch.where(valid, par_full[p].gather(-1, safe),
                                NO_PARENT)
                grew.append(((a != aff[p]).any(-1) | (n != ptr[p]).any(-1)
                             ).to(torch.int32))
                aff[p], ptr[p] = a, n
            return self.psum(grew) > 0

        return aff, self._mark_loop(step, gate)

    def _invalidate_flood_dense(self, parent: Parts, seed: Parts, gate=True
                                ) -> tuple[Parts, int]:
        """The paper's level-by-level SetToInfinity flood with dense aff
        gathers — one round per tree level, the rounds of
        ``delete.mark_subtree_flood``."""
        has = [q >= 0 for q in parent]
        safe = [q.clamp(min=0).long() for q in parent]
        aff = list(seed)

        def step():
            aff_full = self.all_gather(aff)
            new = [aff[p] | (has[p] & aff_full[p].gather(-1, safe[p]))
                   for p in range(self.P)]
            grew = self.psum([(a != b).sum(-1) for a, b in zip(new, aff)])
            aff[:] = new
            return grew > 0

        return aff, self._mark_loop(step, gate)

    def _invalidate_delta(self, parent: Parts, seed: Parts, overflow,
                          gate=True) -> tuple[Parts, int]:
        """The SetToInfinity flood with delta-compressed exchange: each
        round gathers only the NEWLY affected ids (a ``delta_cap`` buffer
        per partition and lane); a round (a lane) where any partition
        overflows gathers the dense aff.  ``overflow`` is the seed's (read
        with the epoch's seed flag); each round reads the next one with its
        own go flag."""
        has = [q >= 0 for q in parent]
        safe = [q.clamp(min=0).long() for q in parent]
        aff, frontier = list(seed), list(seed)
        live = gate
        rounds = 0 if np.ndim(gate) == 0 else np.zeros(len(gate), np.int64)
        while np.any(live):
            base = self._per_lane(
                overflow, lambda: self.all_gather(aff),
                lambda: self.on_each_device(self._mark_ids, self.all_gather(
                    [self._pack(p, f, None)[0]
                     for p, f in enumerate(frontier)])))
            frontier = [has[p] & base[p].gather(-1, safe[p]) & ~aff[p]
                        for p in range(self.P)]
            aff = [a | n for a, n in zip(aff, frontier)]
            rounds = rounds + live
            go, overflow = self._go(frontier, True)
            live = live & go
        return aff, rounds

    # ----------------------------------------------------------- recompute
    def _recompute_pull_push(self, dist: Parts, parent: Parts, aff: Parts,
                             wave: MeshWave):
        """The bulk DistanceQuery as one unmasked pull wave (counted as one
        round, improvements folded into affected rows only — unaffected
        rows cannot improve on a converged tree), then push to fixpoint."""
        dist, parent, improved = self._apply_wave(
            dist, parent, wave, self.all_gather(dist), only=aff)
        n_pull = self.psum(self._counts(improved))
        dist, parent, rounds, msgs = self._relax_body(dist, parent, improved,
                                                      wave)
        return dist, parent, rounds + 1, msgs + n_pull

    def _recompute_delta(self, dist: Parts, parent: Parts, aff: Parts,
                         pools: Sequence[EdgePool], wave: MeshWave):
        """The bulk DistanceQuery in message form (paper Listing 9): each
        partition broadcasts the ids of the sources its affected vertices
        need offers from (a ``delta_cap`` buffer per lane, packed from its
        COO pool slice); the owners of queried reachable vertices become
        the push frontier, and delta rounds deliver the offers.  Overflow:
        every reachable vertex pushes once.  The overflow choice is a device
        select here (both operands are cheap), so it costs no read."""
        cap = self.cfg.delta_cap
        packs, over = [], []
        for p, e in enumerate(pools):
            req = e.active & aff[p][..., (e.dst - p * self.npp).long()]
            order = torch.argsort((~req).to(torch.uint8), dim=-1,
                                  stable=True)
            take = order[..., :cap]
            packs.append(torch.where(req.gather(-1, take), e.src[take], -1))
            over.append(req.sum(-1) > cap)
        overflow = self.psum(over) > 0
        queried = self.on_each_device(self._mark_ids,
                                      self.all_gather(packs))
        frontier0 = [
            (overflow.to(d.device)[..., None]
             | queried[p][..., p * self.npp:(p + 1) * self.npp])
            & torch.isfinite(d) for p, d in enumerate(dist)]
        return self._relax_body(dist, parent, frontier0, wave)

    # ---------------------------------------------------------- bucketed drain
    # The sharded rendering of core/buckets.run_drain: one pull wave into
    # the accumulated invalidated set, then bucket-paced push waves.  The
    # bucket limit comes from the same gathered data a round exchanges, so
    # every partition derives the same (cur, limit) — per lane, ``[S, 1]``
    # for a lane stack — and the wave sequence, hence (dist, parent) and
    # the counters, is the single-device drain's.
    @staticmethod
    def _dense_bucket(bucket_width: float):
        def offers_of(dist_full, push_full):
            cur = torch.where(push_full, dist_full, INF).amin(-1,
                                                              keepdim=True)
            limit = bucket_limit(cur, bucket_width)
            act = push_full & ((dist_full < limit) | (dist_full == cur))
            return cur, limit, torch.where(act, dist_full, INF)

        return offers_of

    def _bucket_offers_allgather(self, dist: Parts, push: Parts,
                                 bucket_width: float
                                 ) -> tuple[Parts, Parts]:
        return self._bucket_split(dist, push, self.on_each_device(
            self._dense_bucket(bucket_width), self.all_gather(dist),
            self.all_gather(push)))

    def _bucket_offers_delta(self, dist: Parts, push: Parts, overflow,
                             bucket_width: float) -> tuple[Parts, Parts]:
        """Delta drain wave: pack the WHOLE pending set (ids + dists); with
        no partition over its buffer every pending vertex is packed, so
        ``cur`` from the packed values is exact.  Overflow (per lane) falls
        back to the dense gathers, still bucket-gated (a superset here
        would change the wave sequence)."""
        def offers_of(idx, val):
            cur = val.amin(-1, keepdim=True)
            limit = bucket_limit(cur, bucket_width)
            act = (val < limit) | (val == cur)
            return cur, limit, self._scatter_offers(
                idx, torch.where(act, val, INF))

        def sparse():
            packs = [self._pack(p, q, d)
                     for p, (q, d) in enumerate(zip(push, dist))]
            return self.on_each_device(
                offers_of, self.all_gather([i for i, _ in packs]),
                self.all_gather([v for _, v in packs]))

        def dense():
            return self.on_each_device(
                self._dense_bucket(bucket_width), self.all_gather(dist),
                self.all_gather(push))

        return self._bucket_split(dist, push,
                                  self._per_lane(overflow, dense, sparse))

    @staticmethod
    def _bucket_split(dist: Parts, push: Parts, got: list
                      ) -> tuple[Parts, Parts]:
        """(offers, active) per partition from each device's (cur, limit,
        offers): the partition's pending vertices inside the lowest
        nonempty bucket are active."""
        offers, active = [], []
        for q, d, (cur, limit, off) in zip(push, dist, got):
            offers.append(off)
            active.append(q & ((d < limit) | (d == cur)))
        return offers, active

    def _drain_body(self, dist: Parts, parent: Parts, push: Parts,
                    pull: Parts, wave: MeshWave, bucket_width: float):
        """Sharded drain: (dist, parent, rounds, messages), the counters of
        ``buckets.run_drain`` (per lane for a lane stack).  The pull is one
        unmasked wave folded into the ``pull`` rows, counted as a round in
        each lane that pulled (skipped, after one read, when none did)."""
        delta = self.cfg.exchange == "delta"
        msgs = torch.zeros(dist[0].shape[:-1], dtype=torch.int64,
                           device=self.dev0)
        (any_pull,) = self._read(self.psum(self._counts(pull)) > 0)
        rounds = relax.no_rounds(dist[0]) + any_pull
        if np.any(any_pull):
            dist, parent, improved = self._apply_wave(
                dist, parent, wave, self.all_gather(dist), only=pull)
            push = [q | i for q, i in zip(push, improved)]
            msgs = msgs + self.psum(self._counts(improved))
        go, overflow = self._go(push, delta)
        while np.any(go):
            if delta:
                offers, active = self._bucket_offers_delta(
                    dist, push, overflow, bucket_width)
            else:
                offers, active = self._bucket_offers_allgather(
                    dist, push, bucket_width)
            dist, parent, improved = self._apply_wave(dist, parent, wave,
                                                      offers)
            push = [(q & ~a) | i for q, a, i in zip(push, active, improved)]
            msgs = msgs + self.psum(self._counts(improved))
            rounds = rounds + go
            go, overflow = self._go(push, delta)
        return dist, parent, rounds, msgs

    # --------------------------------------------------- static entry points
    def make_relax_epoch(self):
        """``epoch(dist, parent, frontier, pools) -> (dist, parent,
        rounds)``: the static relaxation epoch, segment-min waves over the
        pools from ``put_edges``."""
        def epoch(dist, parent, frontier, pools):
            d, p, r, _ = self._relax_body(dist, parent, frontier,
                                          self.segment_waves(pools))
            return d, p, r

        return epoch

    def make_delete_epoch(self):
        """``delete(dist, parent, seed, pools) -> (dist, parent, rounds)``:
        pointer-doubling marking (the delta flood under ``"delta"``) from
        the invalidation roots ``seed`` -> invalidate -> pull -> push-relax
        to fixpoint, as the reference's static epoch (which runs, and
        counts, every loop even for an empty seed).  The pools must already
        exclude the deleted edges."""
        def delete_epoch(dist, parent, seed, pools):
            wave = self.segment_waves(pools)
            if self.cfg.exchange == "delta":
                _, overflow = self._go(seed, True)
                aff, inv_rounds = self._invalidate_delta(parent, seed,
                                                         overflow)
            else:
                aff, inv_rounds = self._invalidate_doubling(parent, seed)
            dist = [torch.where(a, INF, d) for a, d in zip(aff, dist)]
            parent = [torch.where(a, NO_PARENT, q)
                      for a, q in zip(aff, parent)]
            if self.cfg.exchange == "delta":
                dist, parent, rounds, _ = self._recompute_delta(
                    dist, parent, aff, pools, wave)
            else:
                dist, parent, rounds, _ = self._recompute_pull_push(
                    dist, parent, aff, wave)
            return dist, parent, rounds + inv_rounds

        return delete_epoch

    def make_seed_from_deletions(self):
        """``seed(parent, del_src, del_dst) -> bool[npp] per partition``:
        invalidation roots of a deletion batch (ids replicated, padded with
        -1); a deletion seeds iff it was a tree edge (Listing 4)."""
        def seed_fn(parent, del_src, del_dst):
            out = []
            for p, q in enumerate(parent):
                dev = q.device
                s = torch.as_tensor(np.asarray(del_src, np.int32)).to(dev)
                d = torch.as_tensor(np.asarray(del_dst, np.int32)).to(dev)
                row0 = p * self.npp
                local = (d >= row0) & (d < row0 + self.npp) & (d >= 0)
                safe = (d - row0).clamp(0, self.npp - 1)
                is_tree = q[safe.long()] == s
                out.append(relax.mark_vertices(safe, local & is_tree,
                                               self.npp))
            return out

        return seed_fn
