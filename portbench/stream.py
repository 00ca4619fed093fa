"""The SSSP-Del sliding-window stream (arXiv:2508.14319 §5.1.3) over an
undirected graph, as arc events.

The recipe is ``repro_torch.graphs.window.sliding_window_stream``'s,
rewritten in closed form so that it runs in a few torch calls: edges
arrive in order; after every block of ``block_edges`` ADDs, each edge
whose index has fallen more than ``W`` behind the newest is deleted with
probability ``delta`` (each edge is considered once, when it falls out),
in index order.  With C(x) the number of dying edges of index < x and B
the block:

    ADD of edge e  at edge event  e + C(max(0, floor(e / B) * B - W))
    DEL of edge d  at edge event  min((floor((d + W) / B) + 1) * B, U) + C(d)

An undirected edge {u, v} is two arc events side by side, (u, v) then
(v, u), with one weight, added and deleted together.  The first W edges'
ADDs come before any DEL: they are the base graph loaded at set-up.

The stream never holds a duplicate arc and every DEL names a live arc, so
the live arc set after any prefix of events is exact, and ``live_arcs``
gives it to the reference from the ADD and DEL positions alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.graphs import Edges

ADD, DEL = 0, 1           # the program's event kinds (repro_torch.core.events)
NEVER = torch.iinfo(torch.int64).max


@dataclasses.dataclass
class Stream:
    edges: Edges
    add_at: torch.Tensor      # i64[U] edge-event index of each edge's ADD
    del_at: torch.Tensor      # i64[U] ... of its DEL, NEVER if it lives on
    kind: np.ndarray          # u8[T] arc events, host
    src: np.ndarray           # i64[T]
    dst: np.ndarray           # i64[T]
    w: np.ndarray             # f32[T] (0 on a DEL)
    base: int                 # arc events of the base graph

    def __len__(self) -> int:
        return len(self.kind)

    def live_arcs(self, pos: int) -> tuple[torch.Tensor, ...]:
        """(src, dst, w) of the arcs live after arc events [0, pos)."""
        if pos % 2:
            raise ValueError(f"position {pos} splits an edge's two arcs")
        e = self.edges
        live = (self.add_at < pos // 2) & (self.del_at >= pos // 2)
        u, v, w = e.u[live], e.v[live], e.w[live]
        return torch.cat([u, v]), torch.cat([v, u]), torch.cat([w, w])

    def live_counts(self, positions: np.ndarray) -> np.ndarray:
        """Live arcs after each of ``positions`` (host, from the events)."""
        signed = np.where(self.kind == ADD, 1, -1).astype(np.int64)
        cum = np.concatenate([[0], np.cumsum(signed)])
        return cum[np.asarray(positions, np.int64)]


def sliding_window(edges: Edges, traffic: dict,
                   gen: torch.Generator) -> Stream:
    dev = edges.u.device
    U = len(edges.u)
    W = int(float(traffic["window_frac"]) * U)
    B = int(traffic["block_edges"])
    e = torch.arange(U, device=dev)
    dies = (torch.rand(U, generator=gen, device=dev)
            < float(traffic["delta"])) & (e < U - W)
    cex = torch.zeros(U + 1, dtype=torch.int64, device=dev)
    cex[1:] = torch.cumsum(dies, 0)
    add_at = e + cex[((e // B) * B - W).clamp(min=0)]
    out_block_end = torch.clamp(((e + W) // B + 1) * B, max=U)
    del_at = torch.where(dies, out_block_end + cex[e], NEVER)

    n_events = 2 * (U + int(cex[-1]))
    kind = torch.empty(n_events, dtype=torch.uint8, device=dev)
    src = torch.empty(n_events, dtype=torch.int64, device=dev)
    dst = torch.empty(n_events, dtype=torch.int64, device=dev)
    w = torch.zeros(n_events, dtype=torch.float32, device=dev)
    for at, k, sel in ((add_at, ADD, slice(None)), (del_at, DEL, dies)):
        first = 2 * at[sel]
        u, v = edges.u[sel], edges.v[sel]
        for pos, a, b in ((first, u, v), (first + 1, v, u)):
            kind[pos] = k
            src[pos], dst[pos] = a, b
            if k == ADD:
                w[pos] = edges.w
    return Stream(edges, add_at, del_at, kind.cpu().numpy(),
                  src.cpu().numpy(), dst.cpu().numpy(), w.cpu().numpy(),
                  base=2 * W)
