"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

Dispatch (the reference's, step for step):

  1. router logits -> top_k experts per token, softmax-renormalized gates
     (ties to the lower expert id, as ``lax.top_k``: a stable sort on
     -prob);
  2. flatten (token, slot) assignments, stable-sort by expert id;
  3. position-within-expert from ``searchsorted(side="left")``;
  4. assignments beyond capacity C are *dropped* (GShard semantics); a
     dropped one is routed to slot E*C - 1 with a zero update;
  5. scatter into an (E, C, d) buffer -> batched expert SwiGLU (``bmm``
     over the expert dim) -> scatter-combine weighted by the gates.

No (T, E, C) one-hot is materialized.  The scatters are ``index_add``:
sequential on the CPU, atomics in no fixed order on CUDA, so the card's
combine is close to the CPU's, not bit-equal.

Aux losses: load-balancing loss (Switch) + router z-loss, returned for
logging and added to the LM loss by the caller.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers

# Chunk size (in (token, slot) assignments) for the dispatch/combine
# gathers; 0 disables.  Bounds the (T*K, d) transients.  Must divide T*K to
# engage.
DISPATCH_CHUNK = 524_288


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                  # per-expert hidden dim
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    balance_coef: float = 1e-2


def init_moe(d_model: int, cfg: MoEConfig, generator=None, device="cuda",
             leading: tuple = (), dtype=torch.float32) -> dict:
    L = tuple(leading)
    E, Fd = cfg.n_experts, cfg.d_ff
    s_in, s_ff = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(Fd)

    def w(shape, scale):
        return layers.scaled_normal(L + shape, scale, generator, device,
                                    dtype)
    return {"router": w((d_model, E), s_in),
            "w_gate": w((E, d_model, Fd), s_in),
            "w_up": w((E, d_model, Fd), s_in),
            "w_down": w((E, Fd, d_model), s_ff)}


def moe_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest, ties to the lower
    index."""
    order = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return torch.gather(probs, -1, order), order


def moe_forward(params, x: torch.Tensor, cfg: MoEConfig
                ) -> tuple[torch.Tensor, dict]:
    """x (..., d) -> (..., d); aux dict carries router losses."""
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(T, cfg)
    dev = x.device

    logits = xt.to(torch.float32) @ params.router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                          # (T, K)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # ---- aux losses
    me = torch.mean(probs, dim=0)                                  # (E,)
    ce = torch.mean(F.one_hot(gate_idx[:, 0], E).to(torch.float32), dim=0)
    balance = cfg.balance_coef * E * torch.sum(me * ce)
    z = cfg.router_z_coef * torch.mean(torch.logsumexp(logits, -1) ** 2)

    # ---- sort-based dispatch
    flat_e = gate_idx.reshape(-1)                                  # (T*K,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_g = gate_vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st_, sg = flat_e[order], flat_t[order], flat_g[order]
    # position of each sorted slot within its expert
    pos_all = torch.arange(T * K, device=dev)
    first_of_e = torch.searchsorted(se, torch.arange(E, device=dev),
                                    side="left")                   # (E,)
    pos_in_e = pos_all - first_of_e[se]
    keep = pos_in_e < C
    slot = se * C + torch.where(keep, pos_in_e, 0)
    safe_slot = torch.where(keep, slot, E * C - 1)
    n_slots = T * K
    chunked = bool(DISPATCH_CHUNK and n_slots > DISPATCH_CHUNK
                   and n_slots % DISPATCH_CHUNK == 0)
    kp = keep[:, None]
    buf = xt.new_zeros((E * C, d))
    if chunked:
        # bounds the gathered (chunk, d) transient; routing and drops were
        # computed globally above, so they are those of the one-shot path
        for a in range(0, n_slots, DISPATCH_CHUNK):
            sl = slice(a, a + DISPATCH_CHUNK)
            buf = buf.index_add(0, safe_slot[sl],
                                torch.where(kp[sl], xt[st_[sl]], 0.0))
    else:
        buf = buf.index_add(0, safe_slot, torch.where(kp, xt[st_], 0.0))
    buf = buf.reshape(E, C, d)

    # ---- expert SwiGLU (batched over E)
    wg = params.w_gate.to(xt.dtype)
    wu = params.w_up.to(xt.dtype)
    wd = params.w_down.to(xt.dtype)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    y = torch.bmm(h, wd)                                           # (E, C, d)

    # ---- combine: gather each kept slot's output back to its token
    y_flat = y.reshape(E * C, d)
    sgc = sg[:, None].to(xt.dtype)
    out = torch.zeros_like(xt)
    if chunked:
        for a in range(0, n_slots, DISPATCH_CHUNK):
            sl = slice(a, a + DISPATCH_CHUNK)
            contrib = torch.where(kp[sl], y_flat[safe_slot[sl]] * sgc[sl],
                                  0.0)
            out = out.index_add(0, st_[sl], contrib)
    else:
        contrib = torch.where(kp, y_flat[slot] * sgc, 0.0)
        out = out.index_add(0, st_, contrib)

    frac_dropped = 1.0 - torch.sum(keep.to(torch.float32)) / (T * K)
    aux = {"moe_balance": balance, "moe_z": z, "moe_dropped": frac_dropped}
    return out.reshape(orig_shape), aux
