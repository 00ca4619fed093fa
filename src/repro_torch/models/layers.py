"""Shared transformer layers: norms, RoPE, blockwise (flash-style) attention
with GQA, and gated MLPs.

All functions are pure; parameters are f32 master tensors, cast to the
compute dtype (the activations' dtype) at every use, as the reference
keeps them.  Norms and attention statistics run in f32 and cast back.
Layouts are the reference's: activations (B, S, d), heads (B, S, H, D).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import normal

# ---------------------------------------------------------------- norms ----


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(dt)


def init_rms_norm(d: int, device="cuda", leading: tuple = (),
                  dtype=torch.float32) -> torch.Tensor:
    return torch.ones(tuple(leading) + (d,), dtype=dtype, device=device)


# ----------------------------------------------------------------- rope ----

def rope_angles(positions: torch.Tensor, d_head: int, theta: float = 1e4
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> (cos, sin) of shape (..., S, d_head//2)."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D//2) broadcast over heads."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(dt)


# ------------------------------------------------- blockwise attention ----

def kv_blocks(x: torch.Tensor, block_k: int) -> torch.Tensor:
    """(B, T, h, d) -> (B, h, nblk * block_k, d) f32, zero-padded past T."""
    T = x.shape[1]
    nblk = -(-T // block_k)
    x = x.to(torch.float32).transpose(1, 2)
    if nblk * block_k != T:
        x = F.pad(x, (0, 0, 0, nblk * block_k - T))
    return x


def group_heads(q: torch.Tensor, nkv: int) -> torch.Tensor:
    """q (B, S, nq, D) -> (B, nkv, G * S, D) f32, rows ordered (g, s): the
    reference's (B, nkv, G, S, ...) score layout with G and S merged."""
    B, S, nq, D = q.shape
    G = nq // nkv
    return (q.to(torch.float32).reshape(B, S, nkv, G, D)
            .permute(0, 2, 3, 1, 4).reshape(B, nkv, G * S, D))


def block_mask(S: int, G: int, t0: int, block_k: int, valid: int,
               causal: bool, q_offset: int, device) -> torch.Tensor:
    """(G * S, block_k) bool: key ``t0 + j`` is below ``valid`` and, when
    causal, at or before query row s's position ``s + q_offset``."""
    kv_pos = t0 + torch.arange(block_k, device=device)
    mask = (kv_pos < valid)[None, :].expand(S, block_k)
    if causal:
        q_pos = torch.arange(S, device=device) + q_offset
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    return mask.repeat(G, 1)


def scan_blocks(q, k, v, *, causal: bool, block_k: int, q_offset: int = 0,
                kv_len: int | None = None):
    """The reference's ``lax.scan`` over KV blocks with running softmax
    statistics, as a loop: m, l and the accumulator in f32 with the same
    ``m_safe`` / ``corr`` guards (a row with no valid key yet keeps
    m = -inf and contributes nothing).

    Returns (out (B, nkv, G*S, Dv) before the division, m, l), each f32."""
    B, S, nq, D = q.shape
    T, nkv = k.shape[1], k.shape[2]
    G = nq // nkv
    scale = 1.0 / math.sqrt(D)
    kb, vb = kv_blocks(k, block_k), kv_blocks(v, block_k)
    Tp = kb.shape[2]
    valid = Tp if kv_len is None else kv_len
    qh = group_heads(q, nkv)
    m = torch.full((B, nkv, G * S), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, nkv, G * S, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for t0 in range(0, Tp, block_k):
        kblk, vblk = kb[:, :, t0:t0 + block_k], vb[:, :, t0:t0 + block_k]
        s = torch.matmul(qh, kblk.transpose(-1, -2)) * scale
        mask = block_mask(S, G, t0, block_k, valid, causal, q_offset,
                          q.device)
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vblk)
        m = m_new
    return acc, m, l


def ungroup_heads(o: torch.Tensor, S: int) -> torch.Tensor:
    """(B, nkv, G * S, Dv) -> (B, S, nkv * G, Dv)."""
    B, nkv, GS, Dv = o.shape
    G = GS // S
    return (o.reshape(B, nkv, G, S, Dv).permute(0, 3, 1, 2, 4)
            .reshape(B, S, nkv * G, Dv))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, block_k: int = 512, q_offset: int = 0,
                        kv_len: int | None = None) -> torch.Tensor:
    """Flash-style attention: a loop over KV blocks with running softmax
    statistics; autograd differentiates through the loop (the reference's
    ``attn_impl="scan"`` baseline; ``flash.flash_attention`` is the
    custom-backward form).

    q (B, S, nq, D); k/v (B, T, nkv, D[v]), nq % nkv == 0.  ``q_offset``:
    global position of q[0]; ``kv_len``: number of valid kv positions.
    ``kv_len=None`` admits every position of the padded blocks, as the
    reference does: with T not a multiple of ``block_k`` and no causal
    mask the zero padding keys take part (the flash form masks at T).
    Returns (B, S, nq, Dv) in q.dtype."""
    acc, _, l = scan_blocks(q, k, v, causal=causal, block_k=block_k,
                            q_offset=q_offset, kv_len=kv_len)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return ungroup_heads(out, q.shape[1]).to(q.dtype)


def attention_ref(q, k, v, *, causal: bool, q_offset: int = 0,
                  kv_len: int | None = None) -> torch.Tensor:
    """Dense O(S*T) oracle for blockwise_attention (tests only)."""
    B, S, nq, D = q.shape
    T, nkv = k.shape[1], k.shape[2]
    G = nq // nkv
    qg = q.reshape(B, S, nkv, G, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) \
        / math.sqrt(D)
    q_pos = (torch.arange(S, device=q.device) + q_offset)[:, None]
    kv_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = mask & (kv_pos < kv_len)
    if causal:
        mask = mask & (kv_pos <= q_pos)
    s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(B, S, nq, v.shape[-1]).to(q.dtype)


# ------------------------------------------------------------------ mlp ----

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.silu(x @ w_gate.to(dt)) * (x @ w_up.to(dt))
    return h @ w_down.to(dt)


def scaled_normal(shape, scale: float, generator=None, device="cuda",
                  dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 (``params.normal``), then cast: one
    leaf's f32 draw is the only f32 transient of a bf16 init."""
    return normal(tuple(shape), generator, device).mul_(scale).to(dtype)


def init_swiglu(d_model: int, d_ff: int, generator=None, device="cuda",
                leading: tuple = (), dtype=torch.float32) -> dict:
    """``leading`` prepends stacked-layer dims (the reference's ``vmap``
    over init keys draws them one layer at a time)."""
    L = tuple(leading)
    s_in, s_ff = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": scaled_normal(L + (d_model, d_ff), s_in, generator,
                                device, dtype),
        "w_up": scaled_normal(L + (d_model, d_ff), s_in, generator, device,
                              dtype),
        "w_down": scaled_normal(L + (d_ff, d_model), s_ff, generator,
                                device, dtype),
    }


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def init_linear(d_in: int, d_out: int, generator=None, device="cuda",
                leading: tuple = (), dtype=torch.float32) -> torch.Tensor:
    return scaled_normal(tuple(leading) + (d_in, d_out), 1.0 / math.sqrt(d_in),
                         generator, device, dtype)
