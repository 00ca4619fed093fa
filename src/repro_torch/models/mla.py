"""Multi-head Latent Attention (MLA, DeepSeek-V2 / MiniCPM3 style).

Projections:
  q:  x -> q_lora (rank r_q, RMS-normed) -> per-head [nope dn | rope dr]
  kv: x -> [c_kv (rank r_kv, RMS-normed) | shared k_rope (dr)]
  k_h = [W_uk c_kv | k_rope (broadcast over heads)],  v_h = W_uv c_kv

Train/prefill reconstruct full k/v and run blockwise attention.  Decode
uses the **absorbed** form: q_nope is folded through W_uk so scores are
taken directly against the latent cache (c_kv, k_rope) — the cache holds
only (r_kv + dr) per token.

Parameters are read by attribute (``p.w_dq``): a ``ParamTree`` or a layer
of one (``params.at``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import flash as flash_mod
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


def init_mla(d_model: int, n_heads: int, cfg: MLAConfig, generator=None,
             device="cuda", leading: tuple = (), dtype=torch.float32) -> dict:
    L = tuple(leading)
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    def w(d_in, d_out):
        return layers.scaled_normal(L + (d_in, d_out), 1.0 / math.sqrt(d_in),
                                    generator, device, dtype)
    out = {
        "w_dq": w(d_model, rq),
        "w_uq": w(rq, n_heads * (dn + dr)),
        "w_dkv": w(d_model, rkv + dr),
        "w_uk": w(rkv, n_heads * dn),
        "w_uv": w(rkv, n_heads * dv),
        "w_o": w(n_heads * dv, d_model),
    }
    dev = out["w_dq"].device
    out["q_norm"] = layers.init_rms_norm(rq, dev, L, dtype)
    out["kv_norm"] = layers.init_rms_norm(rkv, dev, L, dtype)
    return out


def mla_qkv_full(p, x: torch.Tensor, n_heads: int, cfg: MLAConfig,
                 positions: torch.Tensor, rope_theta: float):
    """Train/prefill path: returns q, k, v as (B, S, H, *) full tensors plus
    the latent (c_kv, k_rope) pair for cache seeding."""
    B, S, _ = x.shape
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ql = layers.rms_norm(x @ p.w_dq.to(x.dtype), p.q_norm)
    q = (ql @ p.w_uq.to(x.dtype)).reshape(B, S, n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv_full = x @ p.w_dkv.to(x.dtype)
    c_kv = layers.rms_norm(ckv_full[..., :cfg.kv_lora_rank], p.kv_norm)
    k_rope = ckv_full[..., cfg.kv_lora_rank:]                    # (B, S, dr)

    cos, sin = layers.rope_angles(positions, dr, rope_theta)
    q_rope = layers.apply_rope(q_rope, cos, sin)
    k_rope = layers.apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    k_nope = (c_kv @ p.w_uk.to(x.dtype)).reshape(B, S, n_heads, dn)
    v = (c_kv @ p.w_uv.to(x.dtype)).reshape(B, S, n_heads, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, n_heads, dr)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, c_kv, k_rope


def mla_attention_full(p, x: torch.Tensor, n_heads: int, cfg: MLAConfig,
                       positions: torch.Tensor, rope_theta: float,
                       block_k: int = 512, attn_impl: str = "flash_vjp"
                       ) -> torch.Tensor:
    q, k, v, _, _ = mla_qkv_full(p, x, n_heads, cfg, positions, rope_theta)
    # v's value dim (dv) differs from k's (dn+dr); both paths support that.
    if attn_impl == "flash_vjp":
        out = flash_mod.flash_attention(q, k, v, True, block_k)
    else:
        out = layers.blockwise_attention(q, k, v, causal=True,
                                         block_k=block_k)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p.w_o.to(x.dtype)


def mla_decode_absorbed(p, x: torch.Tensor, n_heads: int, cfg: MLAConfig,
                        c_kv_cache: torch.Tensor, k_rope_cache: torch.Tensor,
                        kv_len: int, rope_theta: float) -> torch.Tensor:
    """Absorbed single-token decode.

    x (B, 1, d); c_kv_cache (B, T, r_kv) — includes the current token
    already appended by the caller; k_rope_cache (B, T, dr); kv_len: valid
    length (a host int)."""
    B = x.shape[0]
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    rkv = cfg.kv_lora_rank
    T = c_kv_cache.shape[1]
    f32 = torch.float32

    ql = layers.rms_norm(x @ p.w_dq.to(x.dtype), p.q_norm)
    q = (ql @ p.w_uq.to(x.dtype)).reshape(B, 1, n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    pos = torch.full((1, 1), kv_len - 1, dtype=torch.int32, device=x.device)
    cos, sin = layers.rope_angles(pos, dr, rope_theta)
    q_rope = layers.apply_rope(q_rope, cos, sin)

    # absorb q_nope through W_uk:  (B,1,H,dn) x (H,rkv,dn) -> (B,1,H,rkv)
    w_uk = p.w_uk.reshape(rkv, n_heads, dn).permute(1, 0, 2)    # (H,rkv,dn)
    q_lat = torch.einsum("bshd,hrd->bshr", q_nope.to(f32), w_uk.to(f32))

    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_kv_cache.to(f32))
              + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                             k_rope_cache.to(f32)))
    scores = scores / math.sqrt(dn + dr)
    mask = torch.arange(T, device=x.device) < kv_len
    scores = torch.where(mask, scores, -math.inf)
    probs = torch.softmax(scores, dim=-1)

    ctx_lat = torch.einsum("bhst,btr->bshr", probs,
                           c_kv_cache.to(f32))                  # (B,1,H,rkv)
    w_uv = p.w_uv.reshape(rkv, n_heads, dv).permute(1, 0, 2)    # (H,rkv,dv)
    out = torch.einsum("bshr,hrd->bshd", ctx_lat, w_uv.to(f32))
    out = out.reshape(B, 1, n_heads * dv).to(x.dtype)
    return out @ p.w_o.to(x.dtype)


def mla_latent_for_token(p, x: torch.Tensor, cfg: MLAConfig, pos: int,
                         rope_theta: float):
    """(c_kv, k_rope) of a single new token (decode cache append)."""
    ckv_full = x @ p.w_dkv.to(x.dtype)
    c_kv = layers.rms_norm(ckv_full[..., :cfg.kv_lora_rank], p.kv_norm)
    k_rope = ckv_full[..., cfg.kv_lora_rank:]
    dr = cfg.qk_rope_dim
    cos, sin = layers.rope_angles(
        torch.full((1, 1), pos, dtype=torch.int32, device=x.device), dr,
        rope_theta)
    k_rope = layers.apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_rope
