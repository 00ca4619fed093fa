"""Flash attention with a custom backward (block recomputation).

Autograd through ``layers.blockwise_attention``'s loop saves every block's
softmax numerators — an O(S*T) f32 tensor per layer.  This module
implements the flash-attention gradient identity instead:

  D_i     = rowsum(dOut_i * Out_i)
  P_ij    = exp(q_i k_j - m_i) / l_i
  dV_j    = sum_i P_ij dOut_i
  dP_ij   = dOut_i . V_j
  dS_ij   = P_ij * (dP_ij - D_i) * scale
  dQ_i    = sum_j dS_ij K_j ;  dK_j = sum_i dS_ij Q_i

so the backward recomputes P block by block and saves only the
reference's residuals ``(q, k, v, out5, m, l)`` — O(S*d).

Layout matches layers.blockwise_attention: q (B,S,nq,D), k/v (B,T,nkv,Dv),
GQA via nq = G*nkv.  The forward is the same loop over KV blocks (f32
statistics, the same guards); the backward is the reference's block
recompute, a loop over the same blocks accumulating dq in f32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_k: int):
        acc, m, l = layers.scan_blocks(q, k, v, causal=causal,
                                       block_k=block_k, kv_len=k.shape[1])
        l_safe = torch.clamp(l, min=1e-30)
        out5 = acc / l_safe[..., None]                # (B,nkv,G*S,Dv) f32
        ctx.save_for_backward(q, k, v, out5, m, l_safe)
        ctx.causal, ctx.block_k = causal, block_k
        return layers.ungroup_heads(out5, q.shape[1]).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out5, m, l = ctx.saved_tensors
        causal, block_k = ctx.causal, ctx.block_k
        B, S, nq, D = q.shape
        T, nkv = k.shape[1], k.shape[2]
        G = nq // nkv
        scale = 1.0 / math.sqrt(D)
        kb, vb = layers.kv_blocks(k, block_k), layers.kv_blocks(v, block_k)
        Tp = kb.shape[2]
        qh = layers.group_heads(q, nkv)               # (B,nkv,G*S,D)
        do = layers.group_heads(dout, nkv)            # (B,nkv,G*S,Dv)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        dvec = torch.sum(do * out5, dim=-1)           # (B,nkv,G*S)
        dq = torch.zeros_like(qh)
        dks, dvs = [], []
        for t0 in range(0, Tp, block_k):
            kblk, vblk = kb[:, :, t0:t0 + block_k], vb[:, :, t0:t0 + block_k]
            s = torch.matmul(qh, kblk.transpose(-1, -2)) * scale
            mask = layers.block_mask(S, G, t0, block_k, T, causal, 0,
                                     q.device)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            P = p / l[..., None]                      # true softmax probs
            dvs.append(torch.matmul(P.transpose(-1, -2), do))
            dp = torch.matmul(do, vblk.transpose(-1, -2))
            ds = P * (dp - dvec[..., None]) * scale
            dq = dq + torch.matmul(ds, kblk)
            dks.append(torch.matmul(ds.transpose(-1, -2), qh))
        dq = layers.ungroup_heads(dq, S).to(q.dtype)
        dk = torch.cat(dks, dim=2)[:, :, :T].transpose(1, 2).to(k.dtype)
        dv = torch.cat(dvs, dim=2)[:, :, :T].transpose(1, 2).to(v.dtype)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, block_k: int = 512):
    return FlashAttention.apply(q, k, v, causal, block_k)
