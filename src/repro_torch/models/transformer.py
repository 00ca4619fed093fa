"""Decoder-only LM family covering the five assigned transformer archs.

One config dataclass + one parameter tree layout covers:

  * olmoe-1b-7b          — GQA(16/16) + MoE 64e top-8
  * moonshot-v1-16b-a3b  — GQA(16/16) + MoE 64e top-6
  * minicpm3-4b          — MLA (DeepSeek-V2 style latent attention), dense
  * mistral-large-123b   — GQA(96/8), dense
  * qwen3-14b            — GQA(40/8) + qk-norm, dense

Layer parameters are *stacked* on a leading ``L`` axis, as the reference
keeps them; its ``lax.scan`` over layers is a loop over ``at(blocks, i)``.
With ``remat`` each layer runs under non-reentrant
``torch.utils.checkpoint``; ``remat_policy="sqrt"`` also checkpoints each
group of ``remat_group`` layers around them (the reference's two-level
scan).

Entry points:

  * ``lm_loss``      — training forward + loss (grad accumulation in
                       train/steps.py);
  * ``lm_forward``   — full-sequence logits;
  * ``prefill``      — logits plus a filled bf16 decode cache;
  * ``decode_step``  — one token with a KV cache.  GQA caches (k, v); MLA
                       caches the latent (c_kv, k_rope) pair and uses the
                       absorbed-matmul form.

Departures from the reference: ``KVCache.length`` is a host int, so a
decode step reads nothing back from the device; ``decode_step`` and
``prefill`` write the cache tensors in place (the returned cache shares
them) where the reference returns new arrays — a functional copy of a
32k cache a token would move the whole cache each step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import flash as flash_mod
from repro_torch.models import layers, mla as mla_mod, moe as moe_mod
from repro_torch.models.params import ParamTree, at
# the reference's name for the activation-sharding context (an identity)
from repro_torch.models.sharding import (  # noqa: F401
    activation_context as activation_sharding)


def attention(q, k, v, *, causal: bool, block_k: int, impl: str):
    """Training/prefill attention dispatch (decode has its own dense path)."""
    if impl == "flash_vjp":
        return flash_mod.flash_attention(q, k, v, causal, block_k)
    return layers.blockwise_attention(q, k, v, causal=causal, block_k=block_k)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None          # default d_model // n_heads
    attn: str = "gqa"                  # "gqa" | "mla"
    qk_norm: bool = False
    rope_theta: float = 1e4
    moe: moe_mod.MoEConfig | None = None
    mla: mla_mod.MLAConfig | None = None
    tie_embeddings: bool = False
    vocab_pad_to: int = 256
    # performance knobs (the reference's)
    remat: bool = True
    block_k: int = 512
    grad_accum: int = 1                # microbatches per train step
    compute_dtype: Any = torch.bfloat16
    # "flash_vjp": custom-backward flash attention (O(S*d) residuals);
    # "scan": the block loop differentiated by autograd (baseline)
    attn_impl: str = "flash_vjp"
    # "layer": checkpoint each layer.  "sqrt": also checkpoint each group
    # of remat_group layers around them
    remat_policy: str = "layer"
    remat_group: int = 1
    # the reference's batch-only residual constraint; kept so the config
    # equals the reference's, read by nothing (no SPMD partitioner)
    act_batch_sharding: bool = True

    @property
    def head_dim(self) -> int:
        return (self.d_head if self.d_head is not None
                else self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    # ------------------------------------------------- analytic param counts
    def params_per_layer(self) -> int:
        d, dh = self.d_model, self.head_dim
        if self.attn == "mla":
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads
                    * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = (d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                    + self.n_heads * dh * d)
        if self.moe is not None:
            mlp = (self.moe.n_experts * 3 * d * self.moe.d_ff
                   + d * self.moe.n_experts)
        else:
            mlp = 3 * d * self.d_ff
        return attn + mlp + 2 * d  # + norms

    def param_count(self) -> int:
        emb = self.padded_vocab * self.d_model
        head = 0 if self.tie_embeddings else self.d_model * self.padded_vocab
        return emb + head + self.n_layers * self.params_per_layer() \
            + self.d_model

    def active_params_per_layer(self) -> int:
        """MoE: only top_k experts touch each token (MODEL_FLOPS=6·N_act·D)."""
        per = self.params_per_layer()
        if self.moe is not None:
            dense_all = self.moe.n_experts * 3 * self.d_model * self.moe.d_ff
            dense_act = self.moe.top_k * 3 * self.d_model * self.moe.d_ff
            per = per - dense_all + dense_act
        return per

    def active_param_count(self) -> int:
        emb = self.padded_vocab * self.d_model
        head = 0 if self.tie_embeddings else self.d_model * self.padded_vocab
        return emb + head + self.n_layers * self.active_params_per_layer() \
            + self.d_model

    def model_flops(self, n_tokens: int, *, train: bool = True) -> float:
        """6·N_active·D (train fwd+bwd) or 2·N_active·D (inference fwd);
        N_active without the embedding table (the lm_head is real
        compute and stays)."""
        n = self.active_param_count() - self.padded_vocab * self.d_model
        return (6.0 if train else 2.0) * n * n_tokens


class LM(ParamTree):
    """An LM's parameters: ``embed``, ``blocks`` (stacked ``[L, ...]``),
    ``final_norm`` and, untied, ``lm_head`` — the reference's tree."""

    def __init__(self, cfg: LMConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg


# ------------------------------------------------------------------ init ----

def _init_attn(cfg: LMConfig, generator, device, L: tuple, dtype) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    if cfg.attn == "mla":
        return mla_mod.init_mla(d, cfg.n_heads, cfg.mla, generator, device, L,
                                dtype)

    def w(d_in, d_out):
        return layers.scaled_normal(L + (d_in, d_out), 1.0 / math.sqrt(d_in),
                                    generator, device, dtype)
    p = {"wq": w(d, cfg.n_heads * dh), "wk": w(d, cfg.n_kv_heads * dh),
         "wv": w(d, cfg.n_kv_heads * dh), "wo": w(cfg.n_heads * dh, d)}
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rms_norm(dh, p["wq"].device, L, dtype)
        p["k_norm"] = layers.init_rms_norm(dh, p["wq"].device, L, dtype)
    return p


def _init_blocks(cfg: LMConfig, generator, device, L: tuple, dtype) -> dict:
    """The block leaves, each with the leading dims ``L``: ``(n_layers,)``
    stacked for ``init_lm``, ``()`` for one block."""
    d = cfg.d_model
    attn = _init_attn(cfg, generator, device, L, dtype)
    dev = attn["wq" if cfg.attn == "gqa" else "w_dq"].device
    blk = {"attn_norm": layers.init_rms_norm(d, dev, L, dtype),
           "mlp_norm": layers.init_rms_norm(d, dev, L, dtype),
           "attn": attn}
    if cfg.moe is not None:
        blk["moe"] = moe_mod.init_moe(d, cfg.moe, generator, device, L,
                                      dtype)
    else:
        blk["mlp"] = layers.init_swiglu(d, cfg.d_ff, generator, device, L,
                                        dtype)
    return blk


def init_block(cfg: LMConfig, generator: torch.Generator | None = None,
               device="cuda", dtype=torch.float32) -> dict:
    """One transformer block's parameters (a dict of tensors), the leaves
    of one layer of ``init_lm``'s stacked ``blocks``."""
    return _init_blocks(cfg, generator, device, (), dtype)


def init_lm(cfg: LMConfig, generator: torch.Generator | None = None,
            device="cuda", dtype=torch.float32) -> LM:
    """Parameters N(0, 1) scaled as the reference's (its RNG stream is not
    reproduced: tests carry its initial parameters across with
    ``load_jax_params``).  Each stacked leaf is drawn whole on the
    generator's device (pass a CUDA generator to draw on the card) and
    cast to ``dtype`` as it is drawn, so a bf16 serving copy never holds
    the f32 tree; ``device="meta"`` gives shapes alone."""
    d, V = cfg.d_model, cfg.padded_vocab
    blocks = _init_blocks(cfg, generator, device, (cfg.n_layers,), dtype)
    dev = blocks["attn_norm"].device
    params = {"embed": layers.scaled_normal((V, d), 0.02, generator, device,
                                            dtype),
              "blocks": blocks,
              "final_norm": layers.init_rms_norm(d, dev, (), dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_linear(d, V, generator, device, (),
                                               dtype)
    return LM(cfg, params)


def lm_param_shapes(cfg: LMConfig, dtype=torch.float32) -> LM:
    """The parameter tree on ``meta`` (shapes and dtypes, no allocation) —
    the dry run's stand-in for the reference's ``ShapeDtypeStruct`` tree."""
    return init_lm(cfg, device="meta", dtype=dtype)


# --------------------------------------------------------------- forward ----

def _gqa_qkv(p, h, cfg: LMConfig, positions):
    B, S, _ = h.shape
    dh = cfg.head_dim
    q = (h @ p.wq.to(h.dtype)).reshape(B, S, cfg.n_heads, dh)
    k = (h @ p.wk.to(h.dtype)).reshape(B, S, cfg.n_kv_heads, dh)
    v = (h @ p.wv.to(h.dtype)).reshape(B, S, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p.q_norm)
        k = layers.rms_norm(k, p.k_norm)
    cos, sin = layers.rope_angles(positions, dh, cfg.rope_theta)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def _gqa_attention(p, x, cfg: LMConfig, positions, *, causal=True):
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    out = attention(q, k, v, causal=causal, block_k=cfg.block_k,
                    impl=cfg.attn_impl)
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p.wo.to(x.dtype)


def _mlp(blk, h, cfg: LMConfig):
    if cfg.moe is not None:
        return moe_mod.moe_forward(blk.moe, h, cfg.moe)
    return layers.swiglu(h, blk.mlp.w_gate, blk.mlp.w_up, blk.mlp.w_down), {}


def block_forward(blk, x, cfg: LMConfig, positions):
    """One pre-norm transformer block; returns (x, aux)."""
    h = layers.rms_norm(x, blk.attn_norm)
    if cfg.attn == "mla":
        a = mla_mod.mla_attention_full(blk.attn, h, cfg.n_heads, cfg.mla,
                                       positions, cfg.rope_theta, cfg.block_k,
                                       cfg.attn_impl)
    else:
        a = _gqa_attention(blk.attn, h, cfg, positions)
    x = x + a
    m, aux = _mlp(blk, layers.rms_norm(x, blk.mlp_norm), cfg)
    return x + m, aux


def _add_aux(total: dict, aux: dict) -> dict:
    return {k: total[k] + v if k in total else v for k, v in aux.items()}


def _layers(params, x, cfg: LMConfig, positions, lo: int, hi: int):
    """Layers [lo, hi) with their aux summed; each under a checkpoint
    when ``remat``."""
    def body(y, i):
        return block_forward(at(params.blocks, i), y, cfg, positions)

    aux = {}
    for i in range(lo, hi):
        if cfg.remat:
            x, a = checkpoint(body, x, i, use_reentrant=False)
        else:
            x, a = body(x, i)
        aux = _add_aux(aux, a)
    return x, aux


def lm_forward(params, tokens, cfg: LMConfig):
    """tokens (B, S) int -> (logits (B, S, V) in compute dtype, aux dict).

    The embedding rows are gathered and then cast (the reference casts the
    table and gathers: the same values)."""
    B, S = tokens.shape
    x = params.embed[tokens.long()].to(cfg.compute_dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None, :]

    if cfg.remat_policy == "sqrt" and cfg.n_layers % cfg.remat_group > 0:
        raise ValueError("n_layers must divide remat_group for sqrt remat")
    if cfg.remat_policy == "sqrt" and cfg.remat_group > 1:
        # two-level remat: one stashed input a group; the group's layers
        # are recomputed from it in backward
        G, aux = cfg.remat_group, {}
        for g in range(0, cfg.n_layers, G):
            x, a = checkpoint(_layers, params, x, cfg, positions, g, g + G,
                              use_reentrant=False)
            aux = _add_aux(aux, a)
    else:
        x, aux = _layers(params, x, cfg, positions, 0, cfg.n_layers)

    x = layers.rms_norm(x, params.final_norm)
    w_head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ w_head.to(x.dtype), aux


def lm_loss(params, batch: dict, cfg: LMConfig):
    """batch: tokens (B,S) int, labels (B,S) int (-1 = masked).

    Returns (loss, metrics).  Softmax cross-entropy in f32; MoE aux losses
    (balance + z) are added with their configured coefficients."""
    logits, aux = lm_forward(params, batch["tokens"], cfg)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).to(torch.int64)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    ntok = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll) / ntok
    total = loss + aux.get("moe_balance", 0.0) + aux.get("moe_z", 0.0)
    return total, {"loss": loss, "ntok": ntok, **aux}


# ---------------------------------------------------------------- decode ----

@dataclasses.dataclass
class KVCache:
    """Decode cache.  GQA: k/v (L, B, T, n_kv, dh).  MLA: k holds the latent
    c_kv (L, B, T, r_kv) and v holds k_rope (L, B, T, dr).  ``length``:
    the number of valid positions, a host int."""
    k: torch.Tensor
    v: torch.Tensor
    length: int

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def _cache_dims(cfg: LMConfig, batch: int, capacity: int
                ) -> tuple[tuple, tuple]:
    L = cfg.n_layers
    if cfg.attn == "mla":
        return ((L, batch, capacity, cfg.mla.kv_lora_rank),
                (L, batch, capacity, cfg.mla.qk_rope_dim))
    k = (L, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return k, k


def init_cache(cfg: LMConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    ks, vs = _cache_dims(cfg, batch, capacity)
    return KVCache(k=torch.zeros(ks, dtype=dtype, device=device),
                   v=torch.zeros(vs, dtype=dtype, device=device), length=0)


def cache_shapes(cfg: LMConfig, batch: int, capacity: int,
                 dtype=torch.bfloat16) -> KVCache:
    """The cache on ``meta`` (shapes and dtypes, no allocation) — the
    reference's ``ShapeDtypeStruct`` tree."""
    return init_cache(cfg, batch, capacity, dtype, device="meta")


def _write_token(cache_layer: torch.Tensor, new: torch.Tensor, length: int):
    """``lax.dynamic_update_slice(c, new, (0, length, ...))`` in place: the
    start clamps so the one-token update fits (at length == capacity the
    last slot is overwritten)."""
    t = min(max(length, 0), cache_layer.shape[1] - 1)
    cache_layer[:, t:t + 1] = new.to(cache_layer.dtype)


def _decode_attn_gqa(p, x, cfg: LMConfig, ck, cv, length: int):
    """x (B,1,d); ck/cv (B,T,nkv,dh) with the new token NOT yet appended
    (written in place here).  Returns attn_out (B,1,d)."""
    B = x.shape[0]
    dh = cfg.head_dim
    pos = torch.full((1, 1), length, dtype=torch.int32, device=x.device)
    q, k, v = _gqa_qkv(p, x, cfg, pos)
    _write_token(ck, k, length)
    _write_token(cv, v, length)
    T = ck.shape[1]
    # dense single-token attention: scores (B, nkv, G, 1, T) in f32
    nkv, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, 1, nkv, G, dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                     ck.to(torch.float32)) / math.sqrt(dh)
    mask = torch.arange(T, device=x.device) <= length
    s = torch.where(mask, s, -math.inf)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", pr, cv.to(torch.float32))
    o = o.reshape(B, 1, cfg.n_heads * dh).to(x.dtype)
    return o @ p.wo.to(x.dtype)


def _decode_attn_mla(p, x, cfg: LMConfig, cc, cr, length: int):
    """MLA absorbed decode; cc (B,T,rkv), cr (B,T,dr), written in place."""
    c_kv, k_rope = mla_mod.mla_latent_for_token(p, x, cfg.mla, length,
                                                cfg.rope_theta)
    _write_token(cc, c_kv, length)
    _write_token(cr, k_rope, length)
    return mla_mod.mla_decode_absorbed(p, x, cfg.n_heads, cfg.mla, cc, cr,
                                       length + 1, cfg.rope_theta)


def _head(params, x, cfg: LMConfig):
    x = layers.rms_norm(x, params.final_norm)
    w_head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ w_head.to(x.dtype)


@torch.no_grad()
def decode_step(params, cache: KVCache, tokens, cfg: LMConfig):
    """tokens (B,) int (the newest token) -> (logits (B, V), cache with
    length + 1; its tensors are ``cache``'s, written in place)."""
    x = params.embed[tokens.long()].to(cfg.compute_dtype)[:, None, :]
    length = cache.length
    attn_fn = _decode_attn_mla if cfg.attn == "mla" else _decode_attn_gqa
    for i in range(cfg.n_layers):
        blk = at(params.blocks, i)
        a = attn_fn(blk.attn, layers.rms_norm(x, blk.attn_norm), cfg,
                    cache.k[i], cache.v[i], length)
        x = x + a
        m, _ = _mlp(blk, layers.rms_norm(x, blk.mlp_norm), cfg)
        x = x + m
    logits = _head(params, x, cfg)[:, 0, :]
    return logits, KVCache(k=cache.k, v=cache.v, length=length + 1)


@torch.no_grad()
def prefill(params, tokens, cfg: LMConfig, capacity: int):
    """Full-sequence prefill that also fills a bf16 decode cache (the
    serving path).  As the reference, the logits come from ``lm_forward``
    and a second pass over the layers recomputes each layer's attention to
    fill the cache."""
    B, S = tokens.shape
    if S > capacity:
        raise ValueError(f"prefill of {S} tokens into a cache of {capacity}")
    logits, _ = lm_forward(params, tokens, cfg)
    x = params.embed[tokens.long()].to(cfg.compute_dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None, :]
    cache = init_cache(cfg, B, capacity, device=tokens.device)
    for i in range(cfg.n_layers):
        blk = at(params.blocks, i)
        p = blk.attn
        h = layers.rms_norm(x, blk.attn_norm)
        if cfg.attn == "mla":
            q, k, v, c_kv, k_rope = mla_mod.mla_qkv_full(
                p, h, cfg.n_heads, cfg.mla, positions, cfg.rope_theta)
            out = attention(q, k, v, causal=True, block_k=cfg.block_k,
                            impl=cfg.attn_impl)
            a = out.reshape(B, S, -1) @ p.w_o.to(x.dtype)
            ck, cv = c_kv, k_rope
        else:
            q, k, v = _gqa_qkv(p, h, cfg, positions)
            out = attention(q, k, v, causal=True, block_k=cfg.block_k,
                            impl=cfg.attn_impl)
            a = out.reshape(B, S, -1) @ p.wo.to(h.dtype)
            ck, cv = k, v
        cache.k[i, :, :S] = ck.to(torch.bfloat16)
        cache.v[i, :, :S] = cv.to(torch.bfloat16)
        x = x + a
        m, _ = _mlp(blk, layers.rms_norm(x, blk.mlp_norm), cfg)
        x = x + m
    cache.length = S
    return logits, cache
