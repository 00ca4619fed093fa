"""DIN — Deep Interest Network (Zhou et al., arXiv:1706.06978).

Assigned config: embed_dim=18, behaviour seq_len=100, attention MLP 80-40,
prediction MLP 200-80, interaction = target attention.

System shape: huge sparse embedding tables -> feature interaction -> small
MLP.  The lookups are plain tensor indexing (the reference's ``jnp.take``);
the item table's gradient is dense, as in the reference.

Entry points for the assigned shapes:

  * ``din_loss``        — train_batch (65,536): BCE on click labels;
  * ``din_score``       — serve_p99 (512) / serve_bulk (262,144): forward;
  * ``din_retrieval``   — retrieval_cand: ONE user history scored against
    many candidates as one (candidates x seq) interaction, not a loop.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamTree, normal


@dataclasses.dataclass(frozen=True)
class DINConfig:
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple[int, ...] = (80, 40)
    mlp: tuple[int, ...] = (200, 80)
    n_items: int = 10_000_000
    n_cates: int = 1_000
    # Dice/PReLU simplified to silu (activation choice is not the paper's
    # contribution)

    @property
    def d_item(self) -> int:
        return 2 * self.embed_dim  # item ++ cate embedding


class DIN(ParamTree):
    def __init__(self, cfg: DINConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, batch):
        return din_forward(self, batch, self.cfg)


def _mlp_init(dims, generator, device):
    ws = [normal((dims[i], dims[i + 1]), generator, device)
          / math.sqrt(dims[i]) for i in range(len(dims) - 1)]
    return {"w": ws,
            "b": [torch.zeros((dims[i + 1],), dtype=torch.float32,
                              device=ws[0].device)
                  for i in range(len(dims) - 1)]}


def _mlp(p, x, final=None):
    n = len(p.w)
    for i, (w, b) in enumerate(zip(p.w, p.b)):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < n - 1:
            x = F.silu(x)
    return x if final is None else final(x)


def init_din(cfg: DINConfig, generator: torch.Generator | None = None,
             device="cuda") -> DIN:
    d = cfg.embed_dim
    di = cfg.d_item
    # attention MLP input: [target, behav, target-behav, target*behav]
    attn_dims = (4 * di,) + tuple(cfg.attn_mlp) + (1,)
    # prediction MLP input: [user_interest (di), target (di), sum_pool (di)]
    mlp_dims = (3 * di,) + tuple(cfg.mlp) + (1,)
    return DIN(cfg, {
        "item_emb": normal((cfg.n_items, d), generator, device) * 0.01,
        "cate_emb": normal((cfg.n_cates, d), generator, device) * 0.01,
        "attn": _mlp_init(attn_dims, generator, device),
        "mlp": _mlp_init(mlp_dims, generator, device),
    })


def din_param_shapes(cfg: DINConfig) -> DIN:
    """The parameter tree on ``meta`` (shapes and dtypes, no allocation)."""
    return init_din(cfg, device="meta")


def _embed_items(params, item_ids, cate_ids):
    """(..., ) int32 ids -> (..., 2*d) [item ++ cate] embeddings."""
    return torch.cat([params.item_emb[item_ids], params.cate_emb[cate_ids]],
                     dim=-1)


def _target_attention(params, target, behav, behav_mask):
    """DIN's local activation unit.

    target (B, di); behav (B, S, di); mask (B, S) -> interest (B, di).
    Attention weights are NOT softmax-normalized (paper §4.3 keeps the
    un-normalized sum to preserve interest intensity).
    """
    B, S, di = behav.shape
    t = target[:, None, :].expand(B, S, di)
    feat = torch.cat([t, behav, t - behav, t * behav], dim=-1)
    w = _mlp(params.attn, feat)[..., 0]                       # (B, S)
    w = torch.where(behav_mask, w, 0.0)
    return torch.einsum("bs,bsd->bd", w, behav)


def din_forward(params, batch, cfg: DINConfig) -> torch.Tensor:
    """batch: target_item/target_cate (B,), hist_items/hist_cates (B, S),
    hist_mask (B, S) bool.  Returns click logits (B,)."""
    target = _embed_items(params, batch["target_item"], batch["target_cate"])
    behav = _embed_items(params, batch["hist_items"], batch["hist_cates"])
    mask = batch["hist_mask"]
    interest = _target_attention(params, target, behav, mask)
    # sum-pool of the behaviour sequence (masked)
    pool = torch.einsum("bs,bsd->bd", mask.to(behav.dtype), behav)
    x = torch.cat([interest, target, pool], dim=-1)
    return _mlp(params.mlp, x)[..., 0]


def din_loss(params, batch, cfg: DINConfig):
    logits = din_forward(params, batch, cfg).to(torch.float32)
    y = batch["labels"].to(torch.float32)
    loss = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
    return loss, {"loss": loss, "acc": acc}


def din_score(params, batch, cfg: DINConfig) -> torch.Tensor:
    """Online/offline scoring: sigmoid click probability (B,)."""
    return torch.sigmoid(din_forward(params, batch, cfg))


def din_retrieval(params, batch, cfg: DINConfig) -> torch.Tensor:
    """One user, n_candidates targets (retrieval_cand shape).

    batch: hist_items/hist_cates (S,), hist_mask (S,),
           cand_items/cand_cates (C,).  Returns scores (C,).

    The user's behaviour embedding (S, di) is computed ONCE; the local
    activation unit is evaluated as one (C, S) batched interaction.
    """
    behav = _embed_items(params, batch["hist_items"], batch["hist_cates"])
    mask = batch["hist_mask"]                                  # (S,)
    cand = _embed_items(params, batch["cand_items"], batch["cand_cates"])
    Cn, di = cand.shape
    S = behav.shape[0]
    t = cand[:, None, :].expand(Cn, S, di)
    b = behav[None].expand(Cn, S, di)
    feat = torch.cat([t, b, t - b, t * b], dim=-1)
    w = _mlp(params.attn, feat)[..., 0]                        # (C, S)
    w = torch.where(mask[None, :], w, 0.0)
    interest = torch.einsum("cs,sd->cd", w, behav)
    pool = torch.einsum("s,sd->d", mask.to(behav.dtype), behav)
    x = torch.cat([interest, cand, pool[None].expand(Cn, di)], dim=-1)
    return torch.sigmoid(_mlp(params.mlp, x)[..., 0])
