"""AdamW over a name -> tensor dict, with global-norm clipping and a
linear-warmup + cosine schedule — the reference's update, not
``torch.optim.AdamW``'s: the bias corrections are f32 powers of the int32
step, ``eps`` is added to ``sqrt(v_hat)``, the clip scales the gradients
before the moments, and the decoupled decay ``lr * wd * p`` applies to
every leaf (biases, layernorm scales and embedding tables too).

State: ``{"m": {name: f32}, "v": {name: f32}, "step": int32 scalar}``, on
the parameters' device.  ``adamw_update`` writes the parameters and the
moments in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    some = next(iter(params.values()))
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], state: dict,
                 params: dict[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """Updates ``params`` and ``state`` in place; returns the metrics
    ``{"grad_norm", "lr"}`` as device scalars."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(step, cfg)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        m = state["m"][name]
        v = state["v"][name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        p32 = p.to(torch.float32)
        p32 = p32 - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                          + cfg.weight_decay * p32)
        p.copy_(p32.to(p.dtype))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
