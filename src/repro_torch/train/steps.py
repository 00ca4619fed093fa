"""Generic train-step builders: loss -> grads (with microbatch
accumulation) -> AdamW update, in place on the model's parameters.

The reference's ``lax.scan`` over pre-split microbatches is a loop here,
with the same f32 accumulator: gradients and metrics are summed over the
microbatches and divided by ``grad_accum``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.train import optimizer as opt_mod


def _grads(loss_fn, model, batch, params):
    loss, metrics = loss_fn(model, batch)
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), gs)}
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(loss_fn: Callable, opt_cfg: opt_mod.AdamWConfig,
                    grad_accum: int = 1):
    """loss_fn(model, batch) -> (loss, metrics).

    Returns train_step(model, opt_state, batch) -> metrics, which updates
    the model's parameters and ``opt_state`` in place.  With grad_accum > 1
    every batch leaf arrives pre-split as (grad_accum, micro_batch, ...),
    as in the reference."""

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if grad_accum == 1:
            grads, metrics = _grads(loss_fn, model, batch, params)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            metrics = None
            for i in range(grad_accum):
                g, m = _grads(loss_fn, model,
                              {k: v[i] for k, v in batch.items()}, params)
                for k in grads:
                    grads[k] += g[k].to(torch.float32)
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            grads = {k: g / grad_accum for k, g in grads.items()}
            metrics = {k: m / grad_accum for k, m in metrics.items()}
        om = opt_mod.adamw_update(grads, opt_state, params, opt_cfg)
        return {**metrics, **om}

    return train_step


def make_eval_step(loss_fn: Callable):
    @torch.no_grad()
    def eval_step(model, batch):
        _, metrics = loss_fn(model, batch)
        return metrics
    return eval_step
