"""Parameter trees as modules, and weights carried across from the
reference.

A model's parameters are the reference's pytree: nested dicts, lists by
position, array leaves.  ``ParamTree`` holds such a tree as an
``nn.Module`` (a dict becomes a submodule, a list of arrays an
``nn.ParameterList``, a list of dicts an ``nn.ModuleList``), so every
``state_dict`` key is the reference's leaf path joined by ``.``
(``blocks.edge_mlp.w.0``).  Per-layer parameters stay stacked ``[L, ...]``
as the reference's ``vmap``-ed inits make them; ``at(tree, i)`` is
``jax.tree.map(lambda a: a[i], tree)``.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
from torch import nn


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: CUDA is not available; "
                           f"pass device='cpu' to run on the CPU")
    return dev


def normal(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """N(0, 1) f32 drawn on the generator's device, then moved; on the
    ``meta`` device shapes alone (nothing drawn)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    gen_dev = generator.device if generator is not None else "cpu"
    x = torch.randn(tuple(shape), generator=generator, device=gen_dev,
                    dtype=torch.float32)
    return x.to(resolve_device(device))


class ParamTree(nn.Module):
    """A nested dict of tensors as a module (see the module docstring)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            self._put(key, val)

    def _put(self, key: str, val) -> None:
        if isinstance(val, dict):
            self.add_module(key, ParamTree(val))
        elif isinstance(val, (list, tuple)):
            if val and isinstance(val[0], dict):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in val))
            else:
                self.add_module(key, nn.ParameterList(
                    nn.Parameter(v) for v in val))
        else:
            self.register_parameter(key, nn.Parameter(val))


def at(node, i: int):
    """Every leaf indexed at ``i`` along its leading (stacked) axis:
    ``jax.tree.map(lambda a: a[i], node)`` over a ``ParamTree`` or a slice
    of one (a ``SimpleNamespace``)."""
    if isinstance(node, torch.Tensor):
        return node[i]
    if isinstance(node, ParamTree):
        out = {k: at(m, i) for k, m in node.named_children()}
        out.update({k: p[i] for k, p in node.named_parameters(recurse=False)})
        return SimpleNamespace(**out)
    if isinstance(node, SimpleNamespace):
        return SimpleNamespace(**{k: at(v, i) for k, v in vars(node).items()})
    return [at(m, i) for m in node]


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The reference's pytree (arrays convertible by ``np.asarray``) as a
    flat ``{path: tensor}`` dict, paths joined by ``.``."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for k, v in enumerate(node):
                walk(f"{prefix}{k}.", v)
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node))
    walk("", tree)
    return out


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Loads the reference's parameters into ``module`` (strict: the same
    keys, one-to-one), on the module's device."""
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in
                            params_from_jax(tree).items()}, strict=True)
    return module


def adamw_state_from_jax(state, device="cuda") -> dict:
    """The reference's AdamW state ``{"m", "v", "step"}`` in the port's
    form (``train/optimizer.py``)."""
    dev = resolve_device(device)

    def moments(tree):
        return {k: v.to(dev) for k, v in params_from_jax(tree).items()}
    return {"m": moments(state["m"]), "v": moments(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}
