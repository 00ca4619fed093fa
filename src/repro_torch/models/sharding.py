"""Parameter/activation sharding rules (logical axes -> mesh axes), as pure
functions over shapes and a mesh's ``shape`` mapping.

Production mesh axes (the reference's ``launch/mesh.py``):

  * ``data``  (16) — batch parallelism + FSDP (ZeRO-3-style parameter
    sharding);
  * ``model`` (16) — tensor parallelism (heads / d_ff / experts / vocab);
  * ``pod``   (2, multi-pod only) — pure data parallelism across pods.

A spec is a tuple with one entry a dim: ``None`` (replicated), an axis
name, or a tuple of axis names — the entries of the reference's
``PartitionSpec``.  Divisibility is checked per dimension: a rule that
does not divide evenly is dropped to ``None`` for that dim.

The port runs one controller on one card and has no SPMD partitioner, so
the activation constraints (``activation_context``, ``wsc``,
``wsc_batch``) are identities; the specs are what a multi-card layout
would take.  Any object with a ``shape`` mapping (axis -> size) and
``axis_names`` serves as the mesh (``launch/mesh.Mesh``).
"""
from __future__ import annotations

import re
from typing import Sequence

import torch


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    size = 1
    for n in names:
        if n not in mesh.shape:
            return False
        size *= mesh.shape[n]
    return dim % size == 0


def _entry(ax):
    """A spec entry as ``PartitionSpec`` keeps it: one axis in a tuple is
    that axis's name."""
    if isinstance(ax, (tuple, list)):
        return ax[0] if len(ax) == 1 else tuple(ax)
    return ax


def spec_for(shape: Sequence[int], wanted: Sequence, mesh) -> tuple:
    """Clamp a wanted spec to the dims that actually divide."""
    return tuple(_entry(ax) if _fits(dim, mesh, ax) else None
                 for dim, ax in zip(shape, wanted))


# Param-path rules: (regex over "/".join(path), wanted logical spec where
# "fsdp" -> data axis, "tp" -> model axis; matched against the *trailing*
# dims — stacked-layer leading L dims get None automatically).
_LM_RULES: list[tuple[str, tuple]] = [
    (r"embed$",                ("tp", "fsdp")),        # (V, d)
    (r"lm_head$",              ("fsdp", "tp")),        # (d, V)
    (r"final_norm$|.*_norm$|.*norm$", (None,)),        # (d,) and friends
    # GQA attention
    (r"attn/wq$|attn/wk$|attn/wv$", ("fsdp", "tp")),   # (d, h*dh)
    (r"attn/wo$",              ("tp", "fsdp")),        # (h*dh, d)
    # MLA
    (r"attn/w_dq$",            ("fsdp", "tp")),        # (d, rq)
    (r"attn/w_uq$",            ("fsdp", "tp")),        # (rq, h*(dn+dr))
    (r"attn/w_dkv$",           ("fsdp", None)),        # (d, rkv+dr)
    (r"attn/w_uk$|attn/w_uv$", (None, "tp")),          # (rkv, h*dn)
    (r"attn/w_o$",             ("tp", "fsdp")),        # (h*dv, d)
    # dense MLP
    (r"mlp/w_gate$|mlp/w_up$", ("fsdp", "tp")),        # (d, F)
    (r"mlp/w_down$",           ("tp", "fsdp")),        # (F, d)
    # MoE: experts over model axis (expert parallelism)
    (r"moe/router$",           ("fsdp", None)),        # (d, E)
    (r"moe/w_gate$|moe/w_up$", ("tp", "fsdp", None)),  # (E, d, F)
    (r"moe/w_down$",           ("tp", None, "fsdp")),  # (E, F, d)
]


def _resolve(ax, fsdp_axis, tp_axis):
    if ax == "fsdp":
        return fsdp_axis
    if ax == "tp":
        return tp_axis
    return ax


def _shapes(params) -> dict[str, tuple]:
    """``{path: shape}`` of a module (its ``state_dict`` keys) or of a
    ``{path: tensor or shape}`` dict; paths joined by ``.``."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def lm_param_specs(params_shape, mesh, *, fsdp_axis="data",
                   tp_axis="model") -> dict[str, tuple]:
    """``{path: spec}`` for an LM parameter tree (a module, on ``meta`` or
    not, or shapes).

    Stacked-layer leaves (under ``blocks``) get a leading None for the L
    dim."""
    out = {}
    for path, shape in _shapes(params_shape).items():
        pstr = path.replace(".", "/")
        stacked = pstr.startswith("blocks/")
        trail = shape[1:] if stacked else shape
        spec = (None,) * len(shape)          # default: replicated
        for pat, wanted in _LM_RULES:
            if re.search(pat, pstr):
                w = tuple(_resolve(a, fsdp_axis, tp_axis) for a in wanted)
                if len(w) != len(trail):   # e.g. stacked norms (L, d)
                    w = (None,) * (len(trail) - 1) + (w[-1],) \
                        if len(trail) else ()
                sp = spec_for(trail, w, mesh)
                spec = (None,) + sp if stacked else sp
                break
        out[path] = spec
    return out


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch is sharded over: (pod, data) when multi-pod."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def lm_batch_spec(mesh) -> tuple:
    return (_entry(batch_axes(mesh)),)


def cache_spec(cache_shape, mesh) -> dict[str, tuple]:
    """KV cache sharding: batch over (pod, data); cache-length dim over
    model.  ``cache_shape``: a ``KVCache`` (``cache_shapes`` gives one on
    ``meta``) or anything with ``k`` and ``v`` shapes; ``length`` is a
    scalar (replicated, ``()``)."""
    b_ax = batch_axes(mesh)
    out = {}
    for name in ("k", "v"):
        shape = tuple(getattr(cache_shape, name).shape)
        want = [None, b_ax, "model"] + [None] * (len(shape) - 3)
        out[name] = spec_for(shape, want, mesh)
    out["length"] = ()
    return out


def graph_axes(mesh) -> tuple[str, ...]:
    """GNN / recsys / SSSP models flatten every mesh axis into one big
    vertex/row partition (shared-nothing, paper §3)."""
    return tuple(mesh.axis_names)


# ------------------------------------------------ activation-sharding ctx ----

class activation_context:
    """The reference's activation-sharding context: a no-op here."""

    def __init__(self, mesh, batch_axes_):
        self.proto = (mesh, tuple(batch_axes_))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def wsc(x, *wanted):
    """The reference's ``with_sharding_constraint``: the identity here."""
    return x


def wsc_batch(x):
    return x
