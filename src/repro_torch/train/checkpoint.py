"""Chunked, atomic checkpointing in the reference's on-disk layout.

Layout (one directory per step)::

    <dir>/step_000000123.tmp/         # written first
        leaf_00000_0000.npy ...       # one file per leaf chunk (split
        leaf_00001_0000.npy           #   along dim 0 above chunk_bytes)
        MANIFEST.json                 # leaf shapes, dtypes, chunk files
    <dir>/step_000000123/             # atomic rename when complete

A tree is nested dicts (lists by position) of tensors, numpy arrays or
scalars.  Leaves are ordered as ``jax.tree_util.tree_flatten`` orders
them — dict keys sorted at every level, i.e. by the tuple of path
segments — so a checkpoint written by either package restores in the
other.  Flat ``{"a.b": t}`` dicts (a ``state_dict``, the AdamW moments)
enter through ``nest``; ``restore`` checks the leaf count and shapes (the
manifest's ``treedef`` string is informational, each package writes its
own).

Fault-tolerance contract:
  * a crash mid-write leaves only ``*.tmp`` — ``latest_step`` never sees it;
  * ``AsyncSaver`` copies device -> host first (a consistent snapshot),
    then writes in a worker thread that overlaps the next training step;
  * ``restore(..., device=...)`` places every leaf on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def nest(flat: dict) -> dict:
    """``{"a.b.c": x}`` -> ``{"a": {"b": {"c": x}}}``; a level whose keys
    are all digits becomes a list (``ParameterList`` entries)."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for seg in head:
            node = node.setdefault(seg, {})
        node[last] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(out)


def flat_leaves(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path segments, leaf)]`` in ``tree_flatten``'s order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flat_leaves(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flat_leaves(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def _unflatten(like: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _host(x) -> np.ndarray:
    """A leaf as a host array of its own (a copy: the caller may go on
    writing the tensor in place); bf16, which numpy lacks, widens to
    f32."""
    if isinstance(x, torch.Tensor):
        dt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        return x.detach().to(device="cpu", dtype=dt, copy=True).numpy()
    return np.array(x)


def _chunks(arr: np.ndarray, chunk_bytes: int):
    if arr.nbytes <= chunk_bytes or arr.ndim == 0 or arr.shape[0] <= 1:
        return [arr]
    rows = max(1, int(chunk_bytes // max(arr.nbytes // arr.shape[0], 1)))
    return [arr[i:i + rows] for i in range(0, arr.shape[0], rows)]


def _write(paths: list[tuple], host: list[np.ndarray], directory: str,
           step: int, chunk_bytes: int) -> str:
    tmp = os.path.join(directory, f"step_{step:09d}.tmp")
    final = os.path.join(directory, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    treedef = "repro_torch: " + ", ".join("/".join(map(str, p))
                                          for p in paths)
    manifest = {"step": step, "treedef": treedef, "leaves": []}
    for i, arr in enumerate(host):
        names = []
        for j, part in enumerate(_chunks(arr, chunk_bytes)):
            name = f"leaf_{i:05d}_{j:04d}.npy"
            np.save(os.path.join(tmp, name), part)
            names.append(name)
        manifest["leaves"].append({"files": names, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic publish
    return final


def _snapshot(tree: Any) -> tuple[list, list]:
    pairs = flat_leaves(tree)
    return [p for p, _ in pairs], [_host(x) for _, x in pairs]


def save(tree: Any, directory: str, step: int, *,
         chunk_bytes: int = 256 * 1024 * 1024) -> str:
    """Write checkpoint; returns the final path."""
    paths, host = _snapshot(tree)
    return _write(paths, host, directory, step, chunk_bytes)


class AsyncSaver:
    """One-in-flight async checkpointing (device->host copy is synchronous;
    disk I/O overlaps the next step)."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, tree: Any, directory: str, step: int, *,
             chunk_bytes: int = 256 * 1024 * 1024) -> None:
        self.wait()
        paths, host = _snapshot(tree)
        self._thread = threading.Thread(
            target=_write, args=(paths, host, directory, step, chunk_bytes))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "MANIFEST.json"))]
    return max(steps) if steps else None


_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
           torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


def load_leaves(directory: str, step: int | None = None
                ) -> list[np.ndarray]:
    """A checkpoint's leaves as host arrays, in its order (the latest
    complete step by default)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    out = []
    for meta in manifest["leaves"]:
        parts = [np.load(os.path.join(path, n)) for n in meta["files"]]
        out.append(parts[0] if len(parts) == 1
                   else np.concatenate(parts, axis=0))
    return out


def restore(tree_like: Any, directory: str, step: int | None = None,
            *, device=None) -> Any:
    """Load into the structure of ``tree_like`` (shapes validated).  A leaf
    that is a tensor comes back as a tensor of its dtype, on ``device``
    (default: the device of the tensor it replaces); any other leaf as a
    numpy array of its dtype."""
    arrays = load_leaves(directory, step)
    likes = [x for _, x in flat_leaves(tree_like)]
    if len(likes) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, "
                         f"expected {len(likes)}")
    out = []
    for like, arr in zip(likes, arrays):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch: ckpt {arr.shape} vs "
                             f"expected {tuple(like.shape)}")
        if isinstance(like, torch.Tensor):
            t = torch.from_numpy(np.ascontiguousarray(
                arr.astype(_DTYPES.get(like.dtype, np.float32))))
            out.append(t.to(device=like.device if device is None else device,
                            dtype=like.dtype))
        else:
            out.append(arr.astype(np.asarray(like).dtype))
    return _unflatten(tree_like, out)


def cleanup(directory: str, keep: int = 3) -> None:
    """Retention: keep the newest ``keep`` complete checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(s for s in (
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
