"""A program's FLOPs, HBM bytes, live-memory peak and collectives, counted
from the aten ops it dispatches — the port's counterpart of the
reference's ``hlo_analysis`` (which walks compiled XLA HLO; the port has
no compiler and runs every op as its own kernel).

``trace(fn, args)`` runs ``fn(*args)`` under ``CostTracer``, a
``TorchDispatchMode``.  On ``meta`` tensors nothing is allocated and no
kernel runs, so a full-size program traces on any host.  Per op:

  * FLOPs — ``torch.utils.flop_counter``'s formulas (matmuls, batched
    matmuls, convolutions, attention), split by the operand dtype: ``bf16``
    (bf16 and fp16, the tensor cores) and ``f32`` (TF32 is off: SGEMM).
    Element-wise ops count no FLOPs; the byte term covers them.
  * Bytes — every tensor input read once and every output written once:
    an eager op is its own kernel, so this is the HBM traffic as the port
    runs, every intermediate included (a floor for this op sequence, not
    for the function: fused ops would not move their intermediates).
    Three refinements keep the count a floor on what the kernel
    must move: views move nothing; a gather (``index``, ``gather``,
    ``embedding``, ...) reads at most as many source bytes as it writes;
    an in-place scatter (``scatter_reduce_``, ``index_put_``, ...) reads
    and writes at most as many destination bytes as its source holds, and
    an overwrite (``copy_``, ``fill_``, ``zero_``) does not read its
    destination.  A tensor's bytes are capped by its storage (an expanded
    view is read once).
  * Live bytes — every storage an op creates is live until its last
    reference dies (a finalizer on the untyped storage); the peak, with
    the arguments live from the start, is ``peak_live_bytes``.
  * Host reads — a ``bool()`` / ``.item()`` / ``.cpu()`` of a meta tensor
    cannot read data.  The tracer answers it: each data-dependent loop
    (the loop's frame: the first caller outside the read helpers
    ``READ_HELPERS``) is told to go on ``trips`` times, so it runs
    ``trips`` rounds (``trips`` = ``default_trip`` rounded up, at least
    one; the loops in ``DO_WHILE`` run one round before their first read
    and are told ``trips - 1`` times) — the reference's
    ``--default-trip``.  ``answers=`` replays the reads of a real run
    instead (``record_reads``), so the trace repeats that run's rounds.
  * Collectives — the port runs one controller with identity sharding
    hints, so the LM, GNN and DIN programs move nothing between
    partitions and count 0.  The SSSP programs exchange through
    ``DistributedSSSP.all_gather`` and ``psum``; ``trace`` wraps those two
    methods of the program's ``exchange`` and counts, per partition and
    call, the operand bytes and the ring model's wire bytes (all-gather
    ``(P-1)/P`` of the gathered bytes, all-reduce ``2(P-1)/P`` of the
    operand), as the reference's HLO walker does.  A mesh of one repeated
    device gathers one shared copy; each partition's own gathered copy is
    added to the HBM bytes.

All counts are for the whole program (one controller drives every
partition); ``report.roofline_from_trace`` spreads them over the mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import weakref
from collections import Counter
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# functions that read a loop condition on behalf of their caller
READ_HELPERS = frozenset({"host", "host_flags", "_read", "_go"})
# loops whose first round runs before their first read
DO_WHILE = frozenset({"_mark_loop", "_invalidate_delta"})

_GATHERS = frozenset({aten.index, aten.index_select, aten.gather,
                      aten.embedding, aten.take, aten._unsafe_index})
_SCATTERS_INPLACE = frozenset({aten.scatter_, aten.scatter_add_,
                               aten.scatter_reduce_, aten.index_put_,
                               aten.index_add_, aten.index_copy_,
                               aten._index_put_impl_})
_OVERWRITES = frozenset({aten.copy_, aten.fill_, aten.zero_})
_HALF = (torch.bfloat16, torch.float16)

_TORCH_DIR = str(Path(torch.__file__).parent)


def dtype_class(dtype: torch.dtype) -> str:
    """``bf16`` (bf16 / fp16: the tensor cores), ``f32`` or ``other``."""
    if dtype in _HALF:
        return "bf16"
    return "f32" if dtype == torch.float32 else "other"


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a kernel reads or writes for ``t``: its elements, capped
    by its storage (an expanded or overlapping view is moved once)."""
    n = t.numel() * t.element_size()
    return min(n, t.untyped_storage().nbytes())


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's argument or result (nested lists, tuples,
    dicts), without a recursive closure: a reference cycle would keep
    them alive past their last use."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


def storages(tree) -> dict[int, int]:
    """``{storage key: nbytes}`` of every tensor in a tree of modules,
    dataclasses, dicts, lists and tuples (each storage once)."""
    out = {}
    for _, t in leaves(tree):
        s = t.untyped_storage()
        out[s._cdata] = s.nbytes()
    return out


def sharded_leaves(tree, spec=None, path: str = ""):
    """``(path, global shape, itemsize, tensors, spec)`` for each tensor
    leaf of a program's argument or output tree beside its spec tree
    (None: no specs): a ``Parts`` list (one tensor a partition) is one
    leaf, the global vector of its parts along the last axis; a list of
    dataclasses (``EdgePool`` a partition) one such leaf a field; a
    module is its ``named_parameters`` dict, a dataclass its fields; host
    values are skipped."""
    sep = "." if path else ""
    if isinstance(tree, torch.Tensor):
        yield path, tuple(tree.shape), tree.element_size(), [tree], spec
        return
    if isinstance(tree, list) and tree and all(
            isinstance(t, torch.Tensor) for t in tree):
        shape = (*tree[0].shape[:-1], sum(t.shape[-1] for t in tree))
        yield path, tuple(shape), tree[0].element_size(), tree, spec
        return
    if isinstance(tree, list) and tree and all(
            dataclasses.is_dataclass(t) for t in tree):
        for f in dataclasses.fields(tree[0]):
            yield from sharded_leaves([getattr(t, f.name) for t in tree],
                                      spec, f"{path}{sep}{f.name}")
        return
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    elif dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            sub = spec[k] if isinstance(spec, dict) else spec
            yield from sharded_leaves(v, sub, f"{path}{sep}{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from sharded_leaves(v, None if spec is None else spec[i],
                                      f"{path}{sep}{i}")


def leaves(tree) -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor in a program's argument or output
    tree (``sharded_leaves``' walk; a partition list's tensors share its
    path)."""
    return [(path, t) for path, _, _, ts, _ in sharded_leaves(tree)
            for t in ts]


@dataclasses.dataclass
class TraceCost:
    """Whole-program counts of one trace (see the module docstring)."""
    flops_by_dtype: Counter = dataclasses.field(default_factory=Counter)
    hbm_bytes: float = 0.0
    arg_bytes: int = 0            # the arguments' storages, live at start
    peak_live_bytes: int = 0
    ops: int = 0
    host_reads: int = 0
    dynamic_loops: int = 0        # loops whose trips came from default_trip
    coll_operand_bytes: float = 0.0   # per partition, summed over calls
    coll_wire_bytes: float = 0.0      # per partition, ring model
    coll_by_type: Counter = dataclasses.field(default_factory=Counter)
    collectives: int = 0
    flops_by_op: Counter = dataclasses.field(default_factory=Counter)
    bytes_by_op: Counter = dataclasses.field(default_factory=Counter)

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    def summary(self, top: int = 6) -> dict:
        """The counts as a JSON-able dict, with the top ops by bytes and
        by FLOPs."""
        return {
            "flops": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "bytes accessed": self.hbm_bytes,
            "peak_live_bytes": self.peak_live_bytes,
            "arg_bytes": self.arg_bytes,
            "ops": self.ops, "host_reads": self.host_reads,
            "collectives": self.collectives,
            "top_bytes": dict(self.bytes_by_op.most_common(top)),
            "top_flops": dict(self.flops_by_op.most_common(top)),
        }


def op_bytes(func, args, kwargs, out, aliases: bool = False) -> int:
    """One op's HBM bytes under the module's model (read once, write once,
    with the view / gather / scatter / overwrite floors); ``aliases``: the
    op returned its input's storage without writing it (a view in all but
    its schema, as ``_unsafe_view``)."""
    if func.is_view or aliases:
        return 0
    packet = func._overloadpacket
    schema = func._schema.arguments
    ins = []                       # (tensor, read by the op)
    for i, a in enumerate(args):
        info = schema[i].alias_info if i < len(schema) else None
        overwritten = (packet in _OVERWRITES and info is not None
                       and info.is_write)
        ins += [(t, not overwritten) for t in _tensors(a)]
    for k, v in kwargs.items():
        ins += [(t, k != "out") for t in _tensors(v)]
    out_b = sum(tensor_bytes(t) for t in _tensors(out))
    if packet in _GATHERS:
        (src, _), *rest = ins
        return (min(tensor_bytes(src), out_b)
                + sum(tensor_bytes(t) for t, _ in rest) + out_b)
    if packet in _SCATTERS_INPLACE:
        (dst, _), *rest = ins
        src_b = max((tensor_bytes(t) for t, _ in rest
                     if t.dim() > 0 and t.dtype == dst.dtype), default=0)
        return (2 * min(tensor_bytes(dst), src_b)
                + sum(tensor_bytes(t) for t, _ in rest))
    # an in-place op returns its written input: written once, as out_b
    return sum(tensor_bytes(t) for t, read in ins if read) + out_b


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


class _Unkeyed(Exception):
    pass


def _sig(x):
    """What decides a meta op's output metadata: tensors by shape, strides,
    dtype and device; host values by type and value."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y) for y in x)
    if isinstance(x, _SCALARS):
        return (type(x), x)
    raise _Unkeyed


def _fresh(func) -> bool:
    """Whether ``func`` returns new tensors only: no view, no alias of an
    argument, no argument written."""
    schema = func._schema
    return not func.is_view and not any(
        a.alias_info is not None for a in (*schema.arguments,
                                           *schema.returns))


def _template(out):
    """The metadata of an op's fresh outputs, or None if it returned
    anything but a tensor or a tuple / list of them."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (tuple, list)) and all(
            isinstance(t, torch.Tensor) for t in out):
        return [(tuple(t.shape), t.stride(), t.dtype) for t in out]
    return None


def _rebuild(tpl):
    if isinstance(tpl, tuple):
        return torch.empty_strided(tpl[0], tpl[1], dtype=tpl[2],
                                   device="meta")
    return tuple(_rebuild(t) for t in tpl)


def _loop_frame():
    """The frame of the loop a host read serves: the first caller outside
    torch, this module and the read helpers."""
    f = sys._getframe(2)
    here = __file__
    while f is not None:
        name = f.f_code.co_filename
        if not (name.startswith(_TORCH_DIR) or name == here
                or f.f_code.co_name in READ_HELPERS):
            return f
        f = f.f_back
    raise RuntimeError("a host read outside any caller")


class CostTracer(TorchDispatchMode):
    """Counts what every dispatched op costs (module docstring); answers
    host reads of meta tensors with ``trips`` rounds a loop, or replays
    ``answers``."""

    def __init__(self, cost: TraceCost, *, default_trip: float = 1.0,
                 answers: list | None = None, memo: dict | None = None):
        super().__init__()
        self.cost = cost
        self.trips = max(1, math.ceil(default_trip))
        self.answers = None if answers is None else list(answers)
        self._loops: dict[Any, int] = {}
        self._live: dict[int, int] = {}
        self._live_bytes = 0
        # meta outputs by (op, argument metadata): a repeated layer's ops
        # skip torch's Python meta functions
        self._memo: dict = {} if memo is None else memo
        self._fresh: dict = {}

    # ------------------------------------------------------------ liveness
    def track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                        self._live_bytes)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # ---------------------------------------------------------- host reads
    def _go_on(self) -> bool:
        frame = _loop_frame()
        n = self._loops.get(frame, 0)
        limit = self.trips - (1 if frame.f_code.co_name in DO_WHILE else 0)
        if n < limit:
            self._loops[frame] = n + 1
            return True
        self._loops.pop(frame, None)
        self.cost.dynamic_loops += 1
        return False

    def _answer(self, kind: str):
        self.cost.host_reads += 1
        if self.answers is not None:
            got_kind, value = self.answers.pop(0)
            if got_kind != kind:
                raise RuntimeError(f"replayed read {got_kind!r} where the "
                                   f"program reads {kind!r}")
            return value
        return self._go_on()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        first = args[0] if args else None
        if isinstance(first, torch.Tensor) and first.is_meta:
            if func is aten._local_scalar_dense.default:
                return self._answer("scalar")
            if (func is aten._to_copy.default
                    and kwargs.get("device") == torch.device("cpu")):
                got = self._answer("cpu")
                dtype = kwargs.get("dtype") or first.dtype
                return torch.as_tensor(got).to(dtype).expand(
                    first.shape).clone()
        out, aliases = self._run(func, args, kwargs)
        cost = self.cost
        cost.ops += 1
        name = str(func._overloadpacket).split(".")[-1]
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            dt = next(t.dtype for t in _tensors(args))
            cost.flops_by_dtype[dtype_class(dt)] += n
            cost.flops_by_op[name] += n
        b = op_bytes(func, args, kwargs, out, aliases)
        cost.hbm_bytes += b
        cost.bytes_by_op[name] += b
        for t in _tensors(out):
            self.track(t)
        return out


    def _is_fresh(self, func) -> bool:
        fresh = self._fresh.get(func)
        if fresh is None:
            fresh = self._fresh[func] = _fresh(func)
        return fresh

    def _run(self, func, args, kwargs) -> tuple[Any, bool]:
        """``(func(*args, **kwargs), whether it aliased an input)`` on meta
        tensors, through the memo for ops with fresh outputs (a new
        storage each, as the op itself would give).  An op whose schema
        says fresh but whose result shares an input's storage unwritten
        (``_unsafe_view``) is a view: it leaves the memo for good."""
        if not self._is_fresh(func):
            return func(*args, **kwargs), False
        try:
            key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
        except _Unkeyed:
            key = None
        tpl = self._memo.get(key) if key is not None else None
        if tpl is not None:
            return _rebuild(tpl), False
        out = func(*args, **kwargs)
        ins = {t.untyped_storage()._cdata for t in _tensors(args)}
        if any(t.untyped_storage()._cdata in ins for t in _tensors(out)):
            self._fresh[func] = False
            return out, True
        if key is not None and all(t.is_meta for t in _tensors(out)):
            tpl = _template(out)
            if tpl is not None:
                self._memo[key] = tpl
        return out, False


class _Recorder(TorchDispatchMode):
    """Passes every op through and keeps the result of each host read of
    a tensor on ``device_type`` (the reads a meta trace answers)."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.reads: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        first = args[0] if args else None
        if not (isinstance(first, torch.Tensor)
                and first.device.type == self.device_type):
            return out
        if func is aten._local_scalar_dense.default:
            self.reads.append(("scalar", out))
        elif (func is aten._to_copy.default
              and kwargs.get("device") == torch.device("cpu")):
            self.reads.append(("cpu", out.clone()))
        return out


def record_reads(fn: Callable, *args) -> tuple[Any, list]:
    """``fn(*args)`` on real tensors, and the host reads it made of
    tensors on the arguments' device, in order (``trace(..., answers=)``
    replays them).  On the CPU a ``.cpu()`` dispatches nothing, so only
    ``bool()`` / ``.item()`` reads are seen there."""
    rec = _Recorder(leaves(args)[0][1].device.type)
    with rec:
        out = fn(*args)
    return out, rec.reads


@contextlib.contextmanager
def _counted_exchange(eng, cost: TraceCost):
    """Counts ``eng``'s all_gather and psum calls (module docstring)."""
    if eng is None:
        yield
        return
    gather, psum = eng.all_gather, eng.psum
    P = eng.P
    copies = len(set(eng.devices))

    def all_gather(parts):
        out = gather(parts)
        res, operand = tensor_bytes(out[0]), tensor_bytes(parts[0])
        wire = (P - 1) / P * res
        cost.coll_operand_bytes += operand
        cost.coll_wire_bytes += wire
        cost.coll_by_type["all-gather"] += wire
        cost.collectives += 1
        cost.hbm_bytes += (P - copies) * res
        cost.bytes_by_op["all_gather(per-partition copies)"] += \
            (P - copies) * res
        return out

    def all_reduce(parts):
        operand = tensor_bytes(parts[0])
        wire = 2 * (P - 1) / P * operand
        cost.coll_operand_bytes += operand
        cost.coll_wire_bytes += wire
        cost.coll_by_type["all-reduce"] += wire
        cost.collectives += 1
        return psum(parts)

    eng.all_gather, eng.psum = all_gather, all_reduce
    try:
        yield
    finally:
        del eng.all_gather, eng.psum


def trace(fn: Callable, args: tuple, *, default_trip: float = 1.0,
          answers: list | None = None, exchange=None, memo: dict | None = None
          ) -> tuple[TraceCost, Any]:
    """``(cost, outputs)`` of ``fn(*args)`` traced under ``CostTracer``;
    ``exchange``: the SSSP program's ``DistributedSSSP`` (its collectives
    are counted); ``memo``: a dict shared between traces (meta outputs by
    op and argument metadata)."""
    cost = TraceCost()
    tracer = CostTracer(cost, default_trip=default_trip, answers=answers,
                        memo=memo)
    for _, t in leaves(args):
        tracer.track(t)
    cost.arg_bytes = tracer._live_bytes
    with _counted_exchange(exchange, cost), tracer:
        out = fn(*args)
    tracer._loops.clear()
    return cost, out
