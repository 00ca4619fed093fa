"""Multi-pod dry run: build every (arch x input-shape) cell for the
production meshes and trace it on ``meta`` — memory, cost and roofline
evidence from shapes alone, with no card (torch rendering of
``repro.launch.dryrun``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
        --shape train_4k --mesh single --out reports/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] \\
        [--jobs 8]

Per cell it writes ``<out>/<mesh>/<arch>__<shape>.json`` with:
  * status and ``lower_s``, the seconds to build and trace the program;
  * ``memory``: per-device argument, output, temp and alias bytes and
    ``peak_per_device_gb`` (the reference's ``memory_analysis`` fields).
    Arguments and outputs are exact: each leaf's bytes under its spec
    over the mesh, every sharded dim rounded up.  ``alias_bytes`` are the
    outputs that are donated arguments (the train steps update in place;
    decode writes its cache in place).  ``temp_bytes`` is an estimate:
    the traced peak of live storage, less the arguments and the new
    outputs, spread evenly over the mesh (``estimated`` lists it);
  * ``trace_cost`` (in place of ``xla_cost_analysis``): the whole-program
    FLOPs by dtype, bytes, live peak, op count and the top ops;
  * ``roofline``: the H100 terms of ``roofline/report.py``, the
    reference's keys;
  * ``trace_ops`` (in place of ``hlo_bytes``): the number of aten ops.

Departures: no ``compile_s`` (nothing is compiled) and no ``--save-hlo``
(there is no HLO); ``MESHES`` are ``meta`` meshes, so no ``XLA_FLAGS``
line comes first.

Two shortcuts keep ``--all`` to a minute or two of host time.  The LM's
layers are a Python loop of identical layers (the reference's
``lax.scan``, whose body its HLO walker multiplies by the trip count):
an LM cell is traced at three depths a remat group apart (``g``, ``2g``,
``3g`` layers with ``sqrt`` remat; 2, 3 and 4 layers without, as one
layer alone peaks differently), and every count and memory field is
carried along the parabola through them to ``n_layers``
(``layers_traced`` in the record, with each depth's bytes).  A
parabola, not a line: autograd materialises each layer's gradient of a
stacked ``[L, ...]`` parameter at full size, so a train step's bytes
grow as ``L**2``.  A cell whose program does not depend on the mesh
(all but SSSP: one controller, identity sharding hints) is traced once
and its trace reused for the second mesh.  ``--jobs N`` spreads the
traces over N spawned worker processes, the longest first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing as mp
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch

from repro_torch.configs import registry as reg
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.roofline import report as rf_report
from repro_torch.roofline import trace_analysis as ta

MESHES = {"single": False, "multi": True}
ESTIMATED = ("memory.temp_bytes", "memory.peak_per_device_gb")


def _axis_size(entry, mesh: Mesh) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(mesh.shape[a] for a in names)


def spec_bytes(shape, itemsize: int, spec: tuple, mesh: Mesh) -> int:
    """A tensor's bytes on one device under ``spec`` (one entry a dim;
    missing entries replicate), each sharded dim rounded up."""
    n = itemsize
    for i, d in enumerate(shape):
        n *= -(-d // _axis_size(spec[i] if i < len(spec) else None, mesh))
    return n


def _keys(tensors) -> set[int]:
    return {t.untyped_storage()._cdata for t in tensors}


@dataclasses.dataclass
class Traced:
    """One trace of a program, and what its memory record needs from the
    outputs: which output leaves are donated arguments, and the bytes of
    the outputs' new storages."""
    cost: ta.TraceCost
    outputs: object
    aliased: frozenset
    out_new_bytes: int
    seconds: float


def trace_program(prog: reg.Program, *, default_trip: float = 1.0,
                  answers: list | None = None, memo: dict | None = None
                  ) -> Traced:
    """``prog.fn`` traced on its meta arguments (``answers``: a real run's
    host reads to replay; ``memo``: shared between traces)."""
    t0 = time.perf_counter()
    cost, out = ta.trace(prog.fn, prog.args, default_trip=default_trip,
                         answers=answers, exchange=prog.exchange, memo=memo)
    donated = _keys(t for i in prog.donate_argnums
                    for _, t in ta.leaves(prog.args[i]))
    args = _keys(t for _, t in ta.leaves(prog.args))
    aliased, new = set(), {}
    for path, _, _, ts, _ in ta.sharded_leaves(out, prog.out_shardings):
        keys = _keys(ts)
        if keys <= donated:
            aliased.add(path)
        for t in ts:
            s = t.untyped_storage()
            if s._cdata not in args:
                new[s._cdata] = s.nbytes()
    return Traced(cost, out, frozenset(aliased), sum(new.values()),
                  time.perf_counter() - t0)


def _peak_gb(m: dict) -> float:
    return (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
            - m["alias_bytes"]) / 2**30


def memory_record(prog: reg.Program, traced: Traced) -> dict:
    """The per-device memory fields (module docstring)."""
    mesh = prog.mesh

    def total(tree, specs, only=None):
        return sum(spec_bytes(shape, size, spec, mesh)
                   for path, shape, size, _, spec in ta.sharded_leaves(tree,
                                                                    specs)
                   if only is None or path in only)

    arg = total(prog.args, prog.in_shardings)
    out = total(traced.outputs, prog.out_shardings)
    alias = total(traced.outputs, prog.out_shardings, traced.aliased)
    cost = traced.cost
    temp_global = max(0, cost.peak_live_bytes - cost.arg_bytes
                      - traced.out_new_bytes)
    temp = -(-temp_global // mesh.size)
    mem = {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp,
           "alias_bytes": alias}
    mem["peak_per_device_gb"] = _peak_gb(mem)
    return mem


_MEMO: dict = {}   # the tracer's meta-op memo, shared by every trace in a
                  # process


def layer_depths(arch: str, overrides: dict | None) -> tuple | None:
    """The three depths an LM cell is traced at (module docstring), or
    None for a cell traced whole."""
    mod = reg.ARCHES[arch]
    if mod.FAMILY != "lm":
        return None
    cfg = dataclasses.replace(mod.CONFIG, **(overrides or {}))
    if cfg.remat_policy == "sqrt":
        g = cfg.remat_group
        depths = (g, 2 * g, 3 * g)
    else:
        depths = (2, 3, 4)
    return depths if cfg.n_layers > depths[-1] else None


def _curve(ys: tuple, t: float):
    """The value at ``t`` on the parabola through ``ys`` at t = 0, 1, 2:
    numbers, and Counters key by key."""
    if isinstance(ys[0], dict):
        keys = set().union(*ys)
        return type(ys[0])({k: _curve(tuple(y.get(k, 0) for y in ys), t)
                            for k in keys})
    y0, y1, y2 = ys
    return y0 + t * (y1 - y0) + t * (t - 1) / 2 * (y2 - 2 * y1 + y0)


def extend_cost(costs: list[ta.TraceCost], t: float) -> ta.TraceCost:
    """The counts at ``t`` on the parabola through three traces (integer
    counts rounded)."""
    out = ta.TraceCost()
    for f in dataclasses.fields(ta.TraceCost):
        vals = tuple(getattr(c, f.name) for c in costs)
        v = _curve(vals, t)
        setattr(out, f.name, round(v) if isinstance(vals[0], int) else v)
    return out


def _mesh(name: str) -> Mesh:
    return make_production_mesh(multi_pod=MESHES[name])


def cell_units(arch: str, meshes: tuple, overrides: dict | None
               ) -> list[tuple]:
    """The traces a cell needs on ``meshes``, as (depth, the meshes that
    share the trace): depth None traces the whole program, and a program
    that does not depend on the mesh (all but SSSP: one controller,
    identity sharding hints) is traced once for every mesh."""
    depths = layer_depths(arch, overrides) or (None,)
    groups = ([(m,) for m in meshes] if reg.ARCHES[arch].FAMILY == "sssp"
              else [tuple(meshes)])
    return [(d, g) for g in groups for d in depths]


def trace_unit(arch: str, shape: str, depth: int | None, meshes: tuple, *,
               default_trip: float = 1.0, overrides: dict | None = None
               ) -> dict:
    """One trace of a cell's program (at ``depth`` layers, or whole) and
    each mesh's memory record of it: ``{mesh: (cost, memory record,
    seconds to build and trace)}``."""
    ov = overrides if depth is None else {**(overrides or {}),
                                          "n_layers": depth}
    out, traced = {}, None
    for name in meshes:
        t0 = time.perf_counter()
        prog = reg.build_program(arch, shape, _mesh(name), overrides=ov)
        if traced is None:
            traced = trace_program(prog, default_trip=default_trip,
                                   memo=_MEMO)
        out[name] = (traced.cost, memory_record(prog, traced),
                     time.perf_counter() - t0)
    return out


def cell_cost(arch: str, shape: str, mesh_name: str, *,
              default_trip: float = 1.0, overrides: dict | None = None,
              traces: dict | None = None) -> tuple:
    """``(program, cost, memory record, layers traced, seconds)`` of a
    cell on ``mesh_name``.  ``traces``: this mesh's entries of the cell's
    ``trace_unit`` results by depth, traced here where missing; layers
    traced: None for a whole trace, else the three depths and each one's
    bytes (its L**2 term shows there); seconds: to build and trace."""
    t0 = time.perf_counter()
    prog = reg.build_program(arch, shape, _mesh(mesh_name),
                             overrides=overrides)
    seconds = time.perf_counter() - t0
    depths = layer_depths(arch, overrides)
    traces = traces or {}
    runs = [traces[d] if d in traces else trace_unit(
                arch, shape, d, (mesh_name,), default_trip=default_trip,
                overrides=overrides)[mesh_name]
            for d in depths or (None,)]
    seconds += sum(s for _, _, s in runs)
    if depths is None:
        (cost, mem, _), = runs
        return prog, cost, mem, None, seconds
    L = dataclasses.replace(reg.ARCHES[arch].CONFIG,
                            **(overrides or {})).n_layers
    t = (L - depths[0]) / (depths[1] - depths[0])
    mems = [m for _, m, _ in runs]
    mem = {k: round(_curve(tuple(m[k] for m in mems), t)) for k in mems[0]
           if k != "peak_per_device_gb"}
    mem["peak_per_device_gb"] = _peak_gb(mem)
    cost = extend_cost([c for c, _, _ in runs], t)
    at = {"depths": list(depths),
          "hbm_bytes": [c.hbm_bytes for c, _, _ in runs]}
    return prog, cost, mem, at, seconds


def run_cell(arch: str, shape: str, mesh_name: str, *,
             default_trip: float = 1.0, overrides: dict | None = None,
             traces: dict | None = None) -> dict:
    """One cell's record (module docstring); ``traces`` as in
    ``cell_cost``."""
    chips = _mesh(mesh_name).size
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                 "chips": chips, "ok": False, "overrides": overrides}
    try:
        prog, cost, mem, layers, seconds = cell_cost(
            arch, shape, mesh_name, default_trip=default_trip,
            overrides=overrides, traces=traces)
    except ValueError as e:   # skipped cell
        if not _skipped(arch, shape):
            raise
        rec["skipped"] = str(e)
        return rec
    rf = rf_report.roofline_from_trace(cost, num_partitions=chips)
    rec.update({
        "ok": True,
        "lower_s": seconds,
        "memory": mem,
        "trace_cost": cost.summary(),
        "roofline": rf_report.report_dict(rf, prog.meta, chips),
        "meta": {k: v for k, v in prog.meta.items()
                 if isinstance(v, (int, float, str))},
        "trace_ops": cost.ops,
        "default_trip": default_trip,
        "layers_traced": layers,
        "estimated": list(ESTIMATED),
    })
    return rec


def cell_list(args) -> list[tuple[str, str]]:
    if args.arch:
        return [(args.arch, args.shape)]
    return [(c.arch, c.shape) for c in reg.all_cells() if not c.skip]


def _skipped(arch: str, shape: str) -> bool:
    return bool(reg.FAMILY_SHAPES[reg.ARCHES[arch].FAMILY][shape].get(
        "skip"))


def _work(arch: str, shape: str, depth: int | None) -> int:
    """A trace's rough cost, for the order the pool takes them in
    (longest first): its layers, three passes each in a train step."""
    if reg.ARCHES[arch].FAMILY != "lm":
        return 0
    return (depth or 1) * (3 if shape.startswith("train") else 1)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", default="single",
                   choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="reports/dryrun")
    p.add_argument("--default-trip", type=float, default=1.0,
                   help="rounds assumed for data-dependent loops (SSSP "
                        "fixpoints); 1.0 = per-round terms")
    p.add_argument("--attn-impl", choices=["flash_vjp", "scan"],
                   help="override LM attention implementation "
                        "(scan = paper-era baseline, flash_vjp = optimized)")
    p.add_argument("--jobs", type=int, default=1,
                   help="worker processes that trace the cells (1: all "
                        "in this process)")
    args = p.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        p.error("give --arch/--shape or --all")

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    cells = cell_list(args)
    t0 = time.perf_counter()
    overrides = {}
    for arch, _ in cells:
        if args.attn_impl and reg.ARCHES[arch].FAMILY == "lm":
            overrides[arch] = {"attn_impl": args.attn_impl}
            if args.attn_impl == "scan":   # true paper-era baseline
                overrides[arch]["act_batch_sharding"] = False
    pool, done = None, {}
    if args.jobs > 1:
        units = sorted(((a, s, d, g) for a, s in cells if not _skipped(a, s)
                        for d, g in cell_units(a, meshes, overrides.get(a))),
                       key=lambda u: -_work(*u[:3]))
        pool = ProcessPoolExecutor(args.jobs,
                                   mp_context=mp.get_context("spawn"))
        done = {u: pool.submit(trace_unit, *u,
                               default_trip=args.default_trip,
                               overrides=overrides.get(u[0]))
                for u in units}

    def traces(arch, shape, mesh_name):
        """This mesh's traces of the cell by depth, each unit traced once
        (in the pool, or here when first needed)."""
        out = {}
        if _skipped(arch, shape):
            return out
        for d, g in cell_units(arch, meshes, overrides.get(arch)):
            if mesh_name not in g:
                continue
            u = (arch, shape, d, g)
            if u not in done:
                done[u] = trace_unit(*u, default_trip=args.default_trip,
                                     overrides=overrides.get(arch))
            out[d] = (done[u].result() if pool else done[u])[mesh_name]
        return out

    failures = 0
    try:
        for mesh_name in meshes:
            outdir = os.path.join(args.out, mesh_name)
            os.makedirs(outdir, exist_ok=True)
            for arch, shape in cells:
                tag = f"{arch}__{shape}"
                path = os.path.join(outdir, tag + ".json")
                try:
                    rec = run_cell(arch, shape, mesh_name,
                                   default_trip=args.default_trip,
                                   overrides=overrides.get(arch),
                                   traces=traces(arch, shape, mesh_name))
                except Exception:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "ok": False, "error": traceback.format_exc()}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = ("SKIP" if rec.get("skipped")
                          else "ok" if rec["ok"] else "FAIL")
                extra = ""
                if rec.get("ok"):
                    r = rec["roofline"]
                    extra = (f" dom={r['dominant']}"
                             f" c={r['compute_s']:.3e} m={r['memory_s']:.3e}"
                             f" x={r['collective_s']:.3e}"
                             f" peakGB="
                             f"{rec['memory']['peak_per_device_gb']:.2f}"
                             f" trace={rec['lower_s']:.1f}s")
                print(f"[{mesh_name}] {tag}: {status}{extra}", flush=True)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    print(f"dry run: {len(cells) * len(meshes)} cells, {failures} failed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
