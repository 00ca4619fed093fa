"""The port has the reference's whole public surface: for every module of
``src/repro/``, its twin in ``src/repro_torch/`` at the same path has every
public function, class, module-level constant and ``__all__`` name of the
reference under the same name, and every reference function's keyword
parameters (and every class constructor's) are accepted by the twin.

The departures are listed in ``ALLOWED`` below, each with its reason and
where it is recorded (ROADMAP.md, Queue 3's departures and 13c's list;
ROADMAP's Queue 3 also records fault F1).  Anything else the reference has
and the port lacks fails here: a gap to port, not to allowlist.
"""
import importlib
import inspect
import os
import re
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

_TILES = ("Pallas tile knobs and interpret mode: the port's kernels are CUDA, "
          "built and launched by their wrappers (ROADMAP Queue 2)")
_KEY = ("JAX PRNG keys become explicit torch generators (generator=, "
        "device=) (ROADMAP Queue 1 done table, 13a/13b)")
_LAYOUT = ("read from the layout object (dist's length, SlicedEllState's "
           "widths and slice_rows); F1 (ROADMAP Queue 3, closed)")
_CONTROLLER = ("one controller over per-partition tensors: the partition "
               "count and width are the lists' (ROADMAP Queue 3, sharded "
               "engine (d))")
_HLO = ("HLO text: the trace model replaces it (ROADMAP, 13c's departures: "
        "roofline/trace_analysis.py, no --save-hlo)")
_SHARDINGS = ("NamedSharding helpers and SPMD hints: specs are tuples, the "
              "hints identities (ROADMAP Queue 3, LM substrate (a))")
_OCC = ("occupancy is folded from the sparse ladder's counts, which the "
        "host reads anyway (core/frontier.py; ROADMAP Queue 3, host reads "
        "per wave)")
_PMAX = ("reductions over a leading participant dimension on one controller "
         "(ROADMAP Queue 3, LM substrate (g))")
_UNREAD = ("unread in the reference: a field that does nothing is not "
           "carried (ROADMAP Queue 3, surface test)")

# (reference module, name, keyword or None) -> reason; name None = the whole
# module
ALLOWED = {
    ("repro.kernels.relax.config", None, None):
        "engine.resolve_kernel plays its role (ROADMAP, 13c's departures)",
    ("repro.roofline.hlo_analysis", None, None): _HLO,
    ("repro.roofline.report", "roofline_from_text", None): _HLO,
    ("repro.roofline.report", "ICI_BW", None): _HLO,
    ("repro.launch.dryrun", "run_cell", "save_hlo"): _HLO,
    ("repro.models.sharding", "lm_shardings", None): _SHARDINGS,
    ("repro.models.sharding", "row_sharded", None): _SHARDINGS,
    ("repro.models.sharding", "tree_specs_to_shardings", None): _SHARDINGS,
    ("repro.models.sharding", "ACT_CTX", None): _SHARDINGS,
    ("repro.models.moe", "BUFFER_CONSTRAINT", None): _SHARDINGS,
    ("repro.train.checkpoint", "restore", "sharding_tree"): _SHARDINGS,
    ("repro.train.compression", "compressed_psum", "x"):
        _PMAX + ": the participants come as one tensor or list, xs",
    ("repro.train.compression", "compressed_psum", "axis_name"): _PMAX,
    ("repro.train.compression", "ef_compress_tree", "axis_name"): _PMAX,
    ("repro.core.relax", "converged_loop", "track_occupancy"): _OCC,
    ("repro.core.buckets", "run_drain", "track_occupancy"): _OCC,
    ("repro.core.distributed", "per_partition_occupancy", "P"): _CONTROLLER,
    ("repro.core.distributed", "per_partition_occupancy", "npp"):
        _CONTROLLER,
    ("repro.core.frontier", "wrap_shard_wave", "make_wave"):
        _CONTROLLER + ": it takes each partition's wave and pool",
    ("repro.core.backends.sliced", "sliced_gather_min", "use_kernel"):
        "the port's takes the row-min itself (relax=: K1's wrapper or its "
        "plain version), so one function serves the single-device and the "
        "sharded waves (kernels/relax/ref.py)",
    ("repro.core.engine", "EngineConfig", "validate_every"): _UNREAD,
    ("repro", "EngineConfig", "validate_every"): _UNREAD,
    ("repro.models.gnn.common", "init_mlp", "final_bias"):
        "no effect in the reference (zero biases on every layer either "
        "way): a keyword that does nothing is not carried (ROADMAP Queue 3, "
        "surface test)",
}
# keyword departures that apply wherever the reference has them
ANY_FUNCTION = {
    "interpret": _TILES, "block_rows": _TILES, "block_feat": _TILES,
    "block_bags": _TILES, "key": _KEY,
}
ALLOWED_KW_BY_PREFIX = {
    # (module, function-name prefix) -> {keyword: reason}
    ("repro.core.backends.ellpack", "ell_"): {"num_vertices": _LAYOUT},
    ("repro.core.backends.sliced", "sliced_"): {"widths": _LAYOUT,
                                                "slice_rows": _LAYOUT},
    ("repro.kernels.relax.fused", "fused_sliced_relax"): dict.fromkeys(
        ("flat_idx", "flat_w", "osrc", "odst", "ow", "widths",
         "slice_rows"), "K2 takes the SlicedEllState layout object; " + _LAYOUT),
}


def _ref_modules() -> list[str]:
    out = []
    for p in sorted(REF.rglob("*.py")):
        parts = list(p.relative_to(REF.parent).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _import_ref(name: str):
    # repro.launch.dryrun sets XLA_FLAGS at import (512 host devices for
    # its own process); keep that out of this process's environment
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _public(mod, name: str, src: str) -> dict:
    """The reference module's public surface: name -> object."""
    out = {k: getattr(mod, k) for k in getattr(mod, "__all__", ())}
    for k, v in vars(mod).items():
        if k.startswith("_") or isinstance(v, types.ModuleType):
            continue
        fn = getattr(v, "__wrapped__", v)          # jax.jit keeps it here
        if ((inspect.isfunction(fn) or inspect.isclass(fn))
                and fn.__module__ == name):
            out[k] = v
        elif re.search(rf"^{re.escape(k)}\s*(:[^=\n]*)?=", src, re.M):
            out[k] = v                              # a module constant
    return out


def _keywords(obj) -> list[str] | None:
    """Keyword-passable parameter names, or None when any is accepted or
    there is no signature."""
    obj = getattr(obj, "__wrapped__", obj)
    if not (inspect.isfunction(obj) or inspect.isclass(obj)):
        return None
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    if any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values()):
        return None
    return [k for k, p in sig.parameters.items()
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]


def _kw_allowed(mod: str, fn: str, kw: str) -> bool:
    if (mod, fn, kw) in ALLOWED or kw in ANY_FUNCTION:
        return True
    return any(mod == m and fn.startswith(pre) and kw in kws
               for (m, pre), kws in ALLOWED_KW_BY_PREFIX.items())


MODULES = _ref_modules()


@pytest.mark.parametrize("name", MODULES)
def test_port_twin_has_the_reference_surface(name):
    tname = "repro_torch" + name[len("repro"):]
    if (name, None, None) in ALLOWED:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(tname)
        return
    ref = _import_ref(name)
    port = importlib.import_module(tname)
    src = Path(ref.__file__).read_text()
    missing, kw_missing = [], []
    for k, obj in sorted(_public(ref, name, src).items()):
        if (name, k, None) in ALLOWED:
            assert not hasattr(port, k), f"{tname}.{k} exists: drop its entry"
            continue
        if not hasattr(port, k):
            missing.append(k)
            continue
        want = _keywords(obj)
        got = _keywords(getattr(port, k))
        if want is None or got is None:
            continue
        kw_missing += [f"{k}({kw}=)" for kw in want
                       if kw not in got and not _kw_allowed(name, k, kw)]
    assert not missing, f"{tname} lacks {missing}"
    assert not kw_missing, f"{tname} does not accept {kw_missing}"


def test_every_allowlist_entry_names_a_reference_departure():
    """Each entry has its reason, and names something the reference has
    (a stale entry would hide nothing and mislead)."""
    for (mod, name, kw), reason in ALLOWED.items():
        assert mod in MODULES, mod
        if name is None:
            assert reason
            continue
        ref = _import_ref(mod)
        assert hasattr(ref, name), (mod, name)
        if kw is not None:
            assert reason and kw in _keywords(getattr(ref, name)), (
                mod, name, kw)
    for reasons in (ANY_FUNCTION, *ALLOWED_KW_BY_PREFIX.values()):
        assert all(reasons.values())


def test_package_exports_resolve_lazily_as_the_reference():
    """``repro_torch`` has the reference package's exports and its PEP 562
    hooks; the dataset names resolve on first use."""
    import repro
    import repro_torch
    assert set(repro.__all__) <= set(repro_torch.__all__)
    assert set(repro.__all__) <= set(dir(repro_torch))
    for name in repro.__all__:
        assert getattr(repro_torch, name).__name__ == name
    with pytest.raises(AttributeError):
        repro_torch.no_such_name
