"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload kron20.micro4k --seed 7 \
        --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison with the
plain reference judged, beside its limit.  The same numbers close
standard error.  Exits 2, printing no result, without a CUDA device, and
1 if a module of JAX or of the JAX package is loaded once the window has
closed.  The kernel libraries build once into ``build/`` of the checkout.
"""
import time

_T0 = time.perf_counter()    # the process's start, as near as Python gets

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _prepare_env() -> None:
    """Fixed cache directories inside the checkout, and the program and the
    harness on the path."""
    # one process with few threads: the host's intra-op pools stay at one
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _steady_allocator() -> None:
    """Keep freed host memory in the process (glibc): blocks below 32 MiB
    come from the heap and its free top is kept up to 2 GiB, so each query's
    answer copies land on pages faulted once, not on fresh ones that the
    kernel zeroes and maps on first touch.  A no-op off glibc."""
    import ctypes
    import ctypes.util
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return
    m_trim_threshold, m_mmap_threshold = -1, -3     # <malloc.h>
    mallopt(m_mmap_threshold, 32 << 20)     # glibc's largest on 64 bits
    mallopt(m_trim_threshold, 2**31 - 1)       # an int: 2 GiB kept


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_env()
    _steady_allocator()

    import torch
    from portbench import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = harness.run_cell(cell["config"], cell["traffic"], seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device="cuda", t_start=_T0)
    found = harness.forbidden_modules()
    if found:
        print(f"error: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips}
    line = harness.result_line(cell, res, bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
