"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``kernels/*/csrc/`` exposes a plain C interface and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library,
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds.  The
build runs at first use, from the repository's sources alone, into
``build/kernels/`` at the repository root (git-ignored).  The library's file
name carries a hash of the source and the flags, so an edited source
rebuilds and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc wall time of this process's build; 0.0 if cached
    log: str         # nvcc/ptxas output (registers, spills) of that build


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def load(source: Path) -> Built:
    """Compile ``source`` unless a library of the same hash exists, and load
    it.  Callers cache the result (one load per process)."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
