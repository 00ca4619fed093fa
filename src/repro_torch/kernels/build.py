"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``kernels/*/csrc/`` exposes a plain C interface and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library,
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds.  The
build runs at first use, from the repository's sources alone, into
``build/kernels/`` at the repository root (git-ignored); ``load_all`` starts
one nvcc per source at once.  The library's file name carries a hash of the
source, the headers beside it, the headers shared between kernels
(``kernels/csrc/``) and the flags, so an edited source rebuilds and a stale
library is never loaded.
"""
from __future__ import annotations

import ctypes
import dataclasses
from collections.abc import Callable
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SHARED_HEADERS = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc wall time of this process's build; 0.0 if cached
    log: str         # nvcc/ptxas output (registers, spills) of that build


def check_args(kernel: str, *, ndim: int = 1,
               **args: tuple[torch.Tensor, torch.dtype]) -> torch.device:
    """Raise ``ValueError`` unless every ``name=(tensor, dtype)`` is a
    contiguous ``ndim``-D tensor of that dtype and all lie on one CUDA
    device; returns the device."""
    dev = next(iter(args.values()))[0].device
    for name, (t, dtype) in args.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{kernel}: tensors must share one CUDA device; "
                             f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} expected a contiguous {ndim}-D {dtype}; "
                f"got {t.dtype} of shape {tuple(t.shape)}")
    return dev


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


def _library(source: Path) -> Path:
    """The library path for ``source``: its name carries a hash of the
    source, of every header beside it or shared (``*.cuh``) and of the
    flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted([*source.parent.glob("*.cuh"),
                          *SHARED_HEADERS.glob("*.cuh")]):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def load_all(sources: list[Path]) -> list[Built]:
    """Compile every source that lacks a library of its hash — one nvcc
    process per source, all started together — then load each.  Callers
    cache the result (one load per process)."""
    sources = [Path(s) for s in sources]
    jobs = []
    for source in sources:
        out = _library(source)
        if out.exists():
            jobs.append((source, out, None, None, 0.0))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(source)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((source, out, tmp, proc, time.perf_counter()))
    # reap every nvcc before acting on any result, so a failure leaves no
    # compiler running
    logs = [(proc.communicate()[0], time.perf_counter() - t0)
            if proc is not None else ("", 0.0)
            for _, _, _, proc, t0 in jobs]
    built = []
    for (source, out, tmp, proc, _), (log, seconds) in zip(jobs, logs):
        if proc is not None:
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
            os.replace(tmp, out)   # atomic: a concurrent loader sees all
        built.append(Built(ctypes.CDLL(str(out)), out, seconds, log))
    return built


def load(source: Path) -> Built:
    """``load_all`` for one source."""
    return load_all([source])[0]


def launcher(source: Path, symbol: str, argtypes: list) -> Callable[..., int]:
    """The C launcher ``symbol`` of ``source``'s library (built at first
    use) with its ctypes signature bound: ``argtypes``, then the stream.
    Callers cache it, so a launch pays no lookup."""
    fn = getattr(load(source).lib, symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, fn: Callable[..., int], dev: torch.device,
           *args) -> None:
    """Enqueue ``fn(*args, stream)`` on ``dev``'s current stream and raise
    if it returns a CUDA error.  The stream goes as its raw handle (as
    torch's own compiled kernels take it, without building a Stream
    object), and the current device is switched only when ``dev`` (a
    tensor's device, so its index is set) is not already current."""
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{err}")
