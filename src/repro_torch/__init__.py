"""repro_torch — dynamic SSSP (the paper's SSSP-Del) in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch port of the JAX package ``repro``: same modules at the same
paths, bit-identical results on the same event streams.  It imports torch
and numpy only — nothing of JAX and nothing of ``repro``.

    import repro_torch
    eng = repro_torch.make_engine(num_vertices=n, edge_capacity=m, source=0,
                                  relax_backend="ellpack")   # on "cuda"
    report = repro_torch.replay_trace(eng, repro_torch.open_trace(path))
    sharded = repro_torch.make_engine(
        num_vertices=n, edge_capacity=m, source=0, relax_backend="ellpack",
        mesh=repro_torch.make_mesh((8,), ("graph",),
                                   devices=[torch.device("cuda:0")] * 8))
"""
from repro_torch.core.dist_engine import (ShardedEngineConfig,
                                          ShardedSSSPDelEngine)
from repro_torch.core.engine import EngineConfig, SSSPDelEngine
from repro_torch.core.factory import make_engine
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.serving import (ServingTrace, TraceReader, TraceRecorder,
                                 open_trace, replay_trace)

__all__ = ["EngineConfig", "Mesh", "SSSPDelEngine", "ServingTrace",
           "ShardedEngineConfig", "ShardedSSSPDelEngine", "TraceReader",
           "TraceRecorder", "dataset_to_trace", "load_dataset_or_exit",
           "make_engine", "make_mesh", "open_trace", "replay_trace"]

# The dataset names resolve on first use (PEP 562, as the reference's whole
# surface does), so that ``python -m repro_torch.graphs.datasets`` finds
# its module not yet imported by the package.
_LAZY = {"dataset_to_trace": "repro_torch.graphs.datasets",
         "load_dataset_or_exit": "repro_torch.graphs.datasets"}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(_LAZY[name]), name)
    globals()[name] = value   # cache: the next access skips __getattr__
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
