"""repro_torch — dynamic SSSP (the paper's SSSP-Del) in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch port of the JAX package ``repro``: same modules at the same
paths, bit-identical results on the same event streams.  It imports torch
and numpy only — nothing of JAX and nothing of ``repro``.

    import repro_torch
    eng = repro_torch.make_engine(num_vertices=n, edge_capacity=m, source=0,
                                  relax_backend="ellpack")   # on "cuda"
"""
from repro_torch.core.engine import EngineConfig, SSSPDelEngine
from repro_torch.core.factory import make_engine

__all__ = ["EngineConfig", "SSSPDelEngine", "make_engine"]
