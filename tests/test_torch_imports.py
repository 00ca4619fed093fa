"""Import discipline of the port: ``repro_torch`` and every submodule import
with ``jax`` and ``repro`` blocked, and no file of the port (nor
``chip_smoke.py``, ``bench_lane_forms.py``, ``bench_sparse_lanes.py`` or
the port's examples) imports either; the engine's default device is CUDA
with no silent CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print(" ".join(names))
"""

# modules that later slices added: each must be among those walked
SLICE_MODULES = ("repro_torch.core.backends.sliced",
                 "repro_torch.core.buckets",
                 "repro_torch.core.frontier",
                 "repro_torch.kernels.relax.fused",
                 "repro_torch.kernels.relax.gather",
                 "repro_torch.kernels.spmm.ops",
                 "repro_torch.kernels.spmm.spmm",
                 "repro_torch.kernels.embed_bag.ops",
                 "repro_torch.kernels.embed_bag.embed_bag",
                 "repro_torch.obs", "repro_torch.obs.counters",
                 "repro_torch.obs.export", "repro_torch.obs.hist",
                 "repro_torch.obs.recorder", "repro_torch.obs.spans",
                 "repro_torch.obs.watchdog", "repro_torch.serving",
                 "repro_torch.serving.metrics", "repro_torch.serving.replay",
                 "repro_torch.serving.trace", "repro_torch.graphs.datasets",
                 "repro_torch.core.distributed",
                 "repro_torch.core.dist_engine",
                 "repro_torch.graphs.partition", "repro_torch.launch",
                 "repro_torch.launch.mesh", "repro_torch.core.baseline",
                 "repro_torch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.steps", "repro_torch.train.data",
                 "repro_torch.graphs.sampler", "repro_torch.graphs.triplets",
                 "repro_torch.models", "repro_torch.models.params",
                 "repro_torch.models.din", "repro_torch.models.gnn",
                 "repro_torch.models.gnn.common",
                 "repro_torch.models.gnn.graphsage",
                 "repro_torch.models.gnn.meshgraphnet",
                 "repro_torch.models.gnn.dimenet",
                 "repro_torch.models.gnn.equiformer",
                 "repro_torch.configs", "repro_torch.configs.registry",
                 "repro_torch.configs.smoke", "repro_torch.configs.din",
                 "repro_torch.configs.dimenet",
                 "repro_torch.configs.equiformer_v2",
                 "repro_torch.configs.graphsage_reddit",
                 "repro_torch.configs.meshgraphnet",
                 "repro_torch.configs.sssp_del",
                 "repro_torch.configs.olmoe_1b_7b",
                 "repro_torch.configs.moonshot_v1_16b_a3b",
                 "repro_torch.configs.minicpm3_4b",
                 "repro_torch.configs.mistral_large_123b",
                 "repro_torch.configs.qwen3_14b",
                 "repro_torch.models.layers", "repro_torch.models.flash",
                 "repro_torch.models.mla", "repro_torch.models.moe",
                 "repro_torch.models.sharding",
                 "repro_torch.models.transformer",
                 "repro_torch.train.checkpoint",
                 "repro_torch.train.compression",
                 "repro_torch.launch.train",
                 "repro_torch.launch.dryrun", "repro_torch.roofline",
                 "repro_torch.roofline.trace_analysis",
                 "repro_torch.roofline.report",
                 "repro_torch.roofline.tables", "repro_torch.testing")


def test_port_imports_with_jax_and_repro_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked = out.stdout.split()
    assert len(walked) >= 24 and set(SLICE_MODULES) <= set(walked)


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "bench_lane_forms.py",
                            ROOT / "bench_sparse_lanes.py",
                            ROOT / "examples" / "torch_streaming_sssp.py",
                            ROOT / "examples"
                            / "torch_sharded_streaming_sssp.py",
                            ROOT / "examples" / "torch_serve_din.py",
                            ROOT / "examples" / "torch_train_lm.py",
                            ROOT / "examples" / "torch_quickstart.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax_or_repro(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_default_device_is_cuda_without_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import make_engine
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_engine(num_vertices=8, edge_capacity=8)
