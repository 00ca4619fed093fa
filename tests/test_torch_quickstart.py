"""``examples/torch_quickstart.py`` (the twin of ``examples/quickstart.py``)
runs on the CPU in a subprocess, to its oracle asserts, and prints the
reference example's answers; without ``--device`` it wants the card."""
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "examples/torch_quickstart.py",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)


def test_quickstart_on_the_cpu():
    got = _run("--device", "cpu")
    assert got.returncode == 0, got.stderr
    lines = got.stdout.splitlines()
    assert lines[0].startswith("query 0: dist=[ 0.  1.  2. inf]")
    assert lines[1].startswith("query 1: dist=[ 0.  1.  5. inf]")
    assert lines[2].startswith("query 2: dist=[0. 1. 2. 1.]")
    assert lines[3:] == ["oracle check: OK",
                         "dynamic deletions + re-additions: OK"]
    if not torch.cuda.is_available():
        got = _run()
        assert got.returncode != 0 and "CUDA is not available" in got.stderr
