"""End-to-end LM training with checkpoint/restart fault tolerance, on the
PyTorch port (``repro_torch``); the twin of examples/train_lm.py.

Run: PYTHONPATH=src python examples/torch_train_lm.py             (the card)
     PYTHONPATH=src python examples/torch_train_lm.py --device cpu
     PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300

Demonstrates the stack end to end on one device: TokenStream data
pipeline -> lm_loss -> AdamW -> chunked atomic checkpoints, plus a
KILL/RESUME cycle in the middle (the fault-tolerance contract of
train/checkpoint.py).
"""
import argparse
import shutil
import subprocess
import sys
import tempfile


def run(argv, check=True):
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + argv
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, check=check).returncode


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        common = ["--arch", "qwen3-14b", "--preset", args.preset,
                  "--steps", str(args.steps), "--ckpt-dir", ckpt_dir,
                  "--ckpt-every", str(max(args.steps // 6, 1)),
                  "--device", args.device]
        fail_at = args.steps // 2
        print(f"=== phase 1: train with an injected crash at step {fail_at}")
        rc = run(common + ["--fail-at-step", str(fail_at)], check=False)
        assert rc == 17, f"expected injected-failure exit 17, got {rc}"

        print("=== phase 2: resume from the last atomic checkpoint")
        run(common + ["--resume"])
        print("=== restart cycle complete: loss continued from checkpoint")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
