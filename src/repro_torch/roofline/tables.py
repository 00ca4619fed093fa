"""Render the roofline tables from the dry-run report JSONs.

Usage: PYTHONPATH=src python -m repro_torch.roofline.tables [reports/dryrun ...]
"""
from __future__ import annotations

import json
import os
import sys


def fmt(x, digits=3):
    if x is None:
        return "—"
    return f"{x:.{digits}e}"


def load_dir(base: str) -> dict:
    out = {}
    for mesh in ("single", "multi"):
        d = os.path.join(base, mesh)
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if f.endswith(".json"):
                with open(os.path.join(d, f)) as fh:
                    rec = json.load(fh)
                if rec.get("ok"):
                    out[(mesh, rec["arch"], rec["shape"],
                         f[:-5].split(".")[-1] if "." in f[:-5] else "")] = rec
    return out


def table(base: str, mesh: str) -> str:
    recs = load_dir(base)
    rows = ["| cell | c (s) | m (s) | x (s) | dominant | peak GB | "
            "MODEL_FLOPS ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    for (m, arch, shape, variant), rec in sorted(recs.items()):
        if m != mesh:
            continue
        r = rec["roofline"]
        name = f"{arch} × {shape}" + (f" [{variant}]" if variant else "")
        rows.append(
            f"| {name} | {fmt(r['compute_s'])} | {fmt(r['memory_s'])} | "
            f"{fmt(r['collective_s'])} | {r['dominant']} | "
            f"{rec['memory']['peak_per_device_gb']:.2f} | "
            f"{fmt(r.get('model_flops_ratio'), 2)} | "
            f"{fmt(r.get('roofline_fraction'), 2)} |")
    return "\n".join(rows)


def main(argv: list[str] | None = None):
    bases = (sys.argv[1:] if argv is None else argv) or ["reports/dryrun"]
    for base in bases:
        for mesh in ("single", "multi"):
            print(f"\n### {base} — {mesh} mesh\n")
            print(table(base, mesh))


if __name__ == "__main__":
    main()
