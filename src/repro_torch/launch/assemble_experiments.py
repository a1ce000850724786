"""Merge dry-run JSON shards and render the roofline tables into a
markdown file in place (twin of ``repro.launch.assemble_experiments``):
the file's ``<!-- DRYRUN_TABLE -->`` and ``<!-- ROOFLINE_TABLE -->``
markers are replaced by ``launch.roofline_report``'s tables of the port's
rows (``launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.assemble_experiments \
        --jsons a.json b.json --md EXPERIMENTS.md
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, applicable_shapes,
                                 get_config)
from repro_torch.launch.roofline_report import render, render_dryrun


def merge(paths):
    seen = {}
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p) as f:
            rows = json.load(f)
        for row in rows:
            key = (row["arch"], row["shape"], row["mesh"])
            # later files win (re-runs supersede recovered log rows)
            if key not in seen or not row.get("from_log"):
                seen[key] = row
    return list(seen.values())


def skip_table() -> str:
    rows = ["| arch | skipped shape | reason |", "|---|---|---|"]
    for a in ARCH_IDS:
        if a == "llama3_70b":
            continue
        cfg = get_config(a)
        live = {s.name for s in applicable_shapes(cfg)}
        for s in SHAPES_BY_NAME.values():
            if s.name in live:
                continue
            reason = ("encoder-only: no autoregressive decode"
                      if not cfg.supports_decode and s.kind == "decode"
                      else "needs sub-quadratic attention (full-attention arch)")
            rows.append(f"| {a} | {s.name} | {reason} |")
    return "\n".join(rows)


def live_cells() -> int:
    """The live (arch, shape) cells of ``dryrun --all``: every registered
    architecture but llama3_70b, at its ``applicable_shapes``."""
    return sum(len(applicable_shapes(get_config(a))) for a in ARCH_IDS
               if a != "llama3_70b")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsons", nargs="+", required=True)
    ap.add_argument("--md", default="EXPERIMENTS.md")
    ap.add_argument("--out-json", default="dryrun_results.json")
    args = ap.parse_args(argv)
    rows = merge(args.jsons)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    with open(args.out_json, "w") as f:
        json.dump(rows, f, indent=1)
    with open(args.md) as f:
        md = f.read()
    n_ok = sum(1 for r in rows if "error" not in r)
    summary = (f"\n**{n_ok}/{len(rows)} cells ran OK** "
               f"({live_cells()} live cells x 2 meshes expected; skips "
               "below).\n\n"
               + skip_table() + "\n\n")
    md = md.replace("<!-- DRYRUN_TABLE -->",
                    summary + render_dryrun(rows))
    md = md.replace("<!-- ROOFLINE_TABLE -->", render(rows))
    with open(args.md, "w") as f:
        f.write(md)
    print(f"assembled {len(rows)} rows -> {args.out_json}, {args.md}")


if __name__ == "__main__":
    main()
