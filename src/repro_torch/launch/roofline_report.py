"""Render the roofline tables from the dry run's rows (twin of
``repro.launch.roofline_report``): the same tables of the same keys, the
terms priced on the H100 (``launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        --json dryrun_results.json [--what roofline|dryrun]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


HINTS = {
    ("compute",): "raise tensor-core utilization: wgmma tiles that fill the "
                  "SMs, fewer remat recomputes, bf16 logits",
    ("memory",): "cut HBM traffic: keep attention's scores in shared memory "
                 "(the flash kernels), fuse the elementwise ops, bf16 "
                 "intermediates, larger batches to amortize weight reads",
    ("collective",): "re-shard to cut wire bytes: FSDP gather granularity, "
                     "EP instead of dispatch, overlap the all-reduces with "
                     "compute on their own stream",
}


def render(results: List[Dict]) -> str:
    rows = []
    header = ("| arch | shape | mesh | compute | memory | memory(flash-adj) | "
              "collective | dominant | MODEL_FLOPS | useful ratio | "
              "args/dev | temp/dev |")
    sep = "|" + "---|" * 12
    rows.append(header)
    rows.append(sep)
    for r in results:
        if "error" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR: {r['error']} |" + " |" * 8)
            continue
        if r["mesh"] != "16x16":
            continue  # roofline table is single-pod only
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt_s(r['compute_term_s'])} "
            f"| {fmt_s(r['memory_term_s'])} "
            f"| {fmt_s(r.get('memory_term_flash_s', r['memory_term_s']))} "
            f"| {fmt_s(r['collective_term_s'])} "
            f"| **{r['dominant']}** "
            f"| {r['model_flops']:.2e} "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['arg_bytes_per_dev']/1e9:.1f}GB "
            f"| {r['temp_bytes_per_dev']/1e9:.1f}GB |")
    return "\n".join(rows)


def render_dryrun(results: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | compile | flops/dev | bytes/dev | "
            "wire/dev | collective mix |", "|" + "---|" * 8]
    for r in results:
        if "error" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR {r['error']} |" + " |" * 4)
            continue
        mix = ", ".join(f"{k}:{v/1e9:.2f}GB" for k, v in
                        r.get("collectives", {}).items()) or "-"
        rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                    f"| {r['compile_s']}s | {r['flops_per_dev']:.2e} "
                    f"| {r['bytes_per_dev']:.2e} "
                    f"| {r['wire_bytes_per_dev']:.2e} | {mix} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="dryrun_results.json")
    ap.add_argument("--what", default="roofline",
                    choices=["roofline", "dryrun"])
    args = ap.parse_args(argv)
    with open(args.json) as f:
        results = json.load(f)
    print(render(results) if args.what == "roofline"
          else render_dryrun(results))


if __name__ == "__main__":
    main()
