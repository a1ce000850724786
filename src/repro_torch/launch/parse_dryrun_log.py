"""Reconstruct dry-run result rows from the printed log (twin of
``repro.launch.parse_dryrun_log``), for cells whose JSON was lost to an
interrupted sweep. The terms are inverted from the printed roofline
numbers with the port's H100 constants (``launch.dryrun``); the
collectives' payload and calls are not in the line and are left empty.

    PYTHONPATH=src python -m repro_torch.launch.parse_dryrun_log \\
        --log dryrun.log --out recovered.json
"""
from __future__ import annotations

import argparse
import json
import re

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch.dryrun import HBM_BW, LINK_BW, PEAK_FLOPS

LINE = re.compile(
    r"\[dryrun\] (\S+)\s+(\S+)\s+mesh=(\S+)\s+compile=\s*([\d.]+)s "
    r"dom=(\S+)\s+C=\s*([\d.]+)ms M=\s*([\d.]+)ms (?:Mf=\s*([\d.]+)ms )?"
    r"N=\s*([\d.]+)ms useful=\s*([\d.]+) args/dev=\s*([\d.]+)GB "
    r"temp/dev=\s*([\d.]+)GB")


def parse(path: str):
    rows = []
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        m = LINE.search(line)
        if not m:
            continue
        (arch, shape, mesh, comp, dom, c, mm, mf, n, useful, args_gb,
         temp_gb) = m.groups()
        cfg = get_config(arch)
        sh = SHAPES_BY_NAME[shape]
        n_active = cfg.active_param_count()
        if sh.kind == "train":
            model_flops = 6.0 * n_active * sh.tokens
        elif sh.kind == "prefill":
            model_flops = 2.0 * n_active * sh.tokens
        else:
            model_flops = 2.0 * n_active * sh.global_batch
        c, mm, n = float(c) / 1e3, float(mm) / 1e3, float(n) / 1e3
        mf_s = float(mf) / 1e3 if mf else mm
        rows.append({
            "arch": arch, "shape": shape, "mesh": mesh,
            "n_chips": 512 if mesh == "2x16x16" else 256,
            "compile_s": float(comp),
            "flops_per_dev": c * PEAK_FLOPS,
            "bytes_per_dev": mm * HBM_BW,
            "wire_bytes_per_dev": n * LINK_BW,
            "collectives": {},
            "compute_term_s": c, "memory_term_s": mm,
            "memory_term_flash_s": mf_s, "collective_term_s": n,
            "dominant": dom,
            "model_flops": model_flops,
            "useful_flops_ratio": float(useful),
            "params_b": cfg.param_count() / 1e9,
            "active_params_b": n_active / 1e9,
            "arg_bytes_per_dev": int(float(args_gb) * 1e9),
            "temp_bytes_per_dev": int(float(temp_gb) * 1e9),
            "out_bytes_per_dev": 0,
            "from_log": True,
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    rows = parse(args.log)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"recovered {len(rows)} rows")


if __name__ == "__main__":
    main()
