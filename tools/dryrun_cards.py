#!/usr/bin/env python3
"""The dry run's terms (``repro_torch.launch.dryrun``) of the four-card
runs of ``tools/dist_cards.py``, each at its own mesh, depth, batch, cache
length and layout on a fake process group of 4 ranks: the H100's compute,
memory (eager, and flash-adjusted) and collective terms a card of one
step, to stand beside the steps' measured times. Runs on the CPU, no card.

    PYTHONPATH=src python3 tools/dryrun_cards.py [--out cards.json]

Runs (``dist_cards.py``'s constants): ``serve`` llama3_70b whole on (1, 4),
prefill 8 x 1024 and decode at 1,088 positions; ``long`` zamba2_7b whole
on (2, 2) under ``seq_sharded``, decode at 524,296 positions (JAX's
long_500k); ``v2`` gemma_2b whole under ``shard_v2``, decode of 128 rows
at 32,768; ``long_mla`` deepseek_v2_lite_16b whole under ``seq_sharded``,
decode at 524,288; ``dispatch`` v2-lite whole with the dispatch einsum,
prefill 8 x 1024 and decode at 1,056; ``fsdp`` gemma_2b whole without and
with FSDP, the same; ``train_whole`` zamba2_7b whole and internlm2_20b
whole under FSDP, a train step of 4 x 1024.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (run, arch, mesh, kind, batch, seq_len (a decode's: its cache length
# less 8), config fields, fsdp)
RUNS = (
    ("serve", "llama3_70b", (1, 4), "prefill", 8, 1024, {}, False),
    ("serve", "llama3_70b", (1, 4), "decode", 8, 1080, {}, False),
    ("long", "zamba2_7b", (2, 2), "decode", 1, 524_288, {}, False),
    ("v2", "gemma_2b", (2, 2), "decode", 128, 32_760, {"shard_v2": True},
     False),
    ("long_mla", "deepseek_v2_lite_16b", (2, 2), "decode", 1, 524_280, {},
     False),
    ("dispatch", "deepseek_v2_lite_16b", (2, 2), "prefill", 8, 1024,
     {"moe_impl": "dispatch_einsum"}, False),
    ("dispatch", "deepseek_v2_lite_16b", (2, 2), "decode", 8, 1048,
     {"moe_impl": "dispatch_einsum"}, False),
    ("fsdp", "gemma_2b", (2, 2), "prefill", 8, 1024, {}, False),
    ("fsdp", "gemma_2b", (2, 2), "decode", 8, 1048, {}, False),
    ("fsdp", "gemma_2b", (2, 2), "prefill", 8, 1024, {}, True),
    ("fsdp", "gemma_2b", (2, 2), "decode", 8, 1048, {}, True),
    ("train_whole", "zamba2_7b", (2, 2), "train", 4, 1024, {}, False),
    ("train_whole", "internlm2_20b", (2, 2), "train", 4, 1024, {}, True),
)


def price(run):
    """One run's row: its terms in ms and counts a card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import compat_make_mesh
    name, arch, shape, kind, batch, seq, fields, fsdp = run
    cfg = get_config(arch)
    if "moe_impl" in fields:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, impl=fields["moe_impl"]))
    cfg = cfg.replace(**{k: v for k, v in fields.items() if k != "moe_impl"})
    mesh = compat_make_mesh(shape, ("data", "model"), device="cpu")
    sh = ShapeConfig(name, seq, batch, kind)
    cost = dr.extrapolated_cost(cfg, sh, mesh, fsdp)
    t = dr.terms(cfg, sh, cost, 4)
    _, _, arg_bytes = dr.build_cell(cfg, sh, mesh, fsdp)
    return {"run": name, "arch": arch, "mesh": list(shape), "kind": kind,
            "batch": batch, "seq_len": seq, "fsdp": fsdp,
            "fields": fields, "flops_per_dev": cost["flops"],
            "bytes_per_dev": cost["bytes"], "wire_bytes_per_dev": cost["wire"],
            "all_reduces": round(cost["calls"]),
            "arg_bytes_per_dev": arg_bytes,
            **{k: v * 1e3 if k.endswith("_s") else v for k, v in t.items()
               if k != "model_flops"}}


def main(argv=None) -> int:
    from repro_torch.launch import dryrun as dr
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dr.fake_world(4)
    rows = []
    for run in RUNS:
        r = price(run)
        rows.append(r)
        print(f"[cards] {r['run']:11s} {r['arch']:21s} {r['kind']:7s} "
              f"mesh={tuple(r['mesh'])} fsdp={r['fsdp']!s:5s} "
              f"C={r['compute_term_s']:9.3f}ms M={r['memory_term_s']:9.3f}ms "
              f"Mf={r['memory_term_flash_s']:9.3f}ms "
              f"N={r['collective_term_s']:8.3f}ms ({r['all_reduces']} "
              f"all-reduces) dom={r['dominant']} "
              f"args={r['arg_bytes_per_dev'] / 1e9:.2f}GB", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
