"""Perf iteration (twin of ``repro.launch.perf_iter``): compare
named config variants of one (arch x shape) cell by their dry-run terms
on the H100 (``launch.dryrun``) and print them.

    PYTHONPATH=src python -m repro_torch.launch.perf_iter \\
        --arch minicpm3_4b --shape train_4k \\
        --variants baseline,mla_absorb,bf16_logits

A variant is a "+"-joined list of ``variant`` names, plus ``no_fsdp``
(FSDP off where JAX's rule would turn it on) and ``donate``, JAX's
donation of the decode caches: a no-op in the port, whose decode writes
its caches in place (the line says so).
"""
import argparse
import dataclasses
import json

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.dryrun import production_mesh, run_cell


def variant(cfg: ModelConfig, name: str) -> ModelConfig:
    """Named beyond-baseline optimizations (the hillclimb moves)."""
    if name == "baseline":
        return cfg
    if name == "mla_absorb":
        return cfg.replace(mla=dataclasses.replace(cfg.mla, absorb=True))
    if name == "bf16_logits":
        return cfg.replace(logits_dtype="bfloat16")
    if name == "moe_dispatch":
        return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   impl="dispatch_einsum"))
    if name == "moe_ragged":
        return cfg.replace(moe=dataclasses.replace(cfg.moe, impl="ragged_ep"))
    if name == "shard_v2":
        return cfg.replace(shard_v2=True)
    if name == "shard_v2_bf16":
        return cfg.replace(shard_v2=True, logits_dtype="bfloat16")
    if name == "attn_in_seqshard":
        return cfg.replace(attn_in_seqshard=True)
    if name == "remat_dots":
        return cfg.replace(remat="dots")
    if name == "remat_none":
        return cfg.replace(remat="none")
    if name == "chunk512":
        if cfg.ssm:
            cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk_size=512))
        if cfg.xlstm:
            cfg = cfg.replace(xlstm=dataclasses.replace(cfg.xlstm,
                                                        chunk_size=512))
        return cfg
    raise ValueError(name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    mesh = production_mesh(args.multi_pod)
    results = []
    base = get_config(args.arch)
    for vname in args.variants.split(","):
        vname = vname.strip()
        mods = vname.split("+")
        fsdp = False if "no_fsdp" in mods else None
        cfg = base
        for m in mods:
            if m not in ("no_fsdp", "donate"):
                cfg = variant(cfg, m)
        res = run_cell(args.arch, args.shape, mesh, args.multi_pod,
                       verbose=False, cfg_override=cfg, fsdp=fsdp)
        res["variant"] = vname
        results.append(res)
        print(f"[perf] {args.arch} {args.shape} {vname:14s} "
              f"dom={res['dominant']:10s} "
              f"C={res['compute_term_s']*1e3:9.2f}ms "
              f"M={res['memory_term_s']*1e3:9.2f}ms "
              f"Mf={res['memory_term_flash_s']*1e3:9.2f}ms "
              f"N={res['collective_term_s']*1e3:9.2f}ms "
              f"useful={res['useful_flops_ratio']:.2f}"
              + (" (donate: a no-op, the decode writes its caches in place)"
                 if "donate" in mods else ""), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
