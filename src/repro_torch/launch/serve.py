"""Serve a small model through ``make_engine`` (the paged engine; the
dense SlotEngine for the MLA configs and the recurrent families): the
reduced config of any registered architecture (``--arch``, one of
``repro_torch.configs.ARCH_IDS``). Prompts are 8-47 tokens; a recurrent
config's are cut to lengths its chunked prefill takes.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_70b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3_4b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b --device cpu

Runs on the card by default, its fixed-shape passes replayed as CUDA
graphs (``--eager`` runs them without capture); ``--device cpu`` runs the
plain attention versions on the host.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.engine.runner import make_engine
from repro_torch.models.transformer import prefill_chunk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="run the passes without CUDA graphs")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch)
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only; no serving path")
    eng = make_engine(cfg, max_batch=args.max_batch, max_len=args.max_len,
                      seed=args.seed, device=args.device,
                      cuda_graphs=not args.eager)
    rng = np.random.default_rng(args.seed)
    chunk = prefill_chunk(cfg)
    t0 = time.monotonic()
    for _ in range(args.requests):
        plen = int(rng.integers(8, 48))
        if chunk and plen > chunk:
            plen -= plen % chunk
        eng.submit(rng.integers(0, cfg.vocab_size, plen), args.max_new)
    done = eng.run()
    wall = time.monotonic() - t0
    toks = sum(len(r.tokens) for r in done)
    ttfts = [r.ttft for r in done if r.ttft is not None]
    tpots = [r.tpot for r in done if r.tpot is not None]
    print(f"[serve] arch={args.arch} device={args.device} requests="
          f"{len(done)} tokens={toks} wall={wall:.2f}s "
          f"thpt={toks/wall:.1f} tok/s")
    print(f"[serve] ttft_mean={np.mean(ttfts)*1e3:.1f}ms "
          f"tpot_mean={np.mean(tpots)*1e3:.1f}ms engine_steps={eng.steps}")
    return done


if __name__ == "__main__":
    main()
