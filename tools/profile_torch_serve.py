#!/usr/bin/env python3
"""Where the time goes in the port's serving path on the card.

    python3 tools/profile_torch_serve.py [--chunk-size N]

Runs the same full-width Gemma-2B workload as ``chip_smoke.py`` (16 seeded
requests, prompts 128-1024 tokens, 64 new tokens each, ``max_batch=8``,
``max_len=2048``, ``block_tokens=16``; with ``--chunk-size`` the chunked
``Engine``, as phase ``chunked`` runs it at 256) twice after a warm-up:

1. timed: every admission, decode pass and chunk pass is bracketed by
   ``torch.cuda.synchronize()`` on the host clock, which splits the wall
   time into prefill (whole-prompt admissions), decode, chunk passes and
   the rest (host bookkeeping);
2. profiled: ``torch.profiler`` over the same run gives device time by
   kernel name, grouped into the attention kernels (paged decode's split
   kernel and its merge together), matrix products and the rest, and the
   device's idle share of the wall time.

Prints one JSON line with every number; needs one CUDA card and the CUDA
toolkit (the kernels build at first use).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _engine(cfg, params, chunk_size: int):
    from repro_torch.engine.core import EngineConfig
    return cs._engine(cfg, params,
                      config=EngineConfig(chunk_size=chunk_size))


def _timed_run(cfg, params, prompts, chunk_size):
    from repro_torch.engine.core import EngineCore
    from repro_torch.models import steps
    spans = defaultdict(list)
    originals = {}
    forwards = [0]                     # chunk passes that ran the model
    chunk_step = steps.chunk_step

    def counted(*a, **k):
        forwards[0] += 1
        return chunk_step(*a, **k)

    def wrap(name):
        fn = getattr(EngineCore, name)
        originals[name] = fn

        def timed(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            spans[name].append(time.monotonic() - t0)
            return out
        setattr(EngineCore, name, timed)

    wrap("_admit_one")
    wrap("_decode_pass")
    wrap("_chunk_pass")
    steps.chunk_step = counted
    try:
        eng = _engine(cfg, params, chunk_size)
        t0 = time.monotonic()
        done = cs._serve(eng, prompts)
        wall = time.monotonic() - t0
    finally:
        for name, fn in originals.items():
            setattr(EngineCore, name, fn)
        steps.chunk_step = chunk_step
    pre, dec = spans["_admit_one"], spans["_decode_pass"]
    chunk = spans["_chunk_pass"]
    toks = sum(len(r.tokens) for r in done)
    return {
        "wall_s": wall, "tokens": toks, "tok_per_s": toks / wall,
        "ttft_mean_ms": float(np.mean([r.ttft for r in done]) * 1e3),
        "tpot_mean_ms": float(np.mean([r.tpot for r in done]) * 1e3),
        "prefills": len(pre), "prefill_s": sum(pre),
        "prefill_mean_ms": float(np.mean(pre) * 1e3),
        "decode_passes": len(dec), "decode_s": sum(dec),
        "decode_mean_ms": float(np.mean(dec) * 1e3),
        "chunk_passes": forwards[0], "chunk_s": sum(chunk),
        "chunk_mean_ms": (float(sum(chunk) / forwards[0] * 1e3)
                          if forwards[0] else None),
        "other_s": wall - sum(pre) - sum(dec) - sum(chunk),
    }


def _group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:       # <DA, kPaged>: demangled or mangled
        paged = ", true>" in low or "lb1e" in low
        return ("paged_chunk_attention kernel" if paged
                else "flash_attention kernel")
    if "paged_decode" in low or "decode_merge" in low:
        return "paged_decode_attention kernels (split + merge)"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "nvjet", "matmul", "splitk")):
        return "matrix products"
    return "other kernels"


def _profiled_run(cfg, params, prompts, chunk_size):
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(cfg, params, chunk_size)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        cs._serve(eng, prompts)
        wall = time.monotonic() - t0
    groups = defaultdict(float)
    top = []
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0)
        if dev <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        groups[_group(evt.key)] += dev / 1e6
        top.append((dev / 1e6, evt.count, evt.key[:90]))
    busy = sum(groups.values())
    top.sort(reverse=True)
    return {
        "profiled_wall_s": wall, "device_busy_s": busy,
        "device_idle_share": (1 - busy / wall) if busy else None,
        "device_s_by_group": dict(groups),
        "top_kernels": [{"device_s": t, "calls": c, "name": n}
                        for t, c, n in top[:12]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="EngineConfig.chunk_size (0: whole prefill)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import gemma_2b
    card = cs.card_line()
    cfg = gemma_2b.CONFIG
    params = cs.full_width_params(cfg)
    prompts = cs._requests(cfg)
    cs._serve(_engine(cfg, params, args.chunk_size), prompts[:2],
              max_new=4)                                        # warm-up
    out = {"card": card, "chunk_size": args.chunk_size,
           "timed": _timed_run(cfg, params, prompts, args.chunk_size),
           "profiled": _profiled_run(cfg, params, prompts,
                                     args.chunk_size)}
    t, p = out["timed"], out["profiled"]
    print(f"[timed] chunk_size {args.chunk_size}, wall {t['wall_s']:.3f}s "
          f"({t['tok_per_s']:.2f} tok/s, TTFT mean {t['ttft_mean_ms']:.2f} "
          f"ms, TPOT mean {t['tpot_mean_ms']:.2f} ms): prefill "
          f"{t['prefill_s']:.3f}s ({t['prefills']} admissions x "
          f"{t['prefill_mean_ms']:.2f} ms), decode {t['decode_s']:.3f}s "
          f"({t['decode_passes']} x {t['decode_mean_ms']:.2f} ms), chunk "
          f"passes {t['chunk_s']:.3f}s ({t['chunk_passes']} that ran the "
          f"model, {t['chunk_mean_ms'] or 0:.2f} ms each), other "
          f"{t['other_s']:.3f}s")
    print(f"[profiled] wall {p['profiled_wall_s']:.3f}s, device busy "
          f"{p['device_busy_s']:.3f}s, idle share {p['device_idle_share']}")
    for g, s in sorted(p["device_s_by_group"].items(), key=lambda x: -x[1]):
        print(f"[profiled] {g}: {s:.4f}s")
    for k in p["top_kernels"]:
        print(f"[profiled]   {k['device_s']:.4f}s {k['calls']:6d}x "
              f"{k['name']}")
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
