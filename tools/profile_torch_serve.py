#!/usr/bin/env python3
"""Where the time goes in the port's serving paths on the card.

    python3 tools/profile_torch_serve.py [--engine paged chunked slot spec]
                                         [--eager] [--arch ARCH]

Runs the full-width Gemma-2B workloads of ``chip_smoke.py`` (16 seeded
requests, prompts 128-1024 tokens, 64 new tokens each, ``max_batch=8``,
``max_len=2048``, ``block_tokens=16``) through each named engine: the paged
``Engine`` with whole prefill, the chunked one (chunk 256), the dense
``SlotEngine`` and the speculative ``Engine`` (8 of the requests, the
target plus seeded noise as draft, ``spec_k = 4``). The engines' passes
replay as CUDA graphs; ``--eager`` builds them with ``cuda_graphs=False``
(run both in one call to compare). ``--arch`` serves another registered
config at full width instead of Gemma-2B; a recurrent one (``zamba2_7b``,
``xlstm_1_3b``) runs only its ``SlotEngine`` (``make_engine`` gives it no
other), on ``chip_smoke.py``'s recurrent requests (prompts of 64-1024
tokens its chunked prefill takes), and profiles a window of its decode
passes in place of the whole run (an xLSTM prefill launches ~25 kernels
per token per sLSTM layer, more events than the profiler can take over
16 prompts). For each engine, after a warm-up:

1. timed: every whole prefill (``steps.prefill_step``, the draft's
   included; chunked admissions run none) and every compiled pass is
   bracketed by ``torch.cuda.synchronize()`` on the host clock, which
   splits the wall time into prefill, each pass kind (passes counted as
   run, and their graph replays) and the rest (host bookkeeping, page
   writes, swaps);
2. profiled: ``torch.profiler`` over the same run gives device time by
   kernel name, grouped into the attention kernels (a decode-shaped
   kernel's split and merge together), matrix products and the rest, and
   the device's idle share of the wall time.

Prints one JSON line per engine with every number; needs one CUDA card and
the CUDA toolkit (the kernels build at first use).
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

ENGINES = ("paged", "chunked", "slot", "spec")


def _maker(kind, cfg, params):
    """(engine factory taking cuda_graphs, the prompts it serves)."""
    from repro_torch.engine.core import EngineConfig, SlotEngine
    from repro_torch.models.transformer import prefill_chunk
    if prefill_chunk(cfg):
        return (lambda **kw: SlotEngine(cfg, params=params, max_batch=8,
                                        max_len=2048, device="cuda", **kw),
                cs._recurrent_requests(cfg))
    prompts = cs._requests(cfg)
    if kind == "slot":
        return (lambda **kw: SlotEngine(cfg, params=params, max_batch=8,
                                        max_len=2048, device="cuda", **kw),
                prompts)
    if kind == "spec":
        draft = cs.noisy_draft_params(params, cfg, cs.SPEC_NOISE)
        config = EngineConfig(draft_cfg=cfg, spec_k=cs.SPEC_K)
        return (lambda **kw: cs._engine(cfg, params, draft_params=draft,
                                        config=config, **kw), prompts[:8])
    config = EngineConfig(chunk_size=cs.CHUNK if kind == "chunked" else 0)
    return lambda **kw: cs._engine(cfg, params, config=config, **kw), prompts


def _timed_run(make, prompts, graphs):
    from repro_torch.engine.graphs import CompiledPass
    from repro_torch.models import steps
    spans = defaultdict(list)
    originals = []

    def wrap(owner, attr, key):
        fn = getattr(owner, attr)
        originals.append((owner, attr, fn))

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[key(a)].append(time.monotonic() - t0)
            return out
        setattr(owner, attr, timed)

    eng = make(cuda_graphs=graphs)
    wrap(steps, "prefill_step", lambda a: "prefill")
    wrap(CompiledPass, "run", lambda a: a[0].name)
    try:
        t0 = time.monotonic()
        done = cs._serve(eng, prompts)
        wall = time.monotonic() - t0
    finally:
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)
    toks = sum(len(r.tokens) for r in done)
    out = {
        "wall_s": wall, "tokens": toks, "tok_per_s": toks / wall,
        "ttft_mean_ms": float(np.mean([r.ttft for r in done]) * 1e3),
        "tpot_mean_ms": float(np.mean([r.tpot for r in done]) * 1e3),
        "capture_s": {n: p.capture_s for n, p in eng.passes().items()},
        "warm_up_s": {n: p.warm_up_s for n, p in eng.passes().items()},
        "steps": eng.steps,
    }
    replays = {n: p.replays for n, p in eng.passes().items()}
    for name, t in spans.items():
        out[name] = {"count": len(t), "replays": replays.get(name),
                     "s": sum(t), "mean_ms": float(np.mean(t) * 1e3)}
    out["other_s"] = wall - sum(sum(t) for t in spans.values())
    if getattr(eng, "spec", False):
        out["tokens_per_step"] = eng.spec_stats()["tokens_per_step"]
    return out


def _group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:       # <DA, kPaged>: demangled or mangled
        paged = ", true>" in low or "lb1e" in low
        return ("paged_chunk_attention kernel" if paged
                else "flash_attention kernel")
    if "paged_verify" in low:
        return "paged_verify_attention kernels (split + merge)"
    if "paged_decode" in low:
        return "paged_decode_attention kernels (split + merge)"
    if "decode_kernel" in low:
        return "decode_attention kernels (split + merge)"
    if "decode_merge" in low:
        return "decode-shaped merge kernel (all three)"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "nvjet", "matmul", "splitk")):
        return "matrix products"
    return "other kernels"


def _profiled_run(make, prompts, graphs):
    from torch.profiler import ProfilerActivity, profile
    eng = make(cuda_graphs=graphs)
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


def _profiled_passes(make, prompts, graphs, n=20):
    """The recurrent cells: ``n`` decode passes profiled once every slot
    holds a request (the first ``max_batch`` prompts admitted and one pass
    run): device time per pass by kernel name, and the device's idle share
    of the window."""
    from torch.profiler import ProfilerActivity, profile
    eng = make(cuda_graphs=graphs)
    for p in prompts[:eng.max_batch]:
        eng.submit(p, max_new_tokens=n + 2)
    eng._admit()
    eng._step_decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            eng._step_decode()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    groups = defaultdict(float)
    top = []
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0)
        if dev <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        groups[_group(evt.key)] += dev / 1e6 / n
        top.append((dev / 1e6 / n, evt.count // n, evt.key[:90]))
    busy = sum(groups.values())
    top.sort(reverse=True)
    return {
        "passes": n, "wall_ms_per_pass": wall / n * 1e3,
        "device_ms_per_pass": busy * 1e3,
        "device_idle_share": (1 - busy * n / wall) if busy else None,
        "device_s_by_group": dict(groups),
        "top_kernels": [{"device_s": t, "calls": c, "name": n_}
                        for t, c, n_ in top[:16]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", nargs="+", choices=ENGINES,
                    default=list(ENGINES), help="engines to profile")
    ap.add_argument("--eager", action="store_true",
                    help="build the engines with cuda_graphs=False")
    ap.add_argument("--arch", default="gemma_2b",
                    help="the config served at full width (a recurrent "
                    "one runs the slot engine only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import prefill_chunk
    card = cs.card_line()
    cfg = get_config(args.arch)
    params = cs.full_width_params(cfg)
    graphs = not args.eager
    arm = "graphed" if graphs else "eager"
    kinds = ["slot"] if prefill_chunk(cfg) else args.engine
    for kind in kinds:
        make, prompts = _maker(kind, cfg, params)
        cs._serve(make(cuda_graphs=graphs), prompts[:2],
                  max_new=4)                                    # warm-up
        out = {"card": card, "arch": args.arch, "engine": kind, "arm": arm,
               "timed": _timed_run(make, prompts, graphs)}
        if prefill_chunk(cfg):
            out["profiled"] = p = _profiled_passes(make, prompts, graphs)
            print(f"[profiled] {args.arch} {arm}: {p['passes']} decode "
                  f"passes at 8 slots, wall {p['wall_ms_per_pass']:.3f} ms "
                  f"a pass, device busy {p['device_ms_per_pass']:.3f} ms, "
                  f"idle share {p['device_idle_share']}")
        else:
            out["profiled"] = _profiled_run(make, prompts, graphs)
        t, p = out["timed"], out["profiled"]
        passes = ", ".join(
            f"{n} {v['s']:.3f}s ({v['count']} x {v['mean_ms']:.2f} ms, "
            f"{v['replays']} replays)" for n, v in t.items()
            if isinstance(v, dict) and "count" in v)
        print(f"[timed] {kind} {arm}: wall {t['wall_s']:.3f}s "
              f"({t['tok_per_s']:.2f} tok/s, TTFT mean "
              f"{t['ttft_mean_ms']:.2f} ms, TPOT mean {t['tpot_mean_ms']:.2f}"
              f" ms): {passes}; other {t['other_s']:.3f}s")
        if "profiled_wall_s" in p:
            print(f"[profiled] {kind} {arm}: wall "
                  f"{p['profiled_wall_s']:.3f}s, device busy "
                  f"{p['device_busy_s']:.3f}s, idle share "
                  f"{p['device_idle_share']}")
        for g, sec in sorted(p["device_s_by_group"].items(),
                             key=lambda x: -x[1]):
            print(f"[profiled]   {g}: {sec:.4f}s")
        for k in p["top_kernels"]:
            print(f"[profiled]     {k['device_s']:.4f}s {k['calls']:6d}x "
                  f"{k['name']}")
        print(json.dumps(out))
        del make
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
