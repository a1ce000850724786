#!/usr/bin/env python3
"""Where the time goes in a full-width train step of the port on the card.

    python3 tools/profile_torch_train.py [--arch gemma_2b minicpm3_4b ...]
                                         [--steps 3]

For each config of ``chip_smoke.py``'s phase ``train`` (``TRAIN_RUNS``:
gemma_2b, hubert_xlarge, minicpm3_4b, deepseek_v2_lite_16b, zamba2_7b and
xlstm_1_3b, each at the phase's depth and remat; ``--arch`` picks among
them), from the phase's seeded perturbed weights at bf16, on batches of 4 x
1024 tokens from ``data.pipeline.batch_at``, after two warm-up steps:

1. timed: ``--steps`` steps, each split on the host clock (bracketed by
   ``torch.cuda.synchronize()``) into the forward and backward
   (``steps.value_and_grad``) and the optimizer (``optim.adamw_update``);
2. profiled: the same number of steps under ``torch.profiler`` (device
   activity only), device time by kernel name grouped into flash
   attention's forward, its backward (the D, dK/dV, dQ and partial-sum
   kernels), matrix products and the rest, and the device's idle share of
   the wall time;
3. the peak memory allocated over the run.

Prints one JSON line per config with every number and the card's name and
power limit; needs one CUDA card and the CUDA toolkit (the kernels build at
first use).
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


def _group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_attention forward kernel"
    if any(w in low for w in ("bwd_dot", "bwd_dkdv", "bwd_dq", "bwd_sum")):
        return "flash_attention_bwd kernels (D, dK/dV, dQ, partial sum)"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "nvjet", "matmul", "splitk")):
        return "matrix products"
    return "other kernels"


def _batches(cfg, n, b, s):
    from repro_torch.data.pipeline import DataConfig, batch_at
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b)
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in batch_at(dc, i).items()} for i in range(n)]


def _step(state, batch, cfg, opt, marks=None):
    """One train step as ``steps.train_step`` runs it, with the host clock
    read after its forward and backward and after its optimizer."""
    from repro_torch.models import optim, steps
    (_, (loss, _)), grads = steps.value_and_grad(state["params"], batch, cfg)
    if marks is not None:
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    optim.adamw_update(state["params"], grads, state["opt"], opt)
    if marks is not None:
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    return loss


def profile_arch(arch: str, layers, remat: str, n: int, b: int, s: int,
                 card: str):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.optim import OptConfig
    cfg = get_config(arch)
    cfg = cfg.replace(num_layers=layers or cfg.num_layers, remat=remat)
    torch.cuda.reset_peak_memory_stats()
    opt = OptConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    share = cs.TRAIN_SHARE.get(arch, 1.0)
    state = cs._state_fn(share=share)(cfg, "cuda")
    batches = _batches(cfg, 2 + 2 * n, b, s)
    for batch in batches[:2]:
        _step(state, batch, cfg, opt)
    torch.cuda.synchronize()
    fb, op = [], []
    for batch in batches[2:2 + n]:
        marks = [time.perf_counter()]
        _step(state, batch, cfg, opt, marks)
        fb.append(marks[1] - marks[0])
        op.append(marks[2] - marks[1])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[2 + n:]:
            _step(state, batch, cfg, opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, top = defaultdict(float), []
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
    flops = cs._train_flops(cfg, b, s)
    step = float(np.median(np.add(fb, op)))
    return {
        "arch": arch, "layers": cfg.num_layers, "remat": remat,
        "batch": b, "seq": s, "steps": n,
        "step_s": step, "fwd_bwd_s": float(np.median(fb)),
        "optimizer_s": float(np.median(op)), "tokens_per_s": b * s / step,
        "model_tflop_per_step": flops / 1e12,
        "model_tflops": flops / step / 1e12,
        "share_of_peak": flops / step / cs.PEAK_BF16_FLOPS,
        "profiled_step_s": wall / n, "device_busy_s_per_step": busy,
        "device_idle_share": 1 - busy * n / wall,
        "device_s_per_step_by_group": dict(groups),
        "top_kernels": [{"device_s": t, "calls": c, "name": nm}
                        for t, c, nm in top[:12]],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=list(cs.TRAIN_ARCHS), choices=cs.TRAIN_ARCHS)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    for arch, layers, remat in cs.TRAIN_RUNS:
        if arch in args.arch:
            out = profile_arch(arch, layers, remat, args.steps,
                               cs.TRAIN_BATCH, cs.TRAIN_SEQ, card)
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
