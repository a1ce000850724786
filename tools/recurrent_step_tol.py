#!/usr/bin/env python3
"""Readings of ``chip_smoke.py``'s check of each recurrent decode step,
over seeds, from which its limit ``STEP_ROW_RTOL`` is set.

    python3 tools/recurrent_step_tol.py [--arch zamba2_7b xlstm_1_3b]
                                        [--seeds 0 1 2 3 4] [--steps N]

For zamba2_7b (81 Mamba2 layers) and xlstm_1_3b (42 mLSTM layers) at full
width, bf16, from ``chip_smoke.full_width_params`` at each seed (xLSTM's
perturbed at ``TRAIN_SHARE``, as phase ``recurrent`` checks it): a prompt
of 512 tokens (64 for xLSTM) drawn from the seed, prefilled, then 4 greedy
decode steps (1 for xLSTM), as phase ``recurrent`` runs them (``--steps``
sets both), every Mamba2 or mLSTM decode step held by
``chip_smoke.layer_checks(gate_steps=False)`` against the same step in
fp32 on its own inputs. For each config (``--arch``) and seed it prints the largest row error (||bf16 - fp32|| / ||fp32|| per output
row), the least row error of the control, which the check must fail (the
fp32 step given the state as it was before the last write, of the step
before or of the prefill), and the largest elementwise error as a share of
the elementwise bound. One JSON line per config and seed, with the card's
name and power limit; needs one CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PROMPT = {"zamba2_7b": 512, "xlstm_1_3b": 64}
STEP = {"zamba2_7b": "mamba2_decode", "xlstm_1_3b": "mlstm_decode"}
DECODES = {"zamba2_7b": 4, "xlstm_1_3b": 1}


def readings(arch: str, seed: int, n_steps: int) -> dict:
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    params = cs.full_width_params(cfg, seed, cs.TRAIN_SHARE.get(arch, 1.0))
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, PROMPT[arch]).astype(np.int32)
    with torch.no_grad(), cs.layer_checks(gate_steps=False) as held:
        cs._prefill_and_decode_dense(params, cfg, prompt, steps=n_steps)
    name = STEP[arch]
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "seed": seed, "step": name,
            "calls": held[name][0], "max_row_err": held[name][2],
            "min_control_row_err": held.controls[name],
            "limit": cs.STEP_ROW_RTOL[name],
            "max_elementwise_share_of_bound": held.bounds[name]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(cs.RECURRENT),
                    choices=cs.RECURRENT)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("recurrent_step_tol: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    card = cs.card_line()
    for arch in args.arch:
        for seed in args.seeds:
            out = readings(arch, seed, args.steps or DECODES[arch])
            print(json.dumps({**out, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
