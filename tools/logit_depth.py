#!/usr/bin/env python3
"""How far the full model's logits through the attention kernels drift from
plain attention's as the model deepens (card).

    python3 tools/logit_depth.py [--arch internlm2_20b pixtral_12b ...]

For each config at full width (bf16, ``chip_smoke.full_width_params``: the
same seeded, perturbed weights as ``chip_smoke.py``'s families phase, depth
cut as there), the last-position logits of one 300-token prefill through
the first L layers, for a sweep of L, three ways (``prefill_three_ways``):

- ``kernels``: ``flash_attention`` as the model runs it;
- ``plain``: ``ref.flash_attention`` (fp32 scores, softmax and P·V);
- ``plain, P bf16``: ``chip_smoke.flash_p_bf16``, the same with the
  unnormalised probabilities rounded to bf16 before P·V and the row sums
  kept in fp32, the rounding the kernel makes.

Prints, per depth, max |a - b| over max |plain logit| for each pair. Where
``plain, P bf16`` sits as far from ``plain`` as the kernels do, the drift is
the model's sensitivity to one bf16 rounding of P in every layer, not a
fault of the kernel. For a MoE config it also prints the share of (token,
MoE layer) top-k expert choices that differ from plain attention's, and
the first MoE layer where one does: a token routed to other experts takes
another path through the layer, which no tolerance of the attention
bounds. Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

# (arch, layers made, depths swept); gemma_2b is the serving phases' model
SWEEP = (("gemma_2b", None, (6, 12, 18)),
         ("internlm2_20b", None, (8, 16, 24, 32, 40, 48)),
         ("llama3_70b", 16, (4, 8, 16)),
         ("pixtral_12b", None, (8, 16, 24, 32, 40)),
         ("nemotron_4_340b", 2, (1, 2)),
         ("minicpm3_4b", None, (16, 31, 62)),
         ("deepseek_v2_lite_16b", None, (2, 4, 8, 16, 27)),
         ("deepseek_v2_236b", 5, (2, 3, 5)))


def prefill_three_ways(params, cfg, prompt):
    """Last-position prefill logits of ``prompt`` with the model's flash
    attention through the kernel, plain attention and ``cs.flash_p_bf16``,
    and each arm's sorted top-k expert ids per MoE layer (none for a dense
    config)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe, steps
    out, routes = [], []
    router = moe._router
    for flash in (ops.flash_attention, ref.flash_attention,
                  cs.flash_p_bf16):
        chosen = []

        def record(p, x2d, c, _chosen=chosen):
            w, idx, aux = router(p, x2d, c)
            _chosen.append(idx.sort(dim=-1).values)
            return w, idx, aux
        saved, ops.flash_attention = ops.flash_attention, flash
        moe._router = record
        try:
            logits, _ = steps.prefill_step(params, {"tokens": torch.as_tensor(
                prompt[None], device="cuda")}, cfg, 512)
        finally:
            ops.flash_attention, moe._router = saved, router
        out.append(logits[0].float())
        routes.append(chosen)
    return out, routes


def routing_line(routes) -> str:
    """The share of (token, MoE layer) expert choices of the kernels' and
    of the P bf16 arm that differ from plain attention's, and the first
    MoE layer (0-based) where the kernels' do."""
    if not routes[0]:
        return ""

    def differ(a, b):
        return torch.stack([(x != y).any(-1) for x, y in zip(a, b)]).float()
    kern, pbf = differ(routes[0], routes[1]), differ(routes[2], routes[1])
    first = [i for i, row in enumerate(kern) if row.any()]
    return (f"; tokens routed to other experts than plain attention's, "
            f"share of (token, MoE layer): kernels {float(kern.mean()):.4f}, "
            f"plain P bf16 {float(pbf.mean()):.4f}; first MoE layer where "
            f"the kernels' differ: {first[0] if first else None}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=[a for a, _, _ in SWEEP])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("logit_depth: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    arms = ("kernels", "plain", "plain, P bf16")
    for arch, layers, depths in SWEEP:
        if arch not in args.arch:
            continue
        full = get_config(arch)
        cfg = full.replace(num_layers=layers or full.num_layers)
        params = cs.full_width_params(cfg)
        prompt = np.random.default_rng(1).integers(
            0, cfg.vocab_size, 300).astype(np.int32)
        for depth in depths:
            c = cfg.replace(num_layers=depth)
            logits, routes = prefill_three_ways(params, c, prompt)
            out = dict(zip(arms, logits))
            scale = float(out["plain"].abs().max())
            rel = lambda a, b: float(  # noqa: E731
                (out[a] - out[b]).abs().max()) / scale
            print(f"[depth] {arch} {depth} of {full.num_layers} layers: max "
                  f"|logit| {scale:.4g}; max |diff| / max |logit|: kernels "
                  f"vs plain {rel('kernels', 'plain'):.4f}, plain P bf16 vs "
                  f"plain {rel('plain, P bf16', 'plain'):.4f}, kernels vs "
                  f"plain P bf16 {rel('kernels', 'plain, P bf16'):.4f}; "
                  f"argmax kernels | plain | P bf16: "
                  f"{[int(out[n].argmax()) for n in arms]}"
                  f"{routing_line(routes)}", flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
