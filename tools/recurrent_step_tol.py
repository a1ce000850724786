#!/usr/bin/env python3
"""Readings of ``chip_smoke.py``'s check of each recurrent decode step,
over seeds, from which its limit ``STEP_ROW_RTOL`` is set; with
``--train``, of phase dist_train_all's gradient gate of the hybrid
family, from which ``DIST_COND_FACTOR`` is set.

    python3 tools/recurrent_step_tol.py [--arch zamba2_7b xlstm_1_3b]
                                        [--seeds 0 1 2 3 4] [--steps N]
    python3 tools/recurrent_step_tol.py --train [--seeds 0 1 2 3 4]
                                        [--fault-seeds 0] [--mesh 2 2]

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

``--train``: for each seed, ``chip_smoke._dist_train_rank`` on zamba2_7b
(14 of 81 layers, full width, bf16, mesh (2, 2), 4 gloo ranks on the
card, one train step of 4 x 1024 tokens from ``seeded_params`` at that
seed) and the one process beside it: the ranks' gradient's 1 - cosine
to the fp32 gradient at the same weights over that of the one process's
bf16 gradient summed from its data shards' (``chip_smoke.cond_ratios``),
of the whole gradient and of its Mamba2 B and C pieces (the gated ones,
``chip_smoke.COND_GATED``), of every leaf (the largest, and Mamba2's
D's), the same over the one process's whole-batch bf16 gradient, the
1 - cosines themselves, the losses and grad norms; and the control's
(the B and C pieces as a rank holds them before their sum over "model"),
which the gate must refuse, and the least single-leaf control's. With
``--fault-seeds``, also those seeds' readings with
a fault planted outside the B and C pieces in every rank: the gated
norms' sum over "model" (``distributed._SumBoth``) given the identity
backward, as if each rank's sum of squares fed only its own heads; the
gate must refuse it too. ``--mesh`` (data, model) runs the ranks on
another mesh (its product the number of ranks).
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


TRAIN_RUN = ("zamba2_7b", 14, (2, 2), False, 4, 1024)


def _faulty_rank(rank, world, *args):
    """``chip_smoke._dist_train_rank`` with ``distributed._SumBoth``'s
    backward the identity."""
    from repro_torch import distributed as D
    D._SumBoth.backward = staticmethod(lambda ctx, g: (g, None))
    cs._dist_train_rank(rank, world, *args)


class _ColumnFp32(torch.autograd.Function):
    """``x @ w`` for ``w`` sharded on its output dim over the model axis
    ``ax``: the bf16 product forward; backward, each rank's gradient of
    ``x`` kept in fp32, summed over "model" and rounded once (in place of
    copy-in's sum of bf16 partials)."""

    @staticmethod
    def forward(ctx, x, w, ax):
        ctx.save_for_backward(x, w)
        ctx.ax = ax
        return x @ w

    @staticmethod
    def backward(ctx, g):
        from repro_torch import distributed as D
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = D.all_reduce(torch.mm(g2, w.T, out_dtype=torch.float32), ctx.ax)
        return (dx.to(x.dtype).reshape(x.shape),
                x.reshape(-1, x.shape[-1]).T @ g2, None)


def _variant_rank(rank, world, variant, *args):
    """``chip_smoke._dist_train_rank`` with the sharded schedule's
    numerics changed (a diagnostic): "row_fp32", the shared block's
    attention and MLP outputs summed as fp32 partials (``row_parallel``)
    in training too; "copy_in_fp32", each Mamba2 ``in_proj``'s gradient of
    its input summed over "model" in fp32 (``_ColumnFp32``);
    "fp32", the ranks and the one process in fp32 with plain attention
    (the kernels take bf16); "no_bf16_reduction", cuBLAS's reduced
    precision (bf16) split-K reductions turned off, in the ranks and the
    one process; "head_fp32", the vocabulary-parallel head's product in
    fp32 (its input cast up at the copy-in in front of it, so each rank's
    gradient of the input is an fp32 partial, summed over "model" in fp32
    and rounded once)."""
    from repro_torch import configs
    from repro_torch.models import attention, layers, mamba2, moe
    from repro_torch.models import transformer as tf
    if variant == "head_fp32":
        from repro_torch import distributed as D
        saved_copy = D.copy_in

        def copy_in(x, ax):
            # the head's copy-in alone: the one ``transformer._run`` makes
            if sys._getframe(1).f_code.co_name == "_run":
                return saved_copy(x.float(), ax)
            return saved_copy(x, ax)
        D.copy_in = copy_in
    if variant == "no_bf16_reduction":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    if variant == "fp32":
        saved_get = configs.get_config
        configs.get_config = lambda arch: saved_get(arch).replace(
            param_dtype="float32", compute_dtype="float32")
        with cs.plain_attention():
            return cs._dist_train_rank(rank, world, *args)
    if variant == "row_fp32":
        def attn_out(out, params, tp=None):
            split = attention._attn_split(tp)
            if split is None:
                return attention._proj_out(out, params["wo"])
            if split == "whole":
                out = attention.local_slice(out, -1, tp.model)
            wo = params["wo"]
            return tp.row_parallel(out.flatten(-2),
                                   wo.reshape(-1, wo.shape[-1]))
        saved_mlp = layers.apply_mlp

        def apply_mlp(params, x, cfg, tp=None):
            if tp is not None and tp.dim("wo") is not None:
                return tp.row_parallel(layers._mlp_hidden(
                    params, tp.copy_in(x), cfg), params["wo"])
            return saved_mlp(params, x, cfg, tp)
        attention._attn_out = attn_out
        layers.apply_mlp = tf.apply_mlp = moe.apply_mlp = apply_mlp
    if variant == "copy_in_fp32":
        saved_fwd = mamba2.mamba2_forward

        def mamba2_forward(params, x, cfg, return_state=False, tp=None):
            if not mamba2.split_heads(tp):
                return saved_fwd(params, x, cfg, return_state, tp)
            z, xh, B, C, dt, A, window = mamba2._gates(
                params, _ColumnFp32.apply(x, params["in_proj"], tp.model),
                cfg, tp=tp)
            y, final = mamba2._ssd_chunked(xh, dt, B, C, A,
                                           cfg.ssm.chunk_size)
            y = y + params["D"].float()[None, None, :, None] * xh.float()
            return mamba2._out(params, y, z, x, cfg, tp), None
        mamba2.mamba2_forward = mamba2_forward
    cs._dist_train_rank(rank, world, *args)


def train_readings(seed: int, fault: bool = False,
                   shape=TRAIN_RUN[2], variant: str = "none") -> dict:
    import shutil
    from repro_torch.launch import mesh
    out_dir = ROOT / "build" / "recurrent_step_tol"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    run = (*TRAIN_RUN[:2], tuple(shape), *TRAIN_RUN[3:])
    args = (str(out_dir), (run,), 1, False, seed)
    if variant != "none":
        fn, args = _variant_rank, (variant, *args)
    else:
        fn = _faulty_rank if fault else cs._dist_train_rank
    mesh.spawn(fn, shape[0] * shape[1], args)
    r = json.loads((out_dir / "train_rank0.json").read_text())[
        cs._train_tag(*run[:4])]
    ratio, ctrl = cs.cond_ratios(r)
    worst, least = cs.cond_gate(r)
    top = max(ratio.items(), key=lambda kv: kv[1])
    whole = {k: (1 - v) / max(1e-6, 1 - r["one_cos32"][k])
             for k, v in r["cos32"].items() if not k.endswith(" control")}
    return {"arch": TRAIN_RUN[0], "seed": seed, "fault": fault,
            "mesh": list(shape), "variant": variant,
            "gated": {k: ratio[k] for k in cs.COND_GATED},
            "control": least[1], "limit": cs.DIST_COND_FACTOR,
            "passes": worst[1] <= cs.DIST_COND_FACTOR < least[1],
            "max_leaf": top[1], "max_leaf_at": top[0],
            "D": ratio["mamba/D"],
            "least_leaf_control": min(ctrl.values(), default=0.0),
            "over_whole_batch": {"max": max(whole.values()),
                                 "D": whole["mamba/D"]},
            "ratios": ratio,
            "one_minus_cos": {k: {"ranks": 1 - v,
                                  "data_shards": 1 - r["split_cos32"][k],
                                  "whole_batch": 1 - r["one_cos32"][k]}
                              for k, v in r["cos32"].items()
                              if not k.endswith(" control")},
            "cos_ranks_to_one_process_bf16": r["cos"],
            "loss_grad_norm": {"ranks": [r["mets"][0][k] for k in
                                         ("loss", "grad_norm")],
                               "one_process": [r["one_mets"][0][k] for k in
                                               ("loss", "grad_norm")]},
            "least_cos_to_one_process_bf16": min(r["cos"].values()),
            "seconds": {"ref": r["ref_s"], "steps": r["secs"],
                        "cos": r["cos_s"], "run": r["run_s"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(cs.RECURRENT),
                    choices=cs.RECURRENT)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--mesh", type=int, nargs=2, default=TRAIN_RUN[2])
    ap.add_argument("--variant", default="none",
                    choices=("none", "row_fp32", "copy_in_fp32", "fp32",
                             "no_bf16_reduction", "head_fp32"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("recurrent_step_tol: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    card = cs.card_line()
    if args.train:
        for seed, fault in ([(s, False) for s in args.seeds]
                            + [(s, True) for s in args.fault_seeds]):
            print(json.dumps({**train_readings(seed, fault, args.mesh,
                                               args.variant),
                              "card": card}), flush=True)
        return 0
    for arch in args.arch:
        for seed in args.seeds:
            out = readings(arch, seed, args.steps or DECODES[arch])
            print(json.dumps({**out, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
