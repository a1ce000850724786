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

``--train --layers``: where the ranks' bf16 gradient parts from the one
process's. One backward of the same zamba2_7b run (step 1's batch, at
each seed) in the ranks and, in rank 0 before them, in one process in
fp32 (plain attention), in bf16 over the whole batch and in bf16 over
each data shard's rows alone (as a data rank computes them). Each
Mamba2 layer's forward keeps the gradient of six of its tensors
(``LAYER_OPS``, from its output back to its input: ``out`` after the
row-parallel ``out_proj``, ``normed`` after the gated RMSNorm, ``skip``
after the D skip (the SSD scan's output takes the same gradient),
``xh`` the conv's x heads that the scan and the D skip read,
``zxbcdt`` after ``in_proj`` and ``x``, the layer's input), and the step its gradient of
D. For each layer, from the loss back, and each tensor it prints 1 -
cosine to the fp32 gradient of the ranks' (assembled from their pieces:
B's and C's columns summed over "model"), of the data shards', of the
whole batch's, and 1 - cosine of the ranks' to the data shards'
(``ranks_vs_one``), and names the first layer and tensor, from the loss
back, where ``ranks_vs_one`` exceeds the data shards' own distance to
fp32 by ``PART_FACTOR``. Beside them the control: the one process with
every sum the ranks split over "model" split alike (``_mamba2_traced``'s
``split``), its 1 - cosine to fp32 and to the one process
(``control_vs_one``): where the ranks part from the one process by
rounding alone, the control parts as far.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
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


LAYER_OPS = ("out", "normed", "skip", "xh", "zxbcdt", "x")
# ``ranks_vs_one`` over the data shards' own 1 - cosine to fp32 past which
# a tensor counts as parted (two bf16 gradients rounded in other orders
# read up to ~1 against each other)
PART_FACTOR = 2.0


def _split_sum(parts, dtype):
    """``parts`` summed as ``distributed.all_reduce`` sums them over their
    count of ranks: two bf16 parts in bf16, more in fp32 and rounded once;
    fp32 parts in fp32."""
    if dtype == torch.float32 or len(parts) > 2:
        return sum(p.float() for p in parts).to(dtype)
    return parts[0] + parts[1]


def _row_parts(x, w, m: int, fp32: bool = False):
    """``x @ w`` as ``m`` model ranks make it: the contracted dim in ``m``
    blocks, each block's product (its fp32 accumulator with ``fp32``, as
    ``Layout.row_parallel``; else rounded to x's dtype, as a reduce-out of
    the ranks' products) summed by ``_split_sum``."""
    from repro_torch.models.layers import mm_fp32
    c = w.shape[0] // m
    prod = mm_fp32 if fp32 else (lambda a, b: a @ b)
    parts = [prod(x[..., i * c:(i + 1) * c], w[i * c:(i + 1) * c])
             for i in range(m)]
    return _split_sum(parts, torch.float32 if fp32 else x.dtype).to(x.dtype)


@contextlib.contextmanager
def _mamba2_traced(store, n_layers, split: int = 1):
    """While open, ``mamba2.mamba2_forward`` computes as it does and hooks
    each ``LAYER_OPS`` tensor of its first ``n_layers`` calls (the
    forward; remat's recomputes come after it and compute alike) to keep
    its gradient in host memory, ``store[layer][op]``. With ``split`` > 1 (one process
    only) every sum the ranks of a model axis of that size split is split
    alike (the control): the gated norm's sum of squares and ``out_proj``
    as fp32 partials, the shared block's ``wo`` and MLP ``wo`` as bf16
    partials (a reduce-out under autograd)."""
    import torch.nn.functional as F
    from repro_torch.models import attention, layers
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm, rms_norm_split
    saved, calls = m2.mamba2_forward, [0]
    saved_attn, saved_mlp = attention._attn_out, layers.apply_mlp

    def split_norm(y, gamma, eps):
        dt, y = y.dtype, y.float()
        c = y.shape[-1] // split
        ss = _split_sum([y[..., i * c:(i + 1) * c].square().sum(
            -1, keepdim=True) for i in range(split)], torch.float32)
        out = y * torch.rsqrt(ss / y.shape[-1] + eps)
        return (out * (1.0 + gamma.float())).to(dt)

    def fwd(params, x, cfg, return_state=False, tp=None):
        i = calls[0]
        calls[0] += 1

        def keep(op, t):
            if i < n_layers and t.requires_grad:
                t.register_hook(lambda g: store.setdefault(
                    i, {}).__setitem__(op, g.detach().cpu()))
            return t
        heads = m2.split_heads(tp)
        keep("x", x)
        xin = tp.copy_in(x) if heads else x
        z, xh, B, C, dt, A, window = m2._gates(
            params, keep("zxbcdt", xin @ params["in_proj"]), cfg, tp=tp)
        keep("xh", xh)
        y, final = m2._ssd_chunked(xh, dt, B, C, A, cfg.ssm.chunk_size)
        y = y + params["D"].float()[None, None, :, None] * xh.float()
        y = keep("skip", y).reshape(*x.shape[:2], m2._local_dims(cfg, tp)[0])
        y = y.to(x.dtype) * F.silu(z)
        if heads:
            y = keep("normed", rms_norm_split(y, params["norm"],
                                              cfg.norm_eps, tp))
            out = tp.row_parallel(y, params["out_proj"])
        elif split > 1:
            y = keep("normed", split_norm(y, params["norm"], cfg.norm_eps))
            out = _row_parts(y, params["out_proj"], split, fp32=True)
        else:
            y = keep("normed", rms_norm(y, params["norm"], cfg.norm_eps))
            out = y @ params["out_proj"]
        state = {"conv": window, "ssm": final} if return_state else None
        return keep("out", out), state
    m2.mamba2_forward = fwd
    if split > 1:
        def attn_out(out, params, tp=None):
            wo = params["wo"]
            return _row_parts(out.flatten(-2), wo.reshape(-1, wo.shape[-1]),
                              split)

        def apply_mlp(params, x, cfg, tp=None):
            return _row_parts(layers._mlp_hidden(params, x, cfg),
                              params["wo"], split)
        attention._attn_out = attn_out
        layers.apply_mlp = tf.apply_mlp = apply_mlp
    try:
        yield store
    finally:
        m2.mamba2_forward = saved
        attention._attn_out = saved_attn
        layers.apply_mlp = tf.apply_mlp = saved_mlp


def _traced_grads(params, batch, cfg, rules=None, mesh=None, split=1):
    """One ``steps.value_and_grad`` under ``_mamba2_traced``: (the kept
    tensors' gradients by layer and op, the gradient of D (L, heads))."""
    from repro_torch.models import steps
    store = {}
    with _mamba2_traced(store, cfg.num_layers, split):
        _, g = steps.value_and_grad(params, batch, cfg, rules, mesh)
    return store, g["mamba"]["D"].detach().cpu()


def _shard_refs(params, batch, cfg, data: int):
    """The one process's bf16 gradients over each of ``data`` shards of
    the batch's rows alone, assembled: the kept tensors' concatenated
    over the rows, each over ``data`` (a shard's loss is its own mean);
    D's summed in fp32 over ``data`` and rounded once, as the ranks'
    data-axes sum (``chip_smoke._train_reference``)."""
    n = len(batch["labels"]) // data
    parts, d_sum = [], None
    for d in range(data):
        shard = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
        store, dg = _traced_grads(params, shard, cfg)
        parts.append(store)
        d_sum = dg.float() / data if d_sum is None else d_sum + \
            dg.float() / data
    store = {i: {op: torch.cat([p[i][op] for p in parts]) / data
                 for op in parts[0][i]} for i in parts[0]}
    return store, d_sum.to(dg.dtype)


def _assemble(pieces, cfg, shape):
    """The whole kept gradients from the ranks' ``pieces`` (rank d * M +
    m of mesh (data D, model M)): ``x`` and ``out`` whole on each model
    rank, ``xh`` and ``skip`` its heads, ``normed`` its d_inner,
    ``zxbcdt`` its z, x and dt channels and B and C whole, a partial
    sum over its heads (summed over "model" here)."""
    from repro_torch.models import mamba2 as m2
    data, model = shape
    d_in, nh, n, _, _ = m2._dims(cfg)
    sizes = [d_in // model, d_in // model, n, n, nh // model]

    def whole(i, op, d):
        ps = [pieces[d * model + m][i][op] for m in range(model)]
        if op in ("x", "out"):
            return ps[0]
        if op in ("xh", "skip"):
            return torch.cat(ps, 2)
        if op == "normed":
            return torch.cat(ps, -1)
        cut = [p.split(sizes, -1) for p in ps]
        return torch.cat([torch.cat([c[j] for c in cut], -1)
                          for j in (0, 1)]
                         + [sum(c[j].float() for c in cut).to(ps[0].dtype)
                            for j in (2, 3)]
                         + [torch.cat([c[4] for c in cut], -1)], -1)
    return {i: {op: torch.cat([whole(i, op, d) for d in range(data)])
                for op in pieces[0][i]} for i in pieces[0]}


def _one_minus_cos(a, b) -> float:
    dot, na, nb = cs._cos_terms([(a.cuda(), b.cuda())]).tolist()
    return 1 - cs._cos_of(dot, na, nb)


def _layer_grads_rank(rank, world, out_dir, shape, seed):
    """One rank of ``--layers``: rank 0 first runs the one-process
    references (``_traced_grads`` in fp32 and bf16, ``_shard_refs``),
    then every rank its traced sharded backward, saving its pieces;
    rank 0 then assembles them (``_assemble``) and writes the readings
    to ``layers.json``."""
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import sharding
    arch, layers = TRAIN_RUN[:2]
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(num_layers=layers)
    batch = cs._dist_batches(cfg, 1, *TRAIN_RUN[4:])[0]
    mesh = compat_make_mesh(shape, ("data", "model"))
    rules = sharding.ShardingRules(mesh)
    refs = {}
    if rank == 0:
        params = cs.seeded_params(cfg, seed)
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        p32 = tree.map_tree(lambda t: t.float(), params)
        with cs.plain_attention():
            refs["fp32"] = _traced_grads(p32, batch, cfg32)
        del p32
        refs["whole"] = _traced_grads(params, batch, cfg)
        refs["split"] = _traced_grads(params, batch, cfg, split=shape[1])
        refs["shards"] = (_shard_refs(params, batch, cfg, shape[0])
                          if shape[0] > 1 else refs["whole"])
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    params = cs.seeded_params(cfg, seed, rules, mesh)
    mine = _traced_grads(params, batch, cfg, rules, mesh)
    del params
    torch.cuda.empty_cache()
    torch.save(mine, os.path.join(out_dir, f"layers_rank{rank}.pt"))
    del mine
    dist.barrier()
    if rank != 0:
        return
    got = [torch.load(os.path.join(out_dir, f"layers_rank{r}.pt"))
           for r in range(world)]
    ranks = _assemble([g[0] for g in got], cfg, shape)
    d_ranks = torch.cat([got[m][1] for m in range(shape[1])], 1)
    del got
    (g32, d32), (gw, dw), (gs, ds), (gc, dc) = (
        refs["fp32"], refs["whole"], refs["shards"], refs["split"])
    out = []
    for i in sorted(ranks, reverse=True):
        row = {"layer": i + 1}
        for op in LAYER_OPS:
            row[op] = {"ranks": _one_minus_cos(ranks[i][op], g32[i][op]),
                       "one": _one_minus_cos(gs[i][op], g32[i][op]),
                       "whole": _one_minus_cos(gw[i][op], g32[i][op]),
                       "ranks_vs_one": _one_minus_cos(ranks[i][op],
                                                      gs[i][op]),
                       "control": _one_minus_cos(gc[i][op], g32[i][op]),
                       "control_vs_one": _one_minus_cos(gc[i][op],
                                                        gw[i][op])}
        row["D"] = {"ranks": _one_minus_cos(d_ranks[i], d32[i]),
                    "one": _one_minus_cos(ds[i], d32[i]),
                    "whole": _one_minus_cos(dw[i], d32[i]),
                    "ranks_vs_one": _one_minus_cos(d_ranks[i], ds[i]),
                    "control": _one_minus_cos(dc[i], d32[i]),
                    "control_vs_one": _one_minus_cos(dc[i], dw[i])}
        out.append(row)
    with open(os.path.join(out_dir, "layers.json"), "w") as f:
        json.dump(out, f)


def _parted(row, op) -> bool:
    r = row[op]
    return r["ranks_vs_one"] > PART_FACTOR * max(r["one"], 1e-12)


def layer_readings(seed: int, shape=TRAIN_RUN[2]) -> dict:
    """``--layers`` at ``seed`` on mesh ``shape``: per Mamba2 layer, from
    the loss back, the readings of ``_layer_grads_rank``, and the first
    parted (layer, tensor) from the loss back (``_parted``; within a
    layer from its output back)."""
    import shutil
    from repro_torch.launch import mesh
    out_dir = ROOT / "build" / "recurrent_step_tol"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    mesh.spawn(_layer_grads_rank, shape[0] * shape[1],
               (str(out_dir), tuple(shape), seed))
    rows = json.loads((out_dir / "layers.json").read_text())
    first = next(((r["layer"], op) for r in rows
                  for op in (*LAYER_OPS, "D") if _parted(r, op)), None)
    return {"arch": TRAIN_RUN[0], "layers": TRAIN_RUN[1], "seed": seed,
            "mesh": list(shape), "part_factor": PART_FACTOR,
            "first_parted": first, "by_layer": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(cs.RECURRENT),
                    choices=cs.RECURRENT)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--layers", action="store_true")
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
    if args.train and args.layers:
        for seed in args.seeds:
            print(json.dumps({**layer_readings(seed, args.mesh),
                              "card": card}), flush=True)
        return 0
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
