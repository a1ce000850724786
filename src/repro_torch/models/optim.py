"""AdamW and its learning-rate schedule (twin of ``repro.models.optim``):
the JAX package's formulas and dtypes, written with plain tensor ops.

``m`` and ``v`` are fp32; the step count is a 0-d int32 tensor, moved on
first; the bias corrections are ``b ** step`` in fp32; gradients are
clipped by their global fp32 norm; a parameter becomes ``(p.f32 - lr ·
delta)`` cast back to its dtype. Where the JAX package returns new trees,
``adamw_update`` writes the new parameters, ``m`` and ``v`` into the
tensors it is given (a full-width train state holds two fp32 copies of
every weight; a second state would double them) and returns the same
trees. The update is elementwise, so it walks each leaf in slices of at
most ``SLICE_ELEMS`` along its first axis: the same values, with fp32
temporaries of a slice rather than of a whole stacked leaf (MiniCPM3-4B's
MLP ``wi`` is 2.0e9 entries, 8 GB a temporary).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch import tree

SLICE_ELEMS = 1 << 25


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(opt: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to 0 at ``total_steps``, in
    fp32 tensors as JAX computes it (``step``: a tensor or an int)."""
    step = torch.as_tensor(step).float()
    warm = opt.lr * (step + 1) / max(1, opt.warmup_steps)
    t = torch.clamp((step - opt.warmup_steps)
                    / max(1, opt.total_steps - opt.warmup_steps), 0.0, 1.0)
    cos = opt.lr * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < opt.warmup_steps, warm, cos)


def init_opt_state(params) -> Dict:
    zeros = lambda p: tree.map_tree(                          # noqa: E731
        lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device),
        p)
    dev = tree.leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over every leaf of its fp32 sum of squares (leaves in
    the JAX package's order). A leaf is summed in ``slices``: its fp32
    square whole would be 20 GB of temporaries at deepseek_v2_236b's
    experts of one MoE layer."""
    return torch.sqrt(sum(sum(torch.sum(torch.square(p.float()))
                              for p in slices(g))
                          for g in tree.leaves(grads)))


@torch.no_grad()
def adamw_update(params, grads, opt_state, opt: OptConfig,
                 gnorm: Optional[torch.Tensor] = None):
    """One AdamW step, in place (see the module docstring). Returns
    (params, {"m", "v", "step"}, the gradients' global norm before
    clipping). ``gnorm`` is that norm where the caller has it (the sharded
    step sums it over the shards); the update itself is elementwise, so on
    a rank's shards it is the same formulas, bit for bit."""
    step = opt_state["step"] + 1
    lr = lr_at(opt, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(opt.grad_clip / (gnorm + 1e-9), max=1.0)
    c1 = 1 - opt.b1 ** step.float()
    c2 = 1 - opt.b2 ** step.float()

    # JAX's operations in JAX's order, each rounded where JAX rounds it,
    # written in place where a temporary would hold a whole fp32 slice
    def upd(*leaf):
        for piece in zip(*(slices(t) for t in leaf)):
            upd_slice(*piece)

    def upd_slice(p, g, m, v):
        g = g.float() * scale
        m.mul_(opt.b1).add_((1 - opt.b1) * g)
        v.mul_(opt.b2).add_((1 - opt.b2) * g.square_())
        delta = (m / c1).div_((v / c2).sqrt_().add_(opt.eps))
        p32 = p.float()
        delta.add_(opt.weight_decay * p32)
        p.copy_(p32.sub_(delta.mul_(lr)))
    tree.map_tree(upd, params, grads, opt_state["m"], opt_state["v"])
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, gnorm


def slices(t):
    """Views of ``t``, each of at most SLICE_ELEMS entries: ``t`` itself if
    it is small or 0-d, else along its first axis, and a row larger than
    SLICE_ELEMS sliced so in turn (a stacked leaf of one layer is one row:
    deepseek_v2_236b's experts' ``wi`` of one MoE layer has 2.5e9
    entries)."""
    if t.ndim == 0 or t.numel() <= SLICE_ELEMS:
        return (t,)
    row = t.numel() // t.shape[0]
    if row > SLICE_ELEMS and t.ndim > 1:
        return tuple(p for r in t for p in slices(r))
    return torch.split(t, max(1, SLICE_ELEMS // row))
