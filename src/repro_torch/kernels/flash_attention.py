"""CUDA flash-attention kernels: the wrappers around
``csrc/flash_attention.cu`` (the forward, optionally with each row's
logsumexp) and ``csrc/flash_attention_bwd.cu`` (its gradient), and the
``torch.autograd.Function`` that joins them for training.

The forward replaces the Pallas kernel
``repro.kernels.flash_attention.flash_attention``; the backward replaces
the gradient the JAX package takes by autodiff of its jnp reference (the
Pallas kernel has no VJP). Each wrapper checks what its kernel takes,
allocates the outputs, launches on PyTorch's current stream and counts the
launch (``launches``, ``backward_launches``). It raises on anything the
kernel does not take; the CPU path lives in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

launches = 0          # forward kernel launches since the last reset
backward_launches = 0  # backward calls (three or four kernels each)
# the fields of ``backward_plan``, in the order the C entry writes them
BWD_PLAN_FIELDS = ("splits", "dkdv_blocks", "dq_blocks", "dkdv_stages",
                   "dq_stages", "dkdv_smem", "dq_smem", "partial_bytes",
                   "scratch_floats")
_fn = None
_fn_lse = None
_fn_bwd = None
_fn_plan = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _entry_lse():
    global _fn_lse
    if _fn_lse is None:
        fn = _build.load("flash_attention").flash_attention_lse_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_lse = fn
    return _fn_lse


def _entry_bwd():
    global _fn_bwd
    if _fn_bwd is None:
        fn = _build.load("flash_attention_bwd").flash_attention_bwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_bwd = fn
    return _fn_bwd


def _entry_plan():
    global _fn_plan
    if _fn_plan is None:
        fn = _build.load("flash_attention_bwd").flash_attention_bwd_plan
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_plan = fn
    return _fn_plan


def backward_plan(b: int, s: int, t: int, nh: int, kvh: int, dq: int,
                  dv: int, device) -> Dict[str, int]:
    """The launch ``flash_attention_bwd`` makes at these shapes on
    ``device``, as its C entry plans it: the GQA group's head splits, the
    dK/dV and dQ blocks, their ring stages and dynamic shared memory, the
    bytes of fp32 partials (0 with one split) and the fp32 scratch the
    wrapper allocates (D, then the partials)."""
    out = (ctypes.c_longlong * len(BWD_PLAN_FIELDS))()
    with _build.launching(device):
        err = _entry_plan()(b, s, t, nh, kvh, dq, dv, out)
    _build.check(err, "flash_attention_bwd plan")
    return dict(zip(BWD_PLAN_FIELDS, out))


def _check(q, k, v, *more):
    """Raise unless the kernels take q, k, v (and ``more``, tensors shaped
    like q's output): bf16 CUDA tensors on one device, dq % 8 == dv % 8 ==
    0, dv <= dq <= 256, nh % kvh == 0."""
    b, s, nh, dq = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    if not (q.is_cuda and all(x.device == q.device for x in (k, v, *more))):
        raise ValueError("flash_attention kernel: q, k, v must be CUDA "
                         "tensors on one device")
    if not all(x.dtype == torch.bfloat16 for x in (q, k, v, *more)):
        raise ValueError(f"flash_attention kernel takes bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if (k.shape != (b, t, kvh, dq) or v.shape != (b, t, kvh, dv)
            or any(x.shape != (b, s, nh, dv) for x in more)
            or nh % kvh or dq % 8 or dv % 8 or dv > dq or dq > 256):
        raise ValueError(f"flash_attention kernel: unsupported shapes "
                         f"q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)} (needs dq % 8 == dv % 8 == 0, "
                         f"dv <= dq <= 256, nh % kvh == 0)")
    return b, s, t, nh, kvh, dq, dv


def _forward(q, k, v, causal, scale, with_lse: bool):
    global launches
    b, s, t, nh, kvh, dq, dv = _check(q, k, v)
    scale = dq ** -0.5 if scale is None else scale
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out = q.new_empty(b, s, nh, dv)
    lse = (torch.empty(b, nh, s, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or s == 0 or t == 0:       # no keys: the plain version's 0
        if lse is not None:
            lse.fill_(float("-inf"))
        return out.zero_(), lse
    with _build.launching(q.device) as stream:
        if with_lse:
            err = _entry_lse()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), lse.data_ptr(), b, s, t, nh,
                               kvh, dq, dv, int(causal), float(scale), stream)
        else:
            err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), b, s, t, nh, kvh, dq, dv,
                           int(causal), float(scale), stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, s, nh, dq), k: (b, t, kvh, dq), v: (b, t, kvh, dv), bf16 CUDA
    tensors on one device; dq % 8 == dv % 8 == 0, dv <= dq <= 256 (MLA's
    value head is never wider than its query), nh % kvh == 0. Returns (b, s,
    nh, dv); the scale defaults to dq ** -0.5."""
    return _forward(q, k, v, causal, scale, False)[0]


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """``flash_attention`` that also returns each row's natural-log
    logsumexp of the scaled scores, fp32 (b, nh, s): the statistic the
    backward rebuilds P from. The output is bit for bit
    ``flash_attention``'s."""
    return _forward(q, k, v, causal, scale, True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None):
    """The gradient of ``flash_attention``: (dq, dk, dv) shaped and typed
    as (q, k, v), from the forward's output ``o`` and ``lse`` and the
    output's gradient ``do`` (``csrc/flash_attention_bwd.cu``, three or
    four launches counted as one in ``backward_launches``). Takes what the
    forward takes; the GQA group's dk, dv are summed over its query heads,
    in a fixed order."""
    global backward_launches
    b, s, t, nh, kvh, dq, dv = _check(q, k, v, o, do)
    if (lse.dtype != torch.float32 or lse.shape != (b, nh, s)
            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be fp32 (b, nh, s) "
                         f"= {(b, nh, s)} on q's device, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    scale = dq ** -0.5 if scale is None else scale
    q, k, v, o, do = (_build.aligned(x) for x in (q, k, v, o, do))
    lse = _build.aligned(lse)
    dq_, dk, dv_ = (torch.empty_like(x) for x in (q, k, v))
    if b == 0 or s == 0 or t == 0:
        return dq_.zero_(), dk.zero_(), dv_.zero_()
    plan = backward_plan(b, s, t, nh, kvh, dq, dv, q.device)
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                          device=q.device)
    with _build.launching(q.device) as stream:
        err = _entry_bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                           scratch.data_ptr(), dq_.data_ptr(), dk.data_ptr(),
                           dv_.data_ptr(), b, s, t, nh, kvh, dq, dv,
                           int(causal), float(scale), stream)
    _build.check(err, "flash_attention_bwd")
    backward_launches += 1
    return dq_, dk, dv_


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention under autograd on the card: the forward launches the
    kernel with ``lse`` and saves q, k, v, o, lse; the backward launches
    ``flash_attention_bwd``. Both are deterministic, so a recompute under
    ``torch.utils.checkpoint`` gives the same output and gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        out, lse = flash_attention_lse(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None
