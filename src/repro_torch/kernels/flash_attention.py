"""CUDA flash-attention (prefill) kernel: the wrapper around
``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``repro.kernels.flash_attention.flash_attention``.
The wrapper checks what the kernel takes, allocates the output, launches on
PyTorch's current stream and counts the launch in ``launches``. It raises on
anything the kernel does not take; the CPU path lives in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, s, nh, dq), k: (b, t, kvh, dq), v: (b, t, kvh, dv), bf16 CUDA
    tensors on one device; dq % 8 == dv % 8 == 0, dv <= dq <= 256 (MLA's
    value head is never wider than its query), nh % kvh == 0. Returns (b, s,
    nh, dv); the scale defaults to dq ** -0.5."""
    global launches
    b, s, nh, dq = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v must be CUDA "
                         "tensors on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention kernel takes bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if (k.shape != (b, t, kvh, dq) or v.shape != (b, t, kvh, dv)
            or nh % kvh or dq % 8 or dv % 8 or dv > dq or dq > 256):
        raise ValueError(f"flash_attention kernel: unsupported shapes "
                         f"q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)} (needs dq % 8 == dv % 8 == 0, "
                         f"dv <= dq <= 256, nh % kvh == 0)")
    scale = dq ** -0.5 if scale is None else scale
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out = q.new_empty(b, s, nh, dv)
    if b == 0 or s == 0 or t == 0:       # no keys: the plain version's 0
        return out.zero_()
    with _build.launching(q.device) as stream:
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, s, t, nh, kvh, dq, dv, int(causal),
                       float(scale), stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
