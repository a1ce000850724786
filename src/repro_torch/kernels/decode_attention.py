"""CUDA dense decode-attention kernel: the wrapper around
``csrc/decode_attention.cu``.

Replaces the Pallas kernel ``repro.kernels.decode_attention.decode_attention``,
with the same contract: ``q`` ``(b, 1, nh, d)`` one new query token per
row, ``k_cache``/``v_cache`` ``(b, S, kvh, d)`` per-row caches padded to a
common ``S``, ``lengths`` ``(b,)`` int32 live tokens per row (mask
``pos < lengths``; a length past ``S`` reads as ``S``). Content at or past
a row's length gets probability exactly 0 and is not read; a length-0 row
gives a finite row (the plain version's is the mean of the padding, the
kernel's zeros). ``dv != d`` is refused (the JAX package, too, takes its
Pallas path only when ``dq == dv``). On the same logical cache the output
equals ``paged_decode_attention``'s bit for bit: the same split points
(every ``_build.DECODE_SPLIT`` tokens) and the same merge. The wrapper
checks what the kernel takes, allocates the fp32 scratch of the per-split
partials (``_build.decode_scratch``), launches the split kernel and its
merge on PyTorch's current stream through one C call and counts it once in
``launches``. With ``return_lse`` the merge also writes each row's
log-sum-exp of its scaled scores, ``(b, nh)`` fp32 (-inf for a length-0
row), and ``out`` is the same tensor bit for bit: the merge computes it
the same way and only stores one more number a row. A caller that splits
one sequence over several calls merges their outputs by it
(``attention.merge_slices``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset
# the splits of one row go on the grid's z dimension (at most 65535 blocks):
# caches of up to 65535 x DECODE_SPLIT positions (4,194,240 at 64)
MAX_SPLITS = 65535
_fn = None


def _entry():
    global _fn
    if _fn is None:
        lib = _build.load("decode_attention")
        _build.check_split(lib, "decode_attention")
        fn = lib.decode_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None,
                     return_lse: bool = False):
    """See the module docstring. bf16 q/caches, int32 lengths, all CUDA
    tensors on one device; d % 8 == 0, d <= 256, nh // kvh <= 16. Returns
    out, or (out, lse) with ``return_lse``."""
    global launches
    b, one, nh, d = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    if not all(x.is_cuda and x.device == dev
               for x in (q, k_cache, v_cache, lengths)):
        raise ValueError("decode_attention kernel: every input must be a "
                         "CUDA tensor on one device")
    if not (q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16):
        raise ValueError("decode_attention kernel takes bf16 q/caches")
    if lengths.dtype != torch.int32:
        raise ValueError("decode_attention kernel takes int32 lengths")
    if (one != 1 or k_cache.shape != (b, S, kvh, d)
            or v_cache.shape != (b, S, kvh, d) or nh % kvh
            or nh // kvh > 16 or d % 8 or d > 256
            or lengths.shape != (b,)):
        raise ValueError(
            f"decode_attention kernel: unsupported shapes q={tuple(q.shape)}"
            f" k_cache={tuple(k_cache.shape)} v_cache="
            f"{tuple(v_cache.shape)} lengths={tuple(lengths.shape)} (needs "
            f"dq == dv, d % 8 == 0, d <= 256, nh // kvh <= 16)")
    if -(-S // _build.DECODE_SPLIT) > MAX_SPLITS:
        raise ValueError(
            f"decode_attention kernel: a cache of {S} positions needs "
            f"{-(-S // _build.DECODE_SPLIT)} splits of "
            f"{_build.DECODE_SPLIT} tokens; the grid holds {MAX_SPLITS}")
    scale = d ** -0.5 if scale is None else scale
    q, k_cache, v_cache = (_build.aligned(x) for x in (q, k_cache, v_cache))
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, nh), dtype=torch.float32, device=dev)
           if return_lse else None)
    if b == 0:
        return (out, lse) if return_lse else out
    scratch = _build.decode_scratch(b * nh, S, d, dev)
    with _build.launching(dev) as stream:
        err = _entry()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                       b, S, nh, kvh, d, float(scale),
                       None if lse is None else lse.data_ptr(), stream)
    _build.check(err, "decode_attention")
    launches += 1
    return (out, lse) if return_lse else out
