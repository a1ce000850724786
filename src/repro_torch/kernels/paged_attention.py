"""CUDA paged decode-attention kernel: the wrapper around
``csrc/paged_attention.cu``.

Replaces the Pallas kernel
``repro.kernels.paged_attention.paged_decode_attention``, with the same
contract: ``q`` ``(b, 1, nh, d)``, pools ``(num_pages, bt, kvh, d)``,
``block_tables`` ``(b, max_blocks)`` int32 whose every entry is a valid page
(dead rows point at the trash page), ``lengths`` ``(b,)`` int32; positions
``>= lengths`` get probability exactly 0 and are not read. A row with length
0 gives a finite garbage row. The wrapper checks what the kernel takes,
launches on PyTorch's current stream and counts the launch in ``launches``.
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
        fn = _build.load("paged_attention").paged_decode_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """See the module docstring. bf16 q/pools, int32 tables/lengths, all
    CUDA tensors on one device; d % 16 == 0, d <= 256, nh // kvh <= 16."""
    global launches
    b, one, nh, d = q.shape
    nb, bt, kvh = k_pool.shape[:3]
    dev = q.device
    if not all(x.is_cuda and x.device == dev
               for x in (q, k_pool, v_pool, block_tables, lengths)):
        raise ValueError("paged_decode_attention kernel: every input must be "
                         "a CUDA tensor on one device")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise ValueError("paged_decode_attention kernel takes bf16 q/pools")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_decode_attention kernel takes int32 "
                         "block_tables and lengths")
    if (one != 1 or k_pool.shape != (nb, bt, kvh, d)
            or v_pool.shape != (nb, bt, kvh, d) or nh % kvh
            or nh // kvh > 16 or d % 16 or d > 256
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(
            f"paged_decode_attention kernel: unsupported shapes "
            f"q={tuple(q.shape)} k_pool={tuple(k_pool.shape)} "
            f"v_pool={tuple(v_pool.shape)} tables={tuple(block_tables.shape)}"
            f" lengths={tuple(lengths.shape)} (needs dq == dv, d % 16 == 0, "
            f"d <= 256, nh // kvh <= 16)")
    scale = d ** -0.5 if scale is None else scale
    q, k_pool, v_pool = (_build.aligned(x) for x in (q, k_pool, v_pool))
    block_tables, lengths = block_tables.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   block_tables.data_ptr(), lengths.data_ptr(),
                   out.data_ptr(), b, nh, kvh, d, bt, block_tables.shape[1],
                   float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_decode_attention")
    launches += 1
    return out
