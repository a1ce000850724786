"""CUDA paged decode- and verify-attention kernels: the wrappers around
``csrc/paged_attention.cu``.

Replace the Pallas kernels ``repro.kernels.paged_attention``
``paged_decode_attention`` and ``paged_verify_attention``, with the same
contract: ``q`` ``(b, s, nh, d)`` (``s == 1`` for decode, ``s = spec_k + 1``
feed positions for verify), pools ``(num_pages, bt, kvh, d)``,
``block_tables`` ``(b, max_blocks)`` int32 whose every entry is a valid page
(dead rows point at the trash page), ``lengths`` ``(b,)`` int32. Decode row
``i`` attends to positions ``< lengths[i]``; verify position ``j`` to
positions ``< lengths[i] + j + 1``, bit for bit what decode gives at that
length. Masked positions get probability exactly 0. A decode row with length
0 gives a finite garbage row. Each wrapper checks what its kernel takes,
launches on PyTorch's current stream and counts the launch in its own
counter: ``launches`` (decode) and ``verify_launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0          # decode kernel launches since the last reset
verify_launches = 0   # verify kernel launches since the last reset
_fns = {}


def _entry(name: str, n_ints: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("paged_attention"), name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_ints + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(what, q, k_pool, v_pool, block_tables, lengths):
    b, s, nh, d = q.shape
    nb, bt, kvh = k_pool.shape[:3]
    dev = q.device
    if not all(x.is_cuda and x.device == dev
               for x in (q, k_pool, v_pool, block_tables, lengths)):
        raise ValueError(f"{what} kernel: every input must be a CUDA tensor "
                         "on one device")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise ValueError(f"{what} kernel takes bf16 q/pools")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{what} kernel takes int32 block_tables and "
                         "lengths")
    if (s < 1 or k_pool.shape != (nb, bt, kvh, d)
            or v_pool.shape != (nb, bt, kvh, d) or nh % kvh
            or nh // kvh > 16 or d % 16 or d > 256
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(
            f"{what} kernel: unsupported shapes q={tuple(q.shape)} "
            f"k_pool={tuple(k_pool.shape)} v_pool={tuple(v_pool.shape)} "
            f"tables={tuple(block_tables.shape)} "
            f"lengths={tuple(lengths.shape)} (needs dq == dv, d % 16 == 0, "
            f"d <= 256, nh // kvh <= 16)")
    q, k_pool, v_pool = (_build.aligned(x) for x in (q, k_pool, v_pool))
    return (q, k_pool, v_pool, block_tables.contiguous(),
            lengths.contiguous(), torch.empty_like(q))


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """See the module docstring. bf16 q ``(b, 1, nh, d)`` and pools, int32
    tables/lengths, all CUDA tensors on one device; d % 16 == 0, d <= 256,
    nh // kvh <= 16."""
    global launches
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention kernel: q must be "
                         f"(b, 1, nh, d), got {tuple(q.shape)}")
    q, k_pool, v_pool, tabs, lens, out = _check(
        "paged_decode_attention", q, k_pool, v_pool, block_tables, lengths)
    b, _, nh, d = q.shape
    if b == 0:
        return out
    scale = d ** -0.5 if scale is None else scale
    err = _entry("paged_decode_attention_bf16", 6)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tabs.data_ptr(),
        lens.data_ptr(), out.data_ptr(), b, nh, k_pool.shape[2], d,
        k_pool.shape[1], tabs.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    launches += 1
    return out


def paged_verify_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """See the module docstring. q ``(b, s, nh, d)``; the rest as for
    ``paged_decode_attention``. The draft positions' K/V must already be in
    the pools, and each live row's table must cover ``lengths + s``."""
    global verify_launches
    q, k_pool, v_pool, tabs, lens, out = _check(
        "paged_verify_attention", q, k_pool, v_pool, block_tables, lengths)
    b, s, nh, d = q.shape
    if b == 0:
        return out
    scale = d ** -0.5 if scale is None else scale
    err = _entry("paged_verify_attention_bf16", 7)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tabs.data_ptr(),
        lens.data_ptr(), out.data_ptr(), b, s, nh, k_pool.shape[2], d,
        k_pool.shape[1], tabs.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_verify_attention")
    verify_launches += 1
    return out
