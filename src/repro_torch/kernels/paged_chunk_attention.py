"""CUDA paged chunk-attention kernel (chunked prefill): the wrapper around
``paged_chunk_attention_bf16`` in ``csrc/flash_attention.cu``.

The JAX package has no Pallas kernel here: its chunk pass runs the jnp
version ``repro.kernels.ref.paged_chunk_attention`` on every backend
(dispatched at ``repro.kernels.ops.paged_chunk_attention``). The port's
kernel is the flash kernel with a paged K/V loader and a per-row query
offset, so a chunk row goes through the same kv tiles, in the same order and
with the same mask as the row at that position of a whole-prompt prefill,
and equals it bit for bit on the same K/V.

Contract (the JAX function's): ``q`` ``(b, s, nh, d)``, query ``j`` of row
``i`` at logical position ``lengths[i] + j``, attending over every pooled
position ``<= lengths[i] + j`` through ``block_tables`` ``(b, max_blocks)``
int32, whose every entry is a valid page (dead entries point at the trash
page); pools ``(num_pages, bt, kvh, d)``. The chunk's own K/V must already
be in the pools. Rows past a row's valid chunk give garbage the caller
ignores. The wrapper checks what the kernel takes, allocates the output,
launches on PyTorch's current stream and counts the launch in
``launches``; it raises on anything else. The CPU path is in ``ops.py``.
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
        fn = _build.load("flash_attention").paged_chunk_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_chunk_attention(q, k_pool, v_pool, block_tables, lengths, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """See the module docstring. bf16 q and pools, int32 tables and
    lengths, all CUDA tensors on one device; d % 8 == 0, d <= 256, nh %
    kvh == 0, and bt one of 8, 16, 32, 64: each 64-row kv tile is 64 / bt
    page-sized TMA boxes, each landing on a 1024-byte swizzle period."""
    global launches
    b, s, nh, d = q.shape
    nb, bt, kvh = k_pool.shape[:3]
    dev = q.device
    if not all(x.is_cuda and x.device == dev
               for x in (q, k_pool, v_pool, block_tables, lengths)):
        raise ValueError("paged_chunk_attention kernel: every input must be "
                         "a CUDA tensor on one device")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise ValueError(f"paged_chunk_attention kernel takes bf16, got "
                         f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_chunk_attention kernel takes int32 "
                         "block_tables and lengths")
    if (k_pool.shape != (nb, bt, kvh, d) or v_pool.shape != (nb, bt, kvh, d)
            or nh % kvh or d % 8 or d > 256 or bt not in (8, 16, 32, 64)
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(
            f"paged_chunk_attention kernel: unsupported shapes "
            f"q={tuple(q.shape)} k_pool={tuple(k_pool.shape)} "
            f"v_pool={tuple(v_pool.shape)} "
            f"tables={tuple(block_tables.shape)} "
            f"lengths={tuple(lengths.shape)} (needs dq == dv, d % 8 == 0, "
            f"d <= 256, nh % kvh == 0, block_tokens in 8/16/32/64)")
    scale = d ** -0.5 if scale is None else scale
    q, k_pool, v_pool = (_build.aligned(x) for x in (q, k_pool, v_pool))
    tabs, lens = block_tables.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    with _build.launching(dev) as stream:
        err = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                       tabs.data_ptr(), lens.data_ptr(), out.data_ptr(), b,
                       s, nh, kvh, d, bt, tabs.shape[1], nb, float(scale),
                       stream)
    _build.check(err, "paged_chunk_attention")
    launches += 1
    return out
