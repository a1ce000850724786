"""Public kernel entry points (attention and the IVF-PQ scan), dispatched
on the tensor's device.

A CUDA tensor launches the hand-written kernel (``flash_attention.py``,
whose ``FlashAttentionFn`` also gives training its gradient kernel,
``decode_attention.py``, ``paged_attention.py``,
``paged_chunk_attention.py``, ``pq_scan.py``), which
raises on a shape or dtype it does not take; there is no fallback. Each
launches with its tensors' device current (``_build.launching``), so a
kernel runs on whichever card of the host holds its inputs. A CPU
tensor takes the plain PyTorch version in ``ref.py``, including the chunked
form for long sequences that ``repro.kernels.ops`` takes off-TPU.

Each wrapper counts its launches in a module counter; ``launch_counts``,
``add_launches`` and ``reset_launches`` read and move all of them by kernel
name (the engine's compiled passes add a graph's launches at each replay).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_chunk_attention as _pca
from repro_torch.kernels import pq_scan as _pq
from repro_torch.kernels import ref as _ref

# kernel name -> (wrapper module, its counter)
_COUNTERS = {
    "flash_attention": (_fa, "launches"),
    "flash_attention_bwd": (_fa, "backward_launches"),
    "paged_decode_attention": (_pa, "launches"),
    "paged_verify_attention": (_pa, "verify_launches"),
    "decode_attention": (_da, "launches"),
    "paged_chunk_attention": (_pca, "launches"),
    "pq_scan": (_pq, "launches"),
}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter, by kernel name."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def add_launches(counts: Dict[str, int], sign: int = 1):
    """Add ``sign`` x ``counts`` (kernel name -> launches) to the
    counters."""
    for name, n in counts.items():
        mod, attr = _COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + sign * n)


def reset_launches():
    """Set every launch counter to 0."""
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """GQA prefill attention. On the card, under autograd (grad mode on and
    an input that needs a gradient) it is ``FlashAttentionFn``, whose
    backward is the hand-written gradient kernel; otherwise the forward
    kernel alone. On the CPU autograd runs through the plain version's
    torch ops."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _fa.FlashAttentionFn.apply(q, k, v, causal, scale)
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale)
    s, t = q.shape[1], k.shape[1]
    if s * t > 2048 * 2048:
        bq = 2048 if s <= 8192 else 4096
        return _ref.chunked_flash_attention(q, k, v, causal=causal,
                                            scale=scale, block_q=bq,
                                            block_k=bq)
    return _ref.flash_attention(q, k, v, causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None, return_lse: bool = False):
    """One-token decode attention against a padded per-row cache (see
    ``decode_attention.py`` for the contract); with ``return_lse`` also
    each row's log-sum-exp, ``(b, nh)`` fp32, -inf for a length-0 row."""
    if q.is_cuda:
        return _da.decode_attention(q, k_cache, v_cache, lengths, scale=scale,
                                    return_lse=return_lse)
    return _ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale,
                                 return_lse=return_lse)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None):
    """Block-table-indexed decode attention over pooled KV pages (see
    ``paged_attention.py`` for the layout contract)."""
    if q.is_cuda:
        return _pa.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                          lengths, scale=scale)
    return _ref.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                       lengths, scale=scale)


def paged_verify_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None):
    """Speculative-verify attention: all ``s = spec_k + 1`` feed positions
    of each row in one call; position ``j`` equals paged decode at
    ``lengths + j + 1`` bit for bit."""
    if q.is_cuda:
        return _pa.paged_verify_attention(q, k_pool, v_pool, block_tables,
                                          lengths, scale=scale)
    return _ref.paged_verify_attention(q, k_pool, v_pool, block_tables,
                                       lengths, scale=scale)


def paged_chunk_attention(q, k_pool, v_pool, block_tables, lengths, *,
                          scale: Optional[float] = None):
    """Chunked-prefill attention over pooled KV pages: query j of row r
    sits at logical position ``lengths[r] + j`` and attends over every
    pooled position ``<= lengths[r] + j``, with flash attention's numerics
    (see ``paged_chunk_attention.py``). The JAX package has no Pallas
    kernel for it and runs its jnp version on every backend."""
    if q.is_cuda:
        return _pca.paged_chunk_attention(q, k_pool, v_pool, block_tables,
                                          lengths, scale=scale)
    return _ref.paged_chunk_attention(q, k_pool, v_pool, block_tables,
                                      lengths, scale=scale)


def pq_scan(codes, lut):
    """IVF-PQ asymmetric-distance scan: codes (N, M), lut (M, K) -> (N,)
    fp32 (see ``pq_scan.py`` for the contract). As the JAX wrapper does,
    integer codes other than uint8 and int32 (``torch.randint`` gives int64)
    are cast to int32 and the LUT to fp32, on either device, so the card and
    the CPU scan the same values."""
    if codes.dtype.is_floating_point or codes.dtype.is_complex \
            or codes.dtype == torch.bool:
        raise ValueError(f"pq_scan takes integer codes, got {codes.dtype}")
    if codes.dtype not in (torch.uint8, torch.int32):
        codes = codes.to(torch.int32)
    lut = lut.float()
    if codes.is_cuda:
        return _pq.pq_scan(codes, lut)
    return _ref.pq_scan(codes, lut)
