"""Public attention entry points, dispatched on the tensor's device.

A CUDA tensor launches the hand-written kernel (``flash_attention.py``,
``decode_attention.py``, ``paged_attention.py``), which raises on a shape or dtype it does not take;
there is no fallback. A CPU tensor takes the plain PyTorch version in
``ref.py``, including the chunked form for long sequences that
``repro.kernels.ops`` takes off-TPU.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale)
    s, t = q.shape[1], k.shape[1]
    if s * t > 2048 * 2048:
        bq = 2048 if s <= 8192 else 4096
        return _ref.chunked_flash_attention(q, k, v, causal=causal,
                                            scale=scale, block_q=bq,
                                            block_k=bq)
    return _ref.flash_attention(q, k, v, causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None):
    """One-token decode attention against a padded per-row cache (see
    ``decode_attention.py`` for the contract)."""
    if q.is_cuda:
        return _da.decode_attention(q, k_cache, v_cache, lengths, scale=scale)
    return _ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale)


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
