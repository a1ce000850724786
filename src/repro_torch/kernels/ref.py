"""Plain PyTorch versions of the attention kernels on the serving path.

Each function has the numerics of its twin in ``repro.kernels.ref``: the CPU
path runs them, the tests hold them against the JAX oracles, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """GQA-aware softmax attention, fp32 scores and softmax.

    q: (b, s, nh, dq)  k: (b, t, kvh, dq)  v: (b, t, kvh, dv); nh % kvh == 0.
    """
    b, s, nh, dq = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = nh // kvh
    scale = dq ** -0.5 if scale is None else scale
    qr = q.reshape(b, s, kvh, g, dq)
    scores = torch.einsum("bskgh,btkh->bkgst", qr.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])      # (s, t)
        scores = torch.where(mask, scores, torch.tensor(NEG_INF,
                                                        device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, nh, v.shape[-1]).to(q.dtype)


def chunked_flash_attention(q, k, v, *, causal: bool = True,
                            scale: Optional[float] = None,
                            block_q: int = 2048, block_k: int = 2048):
    """Blockwise online-softmax attention (python-unrolled blocks).

    Semantics identical to ``flash_attention``; the working set per step is
    one (block_q x block_k) score tile instead of the full (s x t) matrix.
    The CPU path takes it for long sequences, as ``repro.kernels.ops`` does.
    """
    b, s, nh, dq = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = nh // kvh
    dv = v.shape[-1]
    dev = q.device
    scale = dq ** -0.5 if scale is None else scale
    qr = q.reshape(b, s, kvh, g, dq)
    neg = torch.tensor(NEG_INF, device=dev)
    out_blocks = []
    for qs in range(0, s, block_q):
        qe = min(qs + block_q, s)
        qb = qr[:, qs:qe].float()
        m = torch.full((b, kvh, g, qe - qs), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, g, qe - qs), device=dev)
        acc = torch.zeros((b, kvh, g, qe - qs, dv), device=dev)
        for ks in range(0, t, block_k):
            if causal and ks > qe - 1:
                break
            ke = min(ks + block_k, t)
            kb = k[:, ks:ke].float()
            vb = v[:, ks:ke].float()
            sc = torch.einsum("bskgh,btkh->bkgst", qb, kb) * scale
            if causal:
                mask = (torch.arange(ks, ke, device=dev)[None, :]
                        <= torch.arange(qs, qe, device=dev)[:, None])
                sc = torch.where(mask, sc, neg)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgst,btkh->bkgsh",
                                                        p, vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        out_blocks.append(torch.movedim(out, 3, 1))          # (b,sq,kvh,g,dv)
    full = torch.cat(out_blocks, dim=1)
    return full.reshape(b, s, nh, dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None):
    """One-token decode attention against a padded cache.

    q: (b, 1, nh, dq); k_cache/v_cache: (b, S, kvh, d*); lengths: (b,) number
    of valid cache entries (mask is ``pos < lengths``). Operands stay in the
    cache dtype with fp32 accumulation; probabilities are cast to the cache
    dtype before P·V, as in the JAX oracle.
    """
    b, _, nh, dq = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    g = nh // kvh
    scale = dq ** -0.5 if scale is None else scale
    qr = q.reshape(b, kvh, g, dq)
    # bf16 x bf16 products are exact in fp32, so upcasting the operands and
    # contracting in fp32 is bf16-operand / fp32-accumulate arithmetic
    scores = torch.einsum("bkgh,bSkh->bkgS", qr.float(),
                          k_cache.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])                    # (b, S)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgS,bSkh->bkgh", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, nh, v_cache.shape[-1]).to(q.dtype)


def gather_paged_kv(pool, block_tables):
    """Reassemble dense per-request caches from a paged pool.

    pool: (num_blocks, block_tokens, ...); block_tables: (b, max_blocks)
    int32. Returns (b, max_blocks * block_tokens, ...) — logical token
    position p of request i is pool[block_tables[i, p // bt], p % bt].
    """
    gathered = pool[block_tables.long()]            # (b, mb, bt, ...)
    b, mb, bt = gathered.shape[:3]
    return gathered.reshape(b, mb * bt, *pool.shape[2:])


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None):
    """Paged decode attention: gather the pools into dense caches and defer
    to ``decode_attention``. Masked (beyond-``lengths``) positions contribute
    exactly zero probability, so the content of dead table entries (the
    trash page) cannot perturb the result."""
    k = gather_paged_kv(k_pool, block_tables)
    v = gather_paged_kv(v_pool, block_tables)
    return decode_attention(q, k, v, lengths, scale=scale)


def paged_verify_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None):
    """Speculative-verify attention over paged KV: ``s = spec_k + 1`` feed
    positions per row in one call.

    q: (b, s, nh, dq) — query ``j`` of row ``r`` sits at logical position
    ``lengths[r] + j`` and attends over pooled positions ``< lengths[r] + j
    + 1``; the feed's K/V must already be in the pools. Each position is
    the decode oracle at that length (a Python unroll over ``s``), so
    position ``j`` equals ``paged_decode_attention`` at ``lengths + j + 1``
    bit for bit, as the spec == plain contract needs.
    """
    k = gather_paged_kv(k_pool, block_tables)
    v = gather_paged_kv(v_pool, block_tables)
    outs = [decode_attention(q[:, j:j + 1], k, v, lengths + j + 1, scale=scale)
            for j in range(q.shape[1])]
    return torch.cat(outs, dim=1)
