"""Plain PyTorch versions of the kernels: attention on the serving path, its
gradient on the training path and the IVF-PQ scan on the retrieval path.

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
    scale = dq ** -0.5 if scale is None else scale
    probs = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, nh, v.shape[-1]).to(q.dtype)


def _scores(q, k, causal: bool, scale: float):
    """fp32 scaled scores (b, kvh, g, s, t), masked keys at NEG_INF."""
    b, s, nh, dq = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qr = q.reshape(b, s, kvh, nh // kvh, dq)
    scores = torch.einsum("bskgh,btkh->bkgst", qr.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])      # (s, t)
        scores = torch.where(mask, scores, torch.tensor(NEG_INF,
                                                        device=q.device))
    return scores


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """``flash_attention`` and each row's natural-log logsumexp of the
    scaled scores, fp32 (b, nh, s): what the kernel's ``lse`` output
    holds."""
    b, s, nh, dq = q.shape
    scale = dq ** -0.5 if scale is None else scale
    lse = torch.logsumexp(_scores(q, k, causal, scale), dim=-1)
    return (flash_attention(q, k, v, causal=causal, scale=scale),
            lse.reshape(b, nh, s))


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None):
    """The gradient of ``flash_attention`` in fp32 torch ops: (dq, dk, dv)
    in the dtypes of (q, k, v), from the forward's output ``o``, its row
    logsumexp ``lse`` (b, nh, s) and the output's gradient ``do``.
    P = exp(scale Q K^T - lse), dV = P^T dO, dS = P (dO V^T - D) with D =
    rowsum(dO o), dQ = scale dS K, dK = scale dS^T Q; the GQA group's dK,
    dV summed over its query heads. The tests hold it to autograd of
    ``flash_attention``; the card's backward kernel is held to it."""
    b, s, nh, dq = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = nh // kvh
    scale = dq ** -0.5 if scale is None else scale
    p = torch.exp(_scores(q, k, causal, scale)
                  - lse.float().reshape(b, kvh, g, s)[..., None])
    dor = do.float().reshape(b, s, kvh, g, dv)
    d_row = (dor * o.float().reshape(b, s, kvh, g, dv)).sum(-1)  # (b,s,k,g)
    dvv = torch.einsum("bkgst,bskgh->btkh", p, dor)
    dp = torch.einsum("bskgh,btkh->bkgst", dor, v.float())
    ds = p * (dp - d_row.permute(0, 2, 3, 1)[..., None])
    dqq = torch.einsum("bkgst,btkh->bskgh", ds, k.float()) * scale
    dkk = torch.einsum("bkgst,bskgh->btkh", ds,
                       q.float().reshape(b, s, kvh, g, dq)) * scale
    return (dqq.reshape(b, s, nh, dq).to(q.dtype), dkk.to(k.dtype),
            dvv.to(v.dtype))


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
                     scale: Optional[float] = None, return_lse: bool = False):
    """One-token decode attention against a padded cache.

    q: (b, 1, nh, dq); k_cache/v_cache: (b, S, kvh, d*); lengths: (b,) number
    of valid cache entries (mask is ``pos < lengths``). Operands stay in the
    cache dtype with fp32 accumulation; probabilities are cast to the cache
    dtype before P·V, as in the JAX oracle. With ``return_lse`` it returns
    (out, lse): lse ``(b, nh)`` fp32 is the log-sum-exp of each row's
    scaled scores over its valid positions, -inf for a length-0 row (whose
    output is the mean of the padding: it carries weight 0 in a merge).
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
    out = out.reshape(b, 1, nh, v_cache.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    live = torch.clamp(lengths.to(q.device), max=S) > 0
    lse = torch.where(live[:, None, None], torch.logsumexp(scores, dim=-1),
                      float("-inf"))
    return out, lse.reshape(b, nh)


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


def paged_chunk_attention(q, k_pool, v_pool, block_tables, lengths, *,
                          scale: Optional[float] = None):
    """Chunked-prefill attention over paged KV.

    q: (b, s, nh, dq) — query ``j`` of row ``r`` sits at logical position
    ``lengths[r] + j`` and attends over every pooled position ``<=
    lengths[r] + j``: the cached context and the causal part of its own
    chunk, whose K/V the caller has already written into the pools. The
    numerics are ``flash_attention``'s (fp32 scores, softmax and P·V), not
    decode's, so that a chunk row equals the same row of a whole-prompt
    prefill. Masked positions get probability exactly 0, so the content of
    dead table entries (the trash page) cannot perturb the output. Rows past
    a row's valid chunk, and dead rows, give garbage the caller ignores.
    """
    k = gather_paged_kv(k_pool, block_tables)          # (b, S, kvh, dq)
    v = gather_paged_kv(v_pool, block_tables)          # (b, S, kvh, dv)
    b, s, nh, dq = q.shape
    S, kvh = k.shape[1], k.shape[2]
    g = nh // kvh
    scale = dq ** -0.5 if scale is None else scale
    qr = q.reshape(b, s, kvh, g, dq)
    scores = torch.einsum("bskgh,btkh->bkgst", qr.float(), k.float()) * scale
    qpos = (lengths.to(q.device).long()[:, None]
            + torch.arange(s, device=q.device)[None, :])       # (b, s)
    mask = torch.arange(S, device=q.device)[None, None, :] <= qpos[:, :, None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, nh, v.shape[-1]).to(q.dtype)


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


def pq_scan(codes, lut):
    """IVF-PQ asymmetric-distance (ADC) scan, the RAG retrieval hot loop.

    codes: (N, M) PQ codes of any integer type; lut: (M, K) per-subquantizer
    distance table of one query. Returns (N,) float32, ``out[n] = sum_m
    lut[m, codes[n, m]]`` summed in fp32. A code outside ``[0, K)`` adds
    exactly 0: that is what the Pallas kernel computes (its one-hot compare
    matches no column), so the card and the CPU agree on it. The JAX
    reference ``repro.kernels.ref.pq_scan`` differs there: its
    ``take_along_axis`` gives NaN for a code at or past K and wraps a
    negative one. In range the two agree.
    """
    lut = lut.float()
    m, k = lut.shape
    c = codes.long()
    inside = (c >= 0) & (c < k)
    rows = torch.arange(m, device=lut.device)
    gathered = lut[rows, c.clamp(0, k - 1)]                      # (N, M)
    return (gathered * inside).sum(dim=-1)


def pq_scan_in_order(codes, lut):
    """``pq_scan`` summed as the CUDA kernel sums it: from 0, m = 0 … M-1,
    one fp32 add at a time, an out-of-range code adding 0 through ``where``
    (not a product, so a NaN in the LUT cannot leak in through 0). The
    kernel equals it bit for bit; ``pq_scan``'s ``sum`` may take another
    order."""
    lut = lut.float()
    m, k = lut.shape
    c = codes.long()
    acc = torch.zeros(c.shape[0], dtype=torch.float32, device=lut.device)
    zero = torch.zeros((), dtype=torch.float32, device=lut.device)
    for j in range(m):
        cj = c[:, j]
        acc = acc + torch.where((cj >= 0) & (cj < k),
                                lut[j, cj.clamp(0, k - 1)], zero)
    return acc
