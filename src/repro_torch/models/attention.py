"""Attention for serving (twin of ``repro.models.attention``): GQA/MQA and
MLA (DeepSeek-V2 latent attention).

GQA prefill is causal full-sequence attention through ``ops.flash_attention``;
decode reads a dense per-slot cache through ``ops.decode_attention`` or a
paged cache through ``ops.paged_decode_attention``; the chunked-prefill
pass reads a paged cache through ``ops.paged_chunk_attention`` and the
speculative verify pass through ``ops.paged_verify_attention``.
Caches are updated in place: where the JAX package returns a new cache
from ``dynamic_update_slice`` or ``.at[slot].set(...)``, this module writes
the new tokens' K/V into the layer's slice of the cache with index writes,
which saves a whole-cache copy per layer per step. The returned cache dict
still names the (same) tensors, so callers read like the JAX package's.

Where a layout splits the caches' positions (its ``seq``: the data axes
under ``seq_sharded``, "model" or ("data", "model") under ``shard_v2``;
``distributed.cache_groups``) a rank's cache holds its slice of the
positions: prefill writes the rank's slice of the prompt's K/V (or
latent), and decode writes the new token on the rank whose slice holds its
position, attends over the rank's slice (``ops.decode_attention`` with the
rows' log-sum-exp; MLA's einsums with theirs) and merges the slices over
the group (``merge_slices``). Where the group holds "model", every model
rank holds every kv head of its positions: each gathers the query heads
over "model", attends them all and keeps its own heads' merged output for
the row-parallel ``wo``.

MLA prefill also goes through ``ops.flash_attention``, with query and key
at ``qk_nope + qk_rope`` and value at ``v_head_dim`` (dq != dv); its decode
is einsums over the latent cache (``c_kv``, ``k_rope``), as in the JAX
package, either re-expanding K/V (naive) or in the latent space
(``MLAConfig.absorb``). MLA's cache is dense only: the paged passes
(chunk, verify) serve GQA.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import distributed as dist_
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import HeadsRead, local_slice
from repro_torch.kernels import ops
from repro_torch.models.layers import (Initializer, apply_norm, apply_rope,
                                       init_norm, proj_in)

NEG_INF = -1e30


def init_attention(init: Initializer, cfg: ModelConfig) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.attn_type == "mla":
        m = cfg.mla
        p: Dict = {}
        if m.q_lora_rank:
            p["wdq"] = init.w((d, m.q_lora_rank), ("w_embed", "q_lora"))
            p["q_norm"] = init_norm(init, cfg, m.q_lora_rank)
        q_in = m.q_lora_rank or d
        p["wuq"] = init.w((q_in, cfg.num_heads,
                           m.qk_nope_head_dim + m.qk_rope_head_dim),
                          ("q_lora" if m.q_lora_rank else "w_embed", "heads",
                           "head_dim"))
        p["wdkv"] = init.w((d, m.kv_lora_rank), ("w_embed", "kv_lora"))
        p["wkr"] = init.w((d, m.qk_rope_head_dim), ("w_embed", "head_dim"))
        p["kv_norm"] = init_norm(init, cfg, m.kv_lora_rank)
        p["wuk"] = init.w((m.kv_lora_rank, cfg.num_heads, m.qk_nope_head_dim),
                          ("kv_lora", "heads", "head_dim"))
        p["wuv"] = init.w((m.kv_lora_rank, cfg.num_heads, m.v_head_dim),
                          ("kv_lora", "heads", "head_dim"))
        p["wo"] = init.z((cfg.num_heads, m.v_head_dim, d),
                         ("heads", "head_dim", "w_embed"))
        return p
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"attn_type={cfg.attn_type!r}")
    # JAX tags head_dim "head_dim_shard" (it takes "model" where the heads
    # cannot), or "head_dim" under shard_v2
    hd_ax = "head_dim" if cfg.shard_v2 else "head_dim_shard"
    return {
        "wq": init.w((d, cfg.num_heads, hd), ("w_embed", "heads", hd_ax)),
        "wk": init.w((d, cfg.num_kv_heads, hd),
                     ("w_embed", "kv_heads", hd_ax)),
        "wv": init.w((d, cfg.num_kv_heads, hd),
                     ("w_embed", "kv_heads", hd_ax)),
        "wo": init.z((cfg.num_heads, hd, d), ("heads", hd_ax, "w_embed")),
    }


def _proj_out(o, w):
    """einsum("bsnh,nhd->bsd") as one matmul."""
    return o.flatten(-2) @ w.reshape(-1, w.shape[-1])


def _attn_split(tp) -> Optional[str]:
    """How a GQA block's attention splits over "model" under its layout
    ``tp``: "heads" (``wq``/``wo`` on their heads: each rank attends with
    its query heads), "whole" (the heads do not divide "model" and
    ``wq``/``wo`` split their head dim: attention whole on every rank),
    or None (nothing sharded)."""
    if tp is None:
        return None
    dims = [tp.dim(n) for n in ("wq", "wk", "wv", "wo")]
    if all(d is None for d in dims):
        return None
    if dims[0] not in (1, 2) or dims[3] != dims[0] - 1:
        tp.refuse("wq", "query heads or head dim and wo alike")
    return "heads" if dims[0] == 1 else "whole"


def _qkv(params, x, positions, cfg: ModelConfig, tp=None, take=True):
    """q, k, v ``(b, s, heads, hd)``, rope applied at ``positions``.

    Under a mesh (``tp``: the block's ``attn`` layout) on the rank's
    shards: with ``_attn_split`` "heads", q holds the rank's query heads
    and k/v the kv heads they read (``distributed.HeadsRead``: local
    query head i meets local kv head i // (n / local kv heads)); K/V come
    as the rules lay them, on their kv heads (aligned with the local
    query heads), on the head dim (gathered along it before rope, which
    rotates across its halves) or whole (copy-in). With "whole" (JAX's
    sequence-sharded layout there changes no value) q, k and v are whole
    on every rank, gathered along the head dim. With ``take`` False k and
    v keep every kv head (the cache of a rank whose positions split over
    "model" holds them all; ``_heads_read`` cuts them for attention)."""
    split = _attn_split(tp)
    if split is None:
        q = proj_in(x, params["wq"])
        k = proj_in(x, params["wk"])
        v = proj_in(x, params["wv"])
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)
    xin = tp.copy_in(x)

    def proj(name):
        """The projection as the consumers need it: local heads, or
        whole (gathered along the head dim, or copy-in of a replicated
        product); and whether it is on the rank's kv heads already."""
        d = tp.dim(name)
        if d is None:
            return tp.copy_in(proj_in(x, params[name])), False
        t = proj_in(xin, params[name])
        if d == 2:
            return tp.gather(t, -1), False
        if split == "whole":             # kv heads split, attention whole
            return tp.gather(t, -2), False
        return t, True

    q, _ = proj("wq")
    (k, k_local), (v, v_local) = proj("wk"), proj("wv")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if split == "heads" and take:
        read = HeadsRead(cfg.num_heads, cfg.num_kv_heads)
        if not k_local:
            k = read.take(k, 2, tp.model)
        if not v_local:
            v = read.take(v, 2, tp.model)
    return q, k, v


def _heads_read(t, cfg: ModelConfig, tp):
    """The kv heads of ``t`` (every kv head) that the rank's query heads
    read, where its attention runs on its heads."""
    if _attn_split(tp) != "heads":
        return t
    return HeadsRead(cfg.num_heads, cfg.num_kv_heads).take(t, 2, tp.model)


def _seq_split(tp):
    """(the axis group the layout's caches split their positions over, or
    None; whether it holds "model")."""
    seq = None if tp is None else tp.seq
    if seq is None or seq.size == 1:
        return None, False
    return seq, "model" in seq.names


def _prompt_slice(n_loc: int, s: int, seq):
    """(the first prompt position of the rank's cache slice, how many of
    the ``s`` prompt positions fall in it) for a slice of ``n_loc``
    positions over ``seq`` (None: the whole cache)."""
    if seq is None:
        return 0, s
    lo = seq.index * n_loc
    return lo, max(0, min(s - lo, n_loc))


def _write_token(bufs, news, lengths, seq):
    """Write each row's new entry (``news``, one ``(b, ...)`` a buffer) into
    the cache buffers ``bufs`` ``(b, S_loc, ...)`` in place at its position
    ``min(length, S - 1)`` (JAX's clamp over the whole cache of ``S``
    positions): with positions split over ``seq``, only on the rank whose
    slice holds it. Returns the rank's first position."""
    n_loc = bufs[0].shape[1]
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    if seq is None:
        at = torch.clamp(lengths, max=n_loc - 1).long()
        for buf, new in zip(bufs, news):
            buf[rows, at] = new.to(buf.dtype)
        return 0
    start = seq.index * n_loc
    at = torch.clamp(lengths, max=n_loc * seq.size - 1).long() - start
    mine = (at >= 0) & (at < n_loc)
    at = torch.clamp(at, 0, n_loc - 1)
    for buf, new in zip(bufs, news):
        keep = mine.reshape(-1, *([1] * (new.dim() - 1)))
        buf[rows, at] = torch.where(keep, new.to(buf.dtype), buf[rows, at])
    return start


def _attn_out(out, params, tp=None):
    """The output projection ``wo``; under a mesh the rank's heads (or its
    slice of the head dim, where attention ran whole), summed over
    "model": a reduce-out under autograd, else the fp32 partial products'
    sum rounded once (``Layout.row_parallel``)."""
    split = _attn_split(tp)
    if split is None:
        return _proj_out(out, params["wo"])
    if split == "whole":
        out = local_slice(out, -1, tp.model)
    if not torch.is_grad_enabled():
        wo = params["wo"]
        return tp.row_parallel(out.flatten(-2), wo.reshape(-1, wo.shape[-1]))
    return tp.reduce_out(_proj_out(out, params["wo"]))


def gqa_prefill(params, x, positions, cfg: ModelConfig,
                cache: Optional[Dict] = None, tp=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence attention. If ``cache`` is given (a pre-allocated
    ``(b, S, kvh, hd)`` layer slice), the computed K/V are written into its
    first ``s`` positions in place (inference prefill). Under a mesh
    (``tp``: the block's ``attn`` layout) it runs on the rank's shards
    (``_qkv``) and the cache is the rank's (``transformer.cache_specs``:
    its rows, and the kv heads its query heads read, or whole where
    attention runs whole). Under ``seq_sharded`` (``tp.seq``) every data
    rank computes the whole prompt and keeps its slice of the positions;
    where the positions split over a group holding "model" (``shard_v2``)
    every kv head of them."""
    hd = cfg.resolved_head_dim
    seq, seq_model = _seq_split(tp)
    q, k, v = _qkv(params, x, positions, cfg, tp, take=not seq_model)
    kq, vq = ((_heads_read(k, cfg, tp), _heads_read(v, cfg, tp))
              if seq_model else (k, v))
    out = ops.flash_attention(q, kq, vq, causal=not cfg.encoder_only,
                              scale=hd ** -0.5)
    new_cache = None
    if cache is not None:
        s = k.shape[1]
        lo, n = _prompt_slice(cache["k"].shape[1], s, seq)
        cache["k"][:, :n] = k[:, lo:lo + n]
        cache["v"][:, :n] = v[:, lo:lo + n]
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "length": torch.full_like(cache["length"], s)}
    return _attn_out(out, params, tp), new_cache


def gqa_decode(params, x, cfg: ModelConfig, cache: Dict, tp=None
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against a dense per-slot cache.

    x: (b, 1, d); cache k/v: (b, S, kvh, hd); cache["length"]: (b,) valid
    tokens per row. The new token's K/V is written in place at index
    ``length``, clamped to ``S - 1`` as JAX's ``dynamic_update_slice``
    clamps it (the ``SlotEngine``'s dead slots keep stale, growing lengths).
    A paged cache (``k_pool`` present) routes to ``gqa_decode_paged``.
    Under a mesh (``tp``) the rank's rows, heads and cache, as
    ``gqa_prefill``: the kernel sees the rank's query heads over the kv
    heads they read, and the new K/V goes into the rank's own cache.
    Where the positions split (``tp.seq``) the rank holding global
    position ``min(length, S - 1)`` (JAX's clamp over the whole cache)
    writes the new K/V; each rank attends over its slice, with its local
    lengths ``clamp(length + 1 - start, 0, S / n)``, and ``merge_slices``
    merges the slices; over a group holding "model" with the query heads
    gathered, the rank's own heads kept after the merge.
    """
    if "k_pool" in cache:
        return gqa_decode_paged(params, x, cfg, cache)
    hd = cfg.resolved_head_dim
    lengths = cache["length"]
    k_cache, v_cache = cache["k"], cache["v"]
    seq, seq_model = _seq_split(tp)
    q, k, v = _qkv(params, x, lengths[:, None], cfg, tp, take=not seq_model)
    start = _write_token((k_cache, v_cache), (k[:, 0], v[:, 0]), lengths,
                         seq)
    if seq is None:
        out = ops.decode_attention(q, k_cache, v_cache, lengths + 1,
                                   scale=hd ** -0.5)
    else:
        heads = seq_model and _attn_split(tp) == "heads"
        if heads:
            q = tp.gather(q, 2)
        local = torch.clamp(lengths + 1 - start, 0,
                            k_cache.shape[1]).to(torch.int32)
        out = seq_decode_attention(q, k_cache, v_cache, local, hd ** -0.5,
                                   seq)
        if heads:
            out = local_slice(out, 2, tp.model)
    return _attn_out(out, params, tp), {"k": k_cache, "v": v_cache,
                                        "length": lengths + 1}


def seq_decode_attention(q, k_cache, v_cache, lengths, scale: float, ax):
    """Decode attention over one sequence split over ``ax``: the rank's
    slice of the cache at its local ``lengths`` through
    ``ops.decode_attention`` with the rows' log-sum-exp, merged over
    ``ax`` (``merge_slices``)."""
    out, lse = ops.decode_attention(q, k_cache, v_cache, lengths,
                                    scale=scale, return_lse=True)
    return merge_slices(out, lse, ax)


def merge_slices(out, lse, ax):
    """The attention output over a whole sequence from each rank's output
    over its slice, ``out`` ``(b, 1, nh, d)``, and its rows' log-sum-exp
    ``lse`` ``(b, nh)`` (-inf for an empty slice), with all-reduces only
    over ``ax``: the max M of the lse values, then the sums of
    ``exp(lse - M) out`` and of ``exp(lse - M)``, in fp32 (one
    all-reduce), the output their quotient in ``out``'s dtype. An empty
    slice weighs exactly 0 (its output, the kernel's zeros or the plain
    version's mean of the padding, is not read)."""
    return _merge(out, lse, lambda t, op: dist_.all_reduce(t, ax, op))


def merge_stacked(outs, lses):
    """``merge_slices`` in one process: the outputs and lse values of the
    slices as lists, merged by the same arithmetic."""
    def reduce(t, op):
        return (t.amax(0, keepdim=True) if op == "max"
                else t.sum(0, keepdim=True)).expand_as(t)
    return _merge(torch.stack(outs), torch.stack(lses), reduce)[0]


def _merge(out, lse, reduce):
    """``merge_slices``' arithmetic, ``reduce(t, op)`` giving the max
    ("max") or sum ("sum") of ``t`` over the slices in ``t``'s shape."""
    m = reduce(lse.clone(), "max")
    w = torch.exp(lse - m)[..., None, :, None]            # (b, 1, nh, 1)
    num = torch.where(w > 0, out.float(), 0.0) * w
    both = reduce(torch.cat([num, w], dim=-1), "sum")
    return (both[..., :-1] / both[..., -1:]).to(out.dtype)


def gqa_decode_paged(params, x, cfg: ModelConfig,
                     cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against a *paged* cache (block-table-indexed pool).

    The layer cache holds pools ``k_pool``/``v_pool`` ``(num_pages,
    block_tokens, kvh, hd)`` plus ``block_tables`` ``(b, max_blocks)`` and
    ``length`` ``(b,)``. The new token's K/V is written in place at logical
    position ``length`` — physical slot ``(block_tables[i, length // bt],
    length % bt)``, with the block index clamped to ``max_blocks - 1`` as in
    the JAX package — so the caller must have grown the table to cover that
    position before the step. Dead rows point at the trash page; their
    writes land there and their output rows are garbage the caller ignores.
    """
    hd = cfg.resolved_head_dim
    lengths = cache["length"]
    tables = cache["block_tables"]
    k_pool, v_pool = cache["k_pool"], cache["v_pool"]
    bt, mb = k_pool.shape[1], tables.shape[1]
    pos = lengths[:, None]
    q, k, v = _qkv(params, x, pos, cfg)

    blk = torch.gather(tables, 1,
                       torch.clamp(lengths // bt, max=mb - 1)[:, None].long()
                       )[:, 0]
    slot = (blk.long() * bt + (lengths % bt).long())          # flat pool row
    k_pool.view(-1, *k_pool.shape[2:]).index_copy_(
        0, slot, k[:, 0].to(k_pool.dtype))
    v_pool.view(-1, *v_pool.shape[2:]).index_copy_(
        0, slot, v[:, 0].to(v_pool.dtype))
    out = ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths + 1,
                                     scale=hd ** -0.5)
    return _proj_out(out, params["wo"]), {
        "k_pool": k_pool, "v_pool": v_pool, "block_tables": tables,
        "length": lengths + 1}


def _write_feed(k_pool, v_pool, tables, pos, valid_q, k, v):
    """Write a left-aligned feed's K/V ``(b, s, kvh, hd)`` in place at
    logical positions ``pos`` ``(b, s)`` through the flat slot ``block * bt
    + pos % bt``; positions where ``valid_q`` is False (padding, dead rows)
    go to the trash page, the last pool page, at slot ``j % bt``, so they
    never touch a live page."""
    bt, mb = k_pool.shape[1], tables.shape[1]
    b, s = pos.shape
    j = torch.arange(s, device=pos.device)[None, :]
    blk = torch.gather(tables, 1, torch.clamp(pos // bt, 0, mb - 1).long())
    trash = k_pool.shape[0] - 1
    slot = torch.where(valid_q, blk.long() * bt + pos % bt,
                       trash * bt + j % bt).reshape(-1)
    k_pool.view(-1, *k_pool.shape[2:]).index_copy_(
        0, slot, k.reshape(b * s, *k.shape[2:]).to(k_pool.dtype))
    v_pool.view(-1, *v_pool.shape[2:]).index_copy_(
        0, slot, v.reshape(b * s, *v.shape[2:]).to(v_pool.dtype))


def gqa_prefill_paged(params, x, cfg: ModelConfig, cache: Dict,
                      q_valid: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Prefill a chunk of each request against a *paged* cache (the
    continuation path of chunked prefill).

    x: (b, s, d) — row ``r`` carries ``q_valid[r]`` valid chunk tokens
    (left-aligned, the rest padding) starting at logical position
    ``cache["length"][r]``; everything before it is already in the pools.
    The chunk's K/V is written in place first (``_write_feed``: padding,
    decode rows riding along with ``q_valid == 0`` and dead rows go to the
    trash page), then every query attends over the cached context and the
    causal part of its own chunk through ``ops.paged_chunk_attention``.
    Valid positions may land on prefix-shared pages: sharers rewrite
    matched blocks with identical content. The projections and rope are
    whole prefill's, per position, and the chunk attention has flash
    attention's numerics, so a chunk row equals the whole-prompt row.
    """
    hd = cfg.resolved_head_dim
    lengths = cache["length"]
    tables = cache["block_tables"]
    k_pool, v_pool = cache["k_pool"], cache["v_pool"]
    s = x.shape[1]
    j = torch.arange(s, device=x.device)[None, :]
    pos = lengths[:, None] + j                          # (b, s) logical pos
    q, k, v = _qkv(params, x, pos, cfg)
    _write_feed(k_pool, v_pool, tables, pos, j < q_valid[:, None], k, v)
    out = ops.paged_chunk_attention(q, k_pool, v_pool, tables, lengths,
                                    scale=hd ** -0.5)
    return _proj_out(out, params["wo"]), {
        "k_pool": k_pool, "v_pool": v_pool, "block_tables": tables,
        "length": lengths + q_valid}


def gqa_verify_paged(params, x, cfg: ModelConfig, cache: Dict,
                     q_valid: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Speculative-verify pass against a *paged* cache: row ``r`` carries
    ``q_valid[r]`` feed tokens (the last committed token plus its draft
    continuation) at logical positions ``cache["length"][r] + j``.

    Every feed position's K/V is written in place first (``_write_feed``:
    positions ``j >= q_valid[r]`` go to the trash page). Then
    ``ops.paged_verify_attention`` scores every position, position ``j``
    bit for bit what a one-token ``gqa_decode_paged`` gives there. The
    caller must have fork-grown each live row's table to cover ``length +
    q_valid`` positions with private pages (``PagedKVStore.fork_table``).
    """
    hd = cfg.resolved_head_dim
    lengths = cache["length"]
    tables = cache["block_tables"]
    k_pool, v_pool = cache["k_pool"], cache["v_pool"]
    s = x.shape[1]
    j = torch.arange(s, device=x.device)[None, :]
    pos = lengths[:, None] + j                          # (b, s) logical pos
    q, k, v = _qkv(params, x, pos, cfg)
    _write_feed(k_pool, v_pool, tables, pos, j < q_valid[:, None], k, v)
    out = ops.paged_verify_attention(q, k_pool, v_pool, tables, lengths,
                                     scale=hd ** -0.5)
    return _proj_out(out, params["wo"]), {
        "k_pool": k_pool, "v_pool": v_pool, "block_tables": tables,
        "length": lengths + q_valid}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _einsum(eq, a, b):
    """``jnp.einsum`` with JAX's type promotion (a bf16 latent cache times
    fp32 weights is fp32); ``torch.einsum`` takes one dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _mla_q(params, x, positions, cfg: ModelConfig):
    """(q_nope, q_rope) ``(b, s, n, nope)`` / ``(b, s, n, rope)``, the rope
    half rotated at ``positions``."""
    m = cfg.mla
    cq = (apply_norm(params["q_norm"], x @ params["wdq"], cfg)
          if m.q_lora_rank else x)
    q = proj_in(cq, params["wuq"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(params, x, positions, cfg: ModelConfig):
    """(c_kv ``(b, s, kv_lora)``, k_rope ``(b, s, 1, rope)``)."""
    c_kv = apply_norm(params["kv_norm"], x @ params["wdkv"], cfg)
    k_rope = apply_rope((x @ params["wkr"])[:, :, None, :], positions,
                        cfg.rope_theta)
    return c_kv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def _mla_inputs(params, x, positions, cfg: ModelConfig, tp=None):
    """(q_nope, q_rope, c_kv, k_rope): ``_mla_q`` and ``_mla_latent``.
    Under a mesh (``tp``: the block's ``attn`` layout) the per-head
    products ``wuq`` (and, after, ``wuk``, ``wuv`` and ``wo``) are on the
    rank's heads; the latents ``x @ wdkv`` (and ``x @ wdq``) are computed
    on the rank's ``kv_lora`` (``q_lora``) slice and gathered along it
    before their norms, which normalise the whole latent (the gather's
    backward keeps the rank's slice; the copy-in after the norm sums the
    heads' gradients, so the norm's gamma gets the whole one); the shared
    rope key is whole (copy-in). So ``c_kv`` and ``k_rope`` are whole on
    every rank, the latent cache's layout under a mesh."""
    if _mla_whole(tp):
        return (*_mla_q(params, x, positions, cfg),
                *_mla_latent(params, x, positions, cfg))
    m = cfg.mla
    for name in ("wuq", "wuk", "wuv"):
        if tp.dim(name) != 1:
            tp.refuse(name, "MLA runs with its heads split over 'model'")
    if tp.dim("wo") != 0 or tp.dim("wkr") is not None:
        tp.refuse("wo", "MLA runs with its heads split over 'model'")
    xin = tp.copy_in(x)

    def latent(w, norm):
        # whole on every rank, normalised, then copy-in: the norm's gamma
        # takes the whole gradient, summed over the ranks' heads
        if tp.dim(w) is None:
            c = x @ params[w]
        elif tp.dim(w) == 1:
            c = tp.gather(xin @ params[w], -1, reduce_grad=False)
        else:
            tp.refuse(w, "a latent split on its rank dim")
        return tp.copy_in(apply_norm(params[norm], c, cfg))
    cq = latent("wdq", "q_norm") if m.q_lora_rank else xin
    q = proj_in(cq, params["wuq"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = tp.copy_in(apply_rope((x @ params["wkr"])[:, :, None, :],
                                   positions, cfg.rope_theta))
    return q_nope, q_rope, latent("wdkv", "kv_norm"), k_rope


_MLA_LEAVES = ("wdq", "wuq", "wdkv", "wkr", "wuk", "wuv", "wo")


def _mla_whole(tp) -> bool:
    """Whether MLA runs whole on the rank (one process, or a layout that
    keeps every attention leaf whole: heads that do not divide "model",
    ``transformer.param_specs``)."""
    return tp is None or all(tp.dims.get(tp._key(n)) is None
                             for n in _MLA_LEAVES)


def _mla_out(out, params, tp=None):
    out = _proj_out(out, params["wo"])
    return out if _mla_whole(tp) else tp.reduce_out(out)


def mla_prefill(params, x, positions, cfg: ModelConfig,
                cache: Optional[Dict] = None, tp=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence MLA: K/V re-expanded from the latent, the rope key
    shared by every head, through ``ops.flash_attention`` at dq = nope +
    rope, dv = v_head_dim. If ``cache`` is given (a pre-allocated ``(b, S,
    kv_lora)`` / ``(b, S, rope)`` layer slice), the latent and the rope key
    are written into its first ``s`` positions in place. Under a mesh
    (``tp``) it runs on the rank's heads and rows (``_mla_inputs``); the
    cache holds the rank's rows of the whole latent, and of its positions
    where the layout splits them (``tp.seq``)."""
    m = cfg.mla
    q_nope, q_rope, c_kv, k_rope = _mla_inputs(params, x, positions, cfg,
                                               tp)
    k_nope = proj_in(c_kv, params["wuk"])
    v = proj_in(c_kv, params["wuv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3],
                                         m.qk_rope_head_dim)], dim=-1)
    out = ops.flash_attention(q, k, v, causal=not cfg.encoder_only,
                              scale=_mla_scale(cfg))
    new_cache = None
    if cache is not None:
        s = c_kv.shape[1]
        lo, n = _prompt_slice(cache["c_kv"].shape[1], s, _seq_split(tp)[0])
        cache["c_kv"][:, :n] = c_kv[:, lo:lo + n]
        cache["k_rope"][:, :n] = k_rope[:, lo:lo + n, 0]
        new_cache = {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"],
                     "length": torch.full_like(cache["length"], s)}
    return _mla_out(out, params, tp), new_cache


def mla_decode(params, x, cfg: ModelConfig, cache: Dict, tp=None
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token MLA decode against the dense latent cache. The new
    token's latent and rope key are written in place at ``length``
    (clamped to ``S - 1``, as in ``gqa_decode``). Naive: K/V re-expanded
    from the whole latent cache; ``cfg.mla.absorb``: attention in the
    latent space, ``wuk`` folded into the query and ``wuv`` applied after.
    JAX's rounding order: the einsums and their scaled sum in the compute
    dtype, the mask and softmax in fp32, the probabilities cast back.
    Under a mesh (``tp``) the einsums run on the rank's heads against
    the rank's rows of the whole latent, written from the gathered
    projection. Where the layout splits the positions (``tp.seq``) the
    owning rank writes the new entry, each rank's einsums run over its
    slice and return the rows' log-sum-exp beside the output (the latent
    output ``o_lat`` when absorbed), and ``merge_slices`` merges them; over
    a group holding "model" with every head (the queries, or naive's
    ``wuk``/``wuv``, gathered over "model"), the rank's own heads kept after
    the merge."""
    m = cfg.mla
    lengths = cache["length"]
    pos = lengths[:, None]
    q_nope, q_rope, c_new, kr_new = _mla_inputs(params, x, pos, cfg, tp)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    seq, seq_model = _seq_split(tp)
    start = _write_token((c_kv, k_rope), (c_new[:, 0], kr_new[:, 0, 0]),
                         lengths, seq)
    S = c_kv.shape[1]
    valid = (torch.arange(S, device=x.device)[None, :] + start
             < (lengths + 1)[:, None])                     # (b, S)
    scale = _mla_scale(cfg)
    wuk, wuv = params["wuk"], params["wuv"]
    heads = seq_model and tp.dim("wuq") == 1
    if heads:
        # every head's queries over the rank's positions
        q_rope = tp.gather(q_rope, 2)
        if m.absorb:
            q_nope = _einsum("bsnh,lnh->bsnl", q_nope, wuk)
        else:
            wuk, wuv = tp.gather(wuk, 1), tp.gather(wuv, 1)
        q_nope = tp.gather(q_nope, 2)

    def softmax(scores):
        scores = torch.where(valid[:, None, :], scores.float(), NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        if seq is None:
            return probs, None
        lse = torch.where(valid.any(-1)[:, None],
                          torch.logsumexp(scores, dim=-1), -torch.inf)
        return probs, lse
    rope = _einsum("bsnh,bSh->bnS", q_rope, k_rope)
    if m.absorb:
        q_lat = q_nope if heads else _einsum("bsnh,lnh->bsnl", q_nope, wuk)
        probs, lse = softmax((_einsum("bsnl,bSl->bnS", q_lat, c_kv) + rope)
                             * scale)
        o_lat = _einsum("bnS,bSl->bnl", probs.to(c_kv.dtype), c_kv)[:, None]
        if seq is not None:
            o_lat = merge_slices(o_lat, lse, seq)
            if heads:
                o_lat = local_slice(o_lat, 2, tp.model)
        out = _einsum("bsnl,lnh->bsnh", o_lat, wuv)
    else:
        k_nope = _einsum("bSl,lnh->bSnh", c_kv, wuk)
        v = _einsum("bSl,lnh->bSnh", c_kv, wuv)
        probs, lse = softmax((_einsum("bsnh,bSnh->bnS", q_nope, k_nope)
                              + rope) * scale)
        out = _einsum("bnS,bSnh->bnh", probs.to(v.dtype), v)[:, None]
        if seq is not None:
            out = merge_slices(out, lse, seq)
            if heads:
                out = local_slice(out, 2, tp.model)
    return _mla_out(out, params, tp), {"c_kv": c_kv, "k_rope": k_rope,
                                       "length": lengths + 1}


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Shape and dtype of the dense KV-cache entry for ONE attention layer:
    MLA's latent ``c_kv`` and shared rope key, or GQA's K/V."""
    if cfg.attn_type == "mla":
        m = cfg.mla
        return {
            "c_kv": ((batch, max_len, m.kv_lora_rank), dtype),
            "k_rope": ((batch, max_len, m.qk_rope_head_dim), dtype),
            "length": ((batch,), torch.int32),
        }
    hd = cfg.resolved_head_dim
    return {
        "k": ((batch, max_len, cfg.num_kv_heads, hd), dtype),
        "v": ((batch, max_len, cfg.num_kv_heads, hd), dtype),
        "length": ((batch,), torch.int32),
    }


def cache_axes(cfg: ModelConfig, seq_sharded: bool = False
               ) -> Dict[str, tuple]:
    """The logical axes of ``cache_spec``'s leaves, JAX's entry for entry
    (``seq_sharded`` is taken and unused, as in JAX): the sequence is
    "cache_seq" under ``shard_v2``, else "seq"; GQA's head dim is
    "head_dim_shard" (it takes "model" where the kv heads cannot), or
    None under ``shard_v2``. Under a mesh the port keeps the head dim and
    MLA's latent whole (``transformer.cache_specs``)."""
    seq_ax = "cache_seq" if cfg.shard_v2 else "seq"
    if cfg.attn_type == "mla":
        return {"c_kv": ("batch", seq_ax, "kv_lora"),
                "k_rope": ("batch", seq_ax, None),
                "length": ("batch",)}
    hd_ax = None if cfg.shard_v2 else "head_dim_shard"
    return {"k": ("batch", seq_ax, "kv_heads", hd_ax),
            "v": ("batch", seq_ax, "kv_heads", hd_ax),
            "length": ("batch",)}


def paged_cache_spec(cfg: ModelConfig, num_pages: int, block_tokens: int,
                     batch: int, max_blocks: int, dtype=torch.bfloat16
                     ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Shape and dtype of the *paged* KV-cache entry for ONE attention
    layer. ``num_pages`` counts every physical page, the trash page
    included."""
    if cfg.attn_type != "gqa":
        raise NotImplementedError("paged KV cache supports gqa/mqa/mha only")
    hd = cfg.resolved_head_dim
    return {
        "k_pool": ((num_pages, block_tokens, cfg.num_kv_heads, hd), dtype),
        "v_pool": ((num_pages, block_tokens, cfg.num_kv_heads, hd), dtype),
        "block_tables": ((batch, max_blocks), torch.int32),
        "length": ((batch,), torch.int32),
    }
