"""GQA/MQA attention for serving (twin of the GQA half of
``repro.models.attention``).

Prefill is causal full-sequence attention through ``ops.flash_attention``;
decode reads a paged cache through ``ops.paged_decode_attention``. Caches are
updated in place: where the JAX package returns a new pool from
``.at[slot].set(...)``, this module writes the new token's K/V into the
layer's slice of the pool with ``index_copy_``, which saves a whole-pool
copy per layer per step. The returned cache dict still names the (same)
pools, so callers read like the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Initializer, apply_rope


def init_attention(init: Initializer, cfg: ModelConfig) -> Dict:
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"attn_type={cfg.attn_type!r}: the PyTorch port serves GQA/MQA "
            "attention; MLA arrives with the other-families slice")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": init.w((d, cfg.num_heads, hd)),
        "wk": init.w((d, cfg.num_kv_heads, hd)),
        "wv": init.w((d, cfg.num_kv_heads, hd)),
        "wo": init.z((cfg.num_heads, hd, d)),
    }


def _proj_in(x, w):
    """einsum("bsd,dnh->bsnh") as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _proj_out(o, w):
    """einsum("bsnh,nhd->bsd") as one matmul."""
    return o.flatten(-2) @ w.reshape(-1, w.shape[-1])


def _qkv(params, x, positions, cfg: ModelConfig):
    q = _proj_in(x, params["wq"])
    k = _proj_in(x, params["wk"])
    v = _proj_in(x, params["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_prefill(params, x, positions, cfg: ModelConfig,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence attention. If ``cache`` is given (a pre-allocated
    ``(b, S, kvh, hd)`` layer slice), the computed K/V are written into its
    first ``s`` positions in place (inference prefill)."""
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(params, x, positions, cfg)
    out = ops.flash_attention(q, k, v, causal=not cfg.encoder_only,
                              scale=hd ** -0.5)
    new_cache = None
    if cache is not None:
        s = k.shape[1]
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "length": torch.full_like(cache["length"], s)}
    return _proj_out(out, params["wo"]), new_cache


def gqa_decode(params, x, cfg: ModelConfig,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. Only the paged cache (``k_pool`` present) is
    served by this slice."""
    if "k_pool" in cache:
        return gqa_decode_paged(params, x, cfg, cache)
    raise NotImplementedError(
        "dense (non-paged) decode arrives with the SlotEngine / "
        "decode_attention slice of the port")


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


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Shape and dtype of the dense KV-cache entry for ONE attention layer."""
    hd = cfg.resolved_head_dim
    return {
        "k": ((batch, max_len, cfg.num_kv_heads, hd), dtype),
        "v": ((batch, max_len, cfg.num_kv_heads, hd), dtype),
        "length": ((batch,), torch.int32),
    }


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
