"""prefill_step / serve_step and the paged-cache page movement (twin of the
serving half of ``repro.models.steps``). Page movement writes the pools in
place and returns the same cache dict."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def prefill_step(params, batch: Dict, cfg: ModelConfig, max_len: int):
    """Full-sequence prefill into fresh ``max_len`` dense caches on the
    tokens' device. Returns (last_logits, caches)."""
    tokens = batch["tokens"]
    caches = tf.init_cache(cfg, tokens.shape[0], max_len, tokens.device)
    return tf.forward(params, cfg, tokens=tokens, mode="prefill",
                      caches=caches)


def serve_step(params, tokens, caches, cfg: ModelConfig):
    """One decode step over paged caches: tokens (b, 1) ->
    (new_token (b,) int32, logits, caches)."""
    logits, caches = tf.forward(params, cfg, tokens=tokens, mode="decode",
                                caches=caches)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits, caches


def write_prefill_pages(caches, dense, ids, *, block_tokens: int):
    """Blockify a dense single-request prefill cache (``(L, 1, S, kvh, hd)``
    leaves) and write its first ``len(ids)`` blocks into the paged pools at
    physical pages ``ids``."""
    n = ids.shape[0]
    for name, g in caches.items():
        for ck, pk in (("k", "k_pool"), ("v", "v_pool")):
            leaf = dense[name][ck][:, 0, :n * block_tokens]
            blocks = leaf.reshape(leaf.shape[0], n, block_tokens,
                                  *leaf.shape[2:])
            g[pk][:, ids] = blocks.to(g[pk].dtype)
    return caches


def gather_pages(caches, ids):
    """Pull physical pages ``ids`` out of every paged cache group:
    ``{group: {"k": (L, n, bt, kvh, hd), "v": ...}}`` (the swap payload)."""
    return {name: {"k": g["k_pool"][:, ids], "v": g["v_pool"][:, ids]}
            for name, g in caches.items()}


def scatter_pages(caches, pages, ids):
    """Inverse of ``gather_pages``: write page payloads back into the pools
    at physical pages ``ids`` (swap-in)."""
    for name, g in caches.items():
        g["k_pool"][:, ids] = pages[name]["k"]
        g["v_pool"][:, ids] = pages[name]["v"]
    return caches
