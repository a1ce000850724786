"""Dense decoder model for serving (twin of the dense family of
``repro.models.transformer``).

Parameters are a plain nested dict of tensors with the JAX pytree's keys and
its stacked ``(L, ...)`` layer layout, so ``weights.from_jax_params`` is a
tree map; ``lax.scan`` over the stack becomes a Python loop over layer
slices. Forward modes of this slice:

  * "prefill": last-position logits, K/V written into dense caches;
  * "decode": one-token logits against dense or paged caches (in place);
  * "verify": the speculative draft-and-verify pass over paged caches,
    logits at every feed position.

Training, chunked prefill and the other families arrive with later slices
and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Initializer, apply_mlp, apply_norm,
                                       init_mlp, init_norm, softcap)

def check_family(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"family={cfg.family!r}, attn_type={cfg.attn_type!r}: the "
            "PyTorch port serves the dense GQA family; the others arrive "
            "with the other-families slice")


def _init_block(init: Initializer, cfg: ModelConfig) -> Dict:
    return {
        "ln1": init_norm(init, cfg, cfg.d_model),
        "attn": attn.init_attention(init, cfg),
        "ln2": init_norm(init, cfg, cfg.d_model),
        "mlp": init_mlp(init, cfg),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, 0)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked ``(L, ...)`` param or cache subtree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device="cuda") -> Dict:
    """Random parameters (truncated-normal fan-in weights, zero output
    projections and norm gammas, as the JAX package) drawn from
    ``generator`` on ``device``."""
    check_family(cfg)
    init = Initializer(cfg, generator, device)
    d = cfg.d_model
    # N(0, 1/d) embeddings + sqrt(d) input scaling (gemma-style)
    params: Dict = {"embed": init.w((cfg.vocab_size, d), scale=d ** -0.5)}
    params["final_norm"] = init_norm(init, cfg, d)
    if not cfg.tie_embeddings:
        params["head"] = init.w((d, cfg.vocab_size), scale=d ** -0.5)
    params["layers"] = _stack([_init_block(init, cfg)
                               for _ in range(cfg.num_layers)])
    return params


def embed_scale(cfg: ModelConfig) -> float:
    """sqrt(d_model) rounded to the compute dtype, as a Python float. The
    JAX package multiplies by the scale already rounded to the compute
    dtype; PyTorch keeps a Python-float operand in fp32, so rounding it
    here first gives JAX's products without a device tensor."""
    compute = getattr(torch, cfg.compute_dtype)
    return float(torch.tensor(cfg.d_model ** 0.5, dtype=compute))


def _block_fwd(p, x, positions, cfg: ModelConfig, mode: str, cache,
               q_valid=None):
    h = apply_norm(p["ln1"], x, cfg)
    if mode == "decode":
        a, new_cache = attn.gqa_decode(p["attn"], h, cfg, cache)
    elif mode == "verify":
        a, new_cache = attn.gqa_verify_paged(p["attn"], h, cfg, cache,
                                             q_valid)
    else:
        a, new_cache = attn.gqa_prefill(p["attn"], h, positions, cfg, cache)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg)
    x = x + apply_mlp(p["mlp"], h, cfg)
    return x, new_cache


def forward(params, cfg: ModelConfig, *, tokens, mode: str = "prefill",
            caches=None, q_valid=None):
    """Returns ``(logits, new_caches)``; logits in ``cfg.logits_dtype``,
    ``(b, vocab)`` at the last position, except in mode "verify".

    mode="verify": ``tokens`` (b, s) holds a left-aligned feed per row (the
    last committed token plus draft tokens, ``q_valid`` (b,) valid per row)
    written through the paged caches; the logits come back un-sliced,
    ``(b, s, vocab)``, since acceptance needs the argmax at every position.
    """
    check_family(cfg)
    if mode not in ("prefill", "decode", "verify"):
        raise NotImplementedError(
            f"mode={mode!r}: train/chunk arrive with later slices")
    compute = getattr(torch, cfg.compute_dtype)
    x = params["embed"].to(compute)[tokens]
    x = x * embed_scale(cfg)
    s = tokens.shape[1]
    positions = (None if mode in ("decode", "verify") else
                 torch.arange(s, dtype=torch.int32, device=x.device)[None, :])

    c = caches["attn"] if caches is not None else None
    lengths = []
    for i in range(cfg.num_layers):
        cache_i = None if c is None else layer_slice(c, i)
        x, nc = _block_fwd(layer_slice(params["layers"], i), x, positions,
                           cfg, mode, cache_i, q_valid)
        if nc is not None:
            lengths.append(nc["length"])
    new_caches = None
    if c is not None:
        # pools/caches were written in place; only the lengths are new
        new_caches = {"attn": {**c, "length": torch.stack(lengths, 0)}}

    x = apply_norm(params["final_norm"], x, cfg)
    if mode == "prefill":
        x = x[:, -1:, :]
    if cfg.tie_embeddings:
        # (E x^T)^T keeps the embedding in its (vocab, d) layout; on the
        # CPU x E^T takes another kernel at some row counts, and then a
        # row's logits depend on how many rows the pass has (verify vs
        # decode)
        flat = x.reshape(-1, x.shape[-1])
        logits = (params["embed"].to(x.dtype) @ flat.T).T.reshape(
            *x.shape[:-1], -1)
    else:
        logits = x @ params["head"].to(x.dtype)
    logits = logits.to(getattr(torch, cfg.logits_dtype))
    logits = softcap(logits, cfg.logits_softcap)
    if mode == "verify":
        return logits, new_caches
    return logits[:, -1, :], new_caches


# ---------------------------------------------------------------------------
# cache factories
# ---------------------------------------------------------------------------

def _zeros_tree(spec, n: int, device):
    return {k: torch.zeros((n, *shape), dtype=dt, device=device)
            for k, (shape, dt) in spec.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Dense ``(L, b, max_len, kvh, hd)`` prefill caches (bf16, as the JAX
    package's ``cache_spec`` default)."""
    check_family(cfg)
    return {"attn": _zeros_tree(attn.cache_spec(cfg, batch, max_len),
                                cfg.num_layers, device)}


def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_tokens: int, max_blocks: int, device="cuda"):
    """Paged caches: each layer holds pools of ``num_blocks + 1`` pages;
    page ``num_blocks`` is the engine's *trash page* — dead rows' tables
    point at it and their masked decode writes land there. Block tables
    start all-trash and lengths at 0."""
    check_family(cfg)
    spec = attn.paged_cache_spec(cfg, num_blocks + 1, block_tokens, batch,
                                 max_blocks)
    g = _zeros_tree(spec, cfg.num_layers, device)
    g["block_tables"].fill_(num_blocks)
    return {"attn": g}
