"""Decoder model for serving (twin of the dense, vlm and moe families of
``repro.models.transformer``; the vlm's stub frontend hands prefill its
embeddings through ``frontend_proj``). Attention is GQA, or MLA in the
dense and moe families; the moe family stacks ``first_k_dense`` dense
blocks (``dense_layers``) before its MoE blocks (``layers``), each group
with its own cache (``dense_attn``, ``attn``).

Parameters are a plain nested dict of tensors with the JAX pytree's keys and
its stacked ``(L, ...)`` layer layout, so ``weights.from_jax_params`` is a
tree map; ``lax.scan`` over the stack becomes a Python loop over layer
slices. Forward modes of this slice:

  * "prefill": last-position logits, K/V written into dense caches;
  * "decode": one-token logits against dense or paged caches (in place);
  * "chunk": the chunked-prefill continuation over paged caches, logits at
    each row's last valid chunk position;
  * "verify": the speculative draft-and-verify pass over paged caches,
    logits at every feed position.

Training and the other families arrive with later slices and raise
``NotImplementedError`` here; so do chunk and verify for MLA, whose cache
is not paged (as in the JAX package).
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Initializer, apply_mlp, apply_norm,
                                       init_mlp, init_norm, softcap)
from repro_torch.models.moe import apply_moe, init_moe


def check_family(cfg: ModelConfig):
    if cfg.family == "audio":
        raise NotImplementedError(
            f"family='audio' ({cfg.name}): its serving entry runs the "
            "encoder forward, mode='train', which arrives with the training "
            "slice of the PyTorch port")
    served = {"dense": ("gqa", "mla"), "vlm": ("gqa",), "moe": ("mla",)}
    if cfg.attn_type not in served.get(cfg.family, ()):
        raise NotImplementedError(
            f"family={cfg.family!r}, attn_type={cfg.attn_type!r}: the "
            "PyTorch port serves GQA and MLA attention in the dense family, "
            "GQA in the vlm and MLA in the moe family; a GQA MoE needs the "
            "paged Engine's MoE path and the recurrent families their own "
            "layers, which arrive with later slices")


def _init_block(init: Initializer, cfg: ModelConfig,
                moe_layer: bool = False) -> Dict:
    p = {
        "ln1": init_norm(init, cfg, cfg.d_model),
        "attn": attn.init_attention(init, cfg),
        "ln2": init_norm(init, cfg, cfg.d_model),
    }
    if moe_layer:
        p["moe"] = init_moe(init, cfg)
    else:
        p["mlp"] = init_mlp(init, cfg)
    return p


def _init_layers(init: Initializer, cfg: ModelConfig, n: int,
                 moe_layer: bool = False) -> Dict:
    """``n`` stacked ``(n, ...)`` blocks, drawn block by block in layer
    order and written into leaves allocated once: the same tensors as
    stacking ``n`` block trees, without holding every layer twice."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n, *t.shape))

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v
    out = None
    for i in range(n):
        block = _init_block(init, cfg, moe_layer)
        out = alloc(block) if out is None else out
        put(out, block, i)
        del block
    return out


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
    if cfg.stub_frontend:
        params["frontend_proj"] = init.w((cfg.frontend_dim, d))
    params["final_norm"] = init_norm(init, cfg, d)
    if not cfg.tie_embeddings:
        params["head"] = init.w((d, cfg.vocab_size), scale=d ** -0.5)
    for pkey, _, n in _groups(cfg):
        params[pkey] = _init_layers(init, cfg, n, moe_layer=(
            cfg.family == "moe" and pkey == "layers"))
    return params


def embed_scale(cfg: ModelConfig) -> float:
    """sqrt(d_model) rounded to the compute dtype, as a Python float. The
    JAX package multiplies by the scale already rounded to the compute
    dtype; PyTorch keeps a Python-float operand in fp32, so rounding it
    here first gives JAX's products without a device tensor."""
    return _rounded_sqrt(cfg.d_model, cfg.compute_dtype)


@functools.lru_cache(maxsize=None)
def _rounded_sqrt(n: int, dtype: str) -> float:
    # cached: the rounding reads a host tensor back, which a pass's
    # sync-free check would see on every call
    return float(torch.tensor(n ** 0.5, dtype=getattr(torch, dtype)))


def _block_fwd(p, x, positions, cfg: ModelConfig, mode: str, cache,
               q_valid=None):
    h = apply_norm(p["ln1"], x, cfg)
    mla = cfg.attn_type == "mla"
    if mla and mode in ("chunk", "verify"):
        what = ("chunked prefill" if mode == "chunk"
                else "speculative verify")
        raise NotImplementedError(f"{what} supports gqa-family attention "
                                  "only (paged KV)")
    if mode == "decode":
        a, new_cache = (attn.mla_decode if mla else attn.gqa_decode)(
            p["attn"], h, cfg, cache)
    elif mode == "chunk":
        a, new_cache = attn.gqa_prefill_paged(p["attn"], h, cfg, cache,
                                              q_valid)
    elif mode == "verify":
        a, new_cache = attn.gqa_verify_paged(p["attn"], h, cfg, cache,
                                             q_valid)
    else:
        a, new_cache = (attn.mla_prefill if mla else attn.gqa_prefill)(
            p["attn"], h, positions, cfg, cache)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        x = x + apply_moe(p["moe"], h, cfg)[0]
    else:
        x = x + apply_mlp(p["mlp"], h, cfg)
    return x, new_cache


def _groups(cfg: ModelConfig):
    """(params key, cache key, layers) of each stack of blocks, in forward
    order: the moe family's ``first_k_dense`` dense blocks, then its MoE
    blocks; one stack otherwise."""
    if cfg.family == "moe":
        kd = cfg.moe.first_k_dense
        return (("dense_layers", "dense_attn", kd),
                ("layers", "attn", cfg.num_layers - kd))
    return (("layers", "attn", cfg.num_layers),)


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            mode: str = "prefill", caches=None, q_valid=None):
    """Returns ``(logits, new_caches)``; logits in ``cfg.logits_dtype``,
    ``(b, vocab)`` at the last position, except in mode "verify".

    ``embeds`` (b, s, frontend_dim), given in place of ``tokens``, are a
    stub frontend's outputs: the input is ``embeds @ frontend_proj``, with
    no embedding scale.

    mode="chunk": ``tokens`` (b, s) holds one left-aligned chunk per row,
    ``q_valid`` (b,) its valid token count, over paged caches; each chunk
    continues the row's cached context at position ``length``. The logits
    are taken at each row's last valid chunk position (rows with ``q_valid
    == 0`` read position 0: garbage the caller ignores).

    mode="verify": ``tokens`` (b, s) holds a left-aligned feed per row (the
    last committed token plus draft tokens, ``q_valid`` (b,) valid per row)
    written through the paged caches; the logits come back un-sliced,
    ``(b, s, vocab)``, since acceptance needs the argmax at every position.
    """
    check_family(cfg)
    if mode not in ("prefill", "decode", "chunk", "verify"):
        raise NotImplementedError(
            f"mode={mode!r}: training arrives with a later slice")
    compute = getattr(torch, cfg.compute_dtype)
    if embeds is not None:
        x = embeds.to(compute) @ params["frontend_proj"].to(compute)
    else:
        x = params["embed"].to(compute)[tokens]
        x = x * embed_scale(cfg)
    s = x.shape[1]
    positions = (None if mode in ("decode", "chunk", "verify") else
                 torch.arange(s, dtype=torch.int32, device=x.device)[None, :])

    new_caches = None if caches is None else {}
    for pkey, ckey, n in _groups(cfg):
        c = caches[ckey] if caches is not None else None
        lengths = []
        for i in range(n):
            cache_i = None if c is None else layer_slice(c, i)
            x, nc = _block_fwd(layer_slice(params[pkey], i), x, positions,
                               cfg, mode, cache_i, q_valid)
            if nc is not None:
                lengths.append(nc["length"])
        if c is not None:
            # pools/caches were written in place; only the lengths are new
            new_caches[ckey] = {**c, "length": torch.stack(lengths, 0)}

    x = apply_norm(params["final_norm"], x, cfg)
    if mode == "prefill":
        x = x[:, -1:, :]
    elif mode == "chunk":
        idx = torch.clamp(q_valid.long() - 1, min=0)
        x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
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
    """Dense prefill caches, one ``(L, ...)`` stack a group of blocks: GQA
    ``(L, b, max_len, kvh, hd)`` K/V, or MLA's latent and rope key (bf16,
    as the JAX package's ``cache_spec`` default)."""
    check_family(cfg)
    spec = attn.cache_spec(cfg, batch, max_len)
    return {ckey: _zeros_tree(spec, n, device)
            for _, ckey, n in _groups(cfg)}


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
