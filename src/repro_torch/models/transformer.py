"""Decoder model for serving (twin of the dense, vlm, moe, hybrid and ssm
families of ``repro.models.transformer``; the vlm's stub frontend hands
prefill its embeddings through ``frontend_proj``). Attention is GQA, or MLA
in the dense and moe families; the moe family stacks ``first_k_dense``
dense blocks (``dense_layers``) before its MoE blocks (``layers``), each
group with its own cache (``dense_attn``, ``attn``). The hybrid (Zamba2)
runs spans of ``shared_attn_every`` Mamba2 layers (``mamba``), each span
followed by one GQA block whose weights every application shares
(``shared``) and whose cache each application has of its own (``attn``,
``(n_apps, ...)``); the ssm family (xLSTM) runs groups of ``slstm_every -
1`` mLSTM layers (``mlstm``), each followed by one sLSTM (``slstm``).
Their caches are the recurrent states (``mamba``, ``mlstm``, ``slstm``).

Parameters are a plain nested dict of tensors with the JAX pytree's keys and
its stacked ``(L, ...)`` layer layout, so ``weights.from_jax_params`` is a
tree map; ``lax.scan`` over the stack becomes a Python loop over layer
slices. Forward modes:

  * "train": full-sequence logits ``(b, s, vocab)`` and no caches, for
    every family (encoder-only configs run it non-causal; it is also
    HuBERT's serving entry). ``train_forward`` also returns the routers'
    load-balancing aux, summed in fp32 over the MoE layers. Under autograd
    the layer bodies follow ``cfg.remat`` as JAX's ``_remat`` wraps them
    (each block, Mamba2 body and mLSTM body; the hybrid's shared block and
    the sLSTM are not wrapped): "full" recomputes a body in the backward
    (``torch.utils.checkpoint``, JAX's ``nothing_saveable``), "dots" saves
    the outputs of its matrix products and recomputes the rest (JAX's
    ``dots_saveable``; the attention kernel is not a product, so its
    forward is recomputed), "none" saves every activation;
  * "prefill": last-position logits, K/V and recurrent states written into
    the caches;
  * "decode": one-token logits against dense or paged caches, K/V and
    recurrent states written in place;
  * "chunk": the chunked-prefill continuation over paged caches, logits at
    each row's last valid chunk position;
  * "verify": the speculative draft-and-verify pass over paged caches,
    logits at every feed position.

Chunk and verify raise ``NotImplementedError`` for MLA and the recurrent
families, whose caches are not paged (as in the JAX package). An
encoder-only config has no decode or cache path: every mode but "train"
and the cache factories raise ``ValueError``.

Under a mesh (``rules``/``mesh``, JAX's arguments) every family runs
sharded in modes "train", "prefill" and "decode" (``distributed.Plan``:
rows over the data axes; heads, ff and vocabulary over "model", the
Mamba2, mLSTM and sLSTM heads too; experts in the MoE layers), with the
params laid out by ``param_specs`` and the dense caches and recurrent
states by ``cache_specs``. Under FSDP (mode "train") the weights' d_model
dim is split over the data axes as well, and each layer gathers its
leaves whole inside its remat body (``Layout.gathered``; the embedding,
head and ``frontend_proj`` where they are used). Under ``seq_sharded``
(serving, GQA caches or none) the batch is whole on every rank and the
data axes split the caches' sequence instead.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch import distributed as dist_
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (Initializer, apply_mlp, apply_norm,
                                       init_mlp, init_norm, softcap)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.sharding import PartitionSpec


def check_family(cfg: ModelConfig):
    served = {"dense": ("gqa", "mla"), "vlm": ("gqa",), "audio": ("gqa",),
              "moe": ("mla",), "hybrid": ("gqa",), "ssm": ("none",)}
    if cfg.attn_type not in served.get(cfg.family, ()):
        raise NotImplementedError(
            f"family={cfg.family!r}, attn_type={cfg.attn_type!r}: the "
            "PyTorch port serves GQA and MLA attention in the dense family, "
            "GQA in the vlm, the audio encoder and the hybrid, MLA in the "
            "moe family and the ssm family without attention; a GQA MoE "
            "needs the paged Engine's MoE path, which arrives with later "
            "slices")


REMATS = ("none", "full", "dots")


def check_train(cfg: ModelConfig, rules=None, mesh=None):
    """Raise for a config the port cannot train: a family it does not
    serve (``check_family``), or a ``remat`` outside JAX's "none",
    "full" and "dots" (``ValueError``); under a mesh, a layout the sharded
    schedule does not run (``distributed.check_rules``:
    ``NotImplementedError``)."""
    check_family(cfg)
    if cfg.remat not in REMATS:
        raise ValueError(f"remat={cfg.remat!r}: one of {REMATS}")
    if rules is not None or mesh is not None:
        dist_.plan(cfg, rules, mesh)


def check_serving(cfg: ModelConfig):
    """Raise ``ValueError`` for an encoder-only config, which has no decode
    or cache path (``supports_decode`` is false)."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only; no serving path")


def prefill_chunk(cfg: ModelConfig) -> int:
    """The chunk of the recurrent families' prefill scan, 0 for the others:
    a prompt of ``l`` tokens is taken when ``l <= chunk`` or ``l % chunk
    == 0`` (the JAX package asserts the same)."""
    if cfg.family == "hybrid":
        return cfg.ssm.chunk_size
    if cfg.family == "ssm":
        return cfg.xlstm.chunk_size
    return 0


def check_prompt(cfg: ModelConfig, n: int):
    """Raise ``ValueError`` for a prompt of ``n`` tokens the config's
    prefill does not take (``prefill_chunk``)."""
    chunk = prefill_chunk(cfg)
    if chunk:
        m2.check_chunks(n, chunk)


def _ssm_layout(cfg: ModelConfig):
    """(n_groups, mlstm_per_group, n_slstm). slstm_every == 0 => pure
    mLSTM."""
    if not cfg.xlstm.slstm_every:
        return 1, cfg.num_layers, 0
    n_groups = cfg.num_layers // cfg.xlstm.slstm_every
    return n_groups, cfg.xlstm.slstm_every - 1, n_groups


def _n_apps(cfg: ModelConfig) -> int:
    """How often the hybrid applies its shared attention block."""
    return (cfg.num_layers // cfg.shared_attn_every
            if cfg.shared_attn_every else 0)


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


def _init_layers(init: Initializer, n: int, build) -> Dict:
    """``n`` stacked ``(n, ...)`` blocks, drawn block by block in layer
    order by ``build()`` and written into leaves allocated once: the same
    tensors as stacking ``n`` block trees, without holding every layer
    twice. A recording ``init`` gets the stack's axes, "scan" in front."""
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
        block = build()
        if out is None:
            out = alloc(block)
            init.stacked(block, out)
        put(out, block, i)
        del block
    return out


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked ``(L, ...)`` param or cache subtree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def unbind_layers(tree, n: int):
    """The ``n`` layers of a stacked ``(L, ...)`` subtree as ``n`` trees of
    views, through one ``torch.unbind`` a leaf. Under autograd a leaf's
    gradient is then one stack of the layers' gradients; ``n``
    ``layer_slice`` views would each scatter theirs into a zero tensor of
    the whole stack and add it, ``n`` times the stack's bytes."""
    if isinstance(tree, dict):
        per = {k: unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return torch.unbind(tree)


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device="cuda") -> Dict:
    """Random parameters (truncated-normal fan-in weights, zero output
    projections and norm gammas, as the JAX package) drawn from
    ``generator`` on ``device``."""
    return _build(cfg, Initializer(cfg, generator, device))


def param_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of every leaf, by JAX's dotted path ("embed",
    "layers.attn.wq", ...; stacked leaves lead with "scan"): what JAX's
    ``init_model(cfg, key)[1]`` gives. The tree is built on the ``meta``
    device, so a full-width config costs no memory."""
    return dict(_abstract(cfg)[1])


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The shape of every leaf, by the paths of ``param_axes``."""
    return dict(_abstract(cfg)[0])


@functools.lru_cache(maxsize=64)
def _abstract(cfg: ModelConfig):
    init = Initializer(cfg, None, "meta", record=True)
    params = _build(cfg, init)
    shapes, axes = {}, {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        else:
            shapes[prefix] = tuple(t.shape)
            axes[prefix] = init.axes[id(t)]
    walk(params, "")
    return shapes, axes


def _build(cfg: ModelConfig, init: Initializer) -> Dict:
    check_family(cfg)
    d = cfg.d_model
    # N(0, 1/d) embeddings + sqrt(d) input scaling (gemma-style)
    params: Dict = {"embed": init.w((cfg.vocab_size, d),
                                    ("vocab", "w_embed"), scale=d ** -0.5)}
    if cfg.stub_frontend:
        params["frontend_proj"] = init.w((cfg.frontend_dim, d),
                                         (None, "w_embed"))
    params["final_norm"] = init_norm(init, cfg, d)
    if not cfg.tie_embeddings:
        params["head"] = init.w((d, cfg.vocab_size), ("w_embed", "vocab"),
                                scale=d ** -0.5)
    if cfg.family == "hybrid":
        params["mamba"] = _init_layers(
            init, cfg.num_layers, lambda: m2.init_mamba2(init, cfg))
        params["shared"] = _init_block(init, cfg)
    elif cfg.family == "ssm":
        n_groups, n_m_per, n_slstm = _ssm_layout(cfg)
        params["mlstm"] = _init_layers(
            init, n_groups * n_m_per, lambda: xl.init_mlstm(init, cfg))
        if n_slstm:
            params["slstm"] = _init_layers(
                init, n_slstm, lambda: xl.init_slstm(init, cfg))
    else:
        for pkey, _, n in _groups(cfg):
            moe_layer = cfg.family == "moe" and pkey == "layers"
            params[pkey] = _init_layers(
                init, n, lambda: _init_block(init, cfg, moe_layer))
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
               q_valid=None, tp=None):
    h = apply_norm(p["ln1"], x, cfg)
    mla = cfg.attn_type == "mla"
    if mla and mode in ("chunk", "verify"):
        what = ("chunked prefill" if mode == "chunk"
                else "speculative verify")
        raise NotImplementedError(f"{what} supports gqa-family attention "
                                  "only (paged KV)")
    atp = None if tp is None else tp.sub("attn")
    if mode == "decode":
        a, new_cache = (attn.mla_decode if mla else attn.gqa_decode)(
            p["attn"], h, cfg, cache, atp)
    elif mode == "chunk":
        a, new_cache = attn.gqa_prefill_paged(p["attn"], h, cfg, cache,
                                              q_valid)
    elif mode == "verify":
        a, new_cache = attn.gqa_verify_paged(p["attn"], h, cfg, cache,
                                             q_valid)
    else:
        a, new_cache = (attn.mla_prefill if mla else attn.gqa_prefill)(
            p["attn"], h, positions, cfg, cache, atp)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg)
    aux = None
    if "moe" in p:
        mo, aux = apply_moe(p["moe"], h, cfg,
                            tp=None if tp is None else tp.sub("moe"))
        x = x + mo
    else:
        x = x + apply_mlp(p["mlp"], h, cfg,
                          tp=None if tp is None else tp.sub("mlp"))
    return x, new_cache, aux


# the products whose outputs remat "dots" saves (JAX's dots_saveable keeps
# every dot_general's)
_DOTS = ("mm", "bmm", "addmm", "baddbmm", "_grouped_mm")


@functools.lru_cache(maxsize=None)
def _dot_ops():
    return frozenset(getattr(torch.ops.aten, n).default for n in _DOTS)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _dot_ops()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, cfg: ModelConfig):
    """JAX's ``_remat`` for mode "train": ``fn`` itself under remat "none"
    or when autograd does not record; else ``fn`` under
    ``torch.utils.checkpoint``, its body recomputed in the backward
    ("full"), or all of it but its matrix products' outputs ("dots")."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {} if cfg.remat == "full" else {"context_fn": _dots_context}
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False, **kw)


def _gathered(p, tp):
    """A layer's leaves as its body reads them: under FSDP gathered whole
    over the data axes (``distributed.Layout.gathered``)."""
    return p if tp is None else tp.gathered(p)


def _train_block(p, x, positions, cfg: ModelConfig, tp=None):
    """One attention block of mode "train": (x, its MoE aux or None);
    under a mesh ``tp`` is the block's ``distributed.Layout``."""
    x, _, aux = _block_fwd(_gathered(p, tp), x, positions, cfg, "train",
                           None, tp=tp)
    return x, aux


def _train_mamba(p, x, cfg: ModelConfig, tp=None):
    return x + m2.mamba2_forward(_gathered(p, tp), x, cfg, tp=tp)[0]


def _train_mlstm(p, x, cfg: ModelConfig, tp=None):
    return x + xl.mlstm_forward(_gathered(p, tp), x, cfg, tp=tp)[0]


def _train_blocks(params, x, positions, cfg: ModelConfig, plan=None):
    """The attention blocks of mode "train", with no caches, each under
    ``_remat``. Returns (x, the routers' aux summed in fp32 in layer
    order, 0 without MoE layers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat(_train_block, cfg)
    for pkey, _, n in _groups(cfg):
        tp = None if plan is None else plan.block(pkey)
        for p in unbind_layers(params[pkey], n):
            x, a = block(p, x, positions, cfg, tp)
            if a is not None:
                aux = aux + a
    return x, aux


def _groups(cfg: ModelConfig):
    """(params key, cache key, layers) of each stack of blocks, in forward
    order: the moe family's ``first_k_dense`` dense blocks, then its MoE
    blocks; one stack otherwise."""
    if cfg.family == "moe":
        kd = cfg.moe.first_k_dense
        return (("dense_layers", "dense_attn", kd),
                ("layers", "attn", cfg.num_layers - kd))
    return (("layers", "attn", cfg.num_layers),)


def _put(dst: Dict, src: Dict):
    """Write a layer's new state ``src`` into its cache slice ``dst`` in
    place."""
    for k, v in src.items():
        dst[k].copy_(v)


def _mamba_layer(params, x, i: int, cfg: ModelConfig, mode: str, state,
                 tp=None):
    """Mamba2 layer ``i`` with its residual; its state (``state``: the
    ``mamba`` cache, or None) is written in place. ``tp``: the layer's
    layout under a mesh."""
    p = _gathered(layer_slice(params["mamba"], i), tp)
    if mode == "decode":
        y, _ = m2.mamba2_decode(p, x, cfg, layer_slice(state, i), tp=tp)
    else:
        y, st = m2.mamba2_forward(p, x, cfg, return_state=state is not None,
                                  tp=tp)
        if state is not None:
            _put(layer_slice(state, i), st)
    return x + y


def _hybrid(params, x, positions, cfg: ModelConfig, mode: str, caches,
            plan=None):
    """Spans of ``shared_attn_every`` Mamba2 layers, each followed by the
    shared attention block over its own cache (application ``g`` reads
    ``attn[g]``); the leftover Mamba2 layers come last. In mode "train"
    (no caches, each scan from zeros) each Mamba2 body is under
    ``_remat`` and the shared block is not, as in JAX. Under ``plan`` the
    Mamba2 layers run on the rank's heads and the shared block as the
    dense families' blocks do (under FSDP gathered at each
    application)."""
    state = caches["mamba"] if caches is not None else None
    attn_c = caches.get("attn") if caches is not None else None
    mtp = None if plan is None else plan.block("mamba")
    if mode == "train":
        body = _remat(_train_mamba, cfg)
        layers = unbind_layers(params["mamba"], cfg.num_layers)

        def mamba(x, i):
            return body(layers[i], x, cfg, mtp)
    else:
        def mamba(x, i):
            return _mamba_layer(params, x, i, cfg, mode, state, mtp)
    stp = None if plan is None else plan.block("shared")
    per = cfg.shared_attn_every
    lengths = []
    idx = 0
    for g in range(_n_apps(cfg)):
        for i in range(idx, idx + per):
            x = mamba(x, i)
        ac = None if attn_c is None else layer_slice(attn_c, g)
        x, nac, _ = _block_fwd(_gathered(params["shared"], stp), x,
                               positions, cfg, mode, ac, tp=stp)
        if nac is not None:
            lengths.append(nac["length"])
        idx += per
    for i in range(idx, cfg.num_layers):
        x = mamba(x, i)
    if caches is None:
        return x, None
    new = {"mamba": state}
    if lengths:
        new["attn"] = {**attn_c, "length": torch.stack(lengths, 0)}
    return x, new


def _ssm(params, x, cfg: ModelConfig, mode: str, caches, plan=None):
    """Groups of ``slstm_every - 1`` mLSTM layers, each followed by one
    sLSTM. As in the JAX package, a prefill given caches starts each sLSTM
    from its cache's state (zeros from ``init_cache``), and without caches
    from zeros with m = -1e30; the mLSTM prefill always starts fresh. In
    mode "train" (no caches) each mLSTM body is under ``_remat`` and the
    sLSTM is not, as in JAX. Under ``plan`` each layer runs on the rank's
    heads."""
    n_groups, n_m_per, n_slstm = _ssm_layout(cfg)
    mstate = caches["mlstm"] if caches is not None else None
    sstate = caches.get("slstm") if caches is not None else None
    mtp = None if plan is None else plan.block("mlstm")
    stp = None if plan is None else plan.block("slstm")
    if mode == "train":
        body = _remat(_train_mlstm, cfg)
        layers = unbind_layers(params["mlstm"], n_groups * n_m_per)
        slstms = unbind_layers(params["slstm"], n_slstm) if n_slstm else ()

        def mlstm(x, i):
            return body(layers[i], x, cfg, mtp)

        def slstm(x, g):
            return x + xl.slstm_forward(_gathered(slstms[g], stp), x, cfg,
                                        tp=stp)[0]
    else:
        def mlstm(x, i):
            p = _gathered(layer_slice(params["mlstm"], i), mtp)
            if mode == "decode":
                y, _ = xl.mlstm_decode(p, x, cfg, layer_slice(mstate, i),
                                       tp=mtp)
            else:
                y, st = xl.mlstm_forward(p, x, cfg,
                                         return_state=mstate is not None,
                                         tp=mtp)
                if mstate is not None:
                    _put(layer_slice(mstate, i), st)
            return x + y

        def slstm(x, g):
            ss = None if sstate is None else layer_slice(sstate, g)
            y, new_ss = xl.slstm_forward(
                _gathered(layer_slice(params["slstm"], g), stp), x, cfg,
                state=ss, tp=stp)
            if ss is not None:
                _put(ss, new_ss)
            return x + y
    for g in range(n_groups):
        for i in range(g * n_m_per, (g + 1) * n_m_per):
            x = mlstm(x, i)
        if n_slstm:
            x = slstm(x, g)
    if caches is None:
        return x, None
    new = {"mlstm": mstate}
    if sstate is not None:
        new["slstm"] = sstate
    return x, new


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            mode: str = "prefill", caches=None, q_valid=None, rules=None,
            mesh=None):
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

    mode="train" drops the aux that ``train_forward`` returns. With
    ``rules``/``mesh`` (JAX's arguments) the forward runs sharded on this
    rank's shards of ``params`` (``weights.shard_params`` with
    ``param_specs``) and the global ``tokens``/``embeds``: mode "train" as
    ``train_forward`` says; modes "prefill" and "decode" over the rank's
    dense caches and states (``init_cache(..., rules, mesh)``), their
    logits whole on every rank (``whole_logits``). Paged caches and modes
    "chunk" and "verify" raise ``NotImplementedError`` there
    (``distributed.check_serving``), as do the layouts
    ``distributed.check_rules`` names.
    """
    plan = dist_.plan(cfg, rules, mesh, mode, caches)
    return _run(params, cfg, tokens, embeds, mode, caches, q_valid,
                plan)[:2]


def train_forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                  rules=None, mesh=None):
    """Mode "train" (JAX's ``forward(mode="train")``): (logits ``(b, s,
    vocab)``, the routers' load-balancing aux, a 0-d fp32 tensor summed
    over the MoE layers in layer order, 0 for the other families).

    Under ``rules``/``mesh`` ``params`` are this rank's shards and
    ``tokens``/``embeds`` the global batch: the rank runs its rows (the
    data axes' share) and returns its block of the logits, its rows and
    its slice of the vocabulary where "model" shards the vocabulary (the
    logits are never gathered whole), and its data shard's aux."""
    logits, _, aux = _run(params, cfg, tokens, embeds, "train", None, None,
                          dist_.plan(cfg, rules, mesh))
    return logits, aux


def _vocab_lookup(embed, tokens, compute, ax):
    """The embedding of ``tokens`` from this rank's vocabulary rows: a
    masked lookup, summed over the model axis (reduce-out)."""
    n = embed.shape[0]
    local = tokens.long() - ax.index * n
    inside = (local >= 0) & (local < n)
    x = embed.to(compute)[torch.where(inside, local, 0)]
    return dist_.reduce_out(torch.where(inside[..., None], x, 0.0), ax)


def vocab_sharded(cfg: ModelConfig, plan) -> bool:
    """Whether the logits' vocabulary is split over "model" under
    ``plan`` (the head's, or the tied embedding's, vocab dim)."""
    if plan is None:
        return False
    if cfg.tie_embeddings:
        return plan.dims["embed"] == 0
    return plan.dims["head"] == 1


def whole_logits(logits, cfg: ModelConfig, plan):
    """Serving logits whole on every rank: the rank's block (its rows, and
    its slice of the vocabulary where ``vocab_sharded``) gathered over
    "model" and the data axes (under ``seq_sharded`` every rank has every
    row already)."""
    if vocab_sharded(cfg, plan):
        logits = dist_.gather(logits, -1, plan.model)
    return dist_.gather(logits, 0, plan.batch)


def _run(params, cfg: ModelConfig, tokens, embeds, mode: str, caches,
         q_valid, plan=None):
    """``forward``'s body: (logits, new caches, the aux in mode "train",
    else None)."""
    check_family(cfg)
    if mode == "train":
        check_train(cfg)
    elif mode in ("prefill", "decode", "chunk", "verify"):
        check_serving(cfg)
    else:
        raise ValueError(f"mode={mode!r}")
    if plan is not None:
        tokens, embeds = plan.rows(tokens), plan.rows(embeds)
    if prefill_chunk(cfg) and mode in ("chunk", "verify"):
        raise NotImplementedError(
            f"mode={mode!r} runs over paged caches; family={cfg.family!r} "
            "carries recurrent state, which is not paged (as in the JAX "
            "package)")
    compute = getattr(torch, cfg.compute_dtype)

    whole = {}

    def leaf(path):
        """A top-level leaf where it is used: under FSDP gathered whole
        over the data axes at each use (in the serving modes once a pass:
        a tied embedding's lookup and head share one gather)."""
        if plan is None:
            return params[path]
        if mode == "train" or path not in whole:
            whole[path] = plan.block("").gathered(params[path], path)
        return whole[path]
    if embeds is not None:
        x = embeds.to(compute) @ leaf("frontend_proj").to(compute)
    else:
        if plan is not None and plan.dims["embed"] == 0:
            x = _vocab_lookup(leaf("embed"), tokens, compute, plan.model)
        else:
            x = leaf("embed").to(compute)[tokens]
        x = x * embed_scale(cfg)
    s = x.shape[1]
    positions = (None if mode in ("decode", "chunk", "verify") else
                 torch.arange(s, dtype=torch.int32, device=x.device)[None, :])

    aux = new_caches = None
    if cfg.family == "hybrid":
        x, new_caches = _hybrid(params, x, positions, cfg, mode, caches,
                                plan)
    elif cfg.family == "ssm":
        x, new_caches = _ssm(params, x, cfg, mode, caches, plan)
    elif mode == "train":
        x, aux = _train_blocks(params, x, positions, cfg, plan)
    else:
        new_caches = None if caches is None else {}
        for pkey, ckey, n in _groups(cfg):
            c = caches[ckey] if caches is not None else None
            tp = None if plan is None else plan.block(pkey)
            lengths = []
            for i in range(n):
                cache_i = None if c is None else layer_slice(c, i)
                x, nc, _ = _block_fwd(_gathered(layer_slice(params[pkey], i),
                                                tp), x, positions, cfg, mode,
                                      cache_i, q_valid, tp)
                if nc is not None:
                    lengths.append(nc["length"])
            if c is not None:
                # pools/caches were written in place; only the lengths are
                # new
                new_caches[ckey] = {**c, "length": torch.stack(lengths, 0)}

    x = apply_norm(params["final_norm"], x, cfg)
    if mode == "prefill":
        x = x[:, -1:, :]
    elif mode == "chunk":
        idx = torch.clamp(q_valid.long() - 1, min=0)
        x = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    if vocab_sharded(cfg, plan):
        # vocabulary-parallel logits: each rank its slice (copy-in: the
        # gradient of x sums the ranks' slices)
        x = dist_.copy_in(x, plan.model)
    if cfg.tie_embeddings and mode == "train":
        logits = x @ leaf("embed").to(x.dtype).T
    elif cfg.tie_embeddings:
        # (E x^T)^T keeps the embedding in its (vocab, d) layout; on the
        # CPU x E^T takes another kernel at some row counts, and then a
        # row's logits depend on how many rows the pass has (verify vs
        # decode)
        flat = x.reshape(-1, x.shape[-1])
        logits = (leaf("embed").to(x.dtype) @ flat.T).T.reshape(
            *x.shape[:-1], -1)
    else:
        logits = x @ leaf("head").to(x.dtype)
    logits = logits.to(getattr(torch, cfg.logits_dtype))
    logits = softcap(logits, cfg.logits_softcap)
    if plan is not None and mode != "train":
        logits = whole_logits(logits, cfg, plan)
    if mode == "train" and aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    if mode in ("verify", "train"):
        return logits, new_caches, aux
    return logits[:, -1, :], new_caches, aux


# ---------------------------------------------------------------------------
# cache factories
# ---------------------------------------------------------------------------

def _stacked(spec, n: int):
    return {k: ((n, *shape), dt) for k, (shape, dt) in spec.items()}


def _scanned(axes):
    return {k: ("scan", *a) for k, a in axes.items()}


def init_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """JAX's ``init_cache_spec``: (spec, axes), the dense caches' shapes
    and dtypes (``(shape, dtype)`` leaves) and their logical axes, one
    ``(L, ...)`` stack a group ("scan" in front): GQA ``(L, b, max_len,
    kvh, hd)`` K/V, or MLA's latent and rope key (bf16, as JAX's
    ``cache_spec`` default); the moe family's ``dense_attn`` and
    ``attn``; the hybrid's Mamba2 states (``mamba``) and the shared
    block's K/V, one ``(n_apps, ...)`` stack (``attn``); the ssm family's
    mLSTM and sLSTM states (``mlstm``, ``slstm``); the Mamba2 conv
    window in the compute dtype, which JAX's spec gives as bf16 and its
    steps return in the compute dtype (``mamba2_state_spec``). Every
    family has one, the encoder-only audio family too (as in JAX)."""
    check_family(cfg)
    if cfg.family == "hybrid":
        spec = {"mamba": _stacked(m2.mamba2_state_spec(cfg, batch),
                                  cfg.num_layers)}
        axes = {"mamba": _scanned(m2.mamba2_state_axes())}
        if _n_apps(cfg):
            spec["attn"] = _stacked(attn.cache_spec(cfg, batch, max_len),
                                    _n_apps(cfg))
            axes["attn"] = _scanned(attn.cache_axes(cfg))
        return spec, axes
    if cfg.family == "ssm":
        n_groups, n_m_per, n_slstm = _ssm_layout(cfg)
        spec = {"mlstm": _stacked(xl.mlstm_state_spec(cfg, batch),
                                  n_groups * n_m_per)}
        axes = {"mlstm": _scanned(xl.mlstm_state_axes())}
        if n_slstm:
            spec["slstm"] = _stacked(xl.slstm_state_spec(cfg, batch),
                                     n_slstm)
            axes["slstm"] = _scanned(xl.slstm_state_axes())
        return spec, axes
    base = attn.cache_spec(cfg, batch, max_len)
    return ({ckey: _stacked(base, n) for _, ckey, n in _groups(cfg)},
            {ckey: _scanned(attn.cache_axes(cfg))
             for _, ckey, _ in _groups(cfg)})


def _whole_blocks(cfg: ModelConfig, rules) -> Tuple[str, ...]:
    """The path prefixes of the blocks that run whole on every model rank
    (``param_specs``): MLA's attention, and the ssm family's mLSTM and
    sLSTM layers, where their heads do not divide "model"."""
    m = rules.axis_sizes.get("model", 1)
    if m == 1 or cfg.num_heads % m == 0:
        return ()
    if cfg.attn_type == "mla":
        return ("layers.attn.", "dense_layers.attn.")
    if cfg.family == "ssm":
        return ("mlstm.", "slstm.")
    return ()


def param_specs(cfg: ModelConfig, rules) -> Dict[str, PartitionSpec]:
    """The port's layout of the param tree under ``rules``, by JAX's
    dotted path (``param_axes``'s): JAX's specs, but for two kinds of
    leaves. The Mamba2 leaves whose concatenated channels JAX's rules
    split over "model" (``in_proj``, ``conv_w``, ``conv_b``): JAX splits
    them contiguously, which does not follow the heads, and the port lays
    them out as a rank's heads read them (``distributed.Mamba2Read``: its
    z, x and dt channels, and B and C whole on every model rank). And the
    blocks whose heads do not divide "model" (``_whole_blocks``: MLA's
    attention, the mLSTM and sLSTM layers), where JAX's rules put "model"
    on the latents' rank dims or the inner channels, which no rank's
    heads follow: the port keeps their leaves whole and runs the block
    whole on every model rank, as GQA's attention runs whole there."""
    axes, shapes = param_axes(cfg), param_shapes(cfg)
    out = {p: rules.spec(shapes[p], axes[p]) for p in axes}
    for path in out:
        if path.startswith(_whole_blocks(cfg, rules)):
            out[path] = PartitionSpec(*(None if e == "model" else e
                                        for e in out[path]))
    if cfg.family == "hybrid":
        d_in, nh, n = m2._dims(cfg)[:3]
        for name, read in (("in_proj", dist_.Mamba2Read.in_proj(d_in, n, nh)),
                           ("conv_w", dist_.Mamba2Read.conv(d_in, n)),
                           ("conv_b", dist_.Mamba2Read.conv(d_in, n))):
            path = f"mamba.{name}"
            if out[path][-1] == "model":
                out[path] = PartitionSpec(*out[path][:-1], read)
    return out


def cache_specs(cfg: ModelConfig, rules, batch: int, max_len: int):
    """The port's layout of the dense caches under ``rules`` (a tree of
    ``PartitionSpec``s, as ``init_cache_spec``'s): JAX's specs (its
    ``tree_specs`` of ``init_cache_spec``), the rows over the data axes
    (or, under ``seq_sharded``, the sequence) and the kv heads over
    "model", but for two deliberate divergences.
    Where JAX's rules put "model" on a dim the attention kernel needs
    whole on a rank (GQA's "head_dim_shard" when the kv heads do not
    divide "model"; MLA's "kv_lora"), the port keeps that dim whole: a
    GQA rank holds the kv heads its own query heads read
    (``distributed.HeadsRead``) at the whole head dim, or every kv head
    where the query heads do not divide "model" either (attention runs
    whole there); MLA keeps the whole latent on every rank. The new
    token's K/V (or latent) is written from the gathered projection, the
    gather the train path does already. It costs memory on every model
    rank: gemma_2b's one kv head, 18 layers x 256 x 2 (K and V) x 2 B =
    18 KiB a token, and deepseek_v2_lite_16b's latent, 27 layers x (512 +
    64) x 2 B = 30.4 KiB a token, are held whole by each. And the Mamba2
    conv window is laid out as its weights are (``param_specs``: B and C
    whole on every model rank)."""
    spec, axes = init_cache_spec(cfg, batch, max_len)
    m = rules.axis_sizes.get("model", 1)
    read = (dist_.HeadsRead(cfg.num_heads, cfg.num_kv_heads)
            if m > 1 and cfg.num_heads % m == 0 else None)
    conv = (dist_.Mamba2Read.conv(m2._dims(cfg)[0], cfg.ssm.state_dim)
            if cfg.family == "hybrid" else None)
    out = {}
    for g, leaves in spec.items():
        out[g] = {}
        for k, (shape, _) in leaves.items():
            ax = axes[g][k]
            entries = list(rules.spec(shape, ax))
            seq_model = any("model" in dist_.group_of(e)
                            for e, a in zip(entries, ax)
                            if a in ("seq", "cache_seq"))
            for i, a in enumerate(ax):
                if a in ("head_dim_shard", "kv_lora"):
                    entries[i] = None
                elif a == "kv_heads" and entries[i] is None \
                        and not seq_model:
                    entries[i] = read
                elif (g, k) == ("mamba", "conv") and entries[i] == "model":
                    entries[i] = conv
            out[g][k] = PartitionSpec(*entries)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               rules=None, mesh=None):
    """Dense prefill caches at zeros, laid out as ``init_cache_spec``. An
    encoder-only config has none
    (``ValueError``). Under ``rules``/``mesh`` ``batch`` is the global
    batch and the caches are this rank's (``cache_specs``: its rows, its
    kv heads or whole ones, the whole latent; its heads' recurrent
    states; where the layout splits the positions (``seq_sharded``,
    ``shard_v2``: ``distributed.cache_groups``) its slice of them, whose
    group must then divide ``max_len``: JAX's rules fall back to fewer
    axes there, and the port raises ``ValueError``)."""
    check_family(cfg)
    check_serving(cfg)
    spec, _ = init_cache_spec(cfg, batch, max_len)
    if rules is not None or mesh is not None:
        from repro_torch.models.sharding import ShardingRules
        r = rules if rules is not None else ShardingRules(mesh)
        specs = cache_specs(cfg, r, batch, max_len)
        _, want = dist_.cache_groups(cfg, r)
        for g, leaves in specs.items():
            first = next(iter(leaves.values()))    # (scan, batch, seq, ..)
            if g in ("attn", "dense_attn") and want and \
                    dist_.group_of(first[2]) != want:
                raise ValueError(
                    f"a cache of {max_len} positions does not divide over "
                    f"the axes {want} that its positions split over")
    plan = dist_.plan(cfg, rules, mesh, "prefill")
    if plan is not None:
        spec = {g: {k: (dist_.local_shape(shape, specs[g][k], plan.mesh),
                        dt) for k, (shape, dt) in leaves.items()}
                for g, leaves in spec.items()}
    return {g: {k: torch.zeros(shape, dtype=dt, device=device)
                for k, (shape, dt) in leaves.items()}
            for g, leaves in spec.items()}


def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_tokens: int, max_blocks: int, device="cuda"):
    """Paged caches: each layer holds pools of ``num_blocks + 1`` pages;
    page ``num_blocks`` is the engine's *trash page* — dead rows' tables
    point at it and their masked decode writes land there. Block tables
    start all-trash and lengths at 0. Only attention caches page: the
    recurrent families raise, as in the JAX package; an encoder-only config
    has no cache (``ValueError``)."""
    check_family(cfg)
    check_serving(cfg)
    if prefill_chunk(cfg):
        raise NotImplementedError(
            f"paged KV cache is attention-only (family={cfg.family}): "
            "recurrent state has no pages to share")
    spec = attn.paged_cache_spec(cfg, num_blocks + 1, block_tokens, batch,
                                 max_blocks)
    g = {k: torch.zeros((cfg.num_layers, *shape), dtype=dt, device=device)
         for k, (shape, dt) in spec.items()}
    g["block_tables"].fill_(num_blocks)
    return {"attn": g}
