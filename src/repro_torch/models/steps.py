"""The train step (``cross_entropy``, ``loss_fn``, ``train_step``,
``init_train_state``), prefill_step / serve_step / chunk_step / verify_step
and the paged-cache page movement (twin of ``repro.models.steps``).

``train_step`` is ``jax.value_and_grad`` of ``loss_fn`` written as
autograd over the parameter leaves, then ``optim.adamw_update``, which
writes the new parameters and moments into the state it is given. On the
card the attention's backward is the hand-written gradient kernel
(``kernels.flash_attention.FlashAttentionFn``). Page movement writes the
pools in place and returns the same cache dict."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import distributed as dist_
from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.optim import OptConfig, adamw_update, init_opt_state


def cross_entropy(logits, labels, mask: Optional[torch.Tensor] = None):
    """logits (b, s, V); labels (b, s) integer. Reduction always in fp32;
    with ``mask`` (b, s), the mean over the masked positions."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _inputs(batch: Dict, cfg: ModelConfig) -> Dict:
    """The forward's input: a stub frontend's ``embeds`` where given, else
    ``tokens``."""
    if cfg.stub_frontend and "embeds" in batch:
        return {"embeds": batch["embeds"]}
    return {"tokens": batch["tokens"]}


def vocab_parallel_nll(logits, labels, ax):
    """Per-token negative log-likelihood (fp32) from this rank's slice of
    the vocabulary (``logits`` (b, s, V / n), ranks in order over ``ax``):
    the row max by all-reduce(max), the sum of exponentials by
    all-reduce(sum), the label's logit from the rank that holds it."""
    lg = logits.float()
    n = lg.shape[-1]
    gmax = dist_.all_reduce(lg.detach().amax(-1), ax, "max")
    logz = gmax + torch.log(dist_.reduce_out(
        torch.exp(lg - gmax[..., None]).sum(-1), ax))
    local = labels.long() - ax.index * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(lg, -1, torch.where(inside, local, 0)[..., None])
    return logz - dist_.reduce_out(torch.where(inside, gold[..., 0], 0.0),
                                   ax)


def _sharded_loss(logits, batch: Dict, cfg: ModelConfig, plan):
    """The global batch's mean nll from this rank's block of the logits:
    ``sum(nll)`` and ``sum(mask)`` (or the token count) summed over the
    data axes before the one division, JAX's ``sum(nll) / max(sum(mask),
    1)`` over the whole batch (a mean of per-rank means differs where the
    masks do)."""
    labels, mask = plan.rows(batch["labels"]), plan.rows(batch.get("mask"))
    if tf.vocab_sharded(cfg, plan):
        nll = vocab_parallel_nll(logits, labels, plan.model)
    else:
        lg = logits.float()
        nll = (torch.logsumexp(lg, dim=-1)
               - torch.gather(lg, -1, labels.long()[..., None])[..., 0])
    if mask is not None:
        nll = nll * mask
        den = torch.clamp(dist_.all_reduce(
            torch.sum(mask.detach()).float(), plan.data), min=1.0)
    else:
        den = labels.numel() * plan.data.size
    return dist_.reduce_out(torch.sum(nll), plan.data) / den


def loss_fn(params, batch: Dict, cfg: ModelConfig, rules=None, mesh=None):
    """Returns (loss + aux, (loss, aux)): aux is the MoE routers' summed
    load-balancing aux (fp32; 0 without MoE layers).

    Under ``rules``/``mesh`` (JAX's arguments) ``params`` are this rank's
    shards and ``batch`` the global batch; the loss is the global batch's
    (vocabulary-parallel, ``_sharded_loss``) and the aux the mean of the
    data shards' (each shard routes its own rows, as in JAX's shard map),
    both equal on every rank. Each rank's autograd graph holds its own
    share of them, so the gradients summed over the data axes are the
    gradient of the whole (``value_and_grad``)."""
    plan = dist_.plan(cfg, rules, mesh)
    logits, aux = tf.train_forward(params, cfg, rules=rules, mesh=mesh,
                                   **_inputs(batch, cfg))
    if plan is None:
        loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    else:
        loss = _sharded_loss(logits, batch, cfg, plan)
        aux = dist_.reduce_out(aux, plan.data) / plan.data.size
    return loss + aux, (loss, aux)


def value_and_grad(params, batch: Dict, cfg: ModelConfig, rules=None,
                   mesh=None):
    """((total, (loss, aux)), grads): ``jax.value_and_grad(loss_fn,
    has_aux=True)``. The gradients come in the parameters' dtypes; a tied
    embedding's sums its lookup and its use as the head. Under a mesh
    they are this rank's shards of the whole batch's gradient
    (``distributed.Plan.reduce_grad``: summed over the data axes, where
    FSDP's gathers have not reduce-scattered them already, and a Mamba2
    leaf's B and C summed over "model")."""
    live = tree.map_tree(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        total, (loss, aux) = loss_fn(live, batch, cfg, rules, mesh)
        # a leaf the loss does not read (the token embedding when a stub
        # frontend's embeds come in) gets zeros, as in JAX
        grads = torch.autograd.grad(total, tree.leaves(live),
                                    allow_unused=True, materialize_grads=True)
    plan = dist_.plan(cfg, rules, mesh)
    flat = dict(zip(tree.flatten(live), grads))
    if plan is not None:
        for path, g in flat.items():
            plan.reduce_grad(path.replace("/", "."), g)
    return ((total.detach(), (loss.detach(), aux.detach())),
            tree.unflatten(params, flat))


def train_step(state: Dict, batch: Dict, cfg: ModelConfig,
               opt: OptConfig = OptConfig(), rules=None, mesh=None):
    """One AdamW step on ``batch`` (``tokens`` or ``embeds``, ``labels``,
    optional ``mask``). The state's tensors are updated in place and
    returned as the new state, with metrics ``loss``, ``aux_loss`` and
    ``grad_norm`` (0-d fp32 tensors).

    With ``rules``/``mesh`` (JAX's sharded step) every rank calls it with
    its shards of the state (``weights.shard_params`` with
    ``state_specs``) and the global batch: data, tensor and expert
    parallelism as the rules lay the leaves out, and FSDP under
    ``fsdp=True`` (the weights and AdamW's moments also split over the
    data axes on their d_model dim). The gradient norm sums each sharded
    leaf over the ranks that shard it, and AdamW runs on the local
    shards. A layout this schedule does not run raises
    ``NotImplementedError`` (``transformer.check_train``)."""
    tf.check_train(cfg, rules, mesh)
    plan = dist_.plan(cfg, rules, mesh)
    (_, (loss, aux)), grads = value_and_grad(state["params"], batch, cfg,
                                             rules, mesh)
    params, new_opt, gnorm = adamw_update(
        state["params"], grads, state["opt"], opt,
        gnorm=None if plan is None else plan.global_norm(grads))
    return ({"params": params, "opt": new_opt},
            {"loss": loss, "aux_loss": aux, "grad_norm": gnorm})


def state_specs(param_specs) -> Dict:
    """The specs of a train state from its params' (``sharding.tree_specs``):
    AdamW's moments as their params, the step replicated."""
    from repro_torch.models.sharding import PartitionSpec
    return {"params": param_specs,
            "opt": {"m": param_specs, "v": param_specs,
                    "step": PartitionSpec()}}


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda") -> Dict:
    params = tf.init_model(cfg, generator, device)
    return {"params": params, "opt": init_opt_state(params)}


def prefill_step(params, batch: Dict, cfg: ModelConfig, max_len: int,
                 rules=None, mesh=None):
    """Full-sequence prefill into fresh ``max_len`` dense caches on the
    inputs' device: ``batch["tokens"]``, or for a stub-frontend config
    ``batch["embeds"]`` where given. Returns (last_logits, caches). An
    encoder-only config's is its encoder forward (mode "train"): logits
    (b, s, V) at every position and no caches.

    With ``rules``/``mesh`` (JAX's sharded step) every rank calls it with
    its shards of ``params`` and the global batch: the caches returned
    are the rank's (``transformer.init_cache`` under the mesh), the
    logits the whole batch's, whole on every rank."""
    inputs = _inputs(batch, cfg)
    if cfg.encoder_only:
        plan = dist_.plan(cfg, rules, mesh)
        logits = tf.forward(params, cfg, mode="train", rules=rules,
                            mesh=mesh, **inputs)[0]
        return (logits if plan is None
                else tf.whole_logits(logits, cfg, plan)), None
    x = next(iter(inputs.values()))
    caches = tf.init_cache(cfg, x.shape[0], max_len, x.device, rules, mesh)
    return tf.forward(params, cfg, mode="prefill", caches=caches,
                      rules=rules, mesh=mesh, **inputs)


def serve_step(params, tokens, caches, cfg: ModelConfig, rules=None,
               mesh=None):
    """One decode step over dense or paged caches: tokens (b, 1) ->
    (new_token (b,) int32, logits, caches); the new token is the argmax,
    the lowest index of the maximum as in JAX. Under ``rules``/``mesh``
    ``tokens`` is the global batch, ``params`` and ``caches`` the rank's
    shards (``prefill_step``'s); the logits and tokens are the whole
    batch's on every rank, the caches the rank's, written in place."""
    logits, caches = tf.forward(params, cfg, tokens=tokens, mode="decode",
                                caches=caches, rules=rules, mesh=mesh)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits, caches


def chunk_step(params, tokens, q_valid, caches, cfg: ModelConfig,
               rules=None, mesh=None):
    """One chunked-prefill step: tokens (b, s) holds a left-aligned chunk
    per row and q_valid (b,) its valid length (0 for rows not chunking this
    pass). Returns (new_token (b,) int32, logits (b, V), caches):
    ``new_token`` is the greedy continuation after each row's last valid
    chunk position, meaningful only for rows whose chunk completes the
    prompt. ``caches`` are the paged pools; JAX gives them no logical
    axes, and under ``rules``/``mesh`` this raises
    ``NotImplementedError``."""
    logits, caches = tf.forward(params, cfg, tokens=tokens, mode="chunk",
                                caches=caches, q_valid=q_valid, rules=rules,
                                mesh=mesh)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits, caches


def verify_step(params, tokens, q_valid, caches, cfg: ModelConfig,
                rules=None, mesh=None):
    """One speculative-verify step: tokens (b, s) holds a left-aligned feed
    per row (the last committed token, then its draft continuation) and
    q_valid (b,) its length (0 for rows sitting this pass out). Returns
    (greedy (b, s) int32, logits (b, s, V), caches): ``greedy[:, j]`` is
    the argmax after feed position j, what sequential one-token decode
    would emit there. ``caches`` are the paged pools, with fork-grown
    tables covering ``length + q_valid`` positions per live row. Under
    ``rules``/``mesh`` it raises ``NotImplementedError``, as
    ``chunk_step`` does: paged pools have no sharded layout."""
    logits, caches = tf.forward(params, cfg, tokens=tokens, mode="verify",
                                caches=caches, q_valid=q_valid, rules=rules,
                                mesh=mesh)
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


def copy_pages(caches, src, dst):
    """Copy pages ``src`` onto pages ``dst`` within the same pools (the
    copy-on-write step of a speculative fork)."""
    for g in caches.values():
        g["k_pool"][:, dst] = g["k_pool"][:, src]
        g["v_pool"][:, dst] = g["v_pool"][:, src]
    return caches
