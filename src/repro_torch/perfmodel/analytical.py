"""GenZ-style analytical runtime model for LLM inference stages.

This is the "external analytical simulator" of paper §III-E1: it prices a
prefill / decode / embedding forward pass on a ClusterSpec from first
principles (FLOPs vs HBM bytes vs TP-collective time). The polynomial
regression of ``regression.py`` is trained on datapoints generated here (or on
real traces), mirroring the paper's ML-assisted modeling pipeline.

Copied from ``repro.perfmodel.analytical`` onto the port's
``configs.base.ModelConfig`` so that the port imports nothing of
``repro``. It is plain Python: a test holds every function equal to the
original's, not merely close, over every registered config.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.perfmodel.hardware import CacheTierSpec, ChipSpec, ClusterSpec

BYTES_PER_PARAM = 2.0  # bf16 weights
BYTES_KV = 2.0         # bf16 KV cache


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    """KV-cache bytes per token (whole model)."""
    if cfg.attn_type == "mla":
        per_layer = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    elif cfg.attn_type == "gqa":
        per_layer = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    else:
        per_layer = 0
    n_attn = cfg.num_layers
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // max(1, cfg.shared_attn_every)
    if cfg.family == "ssm":
        n_attn = 0
    return BYTES_KV * per_layer * n_attn


def ssm_state_bytes(cfg: ModelConfig) -> float:
    """Per-request recurrent state bytes (SSM/hybrid archs)."""
    total = 0.0
    if cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        nh = d_in // cfg.ssm.head_dim
        total += cfg.num_layers * (nh * cfg.ssm.state_dim * cfg.ssm.head_dim * 4
                                   + (d_in + 2 * cfg.ssm.state_dim)
                                   * (cfg.ssm.conv_width - 1) * 2)
    if cfg.xlstm is not None:
        d_in = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
        hd = d_in // cfg.num_heads
        total += cfg.num_layers * cfg.num_heads * hd * hd * 4
    return total


def flops_per_token(cfg: ModelConfig, context: int = 0) -> float:
    """Forward FLOPs per token: 2*N_active + attention term."""
    base = 2.0 * cfg.active_param_count()
    if cfg.attn_type != "none" and context > 0:
        n_attn = cfg.num_layers
        if cfg.family == "hybrid":
            n_attn = cfg.num_layers // max(1, cfg.shared_attn_every)
        qk_dim = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
                  if cfg.attn_type == "mla" else cfg.resolved_head_dim)
        v_dim = (cfg.mla.v_head_dim if cfg.attn_type == "mla"
                 else cfg.resolved_head_dim)
        base += 2.0 * n_attn * cfg.num_heads * context * (qk_dim + v_dim)
    return base


def _tp_collective_time(cluster: ClusterSpec, tokens: int, d_model: int,
                        n_layers: int) -> float:
    """2 all-reduces per layer (attn + mlp out) under TP, ring algorithm."""
    if cluster.tp <= 1:
        return 0.0
    bytes_per_ar = 2.0 * (cluster.tp - 1) / cluster.tp * tokens * d_model * 2
    t_bw = bytes_per_ar / cluster.intra_link.bandwidth
    t_lat = 2 * (cluster.tp - 1) * cluster.intra_link.latency
    return 2 * n_layers * (t_bw + t_lat)


@dataclass(frozen=True)
class StageCost:
    time: float
    energy: float
    flops: float
    bytes: float
    bound: str  # "compute" | "memory" | "network"


def prefill_time(cfg: ModelConfig, cluster: ClusterSpec, prefill_tokens: int,
                 batch: int = 1, past_tokens: int = 0,
                 chunk: Optional[int] = None) -> StageCost:
    """Time for one prefill pass of ``prefill_tokens`` per request."""
    toks = prefill_tokens * batch
    avg_ctx = past_tokens + prefill_tokens / 2
    fl = flops_per_token(cfg, context=int(avg_ctx)) * toks
    w_bytes = cfg.param_count() * BYTES_PER_PARAM
    kv_b = kv_bytes_per_token(cfg) * (past_tokens + prefill_tokens) * batch
    by = w_bytes + kv_b
    t_comp = fl / (cluster.total_flops * cluster.chip.mfu_prefill)
    t_mem = by / (cluster.total_bw * cluster.chip.mbu_decode)
    t_net = _tp_collective_time(cluster, toks, cfg.d_model, cfg.num_layers)
    t = max(t_comp, t_mem) + t_net
    bound = ("compute" if t_comp >= t_mem else "memory")
    if t_net > max(t_comp, t_mem):
        bound = "network"
    energy = t * cluster.chip.power * cluster.n_chips * (
        1.0 if bound == "compute" else 0.75)
    return StageCost(t, energy, fl, by, bound)


def decode_step_time(cfg: ModelConfig, cluster: ClusterSpec, batch: int,
                     avg_context: int) -> StageCost:
    """Time for ONE decode step of a batch (one token per request)."""
    fl = flops_per_token(cfg, context=avg_context) * batch
    w_bytes = cfg.param_count() * BYTES_PER_PARAM
    kv_b = (kv_bytes_per_token(cfg) * avg_context + ssm_state_bytes(cfg)) * batch
    by = w_bytes + kv_b
    t_comp = fl / (cluster.total_flops * cluster.chip.mfu_prefill)
    t_mem = by / (cluster.total_bw * cluster.chip.mbu_decode)
    t_net = _tp_collective_time(cluster, batch, cfg.d_model, cfg.num_layers)
    t = max(t_comp, t_mem) + t_net
    bound = "compute" if t_comp >= t_mem else "memory"
    if t_net > max(t_comp, t_mem):
        bound = "network"
    energy = t * cluster.chip.power * cluster.n_chips * (
        1.0 if bound == "compute" else 0.55)
    return StageCost(t, energy, fl, by, bound)


def chunked_step_time(cfg: ModelConfig, cluster: ClusterSpec,
                      chunk_tokens: int, decode_batch: int,
                      avg_context: int) -> StageCost:
    """Sarathi-style piggybacked step: chunk of prefill + decode batch."""
    pre = prefill_time(cfg, cluster, chunk_tokens, 1, past_tokens=avg_context)
    # weights are read once for the fused step, decode adds only KV traffic
    kv_b = (kv_bytes_per_token(cfg) * avg_context + ssm_state_bytes(cfg)) * decode_batch
    fl = flops_per_token(cfg, context=avg_context) * decode_batch
    t_extra = max(fl / (cluster.total_flops * cluster.chip.mfu_prefill),
                  kv_b / (cluster.total_bw * cluster.chip.mbu_decode))
    t = pre.time + t_extra
    energy = t * cluster.chip.power * cluster.n_chips * 0.9
    return StageCost(t, energy, pre.flops + fl, pre.bytes + kv_b, pre.bound)


def embedding_time(embed_cfg: ModelConfig, cluster: ClusterSpec,
                   query_tokens: int) -> StageCost:
    return prefill_time(embed_cfg, cluster, query_tokens, 1)


def idle_stall_energy(t: float, cluster: ClusterSpec) -> float:
    """Energy burned while the engine stalls (KV swaps, bubble time)."""
    return t * cluster.chip.power * cluster.n_chips * \
        cluster.chip.idle_power_frac


def kv_swap_cost(nbytes: float, tier: CacheTierSpec,
                 cluster: ClusterSpec) -> StageCost:
    """One KV page-swap traversal of a spill-tier boundary (paper Eq. 1 hit
    term). The engine idles while pages move, so energy is the stall at
    idle power. Composes the two shared primitives the scheduler also uses
    (``CacheTierSpec.transfer_time`` + ``idle_stall_energy``)."""
    t = tier.transfer_time(nbytes)
    return StageCost(t, idle_stall_energy(t, cluster), 0.0, nbytes, "network")


def expected_accepted_tokens(k: int, alpha) -> float:
    """Expected tokens committed per speculative step (draft k, verify once,
    always >= 1 thanks to the bonus token).

    ``alpha`` is either a scalar (i.i.d. per-position acceptance — the
    classic geometric closed form ``(1 - alpha^(k+1)) / (1 - alpha)``) or a
    per-position sequence of CONDITIONAL rates ``[a_0, .., a_{k-1}]`` with
    ``a_i = P(accept position i | accepted 0..i-1)``, as measured by the
    engine (``spec_stats()['conditional_acceptance_per_position']`` — NOT
    the marginal ``acceptance_per_position``, which is already a cumulative
    product): acceptance stops at the first rejection, so
    E[tokens] = 1 + sum_j prod_{i<=j} a_i. A sequence longer than ``k`` is
    truncated; shorter ones extend with their last value (rates flatten past
    the measured horizon)."""
    if isinstance(alpha, (int, float)):
        a = float(alpha)
        return float(k + 1) if a >= 1 else (1 - a ** (k + 1)) / (1 - a)
    rates = [float(a) for a in alpha][:k]
    if rates and len(rates) < k:
        rates.extend([rates[-1]] * (k - len(rates)))
    total, run = 1.0, 1.0
    for a in rates:
        run *= a
        total += run
    return total


def speculative_decode_step(target: ModelConfig, draft: ModelConfig,
                            cluster: ClusterSpec, batch: int, avg_context: int,
                            k: int = 4, alpha=0.8):
    """Speculative decoding (paper §III-E1's optimization list): draft k
    tokens with the small model, verify in one target pass.

    Returns (StageCost for one spec step, expected accepted tokens/step).
    ``alpha`` may be a scalar (geometric acceptance) or a measured
    per-position distribution — see ``expected_accepted_tokens``."""
    draft_cost = decode_step_time(draft, cluster, batch, avg_context)
    # verification: target forward over k+1 positions per request ~ a tiny
    # chunked prefill (weights read once, k+1 tokens of compute)
    verify = prefill_time(target, cluster, k + 1, batch,
                          past_tokens=avg_context)
    t = draft_cost.time * k + verify.time
    expected = expected_accepted_tokens(k, alpha)
    cost = StageCost(t, draft_cost.energy * k + verify.energy,
                     draft_cost.flops * k + verify.flops,
                     draft_cost.bytes * k + verify.bytes, verify.bound)
    return cost, expected
