"""Config schema for the PyTorch port (a copy of ``repro.configs.base``).

Every assigned architecture is expressed as a ``ModelConfig``; input shapes as
``ShapeConfig``. Configs are plain dataclasses so they can be constructed,
reduced (for smoke tests) and serialized without any framework machinery.
The port keeps its own copy so that it imports nothing of ``repro``; the
tests hold the two copies field for field against each other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3) parameters."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 => no query compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # Decode-time weight absorption (DeepSeek-V2 §"absorb"): attend directly in
    # the compressed latent space instead of re-expanding K/V each step.
    absorb: bool = False


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_k_dense: int = 1          # leading dense layers (DeepSeek style)
    shared_d_ff: int = 0            # d_ff of the shared experts (total)
    router_noise: float = 0.0
    capacity_slack: float = 2.0     # EP static-capacity multiplier
    impl: str = "ragged_ep"         # "ragged_ep" | "dispatch_einsum"
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""

    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8            # every k-th block is sLSTM, rest mLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    conv_width: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    mlp_type: str = "swiglu"        # swiglu | geglu | relu2 | gelu
    attn_type: str = "gqa"          # gqa | mla | none
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2): a shared attention block applied every k SSM layers
    shared_attn_every: int = 0
    encoder_only: bool = False
    stub_frontend: bool = False     # vlm/audio: inputs are precomputed embeddings
    frontend_dim: int = 0           # embedding dim delivered by the stub frontend
    rope_theta: float = 10_000.0
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logits_dtype: str = "float32"   # perf knob: bf16 halves lm-head traffic
    remat: str = "full"             # none | full | dots  (activation ckpt policy)
    scan_layers: bool = True
    # §Perf sharding profile: v2 shards the KV-cache SEQUENCE over "model"
    # (flash-decode style) instead of head_dim, avoiding the rope-split
    # resharding storms the baseline exhibits when heads % model != 0.
    shard_v2: bool = False
    # §Perf: seq-shard the attention INPUT (d_model wide) instead of
    # resharding the much wider Q tensor per layer (heads-not-divisible case)
    attn_in_seqshard: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_subquadratic(self) -> bool:
        """Whether the arch supports 500k-token decode (SSM/hybrid/linear)."""
        return self.family in ("hybrid", "ssm")

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (used by the perf model and roofline)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.stub_frontend:
            emb = self.vocab_size * d + (self.frontend_dim or d) * d
        per_layer = 0
        if self.attn_type == "mla":
            m = self.mla
            q_in = m.q_lora_rank or d
            per_layer += (d * m.q_lora_rank if m.q_lora_rank else 0)
            per_layer += q_in * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.num_heads * m.v_head_dim * d
        elif self.attn_type == "gqa":
            per_layer += d * self.num_heads * hd                      # Q
            per_layer += 2 * d * self.num_kv_heads * hd               # K,V
            per_layer += self.num_heads * hd * d                      # O
        n_mult = {"swiglu": 3, "geglu": 3, "relu2": 2, "gelu": 2}[self.mlp_type]
        if self.moe and self.moe.num_experts:
            dense_layers = self.moe.first_k_dense
            moe_layers = L - dense_layers
            per_layer_moe = (
                self.moe.num_experts * n_mult * d * self.moe.expert_d_ff
                + n_mult * d * (self.moe.shared_d_ff or 0)
                + d * self.moe.num_experts
            )
            mlp_total = dense_layers * n_mult * d * self.d_ff + moe_layers * per_layer_moe
        elif self.family == "ssm" and self.xlstm is not None:
            mlp_total = 0  # folded into block accounting below
        else:
            mlp_total = L * n_mult * d * self.d_ff
        total = emb + L * per_layer + mlp_total
        if self.ssm is not None:
            d_inner = self.ssm.expand * d
            nheads = d_inner // self.ssm.head_dim
            per_ssm = d * (2 * d_inner + 2 * self.ssm.state_dim + nheads) + d_inner * d
            total = emb + L * per_ssm
            if self.shared_attn_every:
                total += d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd
                total += 3 * d * self.d_ff
        if self.xlstm is not None:
            pf_m = self.xlstm.proj_factor_mlstm
            d_in = int(pf_m * d)
            per_m = d * d_in * 2 + d_in * d + 3 * d_in * self.num_heads + d_in * d_in // max(1, self.num_heads)
            total = emb + L * per_m
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (= param_count for dense archs)."""
        if not (self.moe and self.moe.num_experts):
            return self.param_count()
        full = self.param_count()
        n_mult = {"swiglu": 3, "geglu": 3, "relu2": 2, "gelu": 2}[self.mlp_type]
        moe_layers = self.num_layers - self.moe.first_k_dense
        all_exp = moe_layers * self.moe.num_experts * n_mult * self.d_model * self.moe.expert_d_ff
        act_exp = moe_layers * self.moe.top_k * n_mult * self.d_model * self.moe.expert_d_ff
        return int(full - all_exp + act_exp)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable_shapes(cfg: ModelConfig):
    """The shapes a given architecture actually runs (skips per DESIGN.md §4)."""
    out = []
    for s in SHAPES:
        if s.kind == "decode" and not cfg.supports_decode:
            continue  # encoder-only: no autoregressive decode
        if s.name == "long_500k" and not cfg.is_subquadratic:
            continue  # needs sub-quadratic attention
        out.append(s)
    return out
