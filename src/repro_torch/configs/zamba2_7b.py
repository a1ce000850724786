"""Zamba2-7B [arXiv:2411.15242]. Hybrid: Mamba2 backbone + shared attention
block applied periodically (weights shared across applications)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32_000,
    mlp_type="swiglu",
    attn_type="gqa",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
    shared_attn_every=13,  # 6 shared-block applications over 81 mamba layers
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-7b-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_size=32),
        shared_attn_every=2,
    )
