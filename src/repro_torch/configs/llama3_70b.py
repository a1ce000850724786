"""Llama-3-70B class config — the model the paper's case studies serve
(Figs. 6/8/10–13, Table III)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128_256,
    mlp_type="swiglu",
    attn_type="gqa",
    rope_theta=500_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llama3-70b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=256,
        vocab_size=512,
    )
