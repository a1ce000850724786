"""Nemotron-4-340B [arXiv:2402.16819]. Dense GQA (kv=8), squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256_000,
    mlp_type="relu2",
    attn_type="gqa",
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="nemotron-4-340b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=256,
        vocab_size=512,
    )
