"""Gemma-2B [arXiv:2403.08295]. MQA (kv=1), GeGLU, head_dim=256."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    mlp_type="geglu",
    attn_type="gqa",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma-2b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
    )
