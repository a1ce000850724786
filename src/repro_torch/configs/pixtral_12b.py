"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]. VLM: pixtral-ViT frontend
(STUB — the caller hands prefill precomputed patch embeddings, ``embeds``)
feeding a Mistral-NeMo-style dense GQA decoder."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    mlp_type="swiglu",
    attn_type="gqa",
    stub_frontend=True,
    frontend_dim=1024,  # pixtral ViT hidden size; projected into d_model
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="pixtral-12b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        frontend_dim=32,
    )
