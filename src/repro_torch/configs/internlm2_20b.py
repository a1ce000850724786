"""InternLM2-20B [arXiv:2403.17297]. Dense GQA (kv=8), SwiGLU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92_544,
    mlp_type="swiglu",
    attn_type="gqa",
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="internlm2-20b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=256,
        vocab_size=512,
    )
