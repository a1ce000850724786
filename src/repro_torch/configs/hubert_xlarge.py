"""HuBERT-XLarge [arXiv:2106.07447]. Encoder-only audio transformer
(wav2vec2-style backbone). The CNN feature extractor is a STUB — the
caller hands the encoder precomputed frame embeddings, ``embeds``. vocab=504
is the masked-prediction codebook."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mlp_type="gelu",
    attn_type="gqa",
    norm_type="layernorm",
    encoder_only=True,
    stub_frontend=True,
    frontend_dim=512,  # conv feature-extractor output dim
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="hubert-xlarge-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        frontend_dim=32,
    )
