"""DeepSeek-V2-Lite-16B [arXiv:2405.04434]. MLA (kv_lora=512, no q compression)
+ MoE: 64 routed experts top-6 + 2 shared, first layer dense."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,               # dense (first_k_dense) layer FFN width
    vocab_size=102_400,
    mlp_type="swiglu",
    attn_type="mla",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,        # lite variant: no query compression
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        expert_d_ff=1408,
        shared_d_ff=2 * 1408,
        first_k_dense=1,
    ),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-lite-16b-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        mla=MLAConfig(
            kv_lora_rank=32,
            q_lora_rank=0,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
        moe=MoEConfig(
            num_experts=8,
            num_shared_experts=2,
            top_k=2,
            expert_d_ff=64,
            shared_d_ff=128,
            first_k_dense=1,
        ),
    )
