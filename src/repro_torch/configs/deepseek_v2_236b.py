"""DeepSeek-V2-236B [arXiv:2405.04434]. MLA (kv_lora=512) + MoE:
160 routed experts top-6 + 2 shared, first layer dense."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,               # dense (first_k_dense) layer FFN width
    vocab_size=102_400,
    mlp_type="swiglu",
    attn_type="mla",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        num_shared_experts=2,
        top_k=6,
        expert_d_ff=1536,
        shared_d_ff=2 * 1536,
        first_k_dense=1,
    ),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-236b-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        mla=MLAConfig(
            kv_lora_rank=32,
            q_lora_rank=48,
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
