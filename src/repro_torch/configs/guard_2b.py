"""Llama-Guard-2B-class safety/draft model (paper §IV-C pipeline stage).

Used by the simulator as the guard stage of safety-checked pipelines and by
the serving stack as the DRAFT model for speculative decoding — a dense
GQA config an order of magnitude under the target models it rides with.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="guard-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=32000,
    mlp_type="gelu",
    attn_type="gqa",
)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU smoke tests. Deliberately shares the
    512-token vocabulary of ``gemma_2b.reduced()`` so it can serve as that
    config's speculative-decoding draft in engine tests and benchmarks."""
    return CONFIG.replace(
        name="guard-2b-smoke",
        num_layers=1,
        d_model=32,
        num_heads=2,
        num_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=512,
    )
