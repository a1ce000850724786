"""xLSTM-1.3B [arXiv:2405.04517]. Stacked mLSTM blocks with periodic sLSTM
blocks (7:1 ratio). d_ff=0: the up/down projections live inside the blocks."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    mlp_type="gelu",
    attn_type="none",
    xlstm=XLSTMConfig(slstm_every=8, proj_factor_mlstm=2.0, conv_width=4),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-1.3b-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        vocab_size=512,
        xlstm=XLSTMConfig(slstm_every=2, proj_factor_mlstm=2.0, conv_width=4, chunk_size=32),
    )
