"""falcon-mamba-7b [ssm]: 64L d_model=4096, attn-free Mamba-1, vocab 65024,
ssm_state=16.  [arXiv:2410.05355; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    optimizer="adamw",
)
