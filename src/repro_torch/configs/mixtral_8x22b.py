"""mixtral-8x22b [moe]: 56L d_model=6144 48H GQA(kv=8) expert d_ff=16384,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    moe_d_ff=16384,
    vocab_size=32768,
    activation="swiglu",
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    optimizer="adamw8bit",
)
