"""moonshot-v1-16b-a3b (Moonlight) [moe]: 48L d_model=2048 16H (kv=16)
expert d_ff=1408, MoE 64 experts top-6, vocab 163840.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=163840,
    activation="swiglu",
    n_experts=64,
    top_k=6,
    optimizer="adamw",
)
