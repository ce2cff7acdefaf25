"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H GQA(kv=8) d_ff=14336,
Mamba:attn 7:1 interleave (attn at offset 4 of each 8-layer period),
MoE 16 experts top-2 on every other layer.  [arXiv:2403.19887; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    optimizer="adamw8bit",
)
