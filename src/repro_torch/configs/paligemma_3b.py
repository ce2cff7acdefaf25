"""paligemma-3b [vlm]: SigLIP (stub) + 18L gemma d_model=2048 8H MQA(kv=1)
d_ff=16384 vocab=257216, GeGLU, prefix-LM over image tokens.
[arXiv:2407.07726; hf]

The vision frontend is a STUB: input_specs() provides 256 precomputed
patch embeddings per image; head_dim 256 (gemma)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    frontend="vision",
    n_prefix=256,
    tie_embeddings=True,
    optimizer="adamw",
)
