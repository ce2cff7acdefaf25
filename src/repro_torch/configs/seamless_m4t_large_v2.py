"""seamless-m4t-large-v2 [audio]: enc-dec, 24L enc + 24L dec, d_model=1024
16H (kv=16) d_ff=8192 vocab=256206.  [arXiv:2308.11596; hf]

The audio frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S_enc, d_model); vocab pads 256206 -> 256256 for TP."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    activation="gelu",
    frontend="audio",
    optimizer="adamw",
)
