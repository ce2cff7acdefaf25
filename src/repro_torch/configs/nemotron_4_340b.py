"""nemotron-4-340b [dense]: 96L d_model=18432 96H GQA(kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP (non-gated).  [arXiv:2402.16819; unverified]

Head dim 18432/96 = 192.  8-bit optimizer state is required to fit v5e HBM
(see DESIGN.md §5)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",
    optimizer="adamw8bit",
    microbatch=32,
)
