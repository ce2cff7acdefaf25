"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses

from .base import SHAPES, ModelConfig, ShapeConfig
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .mistral_large_123b import CONFIG as mistral_large_123b
from .qwen1_5_110b import CONFIG as qwen1_5_110b
from .codeqwen1_5_7b import CONFIG as codeqwen1_5_7b
from .nemotron_4_340b import CONFIG as nemotron_4_340b
from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from .mixtral_8x22b import CONFIG as mixtral_8x22b
from .moonshot_v1_16b_a3b import CONFIG as moonshot_v1_16b_a3b
from .paligemma_3b import CONFIG as paligemma_3b
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b

__all__ = ["ARCHS", "get_config", "smoke_config", "list_archs", "cells"]

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        falcon_mamba_7b,
        mistral_large_123b,
        qwen1_5_110b,
        codeqwen1_5_7b,
        nemotron_4_340b,
        seamless_m4t_large_v2,
        mixtral_8x22b,
        moonshot_v1_16b_a3b,
        paligemma_3b,
        jamba_v0_1_52b,
    ]
}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (tiny dims, few layers)."""
    cfg = get_config(name)
    small: dict = dict(
        d_model=64,
        d_ff=128,
        vocab_size=512,
        dtype="float32",
        remat=False,
        microbatch=None,
    )
    if cfg.n_heads:
        small.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
                     head_dim=16)
    if cfg.family == "hybrid":
        small.update(n_layers=8, attn_period=4, attn_offset=2)
    elif cfg.family == "encdec":
        small.update(n_layers=2, n_enc_layers=2)
    else:
        small.update(n_layers=2)
    if cfg.n_experts:
        small.update(n_experts=4, top_k=2, moe_d_ff=128)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=8, ssm_conv=4, ssm_expand=2, dt_rank=8)
    if cfg.sliding_window:
        small.update(sliding_window=16)
    if cfg.family == "vlm":
        small.update(n_prefix=8)
    return dataclasses.replace(cfg, **small)


def cells() -> list[tuple[str, str]]:
    """All live (arch, shape) dry-run cells: 40 minus skipped long_500k.

    long_500k needs sub-quadratic attention (SSM / hybrid / SWA); pure
    full-attention archs skip it (DESIGN.md §4)."""
    out = []
    for arch, cfg in ARCHS.items():
        for sname, sh in SHAPES.items():
            if sname == "long_500k" and not cfg.sub_quadratic:
                continue
            out.append((arch, sname))
    return out
