"""Feed-forward blocks: SwiGLU / GeGLU (gated) and squared-ReLU / GELU.

The port of ``repro.models.mlp``.  The products stay ``torch.einsum``
(cuBLAS on the card), as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamFactory

__all__ = ["init_mlp", "mlp_apply", "is_gated", "act_fn"]


def is_gated(activation: str) -> bool:
    return activation in ("swiglu", "geglu")


def act_fn(activation: str):
    if activation in ("swiglu",):
        return F.silu
    if activation in ("geglu", "gelu"):
        # jax.nn.gelu defaults to the tanh approximation.
        return lambda x: F.gelu(x, approximate="tanh")
    if activation == "relu2":  # Nemotron-4 squared ReLU
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {activation!r}")


def init_mlp(cfg, f: ParamFactory, d_ff: int, layers: int | None = None) -> dict:
    d = cfg.d_model
    L = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    p = {}
    if is_gated(cfg.activation):
        p["wg"] = f.param(L + (d, d_ff), lax_ + ("embed", "ff"))
        p["wu"] = f.param(L + (d, d_ff), lax_ + ("embed", "ff"))
    else:
        p["wu"] = f.param(L + (d, d_ff), lax_ + ("embed", "ff"))
    p["wd"] = f.param(L + (d_ff, d), lax_ + ("ff_in", "embed"))
    return p


def mlp_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = act_fn(cfg.activation)
    up = torch.einsum("bsd,df->bsf", x, p["wu"])
    if is_gated(cfg.activation):
        gate = torch.einsum("bsd,df->bsf", x, p["wg"])
        h = act(gate) * up
    else:
        h = act(up)
    return torch.einsum("bsf,fd->bsd", h, p["wd"])
