"""Feed-forward blocks: SwiGLU / GeGLU (gated) and squared-ReLU / GELU.

The port of ``repro.models.mlp``.  The products stay ``torch.einsum``
(cuBLAS on the card), as the reference leaves them to XLA; the
activations carry the reference's ``shard_hint``s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.logical import shard_hint
from .common import ParamFactory, einsum

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
    up = einsum("bsd,df->bsf", x, p["wu"])
    up = shard_hint(up, ("batch", "seq", "ff"))
    if is_gated(cfg.activation):
        gate = einsum("bsd,df->bsf", x, p["wg"])
        gate = shard_hint(gate, ("batch", "seq", "ff"))
        h = act(gate) * up
    else:
        h = act(up)
    out = einsum("bsf,fd->bsd", h, p["wd"])
    return shard_hint(out, ("batch", "seq", "embed"))
