"""Shared model building blocks: param factory, norms, rope, vocab padding.

Models are functional, as in ``repro.models``: ``init(cfg, factory) ->
params`` (nested dicts of tensors) and ``apply(cfg, params, ...)``.  The
port's ``ParamFactory`` builds real tensors from a ``torch.Generator``, or,
with no generator, meta tensors (shapes and dtypes only, as the
reference's ``abstract`` mode); the reference's ``axes`` mode belongs to
the mesh tools and waits for them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = [
    "ParamFactory",
    "rms_norm",
    "make_rope",
    "apply_rope",
    "pad_vocab",
    "VOCAB_MULTIPLE",
]

VOCAB_MULTIPLE = 256
_DRAW = 1 << 26  # float32 normals drawn at once (256 MiB)


def pad_vocab(vocab_size: int, multiple: int = VOCAB_MULTIPLE) -> int:
    """Pad vocab so the embedding always shards over the model axis."""
    return -(-vocab_size // multiple) * multiple


class ParamFactory:
    """Builds parameter tensors on ``generator``'s device.  With no
    generator it builds zeros and constants on ``device``, and meta
    tensors for random parameters (the default device is ``meta``).

    ``param`` draws N(0, 1) in float32, scales it and stores it in
    ``dtype``, as the reference does; the scale rule is the reference's
    (``fan_in = shape[-2]``, which for a stacked (L, d, H, D) weight is H).
    The normals are drawn ``_DRAW`` at a time straight into the output, so
    no float32 temporary of a whole stacked weight is made."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype=torch.bfloat16, device=None):
        self.generator = generator
        self.device = (generator.device if generator is not None
                       else torch.device(device or "meta"))
        self.dtype = dtype

    def param(
        self,
        shape: Sequence[int],
        logical: Sequence[Optional[str]],
        scale: Optional[float] = None,
        zero: bool = False,
        dtype=None,
    ) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(logical):
            raise ValueError(f"shape {shape} vs logical axes {logical}")
        dtype = dtype or self.dtype
        if zero:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        out = torch.empty(shape, dtype=dtype, device=self.device)
        if self.generator is None:
            if self.device.type != "meta":
                raise ValueError("random parameters need a generator")
            return out
        flat = out.view(-1)
        for lo in range(0, flat.numel(), _DRAW):
            hi = min(lo + _DRAW, flat.numel())
            draw = torch.randn(hi - lo, generator=self.generator,
                               device=self.device, dtype=torch.float32)
            flat[lo:hi] = draw.mul_(scale)
        return out

    def const(self, value: float, shape, logical, dtype=None) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        return torch.full(shape, value, dtype=dtype or self.dtype,
                          device=self.device)


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


# ---------------------------------------------------------------- rope
def make_rope(positions: torch.Tensor, head_dim: int, theta: float = 10_000.0):
    """cos/sin tables for rotary embedding; positions (..., S) int."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs  # (..., S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch & heads
        c = cos[None, :, None, :]
        s = sin[None, :, None, :]
    else:  # (B, S, half)
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)
