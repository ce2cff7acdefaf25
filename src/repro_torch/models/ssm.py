"""Mamba-1 selective state-space block (falcon-mamba / jamba mixer).

The port of ``repro.models.ssm``.  The full-sequence path runs the
selective scan as a Python loop over time in f32, in the reference's
order: ``h = h * dA_t + dBx_t``, then ``y_t = einsum("bin,bn->bi", h,
C_t)``; ``delta``, ``B``, ``C``, ``dA`` and ``dBx`` are f32, and ``y`` is
cast to the activation dtype only before the gate.  Decode keeps O(1)
state per layer, a (conv-1)-sample convolution tail and the (d_inner, N)
f32 SSM state, and writes both IN PLACE: where the reference returns new
state arrays, the port writes into the ones it was given and returns them.
The reference's scan is plain ``jnp`` (no Pallas kernel), and so is this.

Within ``scan_steps(n)`` (the multi-pod dry-run) the selective scan runs
its first n time steps only and the later outputs repeat the last (a
view, cat into place): the dry-run traces two such lengths and
extrapolates its counts affinely to the full sequence, since a trace of
every step at 32k tokens would take hours.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding.logical import shard_hint
from .common import ParamFactory, einsum

__all__ = ["init_mamba", "mamba_full", "mamba_decode", "mamba_state_shapes",
           "scan_steps"]

_SCAN = threading.local()


@contextlib.contextmanager
def scan_steps(n: Optional[int]):
    """Within: ``mamba_full``'s selective scan runs at most ``n`` time
    steps (None: all)."""
    prev = getattr(_SCAN, "steps", None)
    _SCAN.steps = n
    try:
        yield n
    finally:
        _SCAN.steps = prev


def init_mamba(cfg, f: ParamFactory, layers: int | None = None) -> dict:
    d, di, ns, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_actual
    cw = cfg.ssm_conv
    L = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    f32 = torch.float32
    return {
        "in_proj": f.param(L + (d, 2 * di), lax_ + ("embed", "inner")),
        "conv_w": f.param(L + (cw, di), lax_ + ("conv", "inner"), scale=0.5),
        "conv_b": f.param(L + (di,), lax_ + ("inner",), zero=True),
        "x_proj": f.param(L + (di, dr + 2 * ns), lax_ + ("inner", None)),
        "dt_proj": f.param(L + (dr, di), lax_ + ("dt", "inner")),
        "dt_bias": f.const(0.1, L + (di,), lax_ + ("inner",), dtype=f32),
        "A_log": f.const(0.5, L + (di, ns), lax_ + ("inner", "state"), dtype=f32),
        "D": f.const(1.0, L + (di,), lax_ + ("inner",), dtype=f32),
        "out_proj": f.param(L + (di, d), lax_ + ("inner", "embed")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _conv_full(p, xs):
    """Causal depthwise conv over time. xs: (B, S, di)."""
    cw = p["conv_w"].shape[0]
    S = xs.shape[1]
    pad = F.pad(xs, (0, 0, cw - 1, 0))
    out = torch.zeros_like(xs)
    for i in range(cw):  # tiny static loop (cw=4)
        out = out + pad[:, i : i + S, :] * p["conv_w"][i]
    return out + p["conv_b"]


def _ssm_params(cfg, p, xc):
    """Project to (delta, B, C) and discretize. xc: (B, S, di)."""
    dr, ns = cfg.dt_rank_actual, cfg.ssm_state
    dbc = einsum("bsi,ir->bsr", xc, p["x_proj"])
    dt, B_, C_ = torch.split(dbc, [dr, ns, ns], dim=-1)
    delta = _softplus(
        einsum("bsr,ri->bsi", dt, p["dt_proj"]).float() + p["dt_bias"]
    )  # (B, S, di) f32
    A = -torch.exp(p["A_log"].float())  # (di, ns)
    return delta, B_.float(), C_.float(), A


def mamba_full(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    xz = einsum("bsd,de->bse", x, p["in_proj"])
    xz = shard_hint(xz, ("batch", "seq", "inner"))
    xp, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_conv_full(p, xp))

    delta, B_, C_, A = _ssm_params(cfg, p, xc)
    dA = torch.exp(delta[..., None] * A)  # (B, S, di, ns)
    dBx = delta[..., None] * B_[:, :, None, :] * xc.float()[..., None]

    h = torch.zeros_like(dBx[:, 0])  # (B, di, ns) f32
    ys = []
    steps = getattr(_SCAN, "steps", None)
    steps = S if steps is None else min(S, steps)
    for t in range(steps):
        h = h * dA[:, t] + dBx[:, t]  # (B, di, ns)
        ys.append(einsum("bin,bn->bi", h, C_[:, t]))
    y = torch.stack(ys, dim=1)  # (B, S, di)
    if steps < S:
        y = torch.cat([y, y[:, -1:].expand(B, S - steps, y.shape[2])], dim=1)
    y = y + xc.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    out = einsum("bsi,id->bsd", y, p["out_proj"])
    return shard_hint(out, ("batch", "seq", "embed"))


def mamba_state_shapes(cfg, batch: int):
    """Decode state: conv tail (B, conv-1, di) + SSM state (B, di, ns)."""
    return (
        (batch, cfg.ssm_conv - 1, cfg.d_inner),
        (batch, cfg.d_inner, cfg.ssm_state),
    )


def mamba_decode(cfg, p: dict, x: torch.Tensor, conv_state: torch.Tensor,
                 h: torch.Tensor):
    """One token. x: (B, 1, d); returns (out, conv_state, h), the states
    being the tensors passed in, written in place."""
    xz = einsum("bsd,de->bse", x, p["in_proj"])[:, 0]  # (B, 2di)
    xp, z = torch.chunk(xz, 2, dim=-1)

    # conv ring: the state holds the last (cw-1) inputs.
    hist = torch.cat([conv_state, xp[:, None, :]], dim=1)  # (B, cw, di)
    xc = einsum("bci,ci->bi", hist, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)
    conv_state.copy_(hist[:, 1:, :])

    delta, B_, C_, A = _ssm_params(cfg, p, xc[:, None, :])
    delta, B_, C_ = delta[:, 0], B_[:, 0], C_[:, 0]
    dA = torch.exp(delta[..., None] * A)  # (B, di, ns)
    h.copy_(h * dA
            + delta[..., None] * B_[:, None, :] * xc.float()[..., None])
    y = einsum("bin,bn->bi", h, C_) + xc.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    out = einsum("bi,id->bd", y, p["out_proj"])[:, None, :]
    return shard_hint(out, ("batch", "seq", "embed")), conv_state, h
