"""Attention, the decode half: GQA/MQA/MHA with a sliding-window ring cache.

The port of ``repro.models.attention``'s single-token decode path.  The
cache is pre-allocated (B, S_alloc, KV, D) and updated IN PLACE at slot
``pos`` (``pos % window`` for the ring buffer of sliding-window
attention): where the reference returns new cache arrays, the port writes
into the ones it was given and returns them.  The attention core is the
paged decode-attention kernel (K4) over a page view of that cache, which
copies nothing.  ``attn_full`` and cross-attention are not on the decode
path and are not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.paged_attention import ops
from .common import ParamFactory, apply_rope, make_rope

__all__ = [
    "DECODE_PAGE",
    "DecodeCacheLayout",
    "init_attention",
    "cache_layout",
    "attn_decode",
]

# Largest page K4 sees on the decode path: the page is gcd(S_alloc,
# DECODE_PAGE), so it always divides the allocated slots.
DECODE_PAGE = 16


def init_attention(cfg, f: ParamFactory, layers: int | None = None) -> dict:
    """QKV + output projections; optional leading stacked-layer dim."""
    d, H, KV, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    p = {
        "wq": f.param(L + (d, H, D), lax_ + ("embed", "heads", "head_dim")),
        "wk": f.param(L + (d, KV, D), lax_ + ("embed", "kv_heads", "head_dim")),
        "wv": f.param(L + (d, KV, D), lax_ + ("embed", "kv_heads", "head_dim")),
        "wo": f.param(L + (H, D, d), lax_ + ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = f.param(L + (H, D), lax_ + ("heads", "head_dim"), zero=True)
        p["bk"] = f.param(L + (KV, D), lax_ + ("kv_heads", "head_dim"), zero=True)
        p["bv"] = f.param(L + (KV, D), lax_ + ("kv_heads", "head_dim"), zero=True)
    return p


def _qkv(cfg, p, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


class DecodeCacheLayout(NamedTuple):
    """Static description of one layer's KV cache."""

    seq: int  # allocated slots (= window for SWA, else max seq)
    ring: bool


def cache_layout(cfg, max_seq: int) -> DecodeCacheLayout:
    if cfg.sliding_window is not None and cfg.sliding_window < max_seq:
        return DecodeCacheLayout(cfg.sliding_window, True)
    return DecodeCacheLayout(max_seq, False)


def attn_decode(
    cfg,
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    k_cache: torch.Tensor,  # (B, S_alloc, KV, D), written in place
    v_cache: torch.Tensor,
    pos: int,  # current decode position
    layout: DecodeCacheLayout,
):
    """One decode step; returns (out (B,1,d), k_cache, v_cache).

    The caches are the tensors passed in, with this step's K/V written at
    its slot.  Every slot ``t < min(pos + 1, S_alloc)`` is valid: the
    reference's plain mask ``t <= pos`` and its ring mask ``t <= slot or
    pos >= window`` both come to that, so K4 gets it as ``seq_lens``."""
    pos = int(pos)
    if not layout.ring and pos >= layout.seq:
        raise ValueError(f"position {pos} is past the {layout.seq}-slot cache")
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x)  # (B,1,H,D)/(B,1,KV,D)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    cos, sin = make_rope(posv, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    slot = pos % layout.seq
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]

    page = math.gcd(layout.seq, DECODE_PAGE)
    k_pages, v_pages, page_table = ops.dense_to_pages(k_cache, v_cache, page)
    seq_lens = torch.full((B,), min(pos + 1, layout.seq), dtype=torch.int32,
                          device=x.device)
    out = ops.paged_attention(q[:, 0], k_pages, v_pages, page_table, seq_lens)
    out = torch.einsum("bshd,hdm->bsm", out[:, None], p["wo"])
    return out, k_cache, v_cache
