"""Attention: GQA/MQA/MHA, sliding-window, prefix-LM, cross-attn, KV cache.

The port of ``repro.models.attention``.  Full-sequence (train/prefill)
attention, ``attn_full`` and ``cross_attn_full``, stays plain PyTorch as the
reference's is plain ``jnp``: einsums, with the scores and the softmax in
f32 and the products in the activation dtype.

Decode: the cache is pre-allocated (B, S_alloc, KV, D) and updated IN
PLACE at slot ``pos`` (``pos % window`` for the ring buffer of
sliding-window attention): where the reference returns new cache arrays,
the port writes into the ones it was given and returns them.  The
attention core of ``attn_decode`` and ``cross_attn_decode`` is the paged
decode-attention kernel (K4) over a page view of the cache (or of the
static cross K/V), which copies nothing; its page table and lengths come
from tables made once per (batch, slots, device), so a step launches
nothing for them.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.paged_attention import ops
from .common import ParamFactory, apply_rope, make_rope

__all__ = [
    "DECODE_PAGE",
    "DecodeCacheLayout",
    "init_attention",
    "attn_full",
    "cache_layout",
    "attn_decode",
    "init_cross_attention",
    "cross_attn_full",
    "precompute_cross_kv",
    "cross_attn_decode",
]

# Largest page K4 sees on the decode path: the page is gcd(S_alloc,
# DECODE_PAGE), so it always divides the allocated slots.
DECODE_PAGE = 16
_NEG_INF = -1e30


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


def _scale(head_dim: int) -> float:
    """1 / sqrt(head_dim) in float32 arithmetic, as the reference's
    ``1.0 / jnp.sqrt(head_dim).astype(jnp.float32)``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _gqa_scores(q, k, scale):
    """q (B,S,H,D), k (B,T,KV,D) -> scores (B,KV,G,S,T) in f32."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    return s * scale


def _attend(probs, v):
    """probs (B,KV,G,S,T) f32, v (B,T,KV,D) -> (B,S,H,D)."""
    B, KV, G, S, T = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, KV * G, -1)


def attn_full(
    cfg,
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (S,) int
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Full self-attention. ``prefix_len`` > 0 gives a bidirectional prefix
    (prefix-LM, used by the VLM's image tokens)."""
    S = x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    cos, sin = make_rope(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    scores = _gqa_scores(q, k, _scale(cfg.head_dim))

    ii = positions[:, None]  # (S, 1) query pos
    jj = positions[None, :]  # (1, S) key pos
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
    if causal:
        mask &= jj <= ii
        if prefix_len > 0:  # bidirectional over the prefix block
            mask |= (ii < prefix_len) & (jj < prefix_len)
    if window is not None:
        mask &= ii - jj < window
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _attend(probs, v)
    return torch.einsum("bshd,hdm->bsm", out, p["wo"])


class DecodeCacheLayout(NamedTuple):
    """Static description of one layer's KV cache."""

    seq: int  # allocated slots (= window for SWA, else max seq)
    ring: bool


def cache_layout(cfg, max_seq: int) -> DecodeCacheLayout:
    if cfg.sliding_window is not None and cfg.sliding_window < max_seq:
        return DecodeCacheLayout(cfg.sliding_window, True)
    return DecodeCacheLayout(max_seq, False)


@functools.lru_cache(maxsize=16)
def _cached_tables(B: int, seq: int, page: int, device: torch.device):
    """The identity page table (B, seq / page) of ``dense_to_pages``, and a
    (seq, B) table whose row n - 1 holds every sequence's length n.  Shared
    by every later call: private, so no caller can write into them."""
    table = torch.arange(B * (seq // page), dtype=torch.int32,
                         device=device).view(B, seq // page)
    lens = torch.arange(1, seq + 1, dtype=torch.int32, device=device)
    return table, lens[:, None].expand(seq, B).contiguous()


def _decode_tables(B: int, layout: DecodeCacheLayout, pos: int,
                   device) -> tuple:
    """K4's (page_table, seq_lens) at decode position ``pos``: a cached
    tensor and a row of one, made once per (B, layout, device), so a step
    launches nothing for them.  They are handed only to K4, which reads
    them; nothing may write into them."""
    page = math.gcd(layout.seq, DECODE_PAGE)
    table, lens = _cached_tables(B, layout.seq, page, torch.device(device))
    return table, lens[min(pos + 1, layout.seq) - 1]


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
    q, k, v = _qkv(cfg, p, x)  # (B,1,H,D)/(B,1,KV,D)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    cos, sin = make_rope(posv, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    slot = pos % layout.seq
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]

    page = math.gcd(layout.seq, DECODE_PAGE)
    B, S, KV, D = k_cache.shape
    k_pages = k_cache.view(B * S // page, page, KV, D)
    v_pages = v_cache.view(B * S // page, page, KV, D)
    page_table, seq_lens = _decode_tables(B, layout, pos, x.device)
    out = ops.paged_attention(q[:, 0], k_pages, v_pages, page_table, seq_lens)
    out = torch.einsum("bshd,hdm->bsm", out[:, None], p["wo"])
    return out, k_cache, v_cache


# ---------------------------------------------------------------- cross-attention
def init_cross_attention(cfg, f: ParamFactory, layers: int | None = None) -> dict:
    return init_attention(cfg, f, layers)


def _cross_kv(cfg, p, memory):
    k = torch.einsum("btd,dhk->bthk", memory, p["wk"])
    v = torch.einsum("btd,dhk->bthk", memory, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def cross_attn_full(cfg, p: dict, x: torch.Tensor,
                    memory: torch.Tensor) -> torch.Tensor:
    """Decoder attends to encoder ``memory`` (B, T, d). No RoPE, no mask."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    k, v = _cross_kv(cfg, p, memory)
    probs = torch.softmax(_gqa_scores(q, k, _scale(cfg.head_dim)), dim=-1)
    out = _attend(probs, v)
    return torch.einsum("bshd,hdm->bsm", out, p["wo"])


def precompute_cross_kv(cfg, p: dict, memory: torch.Tensor):
    """Cross-attention K/V are static per sequence -- computed once at
    prefill; contiguous (B, T, KV, D), so K4 takes a page view of them."""
    k, v = _cross_kv(cfg, p, memory)
    return k.contiguous(), v.contiguous()


def cross_attn_decode(cfg, p: dict, x: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor) -> torch.Tensor:
    """One decoder token against the static cross K/V (B, enc_len, KV, D),
    contiguous: K4 over their page view, pages of gcd(enc_len,
    DECODE_PAGE) slots, every sequence ``enc_len`` long."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    B, T, KV, D = ck.shape
    page = math.gcd(T, DECODE_PAGE)
    table, lens = _cached_tables(B, T, page, torch.device(x.device))
    out = ops.paged_attention(q[:, 0], ck.view(B * T // page, page, KV, D),
                              cv.view(B * T // page, page, KV, D), table,
                              lens[T - 1])
    return torch.einsum("bshd,hdm->bsm", out[:, None], p["wo"])
