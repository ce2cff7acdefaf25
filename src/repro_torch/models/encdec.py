"""Encoder-decoder backbone (seamless-m4t style, audio frontend stubbed).

The port of ``repro.models.encdec``.  The modality frontend is a stub:
precomputed frame embeddings (B, S_enc, d_model) go through a learned
adapter into the encoder.  Decoder = self-attention (causal, cached) +
cross-attention (static K/V, precomputed at prefill) + MLP.  The
reference's scans over the stacked layers become Python loops over the
layer index; the decode cache is written in place, and both attentions
of a decode step go through K4.  ``cfg.remat`` checkpoints each encoder
and each decoder layer, as the reference's ``jax.checkpoint(body)``.
"""
from __future__ import annotations

import torch

from .attention import (
    attn_decode,
    attn_full,
    cache_layout,
    cross_attn_decode,
    cross_attn_full,
    init_attention,
    init_cross_attention,
    precompute_cross_kv,
)
from .common import ParamFactory, pad_vocab, rms_norm
from .mlp import init_mlp, mlp_apply
from .transformer import _layer, cross_entropy, remat

__all__ = [
    "init_encdec",
    "encdec_encode",
    "encdec_forward",
    "encdec_loss",
    "make_encdec_cache",
    "prefill_cross_kv",
    "encdec_decode_step",
]


def init_encdec(cfg, f: ParamFactory) -> dict:
    V = pad_vocab(cfg.vocab_size)
    d = cfg.d_model
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    enc = {
        "ln1": f.const(1.0, (Le, d), ("layers", "embed")),
        "attn": init_attention(cfg, f, layers=Le),
        "ln2": f.const(1.0, (Le, d), ("layers", "embed")),
        "mlp": init_mlp(cfg, f, cfg.d_ff, layers=Le),
    }
    dec = {
        "ln1": f.const(1.0, (Ld, d), ("layers", "embed")),
        "self_attn": init_attention(cfg, f, layers=Ld),
        "ln2": f.const(1.0, (Ld, d), ("layers", "embed")),
        "cross_attn": init_cross_attention(cfg, f, layers=Ld),
        "ln3": f.const(1.0, (Ld, d), ("layers", "embed")),
        "mlp": init_mlp(cfg, f, cfg.d_ff, layers=Ld),
    }
    return {
        "frontend_proj": f.param((d, d), ("embed", None)),
        "embed": f.param((V, d), ("vocab", "embed"), scale=0.02),
        "enc": enc,
        "enc_norm": f.const(1.0, (d,), ("embed",)),
        "dec": dec,
        "final_norm": f.const(1.0, (d,), ("embed",)),
        "unembed": f.param((V, d), ("vocab", "embed"), scale=0.02),
    }


def encdec_encode(cfg, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> encoder memory (B, S_enc, d)."""
    x = torch.einsum("bsd,de->bse", frames.to(cfg.activation_dtype),
                     params["frontend_proj"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def body(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn_full(cfg, lp["attn"], h, positions, causal=False)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + mlp_apply(cfg, lp["mlp"], h)

    for i in range(cfg.n_enc_layers):
        x = remat(cfg, body, x, _layer(params["enc"], i))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def encdec_forward(cfg, params: dict, frames: torch.Tensor,
                   dec_tokens: torch.Tensor, return_hidden: bool = False):
    """Teacher-forced logits (B, S_dec, V); with ``return_hidden``, the
    final-normed decoder state."""
    memory = encdec_encode(cfg, params, frames)
    x = params["embed"][dec_tokens.long()].to(cfg.activation_dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def body(x, memory, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn_full(cfg, lp["self_attn"], h, positions, causal=True)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + cross_attn_full(cfg, lp["cross_attn"], h, memory)
        h = rms_norm(x, lp["ln3"], cfg.norm_eps)
        return x + mlp_apply(cfg, lp["mlp"], h)

    for i in range(cfg.n_layers):
        x = remat(cfg, body, x, memory, _layer(params["dec"], i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x
    return torch.einsum("bsd,vd->bsv", x, params["unembed"])


def encdec_loss(cfg, params, frames, dec_tokens, labels):
    """Teacher-forced CE of the decoder over the padded vocab."""
    hidden = encdec_forward(cfg, params, frames, dec_tokens, return_hidden=True)
    return cross_entropy(cfg, hidden, params["unembed"], labels)


def make_encdec_cache(cfg, f: ParamFactory, batch: int, max_seq: int,
                      enc_len: int) -> dict:
    """Zero self-attention K/V (L, B, S_alloc, KV, D) and cross K/V (L, B,
    enc_len, KV, D) on the factory's device; ``pos`` a Python int."""
    L = cfg.n_layers
    layout = cache_layout(cfg, max_seq)
    kv = (L, batch, layout.seq, cfg.n_kv_heads, cfg.head_dim)
    ckv = (L, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    lax_ = ("layers", "batch", "cache_seq", "cache_kv_heads", "head_dim")
    return {
        "k": f.param(kv, lax_, zero=True),
        "v": f.param(kv, lax_, zero=True),
        "cross_k": f.param(ckv, lax_, zero=True),
        "cross_v": f.param(ckv, lax_, zero=True),
        "pos": 0,
    }


def prefill_cross_kv(cfg, params: dict, frames: torch.Tensor):
    """Encoder pass + per-layer cross K/V (the static part of the cache):
    (memory, cross_k, cross_v), the last two (L, B, S_enc, KV, D)."""
    memory = encdec_encode(cfg, params, frames)
    kvs = [precompute_cross_kv(cfg, _layer(params["dec"], i)["cross_attn"],
                               memory) for i in range(cfg.n_layers)]
    return (memory, torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def encdec_decode_step(cfg, params: dict, token: torch.Tensor, cache: dict,
                       max_seq: int):
    """One decoder step against the cache's cross K/V; returns (logits
    (B,1,V), cache), the self-attention K/V written in place."""
    x = params["embed"][token.long()].to(cfg.activation_dtype)
    pos = int(cache["pos"])
    layout = cache_layout(cfg, max_seq)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = attn_decode(cfg, lp["self_attn"], h, cache["k"][i],
                              cache["v"][i], pos, layout)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + cross_attn_decode(cfg, lp["cross_attn"], h,
                                  cache["cross_k"][i], cache["cross_v"][i])
        h = rms_norm(x, lp["ln3"], cfg.norm_eps)
        x = x + mlp_apply(cfg, lp["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", x, params["unembed"])
    return logits, dict(cache, pos=pos + 1)
