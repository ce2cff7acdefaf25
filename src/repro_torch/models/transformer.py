"""Decoder-only LM backbone, the dense and MoE decode paths.

The port of ``repro.models.transformer``'s ``init_lm``,
``make_decode_cache`` and ``lm_decode_step`` for the dense and MoE
families.  The reference's ``lax.scan`` over the stacked (L, ...) layer
parameters becomes a Python loop over the layer index.  The SSM, hybrid,
encoder-decoder and VLM variants and the full-sequence (train/prefill)
forward are not ported yet.
"""
from __future__ import annotations

import torch

from .attention import attn_decode, cache_layout, init_attention
from .common import ParamFactory, pad_vocab, rms_norm
from .mlp import init_mlp, mlp_apply
from .moe import init_moe, moe_apply_with_aux

__all__ = ["init_lm", "make_decode_cache", "lm_decode_step", "require_ported"]

PORTED_FAMILIES = ("dense", "moe")


def require_ported(cfg) -> None:
    """Raise for a family whose decode is not ported yet (ROADMAP.md §1,
    item 2: SSM, hybrid, encoder-decoder and VLM decode).  A hybrid config
    with experts (jamba) is hybrid, not MoE."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; see "
            f"ROADMAP.md §1, item 2"
        )


# ------------------------------------------------------------------ init
def _init_layer_stack(cfg, f: ParamFactory) -> dict:
    L = cfg.n_layers
    d = cfg.d_model
    p = {
        "ln1": f.const(1.0, (L, d), ("layers", "embed")),
        "attn": init_attention(cfg, f, layers=L),
        "ln2": f.const(1.0, (L, d), ("layers", "embed")),
    }
    if cfg.n_experts and cfg.moe_every == 1:
        p["moe"] = init_moe(cfg, f, layers=L)
    else:
        p["mlp"] = init_mlp(cfg, f, cfg.d_ff, layers=L)
    return p


def init_lm(cfg, f: ParamFactory) -> dict:
    require_ported(cfg)
    V = pad_vocab(cfg.vocab_size)
    d = cfg.d_model
    params = {
        "embed": f.param((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": f.const(1.0, (d,), ("embed",)),
        "layers": _init_layer_stack(cfg, f),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = f.param((V, d), ("vocab", "embed"), scale=0.02)
    return params


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked (L, ...) parameter tree, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ------------------------------------------------------------------ decode
def make_decode_cache(cfg, f: ParamFactory, batch: int, max_seq: int) -> dict:
    """Pre-allocated decode cache: zero K/V (L, B, S_alloc, KV, D) in the
    factory's dtype on its device, and ``pos`` as a Python int."""
    require_ported(cfg)
    layout = cache_layout(cfg, max_seq)
    kv = (cfg.n_layers, batch, layout.seq, cfg.n_kv_heads, cfg.head_dim)
    lax_ = ("layers", "batch", "cache_seq", "cache_kv_heads", "head_dim")
    return {
        "k": f.param(kv, lax_, zero=True),
        "v": f.param(kv, lax_, zero=True),
        "pos": 0,
    }


def lm_decode_step(cfg, params: dict, token: torch.Tensor, cache: dict,
                   max_seq: int):
    """One decode step. token: (B, 1) int. Returns (logits (B,1,V), cache).

    The returned cache holds the same K/V tensors, written in place, and
    ``pos + 1``."""
    require_ported(cfg)
    x = params["embed"][token.long()].to(cfg.activation_dtype)
    pos = int(cache["pos"])
    layout = cache_layout(cfg, max_seq)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = attn_decode(cfg, lp["attn"], hn, cache["k"][i],
                              cache["v"][i], pos, layout)
        x = x + a
        hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if "moe" in lp:
            m, _ = moe_apply_with_aux(cfg, lp["moe"], hn)
        else:
            m = mlp_apply(cfg, lp["mlp"], hn)
        x = x + m
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,vd->bsv", x, table)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
