"""Hybrid Mamba+Attention+MoE backbone (Jamba-style, 1:7 attn:mamba).

The port of ``repro.models.hybrid``.  Layers are grouped into *periods* of
``attn_period`` layers: one attention layer (at ``attn_offset``) and
``attn_period-1`` Mamba mixers; the MLP is a MoE (through K5) on layers
where ``global_idx % moe_every == moe_offset``.  The parameters of layer
``i`` of a period are stacked over the P periods (``periods/layer{i}``);
the reference's scan over periods becomes a Python loop over the period
index, and within a period the fixed layer pattern is unrolled.  The
decode cache is written in place: the attention K/V at ``[p]``, the Mamba
states at ``[p, mi]`` (``mi`` the Mamba layer's index within its period).
``cfg.remat`` checkpoints each period, as the reference's
``jax.checkpoint(period_body)``.
"""
from __future__ import annotations

import torch

from .attention import attn_decode, attn_full, cache_layout, init_attention
from .common import ParamFactory, pad_vocab, rms_norm
from .mlp import init_mlp, mlp_apply
from .moe import init_moe, moe_apply_with_aux
from .ssm import init_mamba, mamba_decode, mamba_full, mamba_state_shapes
from .transformer import _layer, cross_entropy, remat

__all__ = [
    "init_hybrid",
    "hybrid_forward",
    "hybrid_loss",
    "make_hybrid_cache",
    "hybrid_decode_step",
]


def _n_periods(cfg) -> int:
    if cfg.n_layers % cfg.attn_period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"periods of {cfg.attn_period}")
    return cfg.n_layers // cfg.attn_period


def init_hybrid(cfg, f: ParamFactory) -> dict:
    V = pad_vocab(cfg.vocab_size)
    d = cfg.d_model
    P = _n_periods(cfg)
    period: dict[str, dict] = {}
    for i in range(cfg.attn_period):
        lp: dict = {"ln1": f.const(1.0, (P, d), ("layers", "embed"))}
        if i == cfg.attn_offset:
            lp["attn"] = init_attention(cfg, f, layers=P)
        else:
            lp["mixer"] = init_mamba(cfg, f, layers=P)
        lp["ln2"] = f.const(1.0, (P, d), ("layers", "embed"))
        if cfg.n_experts and (i % cfg.moe_every == cfg.moe_offset):
            lp["moe"] = init_moe(cfg, f, layers=P)
        else:
            lp["mlp"] = init_mlp(cfg, f, cfg.d_ff, layers=P)
        period[f"layer{i}"] = lp
    return {
        "embed": f.param((V, d), ("vocab", "embed"), scale=0.02),
        "periods": period,
        "final_norm": f.const(1.0, (d,), ("embed",)),
        "unembed": f.param((V, d), ("vocab", "embed"), scale=0.02),
    }


def _ffn(cfg, lp, x):
    """The layer's MoE or MLP on its ln2-normed input: (out, aux)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        return moe_apply_with_aux(cfg, lp["moe"], h)
    return mlp_apply(cfg, lp["mlp"], h), None


def hybrid_forward(cfg, params: dict, tokens: torch.Tensor,
                   return_hidden: bool = False):
    """(logits (B, S, V), aux loss); with ``return_hidden``, the
    final-normed hidden state in place of the logits."""
    x = params["embed"][tokens.long()].to(cfg.activation_dtype)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def period_body(x, aux, pp):
        for i in range(cfg.attn_period):
            lp = pp[f"layer{i}"]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if "attn" in lp:
                x = x + attn_full(cfg, lp["attn"], h, positions, causal=True,
                                  window=cfg.sliding_window)
            else:
                x = x + mamba_full(cfg, lp["mixer"], h)
            m, a = _ffn(cfg, lp, x)
            if a is not None:
                aux = aux + a
            x = x + m
        return x, aux

    for p in range(_n_periods(cfg)):
        x, aux = remat(cfg, period_body, x, aux, _layer(params["periods"], p))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux
    return torch.einsum("bsd,vd->bsv", x, params["unembed"]), aux


def hybrid_loss(cfg, params, tokens, labels, aux_weight: float = 0.01):
    """Next-token CE plus ``aux_weight`` x the MoE layers' load-balance
    loss."""
    hidden, aux = hybrid_forward(cfg, params, tokens, return_hidden=True)
    return cross_entropy(cfg, hidden, params["unembed"], labels) + aux_weight * aux


def make_hybrid_cache(cfg, f: ParamFactory, batch: int, max_seq: int) -> dict:
    """K/V (P, B, S_alloc, KV, D), conv tails (P, attn_period-1, B, conv-1,
    d_inner) and f32 states (P, attn_period-1, B, d_inner, N), zero on the
    factory's device; ``pos`` a Python int."""
    P = _n_periods(cfg)
    n_mamba = cfg.attn_period - 1
    layout = cache_layout(cfg, max_seq)
    cs, hs = mamba_state_shapes(cfg, batch)
    kv = (P, batch, layout.seq, cfg.n_kv_heads, cfg.head_dim)
    lax_ = ("layers", "batch", "cache_seq", "cache_kv_heads", "head_dim")
    return {
        "k": f.param(kv, lax_, zero=True),
        "v": f.param(kv, lax_, zero=True),
        "conv": f.param((P, n_mamba, *cs),
                        ("layers", None, "batch", "conv", "inner"), zero=True),
        "h": f.param((P, n_mamba, *hs),
                     ("layers", None, "batch", "inner", "state"), zero=True,
                     dtype=torch.float32),
        "pos": 0,
    }


def hybrid_decode_step(cfg, params: dict, token: torch.Tensor, cache: dict,
                       max_seq: int):
    """One decode step; returns (logits (B,1,V), cache), the cache's
    tensors written in place and ``pos + 1``."""
    x = params["embed"][token.long()].to(cfg.activation_dtype)
    pos = int(cache["pos"])
    layout = cache_layout(cfg, max_seq)
    for p in range(_n_periods(cfg)):
        pp = _layer(params["periods"], p)
        mi = 0
        for i in range(cfg.attn_period):
            lp = pp[f"layer{i}"]
            hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if "attn" in lp:
                a, _, _ = attn_decode(cfg, lp["attn"], hn, cache["k"][p],
                                      cache["v"][p], pos, layout)
            else:
                a, _, _ = mamba_decode(cfg, lp["mixer"], hn,
                                       cache["conv"][p, mi], cache["h"][p, mi])
                mi += 1
            x = x + a
            m, _ = _ffn(cfg, lp, x)
            x = x + m
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", x, params["unembed"])
    return logits, dict(cache, pos=pos + 1)
