"""Decoder-only LM backbone: dense / MoE / VLM-prefix / SSM families.

The port of ``repro.models.transformer``: ``init_lm``, ``lm_forward``,
the losses (``cross_entropy``, ``lm_loss``), ``make_decode_cache`` and
``lm_decode_step``.  The reference's ``lax.scan`` over the stacked
(L, ...) layer parameters becomes a Python loop over the layer index; the
decode cache is written in place.  ``cfg.remat`` checkpoints each layer
(``remat``, ``torch.utils.checkpoint``) where the reference wraps its
scan body in ``jax.checkpoint``: the values are the same, the backward
recomputes the layer's forward instead of keeping its activations.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attn_decode, attn_full, cache_layout, init_attention
from .common import ParamFactory, pad_vocab, rms_norm
from .mlp import init_mlp, mlp_apply
from .moe import init_moe, moe_apply_with_aux
from .ssm import init_mamba, mamba_decode, mamba_full, mamba_state_shapes

__all__ = ["init_lm", "lm_forward", "cross_entropy", "lm_loss", "remat",
           "make_decode_cache", "lm_decode_step"]


# ------------------------------------------------------------------ init
def _init_layer_stack(cfg, f: ParamFactory) -> dict:
    L = cfg.n_layers
    d = cfg.d_model
    p = {"ln1": f.const(1.0, (L, d), ("layers", "embed"))}
    if cfg.family == "ssm":
        p["mixer"] = init_mamba(cfg, f, layers=L)
        return p
    p["attn"] = init_attention(cfg, f, layers=L)
    p["ln2"] = f.const(1.0, (L, d), ("layers", "embed"))
    if cfg.n_experts and cfg.moe_every == 1:
        p["moe"] = init_moe(cfg, f, layers=L)
    else:
        p["mlp"] = init_mlp(cfg, f, cfg.d_ff, layers=L)
    return p


def init_lm(cfg, f: ParamFactory) -> dict:
    V = pad_vocab(cfg.vocab_size)
    d = cfg.d_model
    params = {
        "embed": f.param((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": f.const(1.0, (d,), ("embed",)),
        "layers": _init_layer_stack(cfg, f),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = f.param((V, d), ("vocab", "embed"), scale=0.02)
    if cfg.family == "vlm":
        # Stub frontend adapter: precomputed patch embeddings -> d_model.
        params["vision_proj"] = f.param((d, d), ("embed", None))
    return params


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked (L, ...) parameter tree, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def remat(cfg, fn, *args):
    """``fn(*args)``, checkpointed (``use_reentrant=False``) where
    ``cfg.remat`` is set and autograd records it (grad mode on and an
    input that requires grad); otherwise, as in serving, a plain call.
    The bodies hold no randomness, so no RNG state is kept."""
    if (cfg.remat and torch.is_grad_enabled()
            and any(t.requires_grad for t in _tensors(args))):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _unembed(cfg, params, x):
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,vd->bsv", x, table)


# ------------------------------------------------------------------ blocks
def _block_full(cfg, lp: dict, x, positions, prefix_len: int):
    """One layer, full-sequence. Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return x + mamba_full(cfg, lp["mixer"], h), aux
    a = attn_full(cfg, lp["attn"], h, positions, causal=True,
                  window=cfg.sliding_window, prefix_len=prefix_len)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        m, aux = moe_apply_with_aux(cfg, lp["moe"], h)
    else:
        m = mlp_apply(cfg, lp["mlp"], h)
    return x + m, aux


# ------------------------------------------------------------------ forward
def _embed_inputs(cfg, params, tokens, prefix_embeds):
    x = params["embed"][tokens.long()].to(cfg.activation_dtype)
    if cfg.family == "vlm":
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name}: the VLM needs prefix_embeds")
        pe = torch.einsum("bpd,de->bpe",
                          prefix_embeds.to(cfg.activation_dtype),
                          params["vision_proj"])
        x = torch.cat([pe, x], dim=1)
    return x


def lm_forward(
    cfg,
    params: dict,
    tokens: torch.Tensor,  # (B, S_text)
    prefix_embeds: Optional[torch.Tensor] = None,  # (B, P, d) for VLM
    return_hidden: bool = False,
):
    """(logits over the padded vocab (B, S_total, V), aux loss); with
    ``return_hidden``, the final-normed hidden state in place of the
    logits."""
    x = _embed_inputs(cfg, params, tokens, prefix_embeds)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    prefix_len = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, aux, lp):
        x, a = _block_full(cfg, lp, x, positions, prefix_len)
        return x, aux + a

    for i in range(cfg.n_layers):
        x, aux = remat(cfg, body, x, aux, _layer(params["layers"], i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux
    return _unembed(cfg, params, x), aux


def cross_entropy(cfg, hidden: torch.Tensor, table: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the padded vocab, the padding columns masked to -1e30;
    token-chunked where ``cfg.loss_chunk`` is set and shorter than S.

    Each chunk of c positions makes its (B, c, V) f32 logits, reduces them
    to the sum of its tokens' nll and drops them: the full (B, S, V) f32
    logits are never held at once (the reference unrolls its chunks for
    the same reason)."""
    B, S, _ = hidden.shape
    V = table.shape[0]
    vmask = torch.arange(V, device=hidden.device) < cfg.vocab_size

    def chunk_nll(xc, lc):
        logits = torch.einsum("bsd,vd->bsv", xc, table)
        logits = torch.where(vmask, logits.float(), -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        return torch.sum(lse - ll)

    c = cfg.loss_chunk
    if not c or c >= S:
        return chunk_nll(hidden, labels) / (B * S)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, c):
        total = total + chunk_nll(hidden[:, i:i + c], labels[:, i:i + c])
    return total / (B * S)


def lm_loss(cfg, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token CE plus ``aux_weight`` x the MoE load-balance loss; the
    VLM's loss is over its text positions only."""
    hidden, aux = lm_forward(cfg, params, tokens, prefix_embeds,
                             return_hidden=True)
    if cfg.family == "vlm":
        hidden = hidden[:, prefix_embeds.shape[1]:, :]
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return cross_entropy(cfg, hidden, table, labels) + aux_weight * aux


# ------------------------------------------------------------------ decode
def make_decode_cache(cfg, f: ParamFactory, batch: int, max_seq: int) -> dict:
    """Pre-allocated decode cache on the factory's device, ``pos`` a Python
    int: zero K/V (L, B, S_alloc, KV, D) in the factory's dtype, or for the
    SSM family the conv tails (L, B, conv-1, d_inner) and the f32 states
    (L, B, d_inner, N)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        cs, hs = mamba_state_shapes(cfg, batch)
        return {
            "conv": f.param((L, *cs), ("layers", "batch", "conv", "inner"),
                            zero=True),
            "h": f.param((L, *hs), ("layers", "batch", "inner", "state"),
                         zero=True, dtype=torch.float32),
            "pos": 0,
        }
    layout = cache_layout(cfg, max_seq)
    kv = (L, batch, layout.seq, cfg.n_kv_heads, cfg.head_dim)
    lax_ = ("layers", "batch", "cache_seq", "cache_kv_heads", "head_dim")
    return {
        "k": f.param(kv, lax_, zero=True),
        "v": f.param(kv, lax_, zero=True),
        "pos": 0,
    }


def lm_decode_step(cfg, params: dict, token: torch.Tensor, cache: dict,
                   max_seq: int):
    """One decode step. token: (B, 1) int. Returns (logits (B,1,V), cache).

    The returned cache holds the same state tensors, written in place, and
    ``pos + 1``."""
    x = params["embed"][token.long()].to(cfg.activation_dtype)
    pos = int(cache["pos"])
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
            out, _, _ = mamba_decode(cfg, lp["mixer"], hn, cache["conv"][i],
                                     cache["h"][i])
            x = x + out
    else:
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
    return _unembed(cfg, params, x), dict(cache, pos=pos + 1)
