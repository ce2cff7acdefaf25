"""Plain PyTorch reference of the decoder the cells serve, in float32.

It follows the published description of the Mistral family (Mixtral and
Mistral Large): pre-norm RMSNorm blocks, rotary embeddings on the two
halves of each head, grouped-query attention with a causal mask, a SwiGLU
MLP or a top-k router over SwiGLU experts (softmax over all experts, the
top k renormalised, which equals the published softmax over the top k
logits), a final RMSNorm and an untied head.  No kernel, cache or
batching: each layer is computed in turn for the sampled sequences at
once, so that only one layer's float32 weights are held.

The inputs are the benchmark's: the bf16 weights it made (read here and
widened to float32), each sequence's prefilled K/V (already rotated, as a
cache holds it) and the tokens fed at positions ``prompt_len`` onward.
``reference_pass`` returns the logits at every fed position and the K/V
that each layer works out for those positions.

``precision="fp8"`` is the control: every operand of a matrix product
(weights per output column, activations per row, q/k/v per head vector)
rounded to float8 e4m3 with its own scale, sums in float32.  It is the
step below the configuration's bf16, and it must fail the comparison.
``precision="bf16"`` rounds the same operands to bfloat16: the step below
a float32 configuration (the tests' float32 cuts).

This module imports torch alone: nothing of the program under test.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["Spec", "spec_from_config", "reference_pass", "PRECISIONS"]

PRECISIONS = ("f32", "bf16", "fp8")
_FP8 = torch.float8_e4m3fn
_FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes the reference needs, from a configuration file."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0
    top_k: int = 0


def spec_from_config(c: dict) -> Spec:
    """A ``Spec`` from a configuration file's published keys."""
    return Spec(
        n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"],
        d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"],
        rope_theta=float(c["rope_theta"]),
        norm_eps=float(c["rms_norm_eps"]),
        n_experts=c.get("num_local_experts", 0),
        top_k=c.get("num_experts_per_tok", 0),
    )


# ------------------------------------------------------------------ precision
def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, one scale for each slice along ``dim``
    (the largest magnitude maps to 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / _FP8_MAX
    return (t / scale).to(_FP8).float() * scale


class _Precision:
    def __init__(self, name: str):
        if name not in PRECISIONS:
            raise ValueError(f"unknown precision {name!r}; one of {PRECISIONS}")
        self.name = name

    def _round(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if self.name == "fp8":
            return _fp8(t, dim)
        if self.name == "bf16":
            return t.to(torch.bfloat16).float()
        return t

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (.., in, out) weight in float32, rounded (fp8: a scale for
        each output column)."""
        return self._round(w.float(), dim=-2)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """Activations (.., in), rounded (fp8: a scale for each row)."""
        return self._round(x, dim=-1)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ w


# ------------------------------------------------------------------ blocks
def _rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.float()


def _rope(x, positions, theta):
    """x (S, n, heads, D) float32, rotated at ``positions`` (n,)."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[:, None] * freqs  # (n, half)
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(spec, q, k_new, v_new, k_pre, v_pre):
    """q (S, n, H, D); k_new, v_new (S, n, KV, D); k_pre, v_pre (S, P, KV,
    D): position P + j attends to every prefilled slot and to new slots
    0..j.  Returns (S, n, H, D)."""
    S, n, H, D = q.shape
    KV = spec.n_kv_heads
    G = H // KV
    P = k_pre.shape[1]
    scale = 1.0 / math.sqrt(D)
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    mask = torch.cat([torch.ones(n, P, dtype=torch.bool, device=q.device),
                      causal], dim=1)  # (n, P + n)
    out = torch.empty_like(q)
    for s in range(S):
        for g in range(KV):
            kk = torch.cat([k_pre[s, :, g], k_new[s, :, g]], dim=0)  # (P+n, D)
            vv = torch.cat([v_pre[s, :, g], v_new[s, :, g]], dim=0)
            qg = q[s, :, g * G:(g + 1) * G].transpose(0, 1)  # (G, n, D)
            sc = (qg @ kk.T) * scale  # (G, n, P+n)
            sc = sc.masked_fill(~mask, float("-inf"))
            out[s, :, g * G:(g + 1) * G] = (torch.softmax(sc, dim=-1) @ vv
                                            ).transpose(0, 1)
    return out


def _swiglu(prec, x, wg, wu, wd):
    h = F.silu(prec.mm(x, wg)) * prec.mm(x, wu)
    return prec.mm(h, wd)


def _moe(spec, prec, x, lw):
    """x (T, d) -> ((T, d), margin (T,)): softmax router, top k
    renormalised, each expert a SwiGLU over the tokens routed to it; the
    margin is how far the k-th router logit lies above the next."""
    logits = x @ lw["router"].float()  # (T, E)
    ranked = torch.topk(logits, spec.top_k + 1, dim=-1).values
    margin = ranked[:, -2] - ranked[:, -1]
    gates = torch.softmax(logits, dim=-1)
    top_v, top_i = torch.topk(gates, spec.top_k, dim=-1)
    top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(spec.n_experts):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = _swiglu(prec, x[tok], prec.weight(lw["wg"][e]),
                     prec.weight(lw["wu"][e]), prec.weight(lw["wd"][e]))
        y.index_add_(0, tok, ye * top_v[tok, slot, None])
    return y, margin


# ------------------------------------------------------------------ pass
def reference_pass(
    spec: Spec,
    weights: dict,
    prefill: Callable[[int], tuple],
    tokens: torch.Tensor,  # (S, n) int, fed at positions P .. P + n - 1
    prompt_len: int,
    precision: str = "f32",
):
    """(logits (S, n, V) float32, [(k, v) (S, n, KV, D) float32 a layer],
    routing margin (S, n)): the margin of a position is the least, over
    its MoE layers, by which its k-th router logit lies above the next
    (inf where the model has no experts); a rounding smaller than it
    cannot change which experts the position takes.

    ``weights`` holds the benchmark's tensors: ``embed`` and ``unembed``
    (V, d), ``final_norm`` (d,), and under ``layers`` the stacked (L, ...)
    ``ln1``, ``ln2``, ``attn`` {``wq`` (d, H, D), ``wk``, ``wv`` (d, KV,
    D), ``wo`` (H, D, d)} and either ``moe`` {``router`` (d, E), ``wg``,
    ``wu`` (E, d, f), ``wd`` (E, f, d)} or ``mlp`` {``wg``, ``wu`` (d, f),
    ``wd`` (f, d)}.  ``prefill(layer)`` gives the sampled sequences'
    prefilled (k, v), (S, P, KV, D), as the cache holds them (k rotated)."""
    prec = _Precision(precision)
    S, n = tokens.shape
    d, H, KV, D = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    eps = spec.norm_eps
    dev = weights["embed"].device
    positions = torch.arange(prompt_len, prompt_len + n, device=dev)
    x = weights["embed"][tokens.long().to(dev)].float()  # (S, n, d)
    kv_out = []
    margin = torch.full((S, n), float("inf"), device=dev)
    layers = weights["layers"]
    for i in range(spec.n_layers):
        att = {k: v[i] for k, v in layers["attn"].items()}
        h = _rms_norm(x, layers["ln1"][i], eps)
        q = prec.mm(h, prec.weight(att["wq"].reshape(d, H * D))).view(S, n, H, D)
        k = prec.mm(h, prec.weight(att["wk"].reshape(d, KV * D))).view(S, n, KV, D)
        v = prec.mm(h, prec.weight(att["wv"].reshape(d, KV * D))).view(S, n, KV, D)
        q = _rope(q, positions, spec.rope_theta)
        k = _rope(k, positions, spec.rope_theta)
        k, v = prec.act(k), prec.act(v)  # the cache's entries
        kv_out.append((k, v))
        k_pre, v_pre = (prec.act(t.float()) for t in prefill(i))
        a = _attention(spec, prec.act(q), k, v, k_pre, v_pre)
        x = x + prec.mm(a.reshape(S, n, H * D),
                        prec.weight(att["wo"].reshape(H * D, d)))
        h = _rms_norm(x, layers["ln2"][i], eps)
        if "moe" in layers:
            lw = {k: v[i] for k, v in layers["moe"].items()}
            m, mg = _moe(spec, prec, h.reshape(S * n, d), lw)
            m = m.view(S, n, d)
            margin = torch.minimum(margin, mg.view(S, n))
        else:
            lw = {k: v[i] for k, v in layers["mlp"].items()}
            m = _swiglu(prec, h, prec.weight(lw["wg"]), prec.weight(lw["wu"]),
                        prec.weight(lw["wd"]))
        x = x + m
    x = _rms_norm(x, weights["final_norm"], eps)
    logits = prec.mm(x, prec.weight(weights["unembed"].T))
    return logits, kv_out, margin
