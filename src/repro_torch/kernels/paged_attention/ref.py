"""Plain PyTorch version of paged decode attention (GQA, one token a
sequence): the port of ``repro.kernels.paged_attention.ref``.

Semantics: q (B, H, D); paged KV with ``page_table`` (B, P) selecting pages
of shape (page_size, KV, D) from the global pools; per-sequence lengths
mask out slots at or past ``seq_lens[b]``.  Equivalent to dense causal
decode attention over the gathered cache.  Scores and the softmax are f32;
the probabilities are cast to v's type for the PV product, as in the
reference.  With ``seq_lens[b] == 0`` every score is masked and the
softmax is uniform, so row b gets the mean of v (the CUDA kernel, like the
Pallas one, gives 0 there; the decode path never asks for 0).

``paged_attention_splits_ref`` is the CUDA kernel's split arithmetic
written plainly: the slots cut into chunks, each chunk's own softmax, the
chunks merged in order.  It gives 0 at ``seq_lens[b] == 0``, as the
kernel does.
"""
from __future__ import annotations

import math

import torch

__all__ = ["paged_attention_ref", "paged_attention_splits_ref",
           "paged_attention_partials_ref"]

_NEG_INF = -1e30


def _gather(q, k_pages, v_pages, page_table):
    """The sequences' dense K and V, (B, T, KV, D), T = P * page."""
    B = q.shape[0]
    _, page, KV, D = k_pages.shape
    T = page_table.shape[1] * page
    idx = page_table.long()
    return (k_pages[idx].reshape(B, T, KV, D),
            v_pages[idx].reshape(B, T, KV, D))


def paged_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (N_pages, page, KV, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, P) int
    seq_lens: torch.Tensor,  # (B,) int
) -> torch.Tensor:
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // KV
    k, v = _gather(q, k_pages, v_pages, page_table)
    qg = q.reshape(B, KV, G, D)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    t = torch.arange(P * page, device=q.device)
    valid = t[None, :] < seq_lens.to(q.device)[:, None]  # (B, T)
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v.dtype), v)
    return out.reshape(B, H, D)


def paged_attention_splits_ref(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (N_pages, page, KV, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, P) int
    seq_lens: torch.Tensor,  # (B,) int
    chunk: int,
) -> torch.Tensor:
    """Decode attention as the kernel splits it: slots [s * chunk, (s + 1)
    * chunk) form split s.  Each split takes its own max m_s over its valid
    slots (-1e30 where it has none), p = exp(s - m_s) rounded to v's type
    for the PV product in f32, l_s = sum p (unrounded), acc_s = sum p v.
    The merge, in split order: m = max m_s, c_s = exp(m_s - m), out = sum
    c_s acc_s / max(sum c_s l_s, 1e-30), in q's type."""
    B, H, D = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    k, v = _gather(q, k_pages, v_pages, page_table)
    T = k.shape[1]
    qg = q.reshape(B, KV, G, D).float()
    t = torch.arange(T, device=q.device)
    valid = t[None, :] < seq_lens.to(q.device)[:, None]  # (B, T)
    parts = []
    for c0 in range(0, T, chunk):
        ks, vs = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        ok = valid[:, None, None, c0:c0 + chunk]
        s = torch.einsum("bkgd,btkd->bkgt", qg, ks.float()) / math.sqrt(D)
        s = s.masked_fill(~ok, _NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]) * ok
        acc = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(),
                           vs.float())
        parts.append((m, p.sum(dim=-1), acc))
    m = torch.stack([m_s for m_s, _, _ in parts]).amax(dim=0)
    l_all = torch.zeros_like(m)
    acc_all = torch.zeros(B, KV, G, D, device=q.device)
    for m_s, l_s, acc_s in parts:
        c = torch.exp(m_s - m)
        l_all = l_all + c * l_s
        acc_all = acc_all + c[..., None] * acc_s
    out = acc_all / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_partials_ref(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (N_pages, page, KV, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, P) int
    seq_lens: torch.Tensor,  # (B,) int
):
    """(out, m, l): the attention over the valid slots as one split of
    ``paged_attention_splits_ref`` takes it -- ``out`` = acc / max(l,
    1e-30) in q's type, m (B, H) the max score (-1e30 where no slot is
    valid), l (B, H) the sum of exp(s - m), both f32.  Shards of a
    sequence merge as the splits do: m = max m_s, c_s = exp(m_s - m),
    out = sum c_s l_s out_s / sum c_s l_s."""
    B, H, D = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    k, v = _gather(q, k_pages, v_pages, page_table)
    T = k.shape[1]
    qg = q.reshape(B, KV, G, D).float()
    t = torch.arange(T, device=q.device)
    ok = (t[None, :] < seq_lens.to(q.device)[:, None])[:, None, None, :]
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) / math.sqrt(D)
    s = s.masked_fill(~ok, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * ok
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    l_ = p.sum(dim=-1)
    out = acc / torch.clamp(l_, min=1e-30)[..., None]
    return (out.reshape(B, H, D).to(q.dtype), m.reshape(B, H),
            l_.reshape(B, H))
