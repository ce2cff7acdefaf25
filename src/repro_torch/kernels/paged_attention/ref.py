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
"""
from __future__ import annotations

import math

import torch

__all__ = ["paged_attention_ref"]

_NEG_INF = -1e30


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
    idx = page_table.long()
    k = k_pages[idx].reshape(B, P * page, KV, D)
    v = v_pages[idx].reshape(B, P * page, KV, D)
    qg = q.reshape(B, KV, G, D)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    t = torch.arange(P * page, device=q.device)
    valid = t[None, :] < seq_lens.to(q.device)[:, None]  # (B, T)
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v.dtype), v)
    return out.reshape(B, H, D)
