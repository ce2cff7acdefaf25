"""Public wrappers for paged decode attention + cache<->page utilities.

The port of ``repro.kernels.paged_attention.ops``: the device picks the
path (a CUDA tensor goes through the kernel, a CPU tensor through the
plain version), so there is no ``use_pallas`` or ``interpret`` argument.
"""
from __future__ import annotations

import torch

from .kernel import paged_attention_kernel

__all__ = ["paged_attention", "paged_attention_partials", "dense_to_pages"]


def paged_attention(q, k_pages, v_pages, page_table, seq_lens):
    """Decode attention over paged KV. q: (B,H,D) -> (B,H,D)."""
    if page_table.dtype != torch.int32:
        page_table = page_table.to(torch.int32)
    if seq_lens.dtype != torch.int32:
        seq_lens = seq_lens.to(torch.int32)
    return paged_attention_kernel(q, k_pages, v_pages, page_table, seq_lens)


def paged_attention_partials(q, k_pages, v_pages, page_table, seq_lens):
    """(out, m, l) of one shard of a sequence-sharded cache, to be merged
    across the shards (``paged_attention_partials_ref``): K4 with its max
    and sum, (B, H) f32, beside the output.  On the CPU the plain version;
    on meta tensors K4's shapes-only call."""
    if page_table.dtype != torch.int32:
        page_table = page_table.to(torch.int32)
    if seq_lens.dtype != torch.int32:
        seq_lens = seq_lens.to(torch.int32)
    return paged_attention_kernel(q, k_pages, v_pages, page_table, seq_lens,
                                  partials=True)


def dense_to_pages(k: torch.Tensor, v: torch.Tensor, page: int):
    """(B, S, KV, D) dense cache -> page pools + identity page table.

    The pools are views of the (contiguous) cache: nothing is copied.  Page
    i of sequence b is global page b*P+i."""
    B, S, KV, D = k.shape
    if S % page:
        raise ValueError(f"page size {page} does not divide {S} slots")
    P = S // page
    k_pages = k.view(B * P, page, KV, D)
    v_pages = v.view(B * P, page, KV, D)
    page_table = torch.arange(
        B * P, dtype=torch.int32, device=k.device
    ).view(B, P)
    return k_pages, v_pages, page_table
