"""Paged KV cache pool: fixed-size pages, per-sequence page tables.

Pages are LifeRaft buckets on the serving side: uniform-size units of
expensive device state.  The pool hands out pages, tracks free lists, and
supports prefix sharing (several sequences referencing the same pages,
refcounted) -- the serving analogue of multiple queries batched on one
bucket.  ``repro_torch.kernels.paged_attention`` consumes the pool's
tensors.

The port of ``repro.serving.kvcache``: the pools are torch tensors on the
pool's device, written in place (copy-on-write copies a page in place).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["PagePool", "SequenceAllocation"]


@dataclasses.dataclass
class SequenceAllocation:
    seq_id: int
    pages: list[int]
    length: int = 0


class PagePool:
    def __init__(self, n_pages: int, page_size: int, n_kv: int, head_dim: int,
                 dtype=torch.bfloat16, device=None):
        self.n_pages = n_pages
        self.page_size = page_size
        self.device = resolve_device(device)
        shape = (n_pages, page_size, n_kv, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free = list(range(n_pages - 1, -1, -1))
        self._refcount = np.zeros(n_pages, dtype=np.int64)
        self._seqs: dict[int, SequenceAllocation] = {}

    # -- allocation ---------------------------------------------------------
    def create(self, seq_id: int, prefix_of: int | None = None) -> SequenceAllocation:
        if prefix_of is not None and prefix_of in self._seqs:
            parent = self._seqs[prefix_of]
            pages = list(parent.pages)  # shared, copy-on-write at append
            for p in pages:
                self._refcount[p] += 1
            alloc = SequenceAllocation(seq_id, pages, parent.length)
        else:
            alloc = SequenceAllocation(seq_id, [])
        self._seqs[seq_id] = alloc
        return alloc

    def append_token_slot(self, seq_id: int) -> tuple[int, int]:
        """Reserve the slot for one new token; returns (page, offset)."""
        alloc = self._seqs[seq_id]
        off = alloc.length % self.page_size
        if off == 0:  # need a fresh page
            page = self._alloc_page()
            alloc.pages.append(page)
        else:
            page = alloc.pages[-1]
            if self._refcount[page] > 1:  # copy-on-write for shared tails
                new = self._alloc_page()
                self.k_pages[new] = self.k_pages[page]
                self.v_pages[new] = self.v_pages[page]
                self._refcount[page] -= 1
                alloc.pages[-1] = new
                page = new
        alloc.length += 1
        return page, off

    def _alloc_page(self) -> int:
        if not self._free:
            raise MemoryError("page pool exhausted")
        p = self._free.pop()
        self._refcount[p] = 1
        return p

    def release(self, seq_id: int) -> None:
        alloc = self._seqs.pop(seq_id, None)
        if alloc is None:
            return
        for p in alloc.pages:
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)

    # -- views ---------------------------------------------------------------
    def write_kv(self, page: int, off: int, k, v) -> None:
        """k/v: (n_kv, head_dim) for one token."""
        self.k_pages[page, off] = torch.as_tensor(k, device=self.device)
        self.v_pages[page, off] = torch.as_tensor(v, device=self.device)

    def page_table(self, seq_ids: list[int], pad_to: int) -> tuple:
        """(B, pad_to) page table + (B,) lengths for the attention kernel,
        as int32 tensors on the pool's device."""
        B = len(seq_ids)
        pt = np.zeros((B, pad_to), dtype=np.int32)
        lens = np.zeros(B, dtype=np.int32)
        for i, sid in enumerate(seq_ids):
            alloc = self._seqs[sid]
            pt[i, : len(alloc.pages)] = alloc.pages
            lens[i] = alloc.length
        return (torch.from_numpy(pt).to(self.device),
                torch.from_numpy(lens).to(self.device))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def utilization(self) -> float:
        return 1.0 - self.free_pages / self.n_pages
