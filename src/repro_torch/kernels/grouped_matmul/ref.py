"""Plain PyTorch versions of the ragged grouped matmul: the port of
``repro.kernels.grouped_matmul.ref``, plus the kernel's own plain version.

Rows of ``x`` are grouped (sorted by group, ragged sizes); row r in group g
is multiplied by that group's weight matrix:  y[r] = x[r] @ w[g].  Used by
MoE expert FFNs (group = expert) and multi-adapter serving (group =
adapter bucket).

* ``grouped_matmul_ref`` is the per-row oracle.  It loops over the groups'
  row ranges; the reference's (T, d, f) weight gather is never made.
* ``grouped_matmul_tiles_ref`` is the plain version of the kernel (K5):
  the group of a row is that of its ``bt``-row tile, ``tile_gid[r // bt]``,
  as in the Pallas kernel.  Each run of tiles with one group id is one
  float32 product, cast to x's dtype, as the kernel accumulates in f32 and
  casts once.  With ``tile_rows`` the rows of each tile past its count are
  taken as zero: they come out +0, by a mask on the device, with no host
  sync for the counts.
"""
from __future__ import annotations

import torch

__all__ = ["grouped_matmul_ref", "grouped_matmul_tiles_ref", "row_groups"]


def row_groups(group_sizes: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Group id per row from ragged group sizes (rows past total -> G)."""
    bounds = torch.cumsum(group_sizes, 0)
    rows = torch.arange(n_rows, device=bounds.device, dtype=bounds.dtype)
    return torch.searchsorted(bounds, rows, right=True)


def grouped_matmul_ref(x: torch.Tensor, group_sizes: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """x: (T, d); group_sizes: (G,) summing to <= T; w: (G, d, f) -> (T, f).

    Rows past the groups' total belong to the last group, as in the
    reference (``row_groups`` clamped to G - 1)."""
    T = x.shape[0]
    G, _, f = w.shape
    out = torch.empty((T, f), dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    ends = torch.cumsum(group_sizes, 0).clamp(max=T).tolist()
    lo = 0
    for g in range(G):
        hi = T if g == G - 1 else max(int(ends[g]), lo)
        out[lo:hi] = x[lo:hi] @ w[g]
        lo = hi
    return out


def grouped_matmul_tiles_ref(x: torch.Tensor, tile_gid: torch.Tensor,
                             w: torch.Tensor, bt: int,
                             tile_rows: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The plain version of K5: y[r] = x[r] @ w[tile_gid[r // bt]], in
    float32, cast to x's dtype.  x: (T, d) with T % bt == 0; tile_gid:
    (T // bt,) int; w: (G, d, f).  tile_rows: None (every row real) or
    (T // bt,) int, the real leading rows of each tile; the others are
    taken as zero, so their outputs are +0."""
    T = x.shape[0]
    if bt <= 0 or T % bt:
        raise ValueError(f"{T} rows are not a whole number of {bt}-row tiles")
    if tile_gid.shape != (T // bt,):
        raise ValueError(f"tile_gid must be ({T // bt},), got "
                         f"{tuple(tile_gid.shape)}")
    if tile_rows is not None and tile_rows.shape != (T // bt,):
        raise ValueError(f"tile_rows must be ({T // bt},), got "
                         f"{tuple(tile_rows.shape)}")
    gids = tile_gid.tolist()
    if gids and (min(gids) < 0 or max(gids) >= w.shape[0]):
        raise ValueError(f"tile_gid outside [0, {w.shape[0]})")
    out = torch.empty((T, w.shape[-1]), dtype=x.dtype, device=x.device)
    i = 0
    while i < len(gids):
        j = i
        while j < len(gids) and gids[j] == gids[i]:
            j += 1
        rows = slice(i * bt, j * bt)
        out[rows] = (x[rows].float() @ w[gids[i]].float()).to(x.dtype)
        i = j
    if tile_rows is not None:
        past = torch.arange(bt, device=x.device) >= tile_rows[:, None]
        out.masked_fill_(past.reshape(T, 1), 0)
    return out
