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
  taken as zero: they come out +0, by a mask on the device, and the
  product covers a run's rows only up to its last real row (a run with
  none takes no product), so a decode's few real rows cost what they
  need.
* ``grouped_matmul_dw_ref`` is the plain version of K5's weight gradient:
  dw[g] = the sum of x[r]^T dy[r] over the real rows r of g's tiles, in
  float32, cast to x's dtype.  The reference has no such kernel (XLA
  transposes its einsum); the port's K5 owes it.
"""
from __future__ import annotations

import torch

__all__ = ["grouped_matmul_dw_ref", "grouped_matmul_ref",
           "grouped_matmul_tiles_ref", "row_groups"]


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


def _check_tiles(T: int, tile_gid, bt: int, tile_rows) -> None:
    if bt <= 0 or T % bt:
        raise ValueError(f"{T} rows are not a whole number of {bt}-row tiles")
    if tile_gid.shape != (T // bt,):
        raise ValueError(f"tile_gid must be ({T // bt},), got "
                         f"{tuple(tile_gid.shape)}")
    if tile_rows is not None and tile_rows.shape != (T // bt,):
        raise ValueError(f"tile_rows must be ({T // bt},), got "
                         f"{tuple(tile_rows.shape)}")


def _runs(gids: list):
    """(first tile, end tile, group id) of each run of equal tile ids."""
    i = 0
    while i < len(gids):
        j = i
        while j < len(gids) and gids[j] == gids[i]:
            j += 1
        yield i, j, gids[i]
        i = j


def _run_rows(counts, i: int, j: int, bt: int) -> slice:
    """The rows of tiles [i, j) a product must cover: all of them without
    ``counts``; else up to the last real row of the last tile with one
    (empty if none has), since the rows past the counts are masked."""
    if counts is None:
        return slice(i * bt, j * bt)
    real = [k for k in range(i, j) if counts[k] > 0]
    end = real[-1] * bt + min(counts[real[-1]], bt) if real else i * bt
    return slice(i * bt, end)


def _past_rows(T: int, bt: int, tile_rows, device) -> torch.Tensor:
    """(T, 1) bool: the rows past their tile's real count."""
    past = torch.arange(bt, device=device) >= tile_rows[:, None]
    return past.reshape(T, 1)


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
    _check_tiles(T, tile_gid, bt, tile_rows)
    gids = tile_gid.tolist()
    if gids and (min(gids) < 0 or max(gids) >= w.shape[0]):
        raise ValueError(f"tile_gid outside [0, {w.shape[0]})")
    counts = None if tile_rows is None else tile_rows.tolist()
    out = torch.empty((T, w.shape[-1]), dtype=x.dtype, device=x.device)
    for i, j, g in _runs(gids):
        rows = _run_rows(counts, i, j, bt)
        out[rows] = (x[rows].float() @ w[g].float()).to(x.dtype)
    if tile_rows is not None:
        out.masked_fill_(_past_rows(T, bt, tile_rows, x.device), 0)
    return out


def grouped_matmul_dw_ref(x: torch.Tensor, dy: torch.Tensor,
                          tile_gid: torch.Tensor, n_groups: int, bt: int,
                          tile_rows: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The plain version of K5's weight gradient: (G, d, f) in x's dtype,
    dw[g] = sum of x[r]^T dy[r] over the rows r of the tiles whose id is g,
    in float32.  x: (T, d), dy: (T, f).  With ``tile_rows`` only each
    tile's real leading rows count; a group with none gets +0, and a tile
    id outside [0, n_groups) belongs to no group."""
    T, d = x.shape
    if dy.shape[0] != T:
        raise ValueError(f"x has {T} rows, dy {dy.shape[0]}")
    _check_tiles(T, tile_gid, bt, tile_rows)
    xs, dys = x.float(), dy.float()
    if tile_rows is not None:
        past = _past_rows(T, bt, tile_rows, x.device)
        xs, dys = xs.masked_fill(past, 0), dys.masked_fill(past, 0)
    out = torch.zeros((n_groups, d, dy.shape[1]), dtype=torch.float32,
                      device=x.device)
    counts = None if tile_rows is None else tile_rows.tolist()
    for i, j, g in _runs(tile_gid.tolist()):
        if 0 <= g < n_groups:
            rows = _run_rows(counts, i, j, bt)
            out[g] += xs[rows].T @ dys[rows]
    return out.to(x.dtype)
