"""Public wrappers: ragged grouped matmul + the paper's hybrid execution.

The port of ``repro.kernels.grouped_matmul.ops``.  The device picks the
path (a CUDA tensor goes through the kernel, a CPU tensor through the
plain version), so there is no ``use_pallas`` or ``interpret`` argument.
Both wrappers are differentiable: the kernel path goes through
``grouped_matmul_fn``, K5 with its backward.

``grouped_matmul``        -- dense tile-mapped kernel path (the 'sequential
                             scan').
``hybrid_grouped_matmul`` -- per-group plan selection: rows of groups with
                             few rows take a gathered path (the 'indexed
                             join'); everything else runs through the kernel.
"""
from __future__ import annotations

import torch

from .kernel import grouped_matmul_fn
from .ref import row_groups

__all__ = ["grouped_matmul", "hybrid_grouped_matmul", "pad_groups_to_tiles",
           "tile_groups"]


def pad_groups_to_tiles(x, group_sizes, bt: int):
    """Where each row would go if every group started at a tile boundary.

    Returns (row_map, padded_sizes, starts): row_map[r] is the padded row
    of original row r, padded_sizes each group's size rounded up to ``bt``
    and starts each group's first padded row (what the reference returns)."""
    gs = torch.as_tensor(group_sizes, device=x.device)
    G, T = gs.shape[0], x.shape[0]
    padded_sizes = ((gs + bt - 1) // bt) * bt
    zero = torch.zeros(1, dtype=torch.int32, device=x.device)
    starts = torch.cat([zero, torch.cumsum(padded_sizes, 0)[:-1].to(torch.int32)])
    gid = row_groups(gs, T).to(torch.int32).clamp(max=G - 1)
    firsts = torch.cumsum(torch.cat([zero, gs[:-1].to(torch.int32)]), 0)
    offset = torch.arange(T, dtype=torch.int32, device=x.device) - firsts[gid]
    row_map = starts[gid] + offset
    return row_map, padded_sizes, starts


def tile_groups(group_sizes: torch.Tensor, n_rows: int, bt: int,
                n_groups: int) -> torch.Tensor:
    """Group id of each ``bt``-row tile (that of its first row), clamped to
    the last group, as int32 on group_sizes' device (``ops.py:61-64``)."""
    gid = row_groups(group_sizes, n_rows)[::bt]
    return gid.clamp(max=n_groups - 1).to(torch.int32)


def grouped_matmul(x: torch.Tensor, group_sizes, w: torch.Tensor,
                   bt: int = 128, bf: int = 256, bk: int = 512):
    """y[r] = x[r] @ w[group of r's bt-row tile].

    Group boundaries must be tile-aligned (every group size a multiple of
    ``bt``) for that to be the row's own group; the MoE capacity layout
    guarantees it.  Like the reference's kernel path, an unaligned boundary
    is not detected: the rows after it up to the next tile take the weights
    of the group the tile starts in.  ``bf`` and ``bk`` are the Pallas
    kernel's column and depth blocks, accepted so the reference's calls
    carry over; the CUDA kernel tiles f and d itself and pads neither."""
    gs = torch.as_tensor(group_sizes, device=x.device)
    tile_gid = tile_groups(gs, x.shape[0], bt, w.shape[0])
    return grouped_matmul_fn(x, tile_gid, w, bt)


def hybrid_grouped_matmul(x: torch.Tensor, group_sizes, w: torch.Tensor,
                          threshold_rows: int = 16, **kw):
    """Paper §3.4 at kernel level: indexed path for groups with fewer than
    ``threshold_rows`` rows, scan path (the kernel) for the rest.  The
    indexed path gathers one weight matrix for each of its rows only."""
    dense = grouped_matmul(x, group_sizes, w, **kw)
    gs = torch.as_tensor(group_sizes, device=x.device)
    gid = row_groups(gs, x.shape[0]).clamp(max=w.shape[0] - 1)
    small = (gs < threshold_rows)[gid]
    rows = torch.nonzero(small).squeeze(1)
    indexed = torch.zeros_like(dense)
    indexed[rows] = torch.einsum(
        "td,tdf->tf", x[rows].float(), w[gid[rows]].float()).to(dense.dtype)
    return torch.where(small[:, None], indexed, dense)
