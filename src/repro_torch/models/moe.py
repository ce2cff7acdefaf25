"""Token-choice top-k Mixture-of-Experts with capacity-bounded dispatch.

The port of ``repro.models.moe``.  Dispatch is the sort-free scatter
formulation: per-token top-k expert ids -> position-in-expert via a
cumulative count -> scatter into the (E*C, d) expert buffer -> grouped
expert FFN -> gather-combine weighted by the (renormalised) router gates.
Tokens past an expert's capacity are dropped (token-choice semantics).

The expert buffer's rows are group-sorted with every group C rows long, C
a multiple of 256, so the three expert products are the grouped-matmul
kernel (K5) on the (E*C, d) view, every ``EXPERT_BT``-row tile in one
expert: the reference's ``einsum("ecd,edf->ecf")``, summed in f32.  Only
the first min(tokens routed to e, C) rows of expert e's C are real (the
rest stay zero); ``expert_tiles`` hands K5 that count for each tile, once
a layer and on the device, so K5 writes the other rows as +0 (what the
einsum gives for a zero row) and reads no weights of an expert with no
token.  The products go through ``grouped_matmul_fn``, K5 with its
backward (dX on the transposed weights, dW its own kernel), so the
experts' weights train as the reference's einsums do.  Where the
reference relies on JAX's semantics the port spells them out:

* ``jax.lax.top_k`` takes the lower index first among equal gates; the
  port takes its top k from a stable descending sort.
* The scatter with ``mode="drop"`` discards rank == C; the port's buffer
  has one spare row past the E*C expert rows, where every dropped token
  lands, and hands K5 only the E*C rows before it (a view, no copy).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.grouped_matmul.kernel import grouped_matmul_fn
from ..kernels.grouped_matmul.ops import tile_groups
from .common import ParamFactory
from .mlp import act_fn, is_gated

__all__ = ["EXPERT_BT", "expert_tiles", "init_moe", "moe_apply",
           "moe_apply_with_aux", "moe_capacity"]

EXPERT_BT = 128  # K5's row tile on the expert buffer; divides C
# (E, C, bt, device) -> (tile_gid, each tile's first row within its expert):
# the same for every layer and step of a shape, so built once instead of in
# 7 launches a layer.
_TILES: dict = {}


def init_moe(cfg, f: ParamFactory, layers: int | None = None) -> dict:
    d, E = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    L = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)
    p = {"router": f.param(L + (d, E), lax_ + ("embed", "experts"), scale=0.02)}
    if is_gated(cfg.activation):
        p["wg"] = f.param(L + (E, d, ff), lax_ + ("experts", "embed", "expert_ff"))
        p["wu"] = f.param(L + (E, d, ff), lax_ + ("experts", "embed", "expert_ff"))
    else:
        p["wu"] = f.param(L + (E, d, ff), lax_ + ("experts", "embed", "expert_ff"))
    p["wd"] = f.param(L + (E, ff, d), lax_ + ("experts", "expert_ff", "embed"))
    return p


def moe_capacity(cfg, n_tokens: int) -> int:
    """Static per-expert capacity C = ceil(k*T*cf/E), padded to 256 (which
    tile-aligns the grouped-matmul kernel)."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return -(-c // 256) * 256


def expert_tiles(top_idx: torch.Tensor, E: int, C: int, bt: int = EXPERT_BT):
    """K5's tiling of the (E*C)-row expert buffer: (tile_gid, tile_rows),
    int32 (E*C // bt,) on top_idx's device.  tile_gid is ``tile_groups`` of
    E groups of C rows (cached in ``_TILES``); tile_rows[t] is how many of
    the tile's rows hold a token, from each expert's min(tokens routed to
    it, C).  Five launches and no host sync."""
    dev = top_idx.device
    key = (E, C, bt, dev)
    if key not in _TILES:
        sizes = torch.full((E,), C, dtype=torch.int32, device=dev)
        _TILES[key] = (tile_groups(sizes, E * C, bt, E),
                       torch.arange(0, C, bt, dtype=torch.int32, device=dev))
    tile_gid, starts = _TILES[key]
    flat = top_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, flat, torch.ones(flat.shape, dtype=torch.int32,
                                            device=dev))
    # A count past C fills all of the expert's tiles: the clamp to bt.
    rows = (counts[:, None] - starts).clamp_(0, bt)
    return tile_gid, rows.reshape(-1)


def moe_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); ``moe_apply_with_aux`` also returns the
    load-balance loss."""
    out, _ = moe_apply_with_aux(cfg, p, x)
    return out


def _dispatch_onehot(top_idx: torch.Tensor, E: int, C: int):
    """Position-in-expert via an exclusive one-hot cumsum (in f32, over the
    flattened (T*k) order).  Returns (dest, within): dest = e*C + rank, or
    E*C for a dropped choice."""
    flat = top_idx.reshape(-1)
    oh = F.one_hot(flat, E).to(torch.float32)  # (T*k, E)
    pos = torch.cumsum(oh, dim=0) - oh
    pos_in_e = torch.sum(pos * oh, dim=-1)  # (T*k,)
    within = pos_in_e < C
    dest = flat * C + pos_in_e.to(flat.dtype)
    dest = torch.where(within, dest, torch.full_like(dest, E * C))
    return dest, within


def _dispatch_sort(top_idx: torch.Tensor, E: int, C: int):
    """Position-in-expert via a stable argsort of the expert ids: rank =
    position - first position of the expert in the sorted order."""
    flat = top_idx.reshape(-1)
    Tk = flat.numel()
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    experts = torch.arange(E, dtype=flat.dtype, device=flat.device)
    starts = torch.searchsorted(sorted_e, experts)
    rank = torch.arange(Tk, dtype=flat.dtype, device=flat.device) - starts[sorted_e]
    within_sorted = rank < C
    dest_sorted = torch.where(within_sorted, sorted_e * C + rank,
                              torch.full_like(rank, E * C))
    dest = torch.empty_like(dest_sorted)
    dest[order] = dest_sorted
    within = torch.empty_like(within_sorted)
    within[order] = within_sorted
    return dest, within


def moe_apply_with_aux(cfg, p: dict, x: torch.Tensor):
    """x: (B, S, d) -> ((B, S, d), load-balance aux loss (f32 scalar))."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = moe_capacity(cfg, T)
    act = act_fn(cfg.activation)

    xf = x.reshape(T, d)
    # bf16 inputs, f32 products and sums (preferred_element_type=f32).
    gates = torch.softmax(xf.float() @ p["router"].float(), dim=-1)  # (T, E)
    top_vals, top_idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)

    # Load-balance aux loss (Switch-style): E * sum_e f_e * P_e.
    me = torch.mean(gates, dim=0)
    fe = torch.mean(F.one_hot(top_idx[:, 0], E).to(torch.float32), dim=0)
    aux_loss = E * torch.sum(fe * me)

    if cfg.moe_dispatch == "sort":
        dest, within = _dispatch_sort(top_idx, E, C)
    else:
        dest, within = _dispatch_onehot(top_idx, E, C)

    # Scatter; row E*C takes every dropped choice and is cut off below.
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, dest, xf.repeat_interleave(k, dim=0))
    xe = buf[: E * C]  # (E*C, d): E groups of C rows

    # Grouped expert FFN -- a batched pass per expert bucket (K5) over the
    # rows that hold a token; the other rows come out +0.
    tile_gid, tile_rows = expert_tiles(top_idx, E, C)

    def experts(h, w):
        return grouped_matmul_fn(h, tile_gid, w, EXPERT_BT, tile_rows)

    up = experts(xe, p["wu"])
    if is_gated(cfg.activation):
        h = act(experts(xe, p["wg"])) * up
    else:
        h = act(up)
    ye = experts(h, p["wd"])  # (E*C, d)

    # Gather back; a dropped choice reads row E*C - 1 (the reference's
    # clamped rank) with weight 0.
    y_rep = ye[dest.clamp(max=E * C - 1)]  # (T*k, d)
    w = (top_vals.reshape(-1) * within).to(x.dtype)[:, None]
    y = (y_rep * w).reshape(T, k, d).sum(dim=1)
    return y.reshape(B, S, d), aux_loss
