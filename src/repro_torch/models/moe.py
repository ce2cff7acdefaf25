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

Under active sharding rules on DTensors (the multi-pod dry-run) the layer
runs in three ``local_map`` regions (``_moe_sharded``): the routing and
the dispatch on the gathered tokens (replicated, as the reference's
(experts, expert_cap, embed) buffer is over ``data`` unless the
``expert_cap`` rule shards it); each expert product, K5 on each rank's
(experts, capacity, depth) shard, its placements derived from the
weight's and from the reference's hints (``("experts", "expert_cap",
"embed" | "expert_ff")``; a sharded depth leaves partial sums, which the
next hint reduces); and the combine.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..kernels.grouped_matmul.kernel import grouped_matmul_fn
from ..kernels.grouped_matmul.ops import tile_groups
from ..sharding.logical import shard_hint, shard_index, sharded
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


def _route_dispatch(cfg, xf: torch.Tensor, router: torch.Tensor, C: int):
    """Gates, top-k, aux loss and the scatter of ``xf`` (T, d) into the
    (E*C + 1, d) buffer: (buf, dest, within, top_vals, top_idx, aux)."""
    d = xf.shape[1]
    E, k = cfg.n_experts, cfg.top_k
    # bf16 inputs, f32 products and sums (preferred_element_type=f32).
    gates = torch.softmax(xf.float() @ router.float(), dim=-1)  # (T, E)
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
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, dest, xf.repeat_interleave(k, dim=0))
    return buf, dest, within, top_vals, top_idx, aux_loss


def _combine(ye: torch.Tensor, dest, within, top_vals, k: int):
    """Gather each token's k expert rows of ``ye`` (E*C, d) and sum them
    weighted by the gates: (T, d)."""
    EC, d = ye.shape
    # A dropped choice reads row E*C - 1 (the reference's clamped rank)
    # with weight 0.
    y_rep = ye[dest.clamp(max=EC - 1)]  # (T*k, d)
    w = (top_vals.reshape(-1) * within).to(ye.dtype)[:, None]
    return (y_rep * w).reshape(-1, k, d).sum(dim=1)


def moe_apply_with_aux(cfg, p: dict, x: torch.Tensor):
    """x: (B, S, d) -> ((B, S, d), load-balance aux loss (f32 scalar))."""
    if sharded(x):
        return _moe_sharded(cfg, p, x)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = moe_capacity(cfg, T)
    act = act_fn(cfg.activation)

    buf, dest, within, top_vals, top_idx, aux_loss = _route_dispatch(
        cfg, x.reshape(T, d), p["router"], C)
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
    y = _combine(ye, dest, within, top_vals, k)
    return y.reshape(B, S, d), aux_loss


# ------------------------------------------------------------ dry-run path
def _expert_product(h_l, w_l, counts, *, mesh, h_pl):
    """K5 on one rank's shards: h_l (E_l, C_l, din_l), w_l (E_l, din_l,
    f_l) -> (E_l, C_l, f_l); each tile's real rows from the routed
    ``counts`` (E,) at the shard's expert and capacity offsets."""
    E_l, C_l, din = h_l.shape
    e0 = shard_index(mesh, h_pl, 0) * E_l
    c0 = shard_index(mesh, h_pl, 1) * C_l
    bt = math.gcd(C_l, EXPERT_BT)
    dev = h_l.device
    sizes = torch.full((E_l,), C_l, dtype=torch.int32, device=dev)
    tile_gid = tile_groups(sizes, E_l * C_l, bt, E_l)
    starts = c0 + torch.arange(0, C_l, bt, dtype=torch.int32, device=dev)
    rows = (counts[e0:e0 + E_l, None] - starts).clamp_(0, bt).reshape(-1)
    y = grouped_matmul_fn(h_l.reshape(E_l * C_l, din), tile_gid, w_l, bt,
                          rows)
    return y.view(E_l, C_l, -1)


def _experts_sharded(h, w, counts):
    """h (E, C, din) @ w (E, din, f) per expert, on DTensors: h takes the
    placements w's admit, K5 runs on each rank's shards (``local_map``);
    a depth sharded over a mesh dim leaves the output partial there."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = h.device_mesh
    h_pl, out_pl = [], []
    for hp, wp in zip(h.placements, w.placements):
        if wp.is_shard(0):
            h_pl.append(Shard(0))
            out_pl.append(Shard(0))
        elif wp.is_shard(1):
            h_pl.append(Shard(2))
            out_pl.append(Partial())
        elif wp.is_shard(2):
            h_pl.append(Replicate())
            out_pl.append(Shard(2))
        else:
            keep = hp if hp.is_shard(1) else Replicate()
            h_pl.append(keep)
            out_pl.append(keep)
    h = h.redistribute(mesh, h_pl)
    fn = local_map(
        functools.partial(_expert_product, mesh=mesh, h_pl=tuple(h_pl)),
        out_placements=out_pl,
        in_placements=(tuple(h_pl), tuple(w.placements), counts.placements),
        device_mesh=mesh,
    )
    return fn(h, w, counts)


def _route_dispatch_local(xf, router, *, cfg, C):
    buf, dest, within, top_vals, top_idx, aux = _route_dispatch(
        cfg, xf, router, C)
    counts = torch.zeros(cfg.n_experts, dtype=torch.int32, device=xf.device)
    flat = top_idx.reshape(-1)
    counts.scatter_add_(0, flat, torch.ones(flat.shape, dtype=torch.int32,
                                            device=xf.device))
    return buf, dest, within, top_vals, counts, aux


def _moe_sharded(cfg, p: dict, x):
    """The layer on DTensors; the routing and the combine on the gathered
    tokens, the experts' products on their shards."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = moe_capacity(cfg, T)
    act = act_fn(cfg.activation)
    route = local_map(functools.partial(_route_dispatch_local, cfg=cfg, C=C),
                      out_placements=(rep,) * 6, in_placements=(rep, rep),
                      device_mesh=mesh)
    buf, dest, within, top_vals, counts, aux = route(
        x.reshape(T, d).redistribute(mesh, rep),
        p["router"].redistribute(mesh, rep))
    cap = ("experts", "expert_cap")
    xe = shard_hint(buf[: E * C].view(E, C, d), cap + ("embed",))
    up = shard_hint(_experts_sharded(xe, p["wu"], counts), cap + ("expert_ff",))
    if is_gated(cfg.activation):
        h = act(_experts_sharded(xe, p["wg"], counts)) * up
    else:
        h = act(up)
    ye = shard_hint(_experts_sharded(h, p["wd"], counts), cap + ("embed",))
    combine = local_map(functools.partial(_combine, k=k),
                        out_placements=list(rep), in_placements=(rep,) * 4,
                        device_mesh=mesh)
    y = combine(ye.reshape(E * C, d).redistribute(mesh, rep), dest, within,
                top_vals)
    return shard_hint(y.reshape(B, S, d), ("batch", "seq", "embed")), aux
