"""Shared model building blocks: param factory, norms, rope, vocab padding.

Models are functional, as in ``repro.models``: ``init(cfg, factory) ->
params`` (nested dicts of tensors) and ``apply(cfg, params, ...)``.  The
port's ``ParamFactory`` builds real tensors from a ``torch.Generator``, or,
with no generator, meta tensors (shapes and dtypes only, as the
reference's ``abstract`` mode); in ``axes`` mode every leaf is its tuple
of logical axis names (sharding spec derivation), as in the reference.

``unembed`` carries the reference's logits hint (``shard_hint``: a
no-op off the dry-run); ``take_rows`` and ``einsum`` are the gather and
the two-operand product, with a DTensor path under active rules.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..sharding.logical import is_dtensor, shard_hint, shard_index, sharded

__all__ = [
    "ParamFactory",
    "einsum",
    "take_rows",
    "unembed",
    "rms_norm",
    "make_rope",
    "apply_rope",
    "pad_vocab",
    "VOCAB_MULTIPLE",
]

VOCAB_MULTIPLE = 256
_DRAW = 1 << 26  # float32 normals drawn at once (256 MiB)


def pad_vocab(vocab_size: int, multiple: int = VOCAB_MULTIPLE) -> int:
    """Pad vocab so the embedding always shards over the model axis."""
    return -(-vocab_size // multiple) * multiple


class ParamFactory:
    """Builds parameter tensors on ``generator``'s device.  With no
    generator it builds zeros and constants on ``device``, and meta
    tensors for random parameters (the default device is ``meta``).  In
    ``mode="axes"`` ``param`` and ``const`` return ``tuple(logical)`` and
    ``position`` returns ``()``, so an init or cache function gives the
    tree of logical axes of the tree it builds.

    ``param`` draws N(0, 1) in float32, scales it and stores it in
    ``dtype``, as the reference does; the scale rule is the reference's
    (``fan_in = shape[-2]``, which for a stacked (L, d, H, D) weight is H).
    The normals are drawn ``_DRAW`` at a time straight into the output, so
    no float32 temporary of a whole stacked weight is made."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype=torch.bfloat16, device=None, mode: str = "init"):
        if mode not in ("init", "axes"):
            raise ValueError(f"unknown ParamFactory mode {mode!r}")
        self.mode = mode
        self.generator = generator
        self.device = (generator.device if generator is not None
                       else torch.device(device or "meta"))
        self.dtype = dtype

    def param(
        self,
        shape: Sequence[int],
        logical: Sequence[Optional[str]],
        scale: Optional[float] = None,
        zero: bool = False,
        dtype=None,
    ) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(logical):
            raise ValueError(f"shape {shape} vs logical axes {logical}")
        if self.mode == "axes":
            return tuple(logical)
        dtype = dtype or self.dtype
        if zero:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        out = torch.empty(shape, dtype=dtype, device=self.device)
        if self.generator is None:
            if self.device.type != "meta":
                raise ValueError("random parameters need a generator")
            return out
        flat = out.view(-1)
        for lo in range(0, flat.numel(), _DRAW):
            hi = min(lo + _DRAW, flat.numel())
            draw = torch.randn(hi - lo, generator=self.generator,
                               device=self.device, dtype=torch.float32)
            flat[lo:hi] = draw.mul_(scale)
        return out

    def const(self, value: float, shape, logical, dtype=None) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.mode == "axes":
            return tuple(logical)
        return torch.full(shape, value, dtype=dtype or self.dtype,
                          device=self.device)

    def position(self):
        """A decode cache's ``pos``: the Python int 0 (the reference holds
        an int32 scalar), or ``()`` in axes mode."""
        return () if self.mode == "axes" else 0


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


# ---------------------------------------------------------------- products
def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``; on DTensors under active sharding
    rules, each rank's einsum on its shards (``_einsum_sharded``), so no
    product goes through DTensor's own einsum, whose views of sharded
    dims some torch versions refuse."""
    if not sharded(a):
        return torch.einsum(eq, a, b)
    return _einsum_sharded(eq, a, b)


def _letter(placement, letters: str):
    return letters[placement.dim] if placement.is_shard() else None


def _einsum_sharded(eq: str, a, b):
    """Per mesh dim: an operand sharded on a letter the other holds pulls
    the other onto it (a chunk of a replicated operand); a letter only one
    operand holds stays sharded in the output, and the other operand is
    gathered there; a shared letter sharded alike shards the output, or
    leaves it partial where it is summed over."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    mesh = a.device_mesh
    if not is_dtensor(b):
        b = type(a).from_local(b, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    a = _reduced(a)
    b = _reduced(b)
    pa, pb, po = [], [], []
    for x, y in zip(a.placements, b.placements):
        ca, cb = _letter(x, la), _letter(y, lb)
        if cb is not None and cb != ca and cb not in la:
            ca = None  # b's letter only in b (and the output): gather a
        elif cb is not None:
            ca = cb
        elif ca is not None and ca in lb:
            cb = ca
        pa.append(Shard(la.index(ca)) if ca else Replicate())
        pb.append(Shard(lb.index(cb)) if cb else Replicate())
        c = cb or ca
        po.append(Replicate() if c is None else
                  Shard(out.index(c)) if c in out else Partial())
    a = a if tuple(a.placements) == tuple(pa) else a.redistribute(mesh, pa)
    b = b if tuple(b.placements) == tuple(pb) else b.redistribute(mesh, pb)
    fn = local_map(functools.partial(torch.einsum, eq), out_placements=po,
                   in_placements=(tuple(pa), tuple(pb)), device_mesh=mesh)
    return fn(a, b)


def _reduced(x):
    """A DTensor with its partial sums reduced (replicated there)."""
    from torch.distributed.tensor import Replicate

    if any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return x


# ---------------------------------------------------------------- embeddings
def take_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on DTensors under active sharding rules, the
    vocab-parallel gather (``_take_rows_sharded``)."""
    if not sharded(table):
        return table[tokens.long()]
    return _take_rows_sharded(table, tokens)


def _local_rows(table, tokens, *, mesh, placements):
    """One rank's rows: tokens outside its vocab shard give zero rows."""
    V_l = table.shape[0]
    idx = tokens.long() - shard_index(mesh, placements, 0) * V_l
    hit = (idx >= 0) & (idx < V_l)
    rows = F.embedding(idx.clamp(0, V_l - 1), table)
    return rows * hit[..., None].to(rows.dtype)


def _take_rows_sharded(table, tokens):
    """Vocab-parallel embedding on DTensors: each rank gathers from its
    vocab shard and the rows are partial sums over the vocab's mesh dims
    (the next hint reduces them)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tab_pl = tuple(table.placements)
    tok_pl, out_pl = [], []
    for tp, kp in zip(tab_pl, tokens.placements):
        if tp.is_shard(0):
            tok_pl.append(Replicate())
            out_pl.append(Partial())
        else:
            tok_pl.append(kp)
            out_pl.append(kp)
    tokens = tokens.redistribute(mesh, tok_pl)
    fn = local_map(functools.partial(_local_rows, mesh=mesh,
                                     placements=tab_pl),
                   out_placements=out_pl, in_placements=(tab_pl, tuple(tok_pl)),
                   device_mesh=mesh)
    return fn(table, tokens)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits over ``table``'s rows, hinted (batch, seq, vocab)."""
    logits = einsum("bsd,vd->bsv", x, table)
    return shard_hint(logits, ("batch", "seq", "vocab"))


# ---------------------------------------------------------------- rope
def make_rope(positions: torch.Tensor, head_dim: int, theta: float = 10_000.0):
    """cos/sin tables for rotary embedding; positions (..., S) int."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs  # (..., S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch & heads
        c = cos[None, :, None, :]
        s = sin[None, :, None, :]
    else:  # (B, S, half)
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)
