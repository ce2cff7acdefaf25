"""Logical-axis sharding rules with divisibility-aware fallback.

The port of ``repro.sharding.logical``.  Model code annotates tensors with
*logical* axis names ("batch", "heads", "ff", ...).  A ``ShardingRules``
table maps logical names to the axes of a ``DeviceMesh``; a rule is
dropped for a given tensor when the dimension is not divisible by the
mesh-axis size (so every (arch x shape x mesh) cell traces -- e.g. 8 KV
heads on a 16-way model axis fall back to replicated KV + a
sequence-sharded cache).

Where the reference has a ``jax.sharding.PartitionSpec`` the port has its
own ``PartitionSpec``, a tuple of ``None``, an axis name or a tuple of
axis names, one entry a tensor dim; where it has a ``NamedSharding`` the
port's ``NamedSharding`` pairs the mesh with the spec and gives the
DTensor placements: for mesh dim i, ``Shard(d)`` if that mesh axis is
named in entry d of the spec, else ``Replicate()``.  DTensor shards one
tensor dim over several mesh dims in mesh-dim order, which is the order
of the rules' one multi-axis entry, ("pod", "data").

Models call ``shard_hint(x, names)``.  With no rules active, or on a
tensor that is not a DTensor, it returns ``x`` after one thread-local
read: the normal path changes no value and launches nothing.  Under
``activate(rules)`` a DTensor is redistributed to the rule's placements,
the counterpart of ``jax.lax.with_sharding_constraint``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Any, Optional, Sequence

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "DECODE_RULES",
    "NamedSharding",
    "PartitionSpec",
    "activate",
    "current_rules",
    "shard_hint",
    "logical_to_spec",
    "named_sharding",
    "mesh_axis_sizes",
    "is_dtensor",
    "sharded",
    "shard_index",
]

# Logical name -> tuple of mesh axis names (tried in order; non-dividing
# axes are dropped per-tensor).  None = always replicated.
DEFAULT_RULES: dict[str, Optional[tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ff": ("model",),
    "ff_in": ("model",),  # row-parallel input dim of the down projection
    "vocab": ("model",),
    "experts": ("model",),
    # When n_experts doesn't divide the model axis (mixtral: 8 < 16) the
    # experts dim falls back to replicated and the per-expert FF dim picks
    # up the model axis instead (tensor-parallel experts) — the used-axis
    # set in spec_for prevents double assignment otherwise.
    "expert_ff": ("model",),
    "expert_cap": None,  # hillclimb: ("data",) shards the capacity dim
    "layers": None,
    "state": None,
    "conv": None,
    "dt": None,
    "inner": ("model",),  # mamba d_inner
    "kv_seq": None,  # training: KV seq replicated
    "opt": ("data",),  # ZeRO-1: optimizer-state extra sharding axis
    "cache_seq": None,
    "cache_kv_heads": ("model",),
}

# Decode-time overrides: when KV heads cannot take the model axis (kv < 16)
# the KV *sequence* takes it instead (sequence-parallel decode attention).
DECODE_RULES = dict(
    DEFAULT_RULES,
    cache_seq=("model",),
    cache_kv_heads=None,
)


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of names (the dim sharded over their product, the first
    outermost)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and a ``shape`` tuple): the reference reads
    ``mesh.shape[name]``, a ``DeviceMesh``'s shape is a tuple."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def shard_index(mesh, placements, dim: int) -> int:
    """This rank's block index along tensor dim ``dim``: the mesh dims that
    shard it taken in order, the first outermost, as DTensor lays them."""
    coord = mesh.get_coordinate()
    index = 0
    for i, pl in enumerate(placements):
        if pl.is_shard(dim):
            index = index * mesh.size(i) + coord[i]
    return index


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where a tensor's shards live."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim: ``Shard(d)`` where the mesh
        axis is named in entry d of the spec, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        where = {}
        for d, entry in enumerate(self.spec):
            for a in _entry_axes(entry):
                where[a] = d
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in self.mesh.mesh_dim_names)

    def local_slices(self, shape: Sequence[int]) -> tuple[slice, ...]:
        """This rank's block of a tensor of ``shape``: one slice a dim,
        the mesh dims that shard a tensor dim taken outermost first."""
        pl = self.placements
        return tuple(slice(k * b, (k + 1) * b) for k, b in (
            (shard_index(self.mesh, pl, d), b)
            for d, b in enumerate(self.shard_shape(shape))))

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """A shard's shape: each dim divided by the sizes of its axes."""
        sizes = mesh_axis_sizes(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            for a in _entry_axes(entry):
                out[d] //= sizes[a]
        return tuple(out)


class ShardingRules:
    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES if rules is None else rules)

    @property
    def sizes(self) -> dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    def axis_size(self, names: tuple[str, ...]) -> int:
        sizes = self.sizes
        size = 1
        for n in names:
            size *= sizes[n]
        return size

    def spec_for(self, logical: Sequence[Optional[str]],
                 shape: Sequence[int]) -> PartitionSpec:
        """PartitionSpec for a tensor with given logical axes and shape."""
        sizes = self.sizes
        parts = []
        used: set[str] = set()
        for name, dim in zip(logical, shape):
            entry = self.rules.get(name) if name else None
            if entry is None:
                parts.append(None)
                continue
            axes = tuple(a for a in entry if a in sizes and a not in used)
            if axes and dim % self.axis_size(axes) == 0:
                parts.append(axes if len(axes) > 1 else axes[0])
                used.update(axes)
            else:
                # Divisibility fallback: try a prefix of the axes tuple.
                ok = None
                for k in range(len(axes) - 1, 0, -1):
                    sub = axes[:k]
                    if dim % self.axis_size(sub) == 0:
                        ok = sub
                        break
                if ok:
                    parts.append(ok if len(ok) > 1 else ok[0])
                    used.update(ok)
                else:
                    parts.append(None)
        return PartitionSpec(*parts)

    def sharding_for(self, logical, shape) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(logical, shape))


_STATE = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def activate(rules: Optional[ShardingRules]):
    """Activate sharding rules for model tracing (launch code only)."""
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (never, unless DTensor was imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def sharded(x) -> bool:
    """Whether rules are active and ``x`` is a DTensor: the dry-run's path
    (one thread-local read when no rules are active)."""
    return current_rules() is not None and is_dtensor(x)


def shard_hint(x, logical: Sequence[Optional[str]]):
    """Annotate an activation with logical axes: with no rules active or
    on a tensor that is not a DTensor, ``x`` itself; else ``x``
    redistributed to the rule's placements (differentiable)."""
    rules = current_rules()
    if rules is None or not is_dtensor(x):
        return x
    placements = rules.sharding_for(logical, x.shape).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(rules.mesh, placements)


def logical_to_spec(rules: ShardingRules, logical, shape) -> PartitionSpec:
    return rules.spec_for(logical, shape)


def named_sharding(rules: ShardingRules, logical, shape) -> NamedSharding:
    return rules.sharding_for(logical, shape)
