"""Roofline-term derivation from a dry-run's per-rank counts.

The port of ``repro.launch.roofline``.  ``Hardware()`` holds the H100 SXM's
data-sheet constants (not measurements):

    compute term    = flops per rank / 989e12 FLOP/s     (bf16 dense)
    memory term     = bytes per rank / 3.35e12 B/s       (HBM3)
    collective term = collective wire bytes per rank / 450e9 B/s

``ici_bw`` keeps the reference's field name and holds NVLink's 450 GB/s
each way per card.  Like the reference this models one link tier: on a
(16, 16) mesh of 8-card hosts the ``model`` and ``data`` axes' collectives
cross the inter-host network, which is slower than NVLink and is not
modelled, so the collective term is a lower bound.

The dry-run's counts are per rank already (taken on the local shards),
so no division by the rank count is applied.  Collective bytes come from
two sources.  ``parse_collectives`` reads an XLA HLO text, as the
reference does (kept, and held equal to it); ``collectives_from_trace``
takes the ``_c10d_functional`` collectives a DTensor trace issued, with
their result bytes and group size.  Both convert to ring-algorithm
bytes-on-the-wire per rank with one formula (``wire_bytes``):

    all-reduce      2 (g-1)/g * size
    all-gather        (g-1)/g * size          (size = gathered result)
    reduce-scatter    (g-1)   * size          (size = scattered result)
    all-to-all        (g-1)/g * size
    collective-permute          size
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Optional

__all__ = ["HW", "Hardware", "parse_collectives", "collectives_from_trace",
           "roofline_terms", "CollectiveStats", "wire_bytes"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One card's peaks.  ``peak_flops``: bf16 dense tensor-core FLOP/s;
    ``hbm_bw``: HBM bytes/s; ``ici_bw``: NVLink bytes/s each way (the
    reference's inter-chip-link field); ``hbm_bytes``: device memory."""

    name: str = "h100-sxm"
    peak_flops: float = 989e12
    hbm_bw: float = 3.35e12
    ici_bw: float = 450e9
    hbm_bytes: float = 80e9


HW = Hardware()

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

# e.g. "bf16[16,256,1024]{2,1,0}" or "f32[]"; tuples handled separately
_TYPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLL_RE = re.compile(
    r"=\s*(\([^)]*\)|[\w\[\],{}]+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\("
)
_GROUPS_RE = re.compile(r"replica_groups=\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

# The _c10d_functional collectives DTensor issues, by their HLO names.
FUNCTIONAL_OPS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _type_bytes(type_str: str) -> int:
    total = 0
    for m in _TYPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def wire_bytes(op: str, size: float, g: int) -> float:
    """Ring-algorithm bytes on the wire per rank of one collective with a
    ``size``-byte result over a group of ``g``."""
    if op == "collective-permute":  # point-to-point: no group attribute
        return size
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * size
    if op == "all-gather":
        return (g - 1) / g * size
    if op == "reduce-scatter":
        return (g - 1) * size
    if op == "all-to-all":
        return (g - 1) / g * size
    return 0.0


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict
    wire_bytes_per_chip: float

    def total_result_bytes(self) -> float:
        return sum(self.result_bytes.values())


def _stats(records: Iterable[tuple[str, float, int]]) -> CollectiveStats:
    """Counts, result bytes and wire bytes of (op, size, group) records."""
    counts: dict[str, int] = {}
    result_bytes: dict[str, float] = {}
    wire = 0.0
    for op, size, g in records:
        counts[op] = counts.get(op, 0) + 1
        result_bytes[op] = result_bytes.get(op, 0.0) + size
        wire += wire_bytes(op, size, g)
    return CollectiveStats(counts, result_bytes, wire)


def _hlo_records(hlo_text: str):
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        if m.group(3) == "-done":  # started op already counted at -start
            continue
        type_str, op = m.group(1), m.group(2)
        size = _type_bytes(type_str)
        # group size
        g = 1
        gi = _GROUPS_IOTA_RE.search(line)
        if gi:
            g = int(gi.group(2))
        else:
            gm = _GROUPS_RE.search(line)
            if gm:
                first = gm.group(1).split("}")[0].lstrip("{")
                g = max(len([x for x in first.split(",") if x.strip() != ""]), 1)
        yield op, size, g


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """The collectives of an optimized HLO text (the reference's parser)."""
    return _stats(_hlo_records(hlo_text))


def collectives_from_trace(records: Iterable[tuple[str, float, int]]
                           ) -> CollectiveStats:
    """The collectives a DTensor trace issued: ``records`` of
    (``_c10d_functional`` op name, result bytes, group size), e.g.
    ("all_gather_into_tensor", 4096, 16)."""
    return _stats((FUNCTIONAL_OPS[op], size, g) for op, size, g in records)


def roofline_terms(
    flops_per_chip: float,
    bytes_per_chip: float,
    coll: CollectiveStats,
    hw: Hardware = HW,
    model_flops_global: Optional[float] = None,
    chips: int = 256,
) -> dict:
    t_compute = flops_per_chip / hw.peak_flops
    t_memory = bytes_per_chip / hw.hbm_bw
    t_coll = coll.wire_bytes_per_chip / hw.ici_bw
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    bound = max(t_compute, t_memory, t_coll)
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "roofline_fraction": (t_compute / bound) if bound > 0 else 0.0,
        "collective_counts": coll.counts,
        "collective_result_bytes": coll.result_bytes,
        "wire_bytes_per_chip": coll.wire_bytes_per_chip,
    }
    if model_flops_global:
        hlo_global = flops_per_chip * chips
        out["model_flops_global"] = model_flops_global
        out["useful_flop_ratio"] = model_flops_global / max(hlo_global, 1.0)
        out["mfu_upper_bound"] = model_flops_global / max(
            chips * hw.peak_flops * bound, 1e-30
        )
    return out
