"""Carry the cross-match state across from plain data.

The system holds no weights: its state is the catalog (object positions
and attributes) and the query trace.  These builders take plain numpy
arrays and dicts, so the same catalog and trace -- made once, by either
package or from a file -- can be handed to this port and to the JAX
reference alike, without relying on two copies of a generator staying in
step.
"""
from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np

from ..core.bucket import BucketStore, Partitioner
from ..core.sfc import htm_id
from ..core.workload import Query
from .catalog import SkyCatalog

__all__ = ["catalog_from_arrays", "queries_from_records"]


def catalog_from_arrays(
    positions: np.ndarray,
    mags: np.ndarray,
    objects_per_bucket: int,
    htm_level: int,
) -> SkyCatalog:
    """A bucketed catalog of ``positions`` ((n, 3) unit vectors) with
    magnitudes ``mags``, partitioned by HTM id at ``htm_level`` into
    buckets of ``objects_per_bucket`` objects (as ``make_catalog`` does)."""
    positions = np.array(positions, dtype=np.float64)
    mags = np.array(mags, dtype=np.float64)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (n, 3); got {positions.shape}")
    if mags.shape != (len(positions),):
        raise ValueError(f"mags must be ({len(positions)},); got {mags.shape}")
    ids = htm_id(positions, level=htm_level)
    part = Partitioner(ids, objects_per_bucket=objects_per_bucket)
    store = BucketStore(part, {"positions": positions, "mags": mags, "htm": ids})
    return SkyCatalog(
        positions=positions,
        mags=mags,
        htm=ids,
        partitioner=part,
        store=store,
        level=htm_level,
    )


def queries_from_records(records: Iterable[Mapping[str, Any]]) -> list[Query]:
    """Queries from plain dicts with ``query_id``, ``arrival_time``,
    ``keys_lo``/``keys_hi`` (per-object HTM bounding ranges), ``payload``
    (a dict of arrays, ``positions`` for the cross-match) and optional
    ``meta``.  Arrays and dicts are copied, so the records stay untouched
    by whatever runs the queries."""
    return [
        Query(
            query_id=int(r["query_id"]),
            arrival_time=float(r["arrival_time"]),
            keys_lo=np.array(r["keys_lo"], dtype=np.uint64),
            keys_hi=np.array(r["keys_hi"], dtype=np.uint64),
            payload={k: np.array(v) for k, v in r.get("payload", {}).items()},
            meta=dict(r.get("meta") or {}),
        )
        for r in records
    ]
