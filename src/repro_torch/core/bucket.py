"""Bucket partitioning: equal-sized, spatially-coherent units of work.

Paper §3.1: relational tables are partitioned into equal-sized (same number
of objects) buckets along the HTM space-filling curve.  Each bucket covers a
contiguous key range, so (a) bucket I/O cost is uniform, (b) spatial
proximity is preserved and joins localize inside a bucket, and (c) a query's
key-range bounding box maps to a small set of overlapping buckets.

``Partitioner`` is data-structure only (host-side numpy); the actual object
payloads live in a ``BucketStore`` that the engines read through the
``BucketCache``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["BucketSpec", "Partitioner", "BucketStore"]


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One bucket: a contiguous SFC-key range holding ``count`` objects."""

    bucket_id: int
    key_lo: int  # inclusive
    key_hi: int  # exclusive
    count: int
    nbytes: int  # simulated storage footprint (uniform by construction)


class Partitioner:
    """Equal-count partition of a sorted key space into buckets.

    Parameters
    ----------
    keys:
        SFC keys of every object in the table (need not be sorted).
    objects_per_bucket:
        Paper uses 10,000 objects => ~40 MB buckets on SDSS.
    bytes_per_object:
        Only used to report the simulated bucket size.
    """

    def __init__(
        self,
        keys: np.ndarray,
        objects_per_bucket: int = 10_000,
        bytes_per_object: int = 4_096,
    ) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[order]
        self.order = order  # original-index permutation, sorted by key
        self.objects_per_bucket = int(objects_per_bucket)
        self.bytes_per_object = int(bytes_per_object)
        n = len(keys)
        self.n_buckets = max(1, -(-n // self.objects_per_bucket))
        # Boundaries are the keys at each bucket's first object.
        starts = np.arange(self.n_buckets) * self.objects_per_bucket
        self._start_idx = starts
        self._boundary_keys = self.sorted_keys[starts]
        # the same boundaries as Python ints, for the per-range lookup
        self._boundary_list = [int(k) for k in self._boundary_keys]
        self._layout_pos: dict[int, float] = {}  # layout_position cache
        self.specs: list[BucketSpec] = []
        for b in range(self.n_buckets):
            lo = int(self._boundary_keys[b])
            hi = (
                int(self._boundary_keys[b + 1])
                if b + 1 < self.n_buckets
                else int(self.sorted_keys[-1]) + 1
            )
            i0 = starts[b]
            i1 = min(n, i0 + self.objects_per_bucket)
            self.specs.append(
                BucketSpec(
                    bucket_id=b,
                    key_lo=lo,
                    key_hi=hi,
                    count=int(i1 - i0),
                    nbytes=int(i1 - i0) * self.bytes_per_object,
                )
            )

    # -- lookup ------------------------------------------------------------
    def bucket_of_keys(self, keys: np.ndarray) -> np.ndarray:
        """Bucket id for each key (vectorized binary search)."""
        keys = np.asarray(keys, dtype=np.uint64)
        idx = np.searchsorted(self._boundary_keys, keys, side="right") - 1
        return np.clip(idx, 0, self.n_buckets - 1).astype(np.int64)

    def _bucket_of_key(self, key: int) -> int:
        """``bucket_of_keys`` for one key, without numpy's per-call cost
        (the intake asks once for each end of every probe's range)."""
        idx = bisect.bisect_right(self._boundary_list, int(key)) - 1
        return min(max(idx, 0), self.n_buckets - 1)

    def buckets_for_range(self, key_lo: int, key_hi: int) -> np.ndarray:
        """All bucket ids whose key range overlaps [key_lo, key_hi]."""
        b0 = self._bucket_of_key(key_lo)
        b1 = self._bucket_of_key(key_hi)
        return np.arange(b0, b1 + 1, dtype=np.int64)

    def object_slice(self, bucket_id: int) -> np.ndarray:
        """Original-table indices of the objects stored in ``bucket_id``."""
        i0 = self._start_idx[bucket_id]
        i1 = min(len(self.sorted_keys), i0 + self.objects_per_bucket)
        return self.order[i0:i1]

    def layout_position(self, bucket_id: int) -> float:
        """Physical file position of the bucket: the mean *original-table*
        row address of its objects (its SFC run gathered back to where the
        rows actually sit).  The table was written in ingest order, not
        SFC order, so bucket id (SFC run) and file position are different
        axes — an elevator sweep that seeks by id zig-zags across the
        file.  This is the ``layout_of`` the prefetch planner's sweep
        should order by (ScanPlanConfig.layout_of)."""
        pos = self._layout_pos.get(bucket_id)
        if pos is None:
            idx = self.object_slice(bucket_id)
            pos = float(idx.mean()) if len(idx) else float(bucket_id)
            self._layout_pos[bucket_id] = pos
        return pos


class BucketStore:
    """Holds per-bucket object payloads (host numpy; the 'disk').

    ``payload`` is any dict of equal-length arrays (e.g. unit vectors +
    attributes).  Reads go through ``repro_torch.core.cache.BucketCache``.
    """

    def __init__(self, partitioner: Partitioner, payload: dict[str, np.ndarray]):
        self.partitioner = partitioner
        self._payload = payload
        lengths = {k: len(v) for k, v in payload.items()}
        assert len(set(lengths.values())) <= 1, f"ragged payload: {lengths}"

    def read(self, bucket_id: int) -> dict[str, np.ndarray]:
        idx = self.partitioner.object_slice(bucket_id)
        return {k: v[idx] for k, v in self._payload.items()}

    @property
    def n_buckets(self) -> int:
        return self.partitioner.n_buckets

    def spec(self, bucket_id: int) -> BucketSpec:
        return self.partitioner.specs[bucket_id]


def equal_count_edges(values: Sequence[float], n_buckets: int) -> np.ndarray:
    """Generic helper: quantile edges giving ~equal-count buckets."""
    qs = np.linspace(0.0, 1.0, n_buckets + 1)
    return np.quantile(np.asarray(values), qs)
