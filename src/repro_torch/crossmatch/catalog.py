"""Synthetic sky catalogs standing in for SDSS/2MASS/USNOB archives.

The paper evaluates on the SDSS fact table (6 TB) partitioned into ~20,000
buckets of 10,000 objects each.  We generate catalogs of unit vectors with
realistic *clustered* density (objects cluster on the sky, which is what
makes equal-count HTM buckets non-uniform in area), bucket them with the
real HTM curve from ``repro_torch.core.sfc``, and expose a ``BucketStore``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.bucket import BucketStore, Partitioner
from ..core.sfc import htm_id, unit_vectors, _normalize

__all__ = ["SkyCatalog", "make_catalog"]


@dataclasses.dataclass
class SkyCatalog:
    """A bucketed point catalog on the unit sphere."""

    positions: np.ndarray  # (n, 3) float64 unit vectors
    mags: np.ndarray  # (n,) synthetic magnitude attribute
    htm: np.ndarray  # (n,) uint64 HTM ids
    partitioner: Partitioner
    store: BucketStore
    level: int

    @property
    def n_objects(self) -> int:
        return len(self.positions)

    @property
    def n_buckets(self) -> int:
        return self.partitioner.n_buckets


def make_catalog(
    n_objects: int = 200_000,
    objects_per_bucket: int = 1_000,
    n_clusters: int = 64,
    cluster_frac: float = 0.5,
    cluster_scale: float = 0.05,
    htm_level: int = 10,
    seed: int = 0,
) -> SkyCatalog:
    """Clustered synthetic catalog.

    ``cluster_frac`` of objects fall in ``n_clusters`` Gaussian blobs
    (angular sigma ``cluster_scale`` rad) — mimicking galactic-plane /
    survey-footprint density — the rest are uniform.  Clustering is what
    gives the workload its Zipf-like bucket contention (Figs. 5/6).
    """
    rng = np.random.default_rng(seed)
    n_cl = int(n_objects * cluster_frac)
    n_un = n_objects - n_cl
    uni = unit_vectors(n_un, seed=seed + 1)
    centers = unit_vectors(n_clusters, seed=seed + 2)
    which = rng.integers(0, n_clusters, size=n_cl)
    pts = centers[which] + rng.normal(scale=cluster_scale, size=(n_cl, 3))
    clustered = _normalize(pts)
    positions = np.concatenate([uni, clustered], axis=0)
    rng.shuffle(positions, axis=0)
    mags = rng.uniform(14.0, 24.0, size=n_objects)

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
