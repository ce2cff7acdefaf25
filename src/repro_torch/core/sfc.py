"""Space-filling curves used to linearize spatial data into buckets.

The paper partitions the celestial sphere with the Hierarchical Triangular
Mesh (HTM): a quad-tree decomposition of the 8 octahedral faces into
spherical triangles.  HTM IDs form a space-filling curve — objects close on
the sky are close in ID — which lets equal-count ID ranges double as
spatially-coherent buckets (paper §3.1, Fig. 1).

We implement:
  * a real (vectorized, numpy) HTM trixel index, ``htm_id`` — the paper's
    curve, 32-bit at level 14 exactly as in SkyQuery;
  * Morton / Z-order curves in 2-D and 3-D, used by the generic partitioner
    (``repro_torch.core.bucket``) for non-spherical data (KV pages, token blocks).

Everything here is pure numpy (host-side pre-processing, never traced).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "htm_id",
    "htm_level_of",
    "unit_vectors",
    "radec_to_unit",
    "morton2d",
    "morton3d",
    "morton2d_decode",
]

# ---------------------------------------------------------------------------
# HTM (Hierarchical Triangular Mesh)
# ---------------------------------------------------------------------------

# Octahedron vertices (the standard HTM basis).
_V = np.array(
    [
        [0.0, 0.0, 1.0],   # v0: north pole
        [1.0, 0.0, 0.0],   # v1
        [0.0, 1.0, 0.0],   # v2
        [-1.0, 0.0, 0.0],  # v3
        [0.0, -1.0, 0.0],  # v4
        [0.0, 0.0, -1.0],  # v5: south pole
    ]
)

# The 8 root trixels (S0-S3, N0-N3) in canonical HTM order; ids 8..15.
# Each row: indices into _V for the triangle corners (counter-clockwise
# seen from outside the sphere).
_ROOTS = np.array(
    [
        [1, 5, 2],  # S0 -> id 8
        [2, 5, 3],  # S1 -> id 9
        [3, 5, 4],  # S2 -> id 10
        [4, 5, 1],  # S3 -> id 11
        [1, 0, 4],  # N0 -> id 12
        [4, 0, 3],  # N1 -> id 13
        [3, 0, 2],  # N2 -> id 14
        [2, 0, 1],  # N3 -> id 15
    ]
)


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def unit_vectors(n: int, seed: int = 0) -> np.ndarray:
    """``n`` uniformly distributed unit vectors on the sphere, shape (n, 3)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return _normalize(v)


def radec_to_unit(ra_deg: np.ndarray, dec_deg: np.ndarray) -> np.ndarray:
    """Astronomy (RA, Dec) in degrees -> unit vectors, shape (..., 3)."""
    ra = np.deg2rad(np.asarray(ra_deg, dtype=np.float64))
    dec = np.deg2rad(np.asarray(dec_deg, dtype=np.float64))
    return np.stack(
        [np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)],
        axis=-1,
    )


def _inside(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """True where point ``p`` is on the inner side of great-circle edge a->b."""
    # sign of det([a, b, p]) == dot(cross(a, b), p)
    return np.einsum("...k,...k->...", np.cross(a, b), p) >= -1e-12


def htm_id(points: np.ndarray, level: int = 14) -> np.ndarray:
    """Vectorized HTM trixel IDs for unit vectors ``points`` (n, 3).

    Returns uint64 ids; at ``level`` L the id occupies 4 + 2L bits
    (level 14 -> 32 bits, matching the paper / SkyQuery).
    """
    p = _normalize(np.asarray(points, dtype=np.float64))
    if p.ndim == 1:
        p = p[None]
    n = p.shape[0]

    # Root trixel: test all 8 (cheap) and take the first containing one.
    ids = np.zeros(n, dtype=np.uint64)
    corners = np.zeros((n, 3, 3))
    assigned = np.zeros(n, dtype=bool)
    for r in range(8):
        a, b, c = _V[_ROOTS[r, 0]], _V[_ROOTS[r, 1]], _V[_ROOTS[r, 2]]
        inside = (
            _inside(p, a[None], b[None])
            & _inside(p, b[None], c[None])
            & _inside(p, c[None], a[None])
            & ~assigned
        )
        ids[inside] = 8 + r
        corners[inside] = np.stack([a, b, c])
        assigned |= inside
    # Numerical stragglers on edges: assign to root 8 (harmless for bucketing).
    if not assigned.all():
        rem = ~assigned
        a, b, c = _V[_ROOTS[0, 0]], _V[_ROOTS[0, 1]], _V[_ROOTS[0, 2]]
        ids[rem] = 8
        corners[rem] = np.stack([a, b, c])

    for _ in range(level):
        v0, v1, v2 = corners[:, 0], corners[:, 1], corners[:, 2]
        w0 = _normalize(v1 + v2)
        w1 = _normalize(v0 + v2)
        w2 = _normalize(v0 + v1)
        # child 0: (v0, w2, w1); 1: (v1, w0, w2); 2: (v2, w1, w0); 3: (w0, w1, w2)
        in0 = _inside(p, v0, w2) & _inside(p, w2, w1) & _inside(p, w1, v0)
        in1 = _inside(p, v1, w0) & _inside(p, w0, w2) & _inside(p, w2, v1)
        in2 = _inside(p, v2, w1) & _inside(p, w1, w0) & _inside(p, w0, v2)
        child = np.where(in0, 0, np.where(in1, 1, np.where(in2, 2, 3)))
        ids = ids * np.uint64(4) + child.astype(np.uint64)
        new_corners = np.empty_like(corners)
        m0, m1, m2 = child == 0, child == 1, child == 2
        m3 = child == 3
        new_corners[m0] = np.stack([v0[m0], w2[m0], w1[m0]], axis=1)
        new_corners[m1] = np.stack([v1[m1], w0[m1], w2[m1]], axis=1)
        new_corners[m2] = np.stack([v2[m2], w1[m2], w0[m2]], axis=1)
        new_corners[m3] = np.stack([w0[m3], w1[m3], w2[m3]], axis=1)
        corners = new_corners
    return ids


def htm_level_of(hid: int) -> int:
    """Level encoded in an HTM id (inverse of the 4+2L bit layout)."""
    return (int(hid).bit_length() - 4) // 2


# ---------------------------------------------------------------------------
# Morton / Z-order
# ---------------------------------------------------------------------------

def _part1by1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _unpart1by1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x5555555555555555)
    x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x


def _part1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton2d(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Interleave two uint32 coordinate arrays into Z-order keys (uint64)."""
    return _part1by1(np.asarray(x)) | (_part1by1(np.asarray(y)) << np.uint64(1))


def morton2d_decode(code: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    code = np.asarray(code, dtype=np.uint64)
    return _unpart1by1(code), _unpart1by1(code >> np.uint64(1))


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave three 21-bit coordinates into Z-order keys (uint64)."""
    return (
        _part1by2(np.asarray(x))
        | (_part1by2(np.asarray(y)) << np.uint64(1))
        | (_part1by2(np.asarray(z)) << np.uint64(2))
    )
