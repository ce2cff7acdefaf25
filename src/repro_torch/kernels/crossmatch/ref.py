"""Plain PyTorch versions of the three cross-match joins.

Semantics (probabilistic spatial join on the unit sphere): given catalog
``bucket`` (N,K) and probe set ``probes`` (M,K), both unit vectors
(zero-padded to K columns), and a cosine threshold = cos(match radius):

  best_idx[m] = argmax_n <probes[m], bucket[n]>   (lowest n on ties)
  best_dot[m] = the corresponding max dot product
  n_cand[m]   = #{n : <probes[m], bucket[n]> >= threshold}

The fused and shared joins add a segment mask (pairs of different
segments dot to -2, below any real dot and any threshold); the shared
join takes the threshold per probe row.  The single-bucket join's band
skips the pairs outside its kept tiles, as the Pallas kernel skips the
tiles: they never win and are never counted.

These are the functions each CUDA kernel in ``kernel`` is held against,
and what its wrapper runs for a tensor on the CPU.  The dots come from
one float32 ``torch.mm``; on the CPU that gives, bit for bit, the
fused multiply-add chain over the columns in order that the JAX
reference's ``jnp.dot`` gives, and that the kernel computes.  Reduced
float32 matmul precision (TF32, bf16) would round away thresholds as
tight as cos(2e-3), so it is refused.

Probes are processed in row chunks so the (chunk, N) dot matrix stays
bounded; each probe row's result depends on that row alone.

``crossmatch_splits_ref`` mirrors the CUDA kernel's decomposition (each
probe's bucket row range cut into splits, each split's best, index and
count, then the merge in split order); fed each probe's range
(``segment_rows`` for the segmented joins, ``bucket_rows`` for the
single-bucket join with or without its band) it gives the joins' results,
and the tests hold it and the kernel to them bit for bit.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "crossmatch_ref",
    "crossmatch_fused_ref",
    "crossmatch_shared_ref",
    "crossmatch_splits_ref",
    "band_keep",
    "band_rows",
    "bucket_rows",
    "segment_rows",
]

_NEG = -2.0  # masked pairs; real dots lie in [-1, 1]
_CHUNK_ELEMS = 1 << 25  # dot-matrix elements per probe chunk (128 MiB f32)


def _check_precision(x: torch.Tensor) -> None:
    if torch.get_float32_matmul_precision() != "highest" or (
        x.is_cuda and torch.backends.cuda.matmul.allow_tf32
    ):
        raise RuntimeError(
            "the cross-match join needs full float32 matmul precision; "
            "set torch.set_float32_matmul_precision('highest')"
        )


def _join(
    bucket: torch.Tensor,
    probes: torch.Tensor,
    thr: torch.Tensor | float,
    keep: Optional[Callable[[int, int], torch.Tensor]] = None,
    skip: bool = False,
):
    """Row-chunked max / first-argmax / threshold count over dots.

    ``keep(lo, hi)`` returns the (hi-lo, N) mask of pairs that take part;
    the others dot to -2, and with ``skip`` are not counted either (at a
    threshold <= -2 the segment joins' reference counts them, the band's
    skips them).  ``thr`` is a scalar or an (M,) tensor."""
    _check_precision(probes)
    m, n = probes.shape[0], bucket.shape[0]
    dev = probes.device
    idx = torch.zeros(m, dtype=torch.int32, device=dev)
    dot = torch.full((m,), _NEG, dtype=torch.float32, device=dev)
    cnt = torch.zeros(m, dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return idx, dot, cnt
    bt = bucket.t()
    step = max(1, _CHUNK_ELEMS // n)
    for lo in range(0, m, step):
        hi = min(lo + step, m)
        d = torch.mm(probes[lo:hi], bt)
        k = None if keep is None else keep(lo, hi)
        if k is not None:
            d = torch.where(k, d, torch.full_like(d, _NEG))
        arg = torch.argmax(d, dim=1)
        idx[lo:hi] = arg.to(torch.int32)
        dot[lo:hi] = d.gather(1, arg[:, None])[:, 0]
        t = thr if not torch.is_tensor(thr) else thr[lo:hi, None]
        passed = d >= t
        if skip and k is not None:
            passed &= k
        cnt[lo:hi] = passed.sum(dim=1).to(torch.int32)
    return idx, dot, cnt


def band_keep(m: int, n: int, bm: int, bn: int, band: int, device):
    """Pair mask of the banded tile grid: pair (row, col) takes part iff
    its tile (i, j) = (row // bm, col // bn) has |j - i*n_j // n_i| <= band,
    with n_i = m // bm and n_j = n // bn from the padded shapes."""
    n_i, n_j = m // bm, n // bn
    tile_j = torch.arange(n, device=device) // bn

    def keep(lo: int, hi: int) -> torch.Tensor:
        tile_i = torch.arange(lo, hi, device=device) // bm
        center = (tile_i * n_j) // max(n_i, 1)
        return (tile_j[None, :] - center[:, None]).abs() <= band

    return keep


def _seg_keep(bucket_seg: torch.Tensor, probe_seg: torch.Tensor):
    def keep(lo: int, hi: int) -> torch.Tensor:
        return probe_seg[lo:hi, None] == bucket_seg[None, :]

    return keep


def crossmatch_ref(
    bucket: torch.Tensor,
    probes: torch.Tensor,
    cos_thr: float,
    band: Optional[int] = None,
    bm: int = 128,
    bn: int = 512,
    m_grid: Optional[int] = None,
):
    """Single-bucket join.  With ``band``, pairs outside the banded tile
    grid (see ``band_keep``) do not take part, as in the Pallas kernel's
    band skip; ``bm``/``bn`` only shape that grid, over ``m_grid`` probe
    rows (default: the probes'; the probes are its first rows)."""
    keep = None
    if band is not None:
        m = probes.shape[0] if m_grid is None else int(m_grid)
        keep = band_keep(m, bucket.shape[0], bm, bn, int(band), probes.device)
    return _join(bucket, probes, float(cos_thr), keep, skip=True)


def crossmatch_fused_ref(
    bucket: torch.Tensor,
    probes: torch.Tensor,
    bucket_seg: torch.Tensor,
    probe_seg: torch.Tensor,
    cos_thr: float,
):
    """Segmented join: probe m only considers bucket rows with
    ``bucket_seg == probe_seg[m]``; ``best_idx`` indexes the concatenated
    bucket."""
    return _join(bucket, probes, float(cos_thr), _seg_keep(bucket_seg, probe_seg))


def crossmatch_shared_ref(
    bucket: torch.Tensor,
    probes: torch.Tensor,
    bucket_seg: torch.Tensor,
    probe_seg: torch.Tensor,
    probe_thr: torch.Tensor,
):
    """Shared-plan join: the segment mask plus a per-probe threshold
    (each in (-2, 1]; masked pairs sit at -2 and pass none)."""
    return _join(bucket, probes, probe_thr, _seg_keep(bucket_seg, probe_seg))


def segment_rows(bucket_seg: torch.Tensor, probe_seg: torch.Tensor):
    """Each probe's bucket row range [lo, hi) in the segmented joins: its
    segment's rows in the ascending ``bucket_seg``."""
    lo = torch.searchsorted(bucket_seg, probe_seg)
    return lo, torch.searchsorted(bucket_seg, probe_seg, right=True)


def band_rows(r: np.ndarray, rows: int, band: int, bm: int, bn: int,
              n_i: int, n_j: int):
    """Bucket rows [lo, hi) of the tiles that probe rows ``r`` (int64)
    keep on the (n_i, n_j) grid of (bm, bn) tiles (``band_keep``),
    clipped to ``rows``."""
    center = (r // bm) * n_j // max(n_i, 1)
    lo = np.maximum(center - band, 0) * bn
    hi = np.minimum(center + band + 1, n_j) * bn
    return np.minimum(lo, rows), np.minimum(hi, rows)


def bucket_rows(m: int, rows: int, band: Optional[int] = None, bm: int = 128,
                bn: int = 512, m_grid: Optional[int] = None,
                n_grid: Optional[int] = None, device=None):
    """Each of the ``m`` probes' bucket row range [lo, hi) in the
    single-bucket join on the card: rows [0, ``rows``), or with ``band``
    its ``band_rows`` on the (``m_grid``, ``n_grid``) grid (default: ``m``
    by ``rows``)."""
    r = np.arange(m, dtype=np.int64)
    lo, hi = np.zeros_like(r), np.full_like(r, rows)
    if band is not None:
        n_i = (m if m_grid is None else m_grid) // bm
        n_j = (rows if n_grid is None else n_grid) // bn
        lo, hi = band_rows(r, rows, band, bm, bn, n_i, n_j)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device))


def crossmatch_splits_ref(
    bucket: torch.Tensor,
    probes: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    thr: torch.Tensor | float,
    splits: int,
):
    """A join as the CUDA kernel decomposes it.

    Probe m takes the bucket rows [lo[m], hi[m]) (``segment_rows``,
    ``bucket_rows``); split s of ``splits`` takes its rows [lo + len*s //
    splits, lo + len*(s+1) // splits).  Each split keeps (best, index,
    count) from (-2, 0, 0): a strictly greater dot in ascending rows, and
    the dots >= ``thr`` (scalar or (M,)).  The merge takes the splits in
    order with a strict > and sums the counts, so where the cuts fall
    does not change the result: the band's kernel, which cuts its block's
    union of ranges, gives the same bits."""
    _check_precision(probes)
    m, n = probes.shape[0], bucket.shape[0]
    dev = probes.device
    idx = torch.zeros(m, dtype=torch.int32, device=dev)
    dot = torch.full((m,), _NEG, dtype=torch.float32, device=dev)
    cnt = torch.zeros(m, dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return idx, dot, cnt
    lo_all = torch.as_tensor(lo, device=dev).to(torch.int64)
    length_all = torch.as_tensor(hi, device=dev).to(torch.int64) - lo_all
    cols = torch.arange(n, device=dev)
    bt = bucket.t()
    step = max(1, _CHUNK_ELEMS // n)
    for a in range(0, m, step):
        b = min(a + step, m)
        d = torch.mm(probes[a:b], bt)
        t = thr if not torch.is_tensor(thr) else thr[a:b, None]
        passed = d >= t
        lo, length = lo_all[a:b], length_all[a:b]
        best = torch.full((b - a,), _NEG, dtype=torch.float32, device=dev)
        arg = torch.zeros(b - a, dtype=torch.int64, device=dev)
        count = torch.zeros(b - a, dtype=torch.int64, device=dev)
        for s in range(splits):
            r0 = lo + length * s // splits
            r1 = lo + length * (s + 1) // splits
            keep = (cols[None, :] >= r0[:, None]) & (cols[None, :] < r1[:, None])
            ds = torch.where(keep, d, torch.full_like(d, -float("inf")))
            s_arg = torch.argmax(ds, dim=1)
            s_best = ds.gather(1, s_arg[:, None])[:, 0]
            found = s_best > _NEG  # the split's best replaced its -2
            upd = found & (s_best > best)
            best = torch.where(upd, s_best, best)
            arg = torch.where(upd, s_arg, arg)
            count += (passed & keep).sum(dim=1)
        idx[a:b] = arg.to(torch.int32)
        dot[a:b] = best
        cnt[a:b] = count.to(torch.int32)
    return idx, dot, cnt
