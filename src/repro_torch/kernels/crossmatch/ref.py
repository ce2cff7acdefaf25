"""Plain PyTorch versions of the three cross-match joins.

Semantics (probabilistic spatial join on the unit sphere): given catalog
``bucket`` (N,K) and probe set ``probes`` (M,K), both unit vectors
(zero-padded to K columns), and a cosine threshold = cos(match radius):

  best_idx[m] = argmax_n <probes[m], bucket[n]>   (lowest n on ties)
  best_dot[m] = the corresponding max dot product
  n_cand[m]   = #{n : <probes[m], bucket[n]> >= threshold}

The fused and shared joins add a segment mask (pairs of different
segments dot to -2, below any real dot and any threshold); the shared
join takes the threshold per probe row.

These are the functions each CUDA kernel in ``kernel`` is held against,
and what its wrapper runs for a tensor on the CPU.  The dots come from
one float32 ``torch.mm``; on the CPU that gives, bit for bit, the
fused multiply-add chain over the columns in order that the JAX
reference's ``jnp.dot`` gives, and that the kernel computes.  Reduced
float32 matmul precision (TF32, bf16) would round away thresholds as
tight as cos(2e-3), so it is refused.

Probes are processed in row chunks so the (chunk, N) dot matrix stays
bounded; each probe row's result depends on that row alone.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = [
    "crossmatch_ref",
    "crossmatch_fused_ref",
    "crossmatch_shared_ref",
    "band_keep",
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
):
    """Row-chunked max / first-argmax / threshold count over dots.

    ``keep(lo, hi)`` returns the (hi-lo, N) mask of pairs that take part;
    the others dot to -2.  ``thr`` is a scalar or an (M,) tensor."""
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
        if keep is not None:
            d = torch.where(keep(lo, hi), d, torch.full_like(d, _NEG))
        arg = torch.argmax(d, dim=1)
        idx[lo:hi] = arg.to(torch.int32)
        dot[lo:hi] = d.gather(1, arg[:, None])[:, 0]
        t = thr if not torch.is_tensor(thr) else thr[lo:hi, None]
        cnt[lo:hi] = (d >= t).sum(dim=1).to(torch.int32)
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
):
    """Single-bucket join.  With ``band``, pairs outside the banded tile
    grid (see ``band_keep``) do not take part, as in the kernel's band
    skip; ``bm``/``bn`` only shape that grid."""
    keep = None
    if band is not None:
        keep = band_keep(
            probes.shape[0], bucket.shape[0], bm, bn, int(band), probes.device
        )
    return _join(bucket, probes, float(cos_thr), keep)


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
