"""Public wrappers for the cross-match joins: host padding and dispatch.

Three entry points, with the JAX reference's signatures (``device`` in
place of ``use_pallas``/``interpret``):

``crossmatch``         one bucket vs its probe batch (K1);
``crossmatch_fused``   k buckets in ONE device call: payloads and probe
                       batches are concatenated with segment ids and the
                       join is segment-masked (K2);
``crossmatch_shared``  the fused call with a per-probe threshold, so
                       queries with different radii share one call (K3).

The device picks the path: on ``cuda`` every call launches the CUDA
kernel (or raises), on ``cpu`` it runs the plain PyTorch version.  With
no ``device`` the call runs on ``cuda`` and raises where there is none.
Outputs are torch tensors on the device the call ran on.

Padding is carried over from the reference exactly, because every detail
shows in the outputs.  Probe and bucket counts are padded to the next
power of two (floor 8), then to multiples of ``bm``/``bn`` (which shape
the band's tile grid); coordinates are zero-padded to ``COORD_PAD``.  A
*marker column* keeps padded rows out of the single-bucket join: probes
carry 1.0 there, padded bucket rows -2.0, real bucket rows 0.0, so a
padded bucket row dots to exactly -2 with every probe -- below any real
dot and any threshold, including ``cos_thr <= 0``.  The fused and shared
joins zero the marker column and fence padded rows with segment
``PAD_SEG`` instead; padded probe rows of the shared join get threshold
+2, which nothing passes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .kernel import (
    COORD_PAD,
    PAD_SEG,
    crossmatch_fused_kernel,
    crossmatch_kernel,
    crossmatch_shared_kernel,
)

__all__ = ["crossmatch", "crossmatch_fused", "crossmatch_shared", "resolve_device"]

_PAD_THR = 2.0  # threshold for padded probe rows: above any dot, passes never
_MARKER_COL = 3  # first zero-padded coordinate column; see module docstring
_MIN_SHAPE = 8  # floor for power-of-two shape buckets


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; ``None`` means ``cuda``, which must
    exist -- there is no silent fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "version"
            )
        return torch.device("cuda")
    return torch.device(device)


def _pow2_ceil(n: int, floor: int = _MIN_SHAPE) -> int:
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def _ceil_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _host_prepare(bucket, probes, bm: int, bn: int):
    """Pad (pow2, then to ``bn``/``bm`` multiples), COORD_PAD-widen and
    marker/sentinel-mark both operands in host numpy: one array build and
    one transfer per operand."""
    bucket = np.asarray(bucket, np.float32)
    probes = np.asarray(probes, np.float32)
    if bucket.shape[1] > _MARKER_COL or probes.shape[1] > _MARKER_COL:
        raise ValueError(
            f"coordinate width must be <= {_MARKER_COL}; column "
            f"{_MARKER_COL} is reserved for the padded-row marker"
        )
    n_true, m_true = bucket.shape[0], probes.shape[0]
    b8 = np.zeros((_ceil_to(_pow2_ceil(n_true), bn), COORD_PAD), np.float32)
    b8[:n_true, : bucket.shape[1]] = bucket
    b8[n_true:, _MARKER_COL] = -2.0
    p8 = np.zeros((_ceil_to(_pow2_ceil(m_true), bm), COORD_PAD), np.float32)
    p8[:m_true, : probes.shape[1]] = probes
    p8[:, _MARKER_COL] = 1.0
    return b8, p8, n_true, m_true


def _padded_segments(seg, n_rows: int, n_true: int) -> np.ndarray:
    """Segment ids as f32; padded rows get ``PAD_SEG``."""
    out = np.full(n_rows, PAD_SEG, np.float32)
    out[:n_true] = np.asarray(seg, np.float32)
    return out


def _finish(idx, dot, cnt, n_true: int, m_true: int):
    # Padded rows cannot win (marker dot -2), but clamp for belt-and-braces.
    idx = torch.clamp(idx[:m_true], max=max(n_true - 1, 0))
    return idx, dot[:m_true], cnt[:m_true]


def crossmatch(
    bucket,
    probes,
    cos_thr: float,
    device=None,
    bm: int = 128,
    bn: int = 512,
    band: Optional[int] = None,
):
    """Cross-match ``probes`` against ``bucket`` (both (?,3) unit vectors).

    Returns (best_idx, best_dot, n_cand), each of length len(probes).
    ``band`` skips the bucket tiles far from the probe tile's scaled
    diagonal (for SFC-sorted inputs)."""
    dev = resolve_device(device)
    b8, p8, n_true, m_true = _host_prepare(bucket, probes, bm, bn)
    idx, dot, cnt = crossmatch_kernel(
        torch.from_numpy(b8).to(dev), torch.from_numpy(p8).to(dev),
        float(cos_thr), bm=bm, bn=bn, band=band,
    )
    return _finish(idx, dot, cnt, n_true, m_true)


def _segmented_inputs(bucket, probes, bucket_seg, probe_seg, bm, bn):
    b8, p8, n_true, m_true = _host_prepare(bucket, probes, bm, bn)
    # The segment mask replaces the marker column: padded/real row fencing
    # comes from PAD_SEG, so neutralize the marker values set above.
    b8[:, _MARKER_COL] = 0.0
    p8[:, _MARKER_COL] = 0.0
    bseg = _padded_segments(bucket_seg, b8.shape[0], n_true)
    pseg = _padded_segments(probe_seg, p8.shape[0], m_true)
    if np.any(bseg[1:] < bseg[:-1]):
        raise ValueError("bucket_seg must be sorted ascending")
    return b8, p8, bseg, pseg, n_true, m_true


def crossmatch_fused(
    bucket,
    probes,
    bucket_seg,
    probe_seg,
    cos_thr: float,
    device=None,
    bm: int = 128,
    bn: int = 512,
):
    """Fused multi-bucket cross-match: ONE device call for k buckets.

    ``bucket`` is the segment-sorted concatenation of the k bucket payloads
    and ``probes`` that of their probe batches; ``bucket_seg``/``probe_seg``
    give each row's segment (0..k-1; ``bucket_seg`` ascending).  A probe only matches bucket rows of its own
    segment; ``best_idx`` indexes the *concatenated* bucket array (callers
    subtract their segment's row offset).  A probe whose segment is empty
    gets n_cand == 0."""
    dev = resolve_device(device)
    b8, p8, bseg, pseg, n_true, m_true = _segmented_inputs(
        bucket, probes, bucket_seg, probe_seg, bm, bn
    )
    idx, dot, cnt = crossmatch_fused_kernel(
        torch.from_numpy(b8).to(dev), torch.from_numpy(p8).to(dev),
        torch.from_numpy(bseg).to(dev), torch.from_numpy(pseg).to(dev),
        float(cos_thr),
    )
    return _finish(idx, dot, cnt, n_true, m_true)


def crossmatch_shared(
    bucket,
    probes,
    bucket_seg,
    probe_seg,
    probe_thr,
    device=None,
    bm: int = 128,
    bn: int = 512,
):
    """Shared-plan cross-match: the query axis fused into ONE device call.

    Like ``crossmatch_fused``, but the cos threshold is a per-probe array
    (``probe_thr[m]`` = probe m's owning query's cos(radius)), so a batch
    of queries with K distinct match radii costs one call.  Thresholds
    must lie in (-2, 1]; real cosines do.  ``best_idx`` indexes the
    concatenated bucket array."""
    dev = resolve_device(device)
    b8, p8, bseg, pseg, n_true, m_true = _segmented_inputs(
        bucket, probes, bucket_seg, probe_seg, bm, bn
    )
    thr = np.full(p8.shape[0], _PAD_THR, np.float32)
    thr[:m_true] = np.asarray(probe_thr, np.float32)
    idx, dot, cnt = crossmatch_shared_kernel(
        torch.from_numpy(b8).to(dev), torch.from_numpy(p8).to(dev),
        torch.from_numpy(bseg).to(dev), torch.from_numpy(pseg).to(dev),
        torch.from_numpy(thr).to(dev),
    )
    return _finish(idx, dot, cnt, n_true, m_true)
