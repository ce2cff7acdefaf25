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
the band's tile grid); coordinates are zero-padded to ``COORD_PAD``.  On
``cuda`` every join hands its kernel only the real probe rows (at least
one), and the single-bucket join the count of real bucket rows and the
padded probe count apart, as the band's grid: a padded probe only joins
padded bucket rows, no real row's result depends on how many there are,
and the kernel visits the padded bucket rows only where the threshold is
<= -2, where the reference counts them.  A
*marker column* keeps padded rows out of the single-bucket join: probes
carry 1.0 there, padded bucket rows -2.0, real bucket rows 0.0, so a
padded bucket row dots to exactly -2 with every probe -- below any real
dot and any threshold, including ``cos_thr <= 0``.  The fused and shared
joins zero the marker column and fence padded rows with segment
``PAD_SEG`` instead; padded probe rows of the shared join get threshold
+2, which nothing passes.

The reference compiles one executable per (join, power-of-two bucket
rows, power-of-two probe rows, static arguments) and reports their count
(``jit_cache_size``).  One CUDA library takes every shape here, so
nothing is compiled per shape; a ``ShapeLog`` collects those keys instead,
for the calls made while it is open, on either device: the shapes the
reference would compile for them from a cold cache.  It also collects the
(join, bucket rows, probe rows) handed to the kernel or its plain
version: on ``cuda`` the real probe rows, so nearly one shape a batch
size.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from .kernel import (
    COORD_PAD,
    PAD_SEG,
    crossmatch_fused_kernel,
    crossmatch_kernel,
    crossmatch_shared_kernel,
)

__all__ = ["crossmatch", "prepared_crossmatch", "crossmatch_fused",
           "crossmatch_shared", "ShapeLog", "resolve_device"]

_PAD_THR = 2.0  # threshold for padded probe rows: above any dot, passes never
_MARKER_COL = 3  # first zero-padded coordinate column; see module docstring
_MIN_SHAPE = 8  # floor for power-of-two shape buckets
# The open ShapeLogs.  set.add is atomic: shard threads may share one.
_LOGS: list = []


class ShapeLog:
    """``with ShapeLog() as log``: ``log.padded`` gets the padded key and
    ``log.launched`` the launch shape of every join called in the block."""

    def __init__(self):
        self.padded: set = set()
        self.launched: set = set()

    def __enter__(self) -> "ShapeLog":
        _LOGS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _LOGS.remove(self)


def _note_shapes(key: tuple, n_true: int, m_true: int, b8, p8) -> None:
    for log in _LOGS:
        log.padded.add((key[0], _pow2_ceil(n_true), _pow2_ceil(m_true),
                        *key[1:]))
        log.launched.add((key[0], b8.shape[0], p8.shape[0]))


def _pow2_ceil(n: int, floor: int = _MIN_SHAPE) -> int:
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def _ceil_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _host_prepare(bucket, probes, bm: int, bn: int, pad_probes: bool = True):
    """Pad (pow2, then to ``bn``/``bm`` multiples), COORD_PAD-widen and
    marker/sentinel-mark both operands in host numpy: one array build and
    one transfer per operand.  ``pad_probes=False`` keeps the real probe
    rows only (one padded row where there are none)."""
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
    m_rows = _probe_grid(m_true, bm) if pad_probes else max(m_true, 1)
    p8 = np.zeros((m_rows, COORD_PAD), np.float32)
    p8[:m_true, : probes.shape[1]] = probes
    p8[:, _MARKER_COL] = 1.0
    return b8, p8, n_true, m_true


def _probe_grid(m_true: int, bm: int) -> int:
    """Probe rows padded as the reference pads them."""
    return _ceil_to(_pow2_ceil(m_true), bm)


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
    return prepared_crossmatch(bucket, probes, cos_thr, device, bm, bn, band)()


def prepared_crossmatch(
    bucket,
    probes,
    cos_thr: float,
    device=None,
    bm: int = 128,
    bn: int = 512,
    band: Optional[int] = None,
):
    """``crossmatch`` cut at the host-device boundary: pads the inputs and
    copies them to the device now, and returns ``join()``, which runs the
    device part alone (on ``cuda`` one K1 launch) and returns what
    ``crossmatch`` returns."""
    dev = resolve_device(device)
    b8, p8, n_true, m_true = _host_prepare(bucket, probes, bm, bn,
                                           dev.type == "cpu")
    _note_shapes(("crossmatch", float(cos_thr), bm, bn, band), n_true,
                 m_true, b8, p8)
    b8t, p8t = torch.from_numpy(b8).to(dev), torch.from_numpy(p8).to(dev)
    m_grid = _probe_grid(m_true, bm)

    def join():
        idx, dot, cnt = crossmatch_kernel(
            b8t, p8t, float(cos_thr), bm=bm, bn=bn, band=band,
            n_real=n_true, m_grid=m_grid,
        )
        return _finish(idx, dot, cnt, n_true, m_true)

    return join


def _segmented_inputs(bucket, probes, bucket_seg, probe_seg, bm, bn,
                      pad_probes: bool = True):
    """The fused and shared joins' padded inputs; ``pad_probes=False``
    gives the card path's, the real probe rows only."""
    b8, p8, n_true, m_true = _host_prepare(bucket, probes, bm, bn, pad_probes)
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
        bucket, probes, bucket_seg, probe_seg, bm, bn, dev.type == "cpu"
    )
    _note_shapes(("crossmatch_fused", float(cos_thr), bm, bn), n_true,
                 m_true, b8, p8)
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
        bucket, probes, bucket_seg, probe_seg, bm, bn, dev.type == "cpu"
    )
    _note_shapes(("crossmatch_shared", bm, bn), n_true, m_true, b8, p8)
    thr = np.full(p8.shape[0], _PAD_THR, np.float32)
    thr[:m_true] = np.asarray(probe_thr, np.float32)
    idx, dot, cnt = crossmatch_shared_kernel(
        torch.from_numpy(b8).to(dev), torch.from_numpy(p8).to(dev),
        torch.from_numpy(bseg).to(dev), torch.from_numpy(pseg).to(dev),
        torch.from_numpy(thr).to(dev),
    )
    return _finish(idx, dot, cnt, n_true, m_true)
