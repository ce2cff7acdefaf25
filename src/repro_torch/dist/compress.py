"""Gradient compression: blockwise int8 quantization, top-k sparsification,
and error feedback.

The port of ``repro.dist.compress``: plain functions on tensors, computed
on the input's device in the reference's f32 order, so ``q``, ``scales``,
the residuals and the kept entries equal the reference's bit for bit
(``torch.round`` and ``jnp.round`` both round half to even).

Blockwise absmax quantization keeps the worst-case dequantization error at
``block_absmax / 127`` per element; error feedback folds the residual into
the next step so the compressed stream is unbiased in the long run
(sum of payloads + final residual == sum of gradients, exactly).
"""
from __future__ import annotations

import torch

__all__ = [
    "quantize_blockwise",
    "dequantize_blockwise",
    "error_feedback_compress",
    "topk_compress",
]

_BLOCK = 256


def quantize_blockwise(x: torch.Tensor, block: int = _BLOCK):
    """Symmetric int8 quantization with per-block absmax scales.

    Returns ``(q, scales)`` where ``q`` is int8 of shape (n_blocks, block)
    (zero-padded) and ``scales`` is float32 of shape (n_blocks,); a block
    whose absmax is 0 has scale 1.
    """
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    absmax = torch.amax(torch.abs(blocks), dim=1)
    scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clip(torch.round(blocks / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, shape):
    """Inverse of :func:`quantize_blockwise` (up to the quantization error)."""
    flat = (q.to(torch.float32) * scales[:, None]).reshape(-1)
    size = 1
    for d in shape:
        size *= int(d)
    return flat[:size].reshape(tuple(shape))


def error_feedback_compress(grad: torch.Tensor, residual=None,
                            block: int = _BLOCK):
    """Quantize ``grad + residual``; return ``((q, scales), new_residual)``.

    The residual carries the quantization error forward so nothing is lost:
    sum(dequantized payloads) + final residual == sum(grads).
    """
    acc = grad if residual is None else grad + residual
    q, s = quantize_blockwise(acc, block)
    new_residual = acc - dequantize_blockwise(q, s, acc.shape)
    return (q, s), new_residual


def topk_compress(grad: torch.Tensor, frac: float, residual=None):
    """Keep the top ``frac`` fraction of entries by magnitude (every entry
    tied with the k-th largest too); the rest go into the returned
    residual.  ``kept + residual == grad + old_residual``."""
    acc = grad if residual is None else grad + residual
    flat = acc.reshape(-1)
    n = flat.numel()
    k = max(1, int(round(frac * n)))
    thresh = torch.sort(torch.abs(flat)).values[n - k]
    keep = torch.abs(acc) >= thresh
    kept = torch.where(keep, acc, torch.zeros((), dtype=acc.dtype,
                                              device=acc.device))
    return kept, acc - kept
