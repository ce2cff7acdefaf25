"""The yardstick's arithmetic: the H100's peaks, the bound rule, and the
operations and bytes of each kernel and of a decode token.

``bound`` and the peaks are copied from the port's
``repro_torch/benchmarks/common.py`` (the same rule every kernel time in
``PERF.md`` is held to); the benchmark keeps its own copy so that no
change to the program can move the yardstick.  Bytes count each input
read once and each output written once, as these inputs need them: K4
the attended K/V slots of each sequence, K5 the weights of the experts the
routing made active and the rows routed to them.
"""
from __future__ import annotations

__all__ = ["PEAK_BF16_FLOPS", "PEAK_FP32_FLOPS", "PEAK_BYTES", "bound",
           "k4_call", "k5_call", "token_flops"]

# H100 SXM (NVIDIA data sheet, dense, 700 W): bf16 tensor cores, FP32
# outside the tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of ``nbytes`` at ``PEAK_BYTES`` and ``flops`` at
    ``peak_flops``."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def k4_call(batch: int, heads: int, kv_heads: int, head_dim: int,
            lens: int, itemsize: int) -> tuple[float, float]:
    """(bytes, flops) of one decode-attention call over ``batch``
    sequences that each attend ``lens`` slots: K and V of those slots read
    once, q read and the output written; QK^T and PV."""
    kv = 2.0 * batch * lens * kv_heads * head_dim * itemsize
    qo = 2.0 * batch * heads * head_dim * itemsize
    return kv + qo, 4.0 * batch * heads * lens * head_dim


def k5_call(active_experts: int, rows: int, d_in: int, d_out: int,
            itemsize: int) -> tuple[float, float]:
    """(bytes, flops) of one grouped product: the weights of the
    ``active_experts`` that hold a routed row, read once, and the ``rows``
    routed rows of x read and of y written."""
    w = float(active_experts) * d_in * d_out * itemsize
    xy = float(rows) * (d_in + d_out) * itemsize
    return w + xy, 2.0 * rows * d_in * d_out


def token_flops(spec, context: int) -> float:
    """Model FLOPs of one decoded token that attends ``context`` slots:
    2 x the parameters it multiplies (attention, the MLP or the top k
    experts and the router, the head) plus attention's 4 x context x heads
    x head size, in every layer."""
    d, H, KV, D = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    attn = d * (H + 2 * KV) * D + H * D * d
    if spec.n_experts:
        ffn = spec.top_k * 3 * d * spec.d_ff + d * spec.n_experts
    else:
        ffn = 3 * d * spec.d_ff
    params = spec.n_layers * (attn + ffn) + spec.vocab_size * d
    return 2.0 * params + 4.0 * context * H * D * spec.n_layers
