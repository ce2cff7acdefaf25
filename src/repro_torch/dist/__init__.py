"""repro_torch.dist — distributed-training substrate: gradient compression
and fault tolerance (the port of ``repro.dist``).

The LifeRaft analogy carries over: stragglers are aged work units whose
priority grows until a backup task is dispatched (paper §6 'future work'
on straggler absorption), and gradient compression is the bandwidth-side
twin of bucket batching — amortize the expensive transfer across many
small updates.
"""
from .compress import (
    dequantize_blockwise,
    error_feedback_compress,
    quantize_blockwise,
    topk_compress,
)
from .ft import (
    FTResult,
    HeartbeatMonitor,
    StragglerPolicy,
    simulate_training_with_failures,
)

__all__ = [
    "dequantize_blockwise",
    "error_feedback_compress",
    "quantize_blockwise",
    "topk_compress",
    "FTResult",
    "HeartbeatMonitor",
    "StragglerPolicy",
    "simulate_training_with_failures",
]
