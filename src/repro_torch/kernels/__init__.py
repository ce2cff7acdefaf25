"""Hand-written Hopper kernels with their plain PyTorch versions.

  crossmatch — the three cross-match joins (single bucket, fused
               segment-masked, shared plan with per-probe thresholds)
               as one CUDA C++ source, ``csrc/crossmatch.cu``
"""
