"""Hand-written Hopper kernels with their plain PyTorch versions.

  crossmatch      — the three cross-match joins (single bucket, fused
                    segment-masked, shared plan with per-probe thresholds)
                    as one CUDA C++ source, ``csrc/crossmatch.cu``
  paged_attention — one-token GQA decode attention over K/V page pools,
                    ``csrc/paged_attention.cu``
  nvcc            — the build (nvcc into ``build/kernels/``) and ctypes
                    loading both use
"""
