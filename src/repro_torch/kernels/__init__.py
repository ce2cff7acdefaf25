"""Hand-written Hopper kernels with their plain PyTorch versions.

  crossmatch      — the three cross-match joins (single bucket, fused
                    segment-masked, shared plan with per-probe thresholds)
                    as one CUDA C++ source, ``csrc/crossmatch.cu``
  paged_attention — one-token GQA decode attention over K/V page pools,
                    ``csrc/paged_attention.cu``
  grouped_matmul  — y[r] = x[r] @ w[group of r's row tile], the MoE expert
                    products (tensor cores in bf16), ``csrc/grouped_matmul.cu``
  nvcc            — the build (nvcc into ``build/kernels/``) and ctypes
                    loading every kernel module uses
  shapes          — what K4 and K5 report when given ``meta`` tensors
                    (the multi-pod dry-run's shards): their output shape,
                    flops and bytes, nothing run
"""
