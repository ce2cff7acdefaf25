"""LifeRaft on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The JAX/Pallas package ``repro`` stays the reference.  This package keeps
its own copies of the JAX-free decision layer (``core``) and of the
serving engine, and rewrites what touched JAX: the cross-match, paged
decode-attention and grouped-matmul kernels (hand-written CUDA for
sm_90a, with a plain PyTorch version beside each), the cross-match
engine, and every model family's decode and prefill.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
a CUDA tensor goes through the kernel, a CPU tensor through the plain
version.  Nothing here imports ``jax`` or ``repro``.
"""
__version__ = "0.1.0"
