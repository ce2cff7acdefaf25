"""Ragged grouped matmul: the CUDA kernel (``kernel``), its plain PyTorch
version (``ref``) and the wrappers the model calls (``ops``)."""
