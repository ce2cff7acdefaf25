"""Cross-match joins: CUDA kernels (``kernel``), plain PyTorch versions
(``ref``) and the host wrappers the engine calls (``ops``)."""
