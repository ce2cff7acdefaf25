"""Model zoo of the port: every family of the reference (dense, MoE, SSM,
the Jamba hybrid, the encoder-decoder and the VLM prefix), full-sequence
(prefill) forward and decode, on PyTorch, with the paged decode-attention
kernel (K4) as every decode attention's core and the grouped-matmul kernel
(K5) as the experts' FFN.

  common      param factory, RMSNorm, RoPE, vocab padding
  attention   QKV projections, ``attn_full``, cache layout, ``attn_decode``,
              cross-attention (full, and decode through K4)
  mlp         gated and plain feed-forward blocks
  moe         router, capacity dispatch, expert FFN through K5
  ssm         Mamba-1: ``mamba_full`` (the f32 selective scan),
              ``mamba_decode``
  transformer ``init_lm``, ``lm_forward``, ``make_decode_cache``,
              ``lm_decode_step`` (dense, MoE, SSM, VLM)
  hybrid      the Jamba periods: forward, cache, decode
  encdec      encoder, decoder forward, cross K/V prefill, decode
  registry    ``init_params``, ``forward_fn``, ``decode_fn``, ``make_cache``
  convert     the reference's parameters into the port, bit for bit
"""
