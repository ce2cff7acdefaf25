"""Model zoo of the port: the dense and MoE decoders' decode path
(``transformer``) on PyTorch, with the paged decode-attention kernel as
the attention core and the grouped-matmul kernel as the experts' FFN.

  common      param factory, RMSNorm, RoPE, vocab padding
  attention   QKV projections, cache layout, ``attn_decode``
  mlp         gated and plain feed-forward blocks
  moe         router, capacity dispatch, expert FFN through K5
  transformer ``init_lm``, ``make_decode_cache``, ``lm_decode_step``
  registry    ``init_params``, ``decode_fn``, ``make_cache``
  convert     the reference's parameters into the port, bit for bit
"""
