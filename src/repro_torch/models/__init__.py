"""Model zoo of the port: the dense decoder's decode path (``transformer``)
on PyTorch, with the paged decode-attention kernel as its attention core.

  common      param factory, RMSNorm, RoPE, vocab padding
  attention   QKV projections, cache layout, ``attn_decode``
  mlp         gated and plain feed-forward blocks
  transformer ``init_lm``, ``make_decode_cache``, ``lm_decode_step``
  registry    ``init_params``, ``decode_fn``, ``make_cache``
  convert     the reference's parameters into the port, bit for bit
"""
