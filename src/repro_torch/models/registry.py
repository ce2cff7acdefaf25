"""Model API for the port: init / decode / cache.

The port of ``repro.models.registry`` for what the serving decode path
calls: ``init_params``, ``decode_fn`` and ``make_cache``.  The dense and
MoE families are ported; every other family raises
``NotImplementedError`` naming its roadmap item
(``transformer.require_ported``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import transformer as _lm
from .common import ParamFactory

__all__ = ["init_params", "decode_fn", "make_cache"]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Parameters drawn from ``generator`` on its device; with none, from a
    generator seeded 0 on ``device`` (``cuda`` by default; ``meta`` gives
    shapes only)."""
    _lm.require_ported(cfg)
    if generator is None:
        dev = resolve_device(device)
        if dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
    return _lm.init_lm(cfg, ParamFactory(generator, cfg.activation_dtype))


def decode_fn(cfg: ModelConfig, max_seq: int):
    _lm.require_ported(cfg)

    def step(params, token, cache):
        return _lm.lm_decode_step(cfg, params, token, cache, max_seq)

    return step


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> dict:
    """Zero decode cache on ``device`` (``cuda`` by default)."""
    _lm.require_ported(cfg)
    f = ParamFactory(None, cfg.activation_dtype, resolve_device(device))
    return _lm.make_decode_cache(cfg, f, batch, max_seq)
