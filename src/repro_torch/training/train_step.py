"""Step assembly: the greedy serving decode step and the prefill step.

The port of ``repro.training.train_step.make_serve_step`` and
``make_prefill_step``.  ``jax.jit`` has no counterpart here: the steps run
eagerly.  The train step belongs to the training substrate, which is not
ported yet.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import registry as R

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(cfg: ModelConfig, max_seq: int):
    """decode: (params, token (B,1), cache) -> (next_token (B,1), cache)."""
    step_fn = R.decode_fn(cfg, max_seq)

    def serve_step(params, token, cache):
        logits, cache = step_fn(params, token, cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return nxt, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """prefill: (params, batch) -> the greedy next token (B,) int32, the
    argmax of the last position's logits over the padded vocab."""
    fwd = R.forward_fn(cfg)

    def prefill_step(params, batch):
        logits = fwd(params, batch)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    return prefill_step
