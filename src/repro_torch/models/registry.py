"""Unified model API over all families: init / forward / decode / cache.

The port of ``repro.models.registry`` for every family (dense, MoE, SSM,
hybrid, encoder-decoder, VLM):

  init_params(cfg, generator | device)         -> params (nested dicts)
  param_axes(cfg) / abstract_params(cfg)       -> logical axes / meta tensors
  loss_fn(cfg)(params, batch)                  -> scalar loss [train]
  forward_fn(cfg)(params, batch)               -> logits  [prefill]
  decode_fn(cfg, max_seq)(params, token, cache) -> (logits, cache) [decode]
  make_cache(cfg, batch, max_seq, device, enc_len) -> cache
  cache_axes(cfg, batch, max_seq, enc_len)     -> the cache's logical axes
  input_specs(cfg, shape) / batch_axes(cfg, shape) -> a step's data inputs
                                                  as meta tensors / axes

``forward_fn``'s batch has the reference's keys: ``tokens``; ``patches``
and ``tokens`` for the VLM; ``frames`` and ``dec_tokens`` for the
encoder-decoder; ``loss_fn``'s adds ``labels``.  The axes trees match the
reference's key for key; a cache's ``pos`` (a Python int here, an int32
scalar there) has the axes ``()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import encdec as _encdec
from . import hybrid as _hybrid
from . import transformer as _lm
from .common import ParamFactory

__all__ = [
    "init_params",
    "param_axes",
    "abstract_params",
    "loss_fn",
    "forward_fn",
    "decode_fn",
    "make_cache",
    "cache_axes",
    "input_specs",
    "batch_axes",
]


def _build(cfg: ModelConfig, f: ParamFactory) -> dict:
    if cfg.family == "encdec":
        return _encdec.init_encdec(cfg, f)
    if cfg.family == "hybrid":
        return _hybrid.init_hybrid(cfg, f)
    return _lm.init_lm(cfg, f)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Parameters drawn from ``generator`` on its device; with none, from a
    generator seeded 0 on ``device`` (``cuda`` by default; ``meta`` gives
    shapes only)."""
    if generator is None:
        dev = resolve_device(device)
        if dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
    return _build(cfg, ParamFactory(generator, cfg.activation_dtype))


def param_axes(cfg: ModelConfig) -> dict:
    """The parameter tree with each leaf its tuple of logical axes."""
    return _build(cfg, ParamFactory(None, cfg.activation_dtype, mode="axes"))


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors: shapes and dtypes only."""
    return init_params(cfg, device="meta")


def loss_fn(cfg: ModelConfig):
    """(params, batch) -> the scalar training loss (f32), by family: the
    encoder-decoder's batch is ``frames``, ``dec_tokens`` and ``labels``;
    the VLM's ``patches``, ``tokens`` and ``labels`` (its loss over the text
    positions); the others' ``tokens`` and ``labels``."""
    if cfg.family == "encdec":

        def loss(params, batch):
            return _encdec.encdec_loss(cfg, params, batch["frames"],
                                       batch["dec_tokens"], batch["labels"])

        return loss
    if cfg.family == "hybrid":

        def loss(params, batch):
            return _hybrid.hybrid_loss(cfg, params, batch["tokens"],
                                       batch["labels"])

        return loss
    if cfg.family == "vlm":

        def loss(params, batch):
            return _lm.lm_loss(cfg, params, batch["tokens"], batch["labels"],
                               prefix_embeds=batch["patches"])

        return loss

    def loss(params, batch):
        return _lm.lm_loss(cfg, params, batch["tokens"], batch["labels"])

    return loss


def forward_fn(cfg: ModelConfig):
    """(params, batch) -> logits over the padded vocab (B, S, V)."""
    if cfg.family == "encdec":

        def fwd(params, batch):
            return _encdec.encdec_forward(cfg, params, batch["frames"],
                                          batch["dec_tokens"])

        return fwd
    if cfg.family == "hybrid":

        def fwd(params, batch):
            return _hybrid.hybrid_forward(cfg, params, batch["tokens"])[0]

        return fwd
    if cfg.family == "vlm":

        def fwd(params, batch):
            return _lm.lm_forward(cfg, params, batch["tokens"],
                                  prefix_embeds=batch["patches"])[0]

        return fwd

    def fwd(params, batch):
        return _lm.lm_forward(cfg, params, batch["tokens"])[0]

    return fwd


def decode_fn(cfg: ModelConfig, max_seq: int):
    if cfg.family == "encdec":
        step_fn = _encdec.encdec_decode_step
    elif cfg.family == "hybrid":
        step_fn = _hybrid.hybrid_decode_step
    else:
        step_fn = _lm.lm_decode_step

    def step(params, token, cache):
        return step_fn(cfg, params, token, cache, max_seq)

    return step


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
               enc_len: Optional[int] = None) -> dict:
    """Zero decode cache on ``device`` (``cuda`` by default).  The
    encoder-decoder's cross K/V hold ``enc_len`` slots, which it must be
    given; the other families ignore it."""
    return _cache(cfg, ParamFactory(None, cfg.activation_dtype,
                                    resolve_device(device)),
                  batch, max_seq, enc_len)


def cache_axes(cfg: ModelConfig, batch: int, max_seq: int,
               enc_len: Optional[int] = None) -> dict:
    """The decode cache's tree with each leaf its logical axes (``pos``:
    ``()``)."""
    f = ParamFactory(None, cfg.activation_dtype, mode="axes")
    return _cache(cfg, f, batch, max_seq, enc_len or max_seq)


def _cache(cfg, f: ParamFactory, batch: int, max_seq: int, enc_len) -> dict:
    if cfg.family == "encdec":
        if enc_len is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder cache needs "
                             f"enc_len, the encoder's length")
        return _encdec.make_encdec_cache(cfg, f, batch, max_seq, enc_len)
    if cfg.family == "hybrid":
        return _hybrid.make_hybrid_cache(cfg, f, batch, max_seq)
    return _lm.make_decode_cache(cfg, f, batch, max_seq)


# ------------------------------------------------------------------ input specs
def _tok(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for one step's data inputs (no allocation),
    the reference's shapes and dtypes.

    train:   token/label batch            -> loss_fn
    prefill: token batch (no labels)      -> forward_fn
    decode:  one new token (the cache apart; see ``make_cache(device="meta")``)
    """
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    act = cfg.activation_dtype
    if shape.kind == "train":
        if cfg.family == "encdec":
            return {
                "frames": _tok((B, S, d), act),
                "dec_tokens": _tok((B, S)),
                "labels": _tok((B, S)),
            }
        if cfg.family == "vlm":
            P = cfg.n_prefix
            return {
                "patches": _tok((B, P, d), act),
                "tokens": _tok((B, S - P)),
                "labels": _tok((B, S - P)),
            }
        return {"tokens": _tok((B, S)), "labels": _tok((B, S))}
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": _tok((B, S, d), act), "dec_tokens": _tok((B, S))}
        if cfg.family == "vlm":
            P = cfg.n_prefix
            return {"patches": _tok((B, P, d), act), "tokens": _tok((B, S - P))}
        return {"tokens": _tok((B, S))}
    if shape.kind == "decode":
        return {"token": _tok((B, 1))}
    raise ValueError(shape.kind)


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical axes for each input (drives their shardings)."""
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            ax = {
                "frames": ("batch", "seq", "embed"),
                "dec_tokens": ("batch", "seq"),
            }
            if shape.kind == "train":
                ax["labels"] = ("batch", "seq")
            return ax
        if cfg.family == "vlm":
            ax = {"patches": ("batch", "seq", "embed"), "tokens": ("batch", "seq")}
            if shape.kind == "train":
                ax["labels"] = ("batch", "seq")
            return ax
        ax = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            ax["labels"] = ("batch", "seq")
        return ax
    return {"token": ("batch", "seq")}
