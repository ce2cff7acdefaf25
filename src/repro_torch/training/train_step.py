"""Step assembly: the train step, the greedy serving decode step and the
prefill step.

The port of ``repro.training.train_step``'s ``make_train_step``,
``make_serve_step`` and ``make_prefill_step``.  ``jax.jit`` has no
counterpart here: the steps run eagerly.  ``tree_shardings`` belongs to
the mesh tools and is not ported yet.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import registry as R
from .optimizer import Optimizer, tree_leaves, tree_map

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step"]


def make_train_step(cfg: ModelConfig, opt: Optimizer):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    The loss and its gradients (``jax.value_and_grad`` in the reference:
    here ``torch.autograd.grad`` with respect to detached copies of the
    parameter leaves, which share their storage), then ``opt.update``,
    which writes the parameters and the state in place.  With
    ``cfg.microbatch`` smaller than the batch, the batch's rows are taken
    in ``n_acc`` microbatches of that many, in order, and the gradients'
    f32 sums and the losses are divided by ``n_acc``, as the reference's
    scan does.  ``metrics``: ``loss``, ``grad_norm``, ``lr`` (0-dim f32
    tensors)."""
    loss_fn = R.loss_fn(cfg)

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)])
        return loss.detach(), tree_map(lambda _: next(grads), params)

    def train_step(params, opt_state, batch):
        micro = cfg.microbatch
        lead = tree_leaves(batch)[0].shape[0]
        if micro and micro < lead:
            if lead % micro:
                raise ValueError(f"a batch of {lead} rows is not a whole "
                                 f"number of microbatches of {micro}")
            n_acc = lead // micro
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            for i in range(n_acc):
                mb = tree_map(lambda x: x[i * micro:(i + 1) * micro], batch)
                loss, grads = grads_of(params, mb)
                lsum = lsum + loss
                tree_map(lambda a, g: a.add_(g.float()), gsum, grads)
            loss = lsum / n_acc
            grads = tree_map(lambda g: g / n_acc, gsum)
        else:
            loss, grads = grads_of(params, batch)
        params, opt_state, om = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    return train_step


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
