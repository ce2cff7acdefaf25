"""Step assembly: the train step, the greedy serving decode step and the
prefill step, plus the sharding-spec derivation used by the multi-pod
dry-run and the elastic restore.

The port of ``repro.training.train_step``.  ``jax.jit`` has no
counterpart here: the steps run eagerly, on plain tensors or, under the
dry-run, on DTensors.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import registry as R
from ..sharding.logical import (NamedSharding, PartitionSpec, ShardingRules,
                                is_dtensor, shard_hint)
from .optimizer import Optimizer, tree_leaves, tree_map

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step",
           "tree_shardings"]


def tree_shardings(rules: ShardingRules, axes_tree, abstract_tree,
                   zero1: bool = False):
    """NamedSharding tree from (logical axes, shapes) twins; a leaf of
    ``abstract_tree`` with no shape (a cache's Python-int ``pos``) maps
    to None.

    ``zero1``: additionally shard dim-0 of any leaf whose dim-0 is
    unsharded over the 'data' axis when divisible (optimizer states)."""
    sizes = rules.sizes

    def one(ax, ab):
        if not hasattr(ab, "shape"):
            return None
        shape = tuple(ab.shape)
        spec = rules.spec_for(ax, shape)
        if zero1 and shape:
            parts = list(spec) + [None] * (len(shape) - len(spec))
            if parts[0] is None and "data" in sizes:
                if shape[0] % sizes["data"] == 0:
                    used = {a for p in parts if p
                            for a in ((p,) if isinstance(p, str) else p)}
                    if "data" not in used:
                        parts[0] = "data"
                        spec = PartitionSpec(*parts)
        return NamedSharding(rules.mesh, spec)

    return tree_map(one, axes_tree, abstract_tree)


def _micro(x, i: int, n_acc: int):
    """Microbatch ``i`` of ``n_acc``: rows [i * m, (i + 1) * m) of ``x``,
    m = rows / n_acc; of a DTensor, of each rank's shard."""
    if not is_dtensor(x):
        m = x.shape[0] // n_acc
        return x[i * m:(i + 1) * m]
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    m = local.shape[0] // n_acc
    return DTensor.from_local(local[i * m:(i + 1) * m], x.device_mesh,
                              x.placements, run_check=False)


def make_train_step(cfg: ModelConfig, opt: Optimizer):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    The loss and its gradients (``jax.value_and_grad`` in the reference:
    here ``torch.autograd.grad`` with respect to detached copies of the
    parameter leaves, which share their storage), then ``opt.update``,
    which writes the parameters and the state in place.  With
    ``cfg.microbatch`` smaller than the batch, the batch's rows are taken
    in ``n_acc`` microbatches of that many, in order, and the gradients'
    f32 sums and the losses are divided by ``n_acc``, as the reference's
    scan does.  On batch-sharded DTensors (the dry-run) each rank takes
    microbatch i from its own shard, the same rows a rank of a
    data-parallel run holds.  ``metrics``: ``loss``, ``grad_norm``,
    ``lr`` (0-dim f32 tensors)."""
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
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
            for i in range(n_acc):
                mb = tree_map(lambda x: _micro(x, i, n_acc), batch)
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


def _greedy(logits):
    """The argmax of the last position's logits, int32 (B,).  On DTensors
    the vocab is gathered first (DTensor's argmax over a sharded dim
    fails where a rank holds one row)."""
    last = shard_hint(logits[:, -1, :], ("batch", None))
    return torch.argmax(last, dim=-1).to(torch.int32)


def make_serve_step(cfg: ModelConfig, max_seq: int):
    """decode: (params, token (B,1), cache) -> (next_token (B,1), cache)."""
    step_fn = R.decode_fn(cfg, max_seq)

    def serve_step(params, token, cache):
        logits, cache = step_fn(params, token, cache)
        return _greedy(logits)[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """prefill: (params, batch) -> the greedy next token (B,) int32, the
    argmax of the last position's logits over the padded vocab."""
    fwd = R.forward_fn(cfg)

    def prefill_step(params, batch):
        return _greedy(fwd(params, batch))

    return prefill_step
