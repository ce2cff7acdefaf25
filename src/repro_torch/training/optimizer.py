"""Optimizers built from scratch: AdamW, 8-bit AdamW, Adafactor.

The port of ``repro.training.optimizer``, with its API and its state
tree, so that a state compares to the reference's leaf for leaf:

    opt = make_optimizer(name, lr=..., ...)
    state = opt.init(params)        # {"mu": per-leaf dicts, "step": int32}
    params, state, metrics = opt.update(grads, state, params)
    axes = opt.state_axes(param_axes)  # the state's logical axes

``params`` is a nested dict of tensors.  The per-leaf state keys are the
reference's: ``m``/``v`` (f32, the parameter's shape) for AdamW;
``m_q``/``m_s``/``v_q``/``v_s`` (int8 blocks of 256 and their f32 scales)
for 8-bit AdamW; ``vr``/``vc`` (the factored row and column moments) or
``v`` (a vector) for Adafactor.  ``step`` is a 0-dim int32 tensor on the
parameters' device; ``metrics`` holds ``grad_norm`` and ``lr`` as 0-dim
f32 tensors.  Nothing is read back to the host.

Where the reference returns new arrays (and donates the old ones under
``jit``), ``update`` writes the parameters and the state IN PLACE under
``torch.no_grad()`` and returns the same tensors.  The elementwise
AdamW update runs over each leaf in chunks of 2^26 elements (a
multiple of the 8-bit block), so its f32 temporaries stay a few hundred
MB however large the leaf; chunking changes no value.

Rounding.  ``torch.round`` and ``jnp.round`` both round half to even, and
the 8-bit blocks are quantized from the same f32 moments by the same
formula, so they agree wherever the moments do; a moment that differs in
its last bit from the reference's (the products' sums run in another
order) can move a code by one at a rounding boundary.  The clip scale is
f32 (the reference's ``x * scale`` promotes a bf16 gradient to f32), and
so is every moment and update.

Under the dry-run the leaves are DTensors (``repro_torch.launch.dryrun``).
The elementwise AdamW and 8-bit updates then run on each leaf's local
shard (``_local``): the moments are sharded like their parameter, and
the 8-bit state's (blocks, 256) codes only on dim 0, over ``data``
(zero1) or not at all.  The clip's global norm still reduces over the
mesh, and Adafactor's row and column means go through DTensor ops, since
they reduce over dims that may be sharded.  Plain tensors take the same
code as before, value for value.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..sharding.logical import is_dtensor, shard_index

__all__ = [
    "Optimizer",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "make_optimizer",
    "tree_leaves",
    "tree_map",
]

_QBLOCK = 256
_CHUNK = 1 << 26  # elements a leaf's AdamW update takes at once


# ---------------------------------------------------------------- trees
def tree_leaves(tree) -> list:
    """The tensors of a nested dict, depth first in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of the trees
    in ``rest``), as a nested dict of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _chunks(n: int):
    for lo in range(0, n, _CHUNK):
        yield lo, min(lo + _CHUNK, n)


def _full(x):
    """A DTensor scalar's value as a plain tensor; anything else as is."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------- norms
def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    if is_dtensor(x):  # reduced over the mesh where x is sharded
        return torch.sum(torch.square(x.float()))
    flat = x.reshape(-1)
    parts = [torch.sum(torch.square(flat[lo:hi].float()))
             for lo, hi in _chunks(flat.numel())]
    return parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    leaves = [_sum_squares(x) for x in tree_leaves(tree)]
    if is_dtensor(leaves[0]):
        total = leaves[0]
        for leaf in leaves[1:]:
            total = total + leaf
        return torch.sqrt(total)
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(the leaves times min(1, max_norm / norm), in f32; the norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: x.float() * scale, tree), norm


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """step -> lr (f32): linear warm-up to ``base_lr``, then a cosine decay
    to 0 at ``total``."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


# ---------------------------------------------------------------- quantization
def _quantize(x: torch.Tensor):
    """f32 -> (int8 blocks (n_blocks, 256), f32 scales (n_blocks, 1)); the
    tail block padded with zeros."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _QBLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clip(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` values of the blocks, flat, in f32."""
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


# ---------------------------------------------------------------- optimizer API
@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]
    state_axes: Callable[[Any], Any]


def make_optimizer(
    name: str = "adamw",
    lr: float | Callable = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)
    if name == "adamw":
        return _adamw(lr_fn, b1, b2, eps, weight_decay, clip_norm, bits8=False)
    if name == "adamw8bit":
        return _adamw(lr_fn, b1, b2, eps, weight_decay, clip_norm, bits8=True)
    if name == "adafactor":
        return _adafactor(lr_fn, weight_decay, clip_norm)
    raise ValueError(f"unknown optimizer {name!r}")


def _step_of(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _lr_at(lr_fn, step: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(lr_fn(step), dtype=torch.float32,
                           device=step.device)


def _flat_triples(grads, state, params):
    """(param, grad, per-leaf state) of every leaf, in params' order."""
    out = []
    tree_map(lambda p, g, s: out.append((p, g, s)), params, grads,
             state["mu"])
    return out


# ---------------------------------------------------------------- AdamW (+8bit)
def _adamw(lr_fn, b1, b2, eps, wd, clip_norm, bits8: bool) -> Optimizer:
    def init(params):
        def per_leaf(p):
            if bits8:
                nb = -(-p.numel() // _QBLOCK)
                z = dict(dtype=torch.int8, device=p.device)
                f = dict(dtype=torch.float32, device=p.device)
                return {
                    "m_q": torch.zeros((nb, _QBLOCK), **z),
                    "m_s": torch.zeros((nb, 1), **f),
                    "v_q": torch.zeros((nb, _QBLOCK), **z),
                    "v_s": torch.zeros((nb, 1), **f),
                }
            return {
                "m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            }

        return {"mu": tree_map(per_leaf, params), "step": _step_of(params)}

    def span(pf, gf, s, base, n, scale, lr, bc1, bc2):
        """Elements [base, base + n) of the flat leaf ``pf`` (gradient
        ``gf``) updated in place; the moments ``s`` start at ``base``."""
        for lo, hi in _chunks(n):
            gc = gf[base + lo:base + hi].float() * scale
            if bits8:
                blk = slice(lo // _QBLOCK, -(-hi // _QBLOCK))
                m = _dequantize(s["m_q"][blk], s["m_s"][blk], hi - lo)
                v = _dequantize(s["v_q"][blk], s["v_s"][blk], hi - lo)
            else:
                m = s["m"].view(-1)[lo:hi]
                v = s["v"].view(-1)[lo:hi]
            m_new = b1 * m + (1 - b1) * gc
            v_new = b2 * v + (1 - b2) * gc * gc
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            pc = pf[base + lo:base + hi].float()
            upd = upd + wd * pc
            pf[base + lo:base + hi] = (pc - lr * upd).to(pf.dtype)
            if bits8:
                for key, val in (("m", m_new), ("v", v_new)):
                    q, sc = _quantize(val)
                    s[f"{key}_q"][blk] = q
                    s[f"{key}_s"][blk] = sc
            else:
                m.copy_(m_new)
                v.copy_(v_new)

    def sharded(p, g, s, *hyper):
        """One DTensor leaf, the update on local shards.  AdamW: p and g
        in the moments' layout (zero1 may shard dim 0 over ``data``).
        8-bit: the full flat leaf's span of this rank's code blocks, the
        updated span gathered back over the blocks' axes."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = p.device_mesh
        if not bits8:
            pl = s["m"].placements
            ps = p if p.placements == pl else p.redistribute(mesh, pl)
            pf = ps.to_local().view(-1)
            local = {k: t.to_local() for k, t in s.items()}
            span(pf, g.redistribute(mesh, pl).to_local().reshape(-1), local,
                 0, pf.numel(), *hyper)
            if ps is not p:
                p.copy_(ps.redistribute(mesh, p.placements))
            return
        rep = (Replicate(),) * mesh.ndim
        n = p.numel()
        pf = p.redistribute(mesh, rep).to_local().reshape(-1)
        gf = g.redistribute(mesh, rep).to_local().reshape(-1)
        local = {k: t.to_local() for k, t in s.items()}
        nb = local["m_q"].shape[0]
        base = shard_index(mesh, s["m_q"].placements, 0) * nb * _QBLOCK
        count = max(0, min(nb * _QBLOCK, n - base))
        span(pf, gf, local, base, count, *hyper)
        piece = torch.nn.functional.pad(pf[base:base + count],
                                        (0, nb * _QBLOCK - count))
        blocks = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                       for pl in s["m_q"].placements)
        full = DTensor.from_local(piece, mesh, blocks, run_check=False)
        full = full.redistribute(mesh, rep).to_local()[:n].view(p.shape)
        new = DTensor.from_local(full, mesh, rep, run_check=False)
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, clip_norm)
        lr = _lr_at(lr_fn, step)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        hyper = tuple(_full(x) for x in (scale, lr, bc1, bc2))

        for p, g, s in _flat_triples(grads, state, params):
            if is_dtensor(p):
                sharded(p, g, s, *hyper)
            else:
                pf = p.view(-1)
                span(pf, g.reshape(-1), s, 0, pf.numel(), *hyper)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def state_axes(param_axes):
        def per_leaf(ax):
            if bits8:
                return {
                    "m_q": ("opt", None),
                    "m_s": ("opt", None),
                    "v_q": ("opt", None),
                    "v_s": ("opt", None),
                }
            return {"m": ax, "v": ax}

        return {"mu": tree_map(per_leaf, param_axes), "step": ()}

    return Optimizer("adamw8bit" if bits8 else "adamw", init, update,
                     state_axes)


# ---------------------------------------------------------------- Adafactor
def _adafactor(lr_fn, wd, clip_norm) -> Optimizer:
    eps = 1e-30

    def init(params):
        def per_leaf(p):
            f = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {
                    "vr": torch.zeros(p.shape[:-1], **f),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f),
                }
            return {"v": torch.zeros(p.shape, **f)}

        return {"mu": tree_map(per_leaf, params), "step": _step_of(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, clip_norm)
        lr = _lr_at(lr_fn, step)
        decay = 1.0 - (step.to(torch.float32) + 1.0) ** -0.8

        for p, g, s in _flat_triples(grads, state, params):
            g = g.float() * scale
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = decay * s["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
                vc = decay * s["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
                mean_r = torch.mean(vr, dim=-1, keepdim=True)
                pre = ((vr / torch.clamp_min(mean_r, eps))[..., None]
                       * vc[..., None, :])
                upd = g / torch.sqrt(torch.clamp_min(pre, eps))
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = decay * s["v"] + (1 - decay) * g2
                upd = g / torch.sqrt(torch.clamp_min(v, eps))
                s["v"].copy_(v)
            pc = p.float()
            upd = upd + wd * pc
            p.copy_((pc - lr * upd).to(p.dtype))
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def state_axes(param_axes):
        def per_leaf(ax):
            if len(ax) >= 2:
                return {"vr": tuple(ax[:-1]), "vc": tuple(ax[:-2]) + (ax[-1],)}
            return {"v": tuple(ax)}

        return {"mu": tree_map(per_leaf, param_axes), "step": ()}

    return Optimizer("adafactor", init, update, state_axes)
