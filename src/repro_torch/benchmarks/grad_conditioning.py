"""How far float32 holds a model's gradients: the loss and every gradient
leaf of a 2-layer float32 cut at full width, on the card and on the CPU,
each held against a float64 evaluation of the same weights and batch.

    PYTHONPATH=src python -m repro_torch.benchmarks.grad_conditioning \\
        [--arch seamless-m4t-large-v2] [--device cuda]

The cut and its inputs are those of ``chip_smoke.py``'s phase 16 (b):
``n_layers`` 2 (and 2 encoder layers; a hybrid keeps one period of an
attention and a Mamba layer), weights drawn on ``--device`` from seed 1
and copied to the CPU, 2 x 16 tokens of ``TokenPipeline(seed=1)`` and
seeded normal frames or patches.  The float64 evaluation runs the same
model code with ``torch.Tensor.float`` and the config's activation dtype
turned to float64 while it runs (the models upcast with ``.float()``), so
its products and sums run in double.  Prints, for each pair of the four
runs, the largest |diff| over the leaf's largest value, and the leaf.
With ``--device cpu`` the "card" runs are a second CPU run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses

import torch

from ..configs import base as config_base
from ..configs import get_config
from ..data import DataConfig, TokenPipeline
from ..device import resolve_device
from ..models import registry as R
from ..training.optimizer import tree_leaves, tree_map


def cut_of(cfg):
    """The 2-layer cut at full width (phase 16 (b)'s), in float32."""
    kw = dict(n_layers=2, dtype="float32")
    if cfg.family == "hybrid":
        kw.update(attn_period=2, attn_offset=0)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2)
    return dataclasses.replace(cfg, **kw)


def batch_of(cfg, B=2, S=16) -> dict:
    """``TokenPipeline(seed=1)``'s first batch in the family's keys, frames
    or patches seeded normals (seed 161), on the CPU."""
    b = TokenPipeline(DataConfig(cfg.vocab_size, S, B, seed=1)).next_batch()
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    gen = torch.Generator().manual_seed(161)
    if cfg.family == "encdec":
        return {"frames": torch.randn(B, S, cfg.d_model, generator=gen),
                "dec_tokens": out["tokens"], "labels": out["labels"]}
    if cfg.family == "vlm":
        return {"patches": torch.randn(B, cfg.n_prefix, cfg.d_model,
                                       generator=gen), **out}
    return out


@contextlib.contextmanager
def float64():
    """Within: ``Tensor.float`` gives float64 and every config's activation
    dtype is float64."""
    saved = torch.Tensor.float, config_base.ModelConfig.activation_dtype
    torch.Tensor.float = lambda self, *a, **k: self.double()
    config_base.ModelConfig.activation_dtype = property(
        lambda self: torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, config_base.ModelConfig.activation_dtype = saved


def grads(cut, params, batch, dev) -> tuple:
    """(loss, the gradient leaves as float64 CPU tensors)."""
    live = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), params)
    batch = {k: v.to(dev) for k, v in batch.items()}
    loss = R.loss_fn(cut)(live, batch)
    leaves = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss.detach()), [g.double().cpu() for g in leaves]


def worst(names, got, want) -> tuple:
    """(the largest |got - want| over the leaf's largest |want|, its leaf)."""
    return max((float((a - b).abs().max()) / (float(b.abs().max()) or 1.0), n)
               for n, a, b in zip(names, got, want))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="seamless-m4t-large-v2")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cut = cut_of(get_config(args.arch))
    drawn = R.init_params(cut, torch.Generator(device=dev).manual_seed(1))
    params = tree_map(lambda p: p.to("cpu", copy=True), drawn)
    del drawn
    batch = batch_of(cut)
    runs = {"card f32": grads(cut, params, batch, dev),
            "cpu f32": grads(cut, params, batch, "cpu")}
    with float64():
        p64 = tree_map(lambda t: t.double(), params)
        b64 = {k: v.double() if v.is_floating_point() else v
               for k, v in batch.items()}
        runs["cpu f64"] = grads(cut, p64, b64, "cpu")
        runs["card f64"] = grads(cut, p64, b64, dev)
    names = [n for n, _ in _named(params)]
    out = {"arch": args.arch, "device": str(dev),
           "losses": {k: v[0] for k, v in runs.items()}, "pairs": {}}
    print(f"[grad_conditioning] {args.arch}, 2-layer f32 cut on {dev}: "
          f"losses {out['losses']}", flush=True)
    for a, b in (("card f32", "cpu f32"), ("card f32", "cpu f64"),
                 ("cpu f32", "cpu f64"), ("card f64", "cpu f64")):
        rel, leaf = worst(names, runs[a][1], runs[b][1])
        out["pairs"][f"{a} vs {b}"] = (rel, leaf)
        print(f"[grad_conditioning]   {a} vs {b}: largest |diff| / the "
              f"leaf's largest value {rel:.3e} ({leaf})", flush=True)
    return out


def _named(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{path}{k}.")
        else:
            yield f"{path}{k}", v


if __name__ == "__main__":
    main()
