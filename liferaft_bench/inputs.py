"""The benchmark's inputs, all made from ``--seed``: weights, each
sequence's prefilled K/V and each request batch's first tokens.

The same tensors go to the program and to the reference.  Weights and K/V
are drawn on the run's device by a ``torch.Generator`` seeded from the run's
seed and a stream number, in the type they are served in and in few large
calls: one draw over one flat buffer for every matrix, one for the norms,
and one for each layer's prefilled K and V (which the reference draws again
after the window, so that it reads nothing the program may have written).

Scales (the benchmark's own, not the program's initialiser): matrices
N(0, 1/fan_in), so that every activation keeps a unit scale; keys N(0,
K_STD^2) in the cache and from ``wk``, so that scores spread as in a
trained model's attention, peaked on few slots; embeddings N(0, 1); norm
weights 1 + N(0, 0.1^2).
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

__all__ = ["K_STD", "sub_seed", "generator", "layout", "make_weights",
           "prefill_kv", "first_tokens", "sample_rng"]

K_STD = 2.5
_ALIGN = 256  # elements: every matrix starts 512 bytes into the buffer


def _np_seed(seed: int) -> int:
    return int(seed) % (1 << 64)  # numpy's seed words are unsigned


def sub_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one stream of the run's inputs."""
    h = hashlib.blake2b(f"{int(seed)}/{stream}/{index}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def generator(device, seed: int, stream: str, index: int = 0):
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, stream, index))
    return g


def layout(spec) -> tuple[list, list]:
    """(matrices, norms): (path, shape, std) of each random matrix and
    (path, shape) of each norm weight, in the tree the program takes."""
    L, d, H, KV, D = (spec.n_layers, spec.d_model, spec.n_heads,
                      spec.n_kv_heads, spec.head_dim)
    V, f = spec.vocab_size, spec.d_ff
    mats = [
        (("embed",), (V, d), 1.0),
        (("unembed",), (V, d), 1 / math.sqrt(d)),
        (("layers", "attn", "wq"), (L, d, H, D), 1 / math.sqrt(d)),
        (("layers", "attn", "wk"), (L, d, KV, D), K_STD / math.sqrt(d)),
        (("layers", "attn", "wv"), (L, d, KV, D), 1 / math.sqrt(d)),
        (("layers", "attn", "wo"), (L, H, D, d), 1 / math.sqrt(H * D)),
    ]
    if spec.n_experts:
        E = spec.n_experts
        mats += [
            (("layers", "moe", "router"), (L, d, E), 1 / math.sqrt(d)),
            (("layers", "moe", "wg"), (L, E, d, f), 1 / math.sqrt(d)),
            (("layers", "moe", "wu"), (L, E, d, f), 1 / math.sqrt(d)),
            (("layers", "moe", "wd"), (L, E, f, d), 1 / math.sqrt(f)),
        ]
    else:
        mats += [
            (("layers", "mlp", "wg"), (L, d, f), 1 / math.sqrt(d)),
            (("layers", "mlp", "wu"), (L, d, f), 1 / math.sqrt(d)),
            (("layers", "mlp", "wd"), (L, f, d), 1 / math.sqrt(f)),
        ]
    norms = [(("final_norm",), (d,)), (("layers", "ln1"), (L, d)),
             (("layers", "ln2"), (L, d))]
    return mats, norms


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _carve(buf: torch.Tensor, shapes: list) -> list:
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(buf[off:off + n].view(shape))
        off += -(-n // _ALIGN) * _ALIGN
    return out


def _numel(shapes: list) -> int:
    return sum(-(-math.prod(s) // _ALIGN) * _ALIGN for s in shapes)


def make_weights(spec, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weight tree: every matrix a view of one flat buffer filled by
    one draw, then scaled; the norms a second buffer."""
    mats, norms = layout(spec)
    shapes = [s for _, s, _ in mats]
    buf = torch.empty(_numel(shapes), dtype=dtype, device=device)
    buf.normal_(0.0, 1.0, generator=generator(device, seed, "weights"))
    tree: dict = {}
    for (path, _, std), view in zip(mats, _carve(buf, shapes)):
        view.mul_(std)
        _put(tree, path, view)
    nshapes = [s for _, s in norms]
    nbuf = torch.empty(_numel(nshapes), dtype=dtype, device=device)
    nbuf.normal_(1.0, 0.1, generator=generator(device, seed, "norms"))
    for (path, _), view in zip(norms, _carve(nbuf, nshapes)):
        _put(tree, path, view)
    return tree


def prefill_kv(spec, seed: int, layer: int, batch: int, prompt_len: int,
               device, dtype=torch.bfloat16):
    """Layer ``layer``'s prefilled (k, v), (batch, prompt_len, KV, D): k
    N(0, K_STD^2) (a rotated key, as the cache holds it), v N(0, 1)."""
    shape = (batch, prompt_len, spec.n_kv_heads, spec.head_dim)
    g = generator(device, seed, "prefill", layer)
    k = torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, K_STD, generator=g)
    v = torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, 1.0, generator=g)
    return k, v


def first_tokens(seed: int, batch_index: int, batch: int,
                 vocab_size: int) -> np.ndarray:
    """Request batch ``batch_index``'s first tokens, uniform over the
    vocabulary, int32 (batch,)."""
    rng = np.random.default_rng([_np_seed(seed), 7, batch_index])
    return rng.integers(0, vocab_size, size=batch, dtype=np.int32)


def sample_rng(seed: int) -> np.random.Generator:
    """The generator that draws the sequences the check compares."""
    return np.random.default_rng([_np_seed(seed), 11])
