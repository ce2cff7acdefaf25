"""The system under test and the closed loop that drives it.

``Server`` builds the port's serving path for a cell: the configuration
file mapped to ``repro_torch``'s ``ModelConfig``, the benchmark's weights
(checked leaf for leaf against the port's own parameter tree), the cache
from ``models.registry.make_cache`` with each layer's prompt K/V written
into it, and ``training.train_step.make_serve_step``, which runs
``lm_decode_step``: K4 in every layer, K5 (MoE) or the MLP's products,
the head and a greedy token.

The loop is closed: each of B users waits for its token before the next
step, and after every step the B tokens are copied to the host, as
streaming them costs.  The timestamp after that copy is each token's
delivery.  A request batch decodes ``new_tokens`` from position
``prompt_len``; the next starts from the same prefilled state (``pos``
back to ``prompt_len``; decoding writes only slots past it) with fresh
first tokens drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from . import inputs

__all__ = ["port_config", "Server", "Window", "WARM_BATCH"]

WARM_BATCH = 1 << 30  # the warm-up's request batch index (its own tokens)


def port_config(config: dict):
    """The port's ``ModelConfig`` for a configuration file (published
    keys, as run)."""
    from repro_torch.configs.base import ModelConfig

    experts = config.get("num_local_experts", 0)
    acts = {"silu": "swiglu"}
    kw = dict(
        name=config["name"],
        family="moe" if experts else "dense",
        n_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        head_dim=(config.get("head_dim")
                  or config["hidden_size"] // config["num_attention_heads"]),
        d_ff=config["intermediate_size"],
        vocab_size=config["vocab_size"],
        activation=acts[config["hidden_act"]],
        rope_theta=float(config["rope_theta"]),
        sliding_window=config.get("sliding_window"),
        tie_embeddings=config["tie_word_embeddings"],
        norm_eps=float(config["rms_norm_eps"]),
        dtype=config["torch_dtype"],
        remat=False,
    )
    if experts:
        kw.update(n_experts=experts, top_k=config["num_experts_per_tok"],
                  moe_d_ff=config["intermediate_size"])
    return ModelConfig(**kw)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def build_kernels(log) -> None:
    """Load (or, on a checkout's first run, compile) K4's and K5's
    libraries, the two at once."""
    from repro_torch.kernels.grouped_matmul import kernel as gk
    from repro_torch.kernels.paged_attention import kernel as pk

    errors = []

    def one(mod):
        try:
            mod.build()
        except Exception as exc:  # reported below, in this thread
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(m,)) for m in (pk, gk)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, mod in (("K4", pk), ("K5", gk)):
        info = mod.build_info()
        log(f"set-up: {name} library {'built' if info['compiled'] else 'loaded'}"
            f" in {info['seconds']:.3f} s ({info['path']})")


@dataclasses.dataclass
class Window:
    """What the window delivered: every step's gap (s) and position, the
    request batches' tokens ((n + 1, B) int32: first tokens, then each
    step's served tokens; the last may be short until ``finish``), and the
    window's host-clock bounds."""

    t0: float
    t_end: float
    gaps: list
    positions: list
    batches: list
    steps: int
    half: int | None = None  # steps before ``at_half`` ran
    t_half: float | None = None  # when it returned


class Server:
    def __init__(self, cell, spec, seed: int, device, log=print):
        from repro_torch.models import registry
        from repro_torch.training.train_step import make_serve_step

        mix = cell.mix
        self.B, self.P, self.n = mix["batch"], mix["prompt_len"], mix["new_tokens"]
        self.slots = mix["cache_slots"]
        if self.P + self.n > self.slots:
            raise ValueError(f"{cell.name}: prompt_len + new_tokens > cache_slots")
        self.seed, self.device, self.spec = seed, torch.device(device), spec
        self.cfg = port_config(cell.config)
        cuda = self.device.type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize()

        self.sync = sync
        t = time.perf_counter()
        self.weights = inputs.make_weights(spec, seed, self.device,
                                           self.cfg.activation_dtype)
        want = dict(_leaves(registry.abstract_params(self.cfg)))
        have = dict(_leaves(self.weights))
        if {k: tuple(v.shape) for k, v in want.items()} != {
                k: tuple(v.shape) for k, v in have.items()}:
            raise ValueError("the benchmark's weight tree differs from the "
                             "port's parameter tree")
        sync()
        nbytes = sum(v.numel() * v.element_size() for v in have.values())
        log(f"set-up: weights made in {time.perf_counter() - t:.3f} s "
            f"({nbytes / 1e9:.3f} GB, {sum(v.numel() for v in have.values()) / 1e9:.4f} G params)")
        t = time.perf_counter()
        self.cache = registry.make_cache(self.cfg, self.B, self.slots,
                                         self.device)
        for i in range(spec.n_layers):
            k, v = inputs.prefill_kv(spec, seed, i, self.B, self.P,
                                     self.device, self.cfg.activation_dtype)
            self.cache["k"][i, :, :self.P].copy_(k)
            self.cache["v"][i, :, :self.P].copy_(v)
            del k, v
        sync()
        kvb = self.cache["k"].numel() * self.cache["k"].element_size() * 2
        log(f"set-up: K/V filled in {time.perf_counter() - t:.3f} s ("
            f"{self.P} of {self.slots} slots x {self.B} sequences, "
            f"{kvb / 1e9:.3f} GB of cache)")
        self.step_fn = make_serve_step(self.cfg, self.slots)
        self.tok = None
        self.batches: list = []

    def start_batch(self, index: int) -> None:
        """Request batch ``index`` starts: its first tokens to the device,
        the cache back to ``prompt_len``."""
        first = inputs.first_tokens(self.seed, index, self.B,
                                    self.spec.vocab_size)
        self.tok = torch.from_numpy(first).view(self.B, 1).to(self.device)
        self.cache = dict(self.cache, pos=self.P)
        self.batches.append([first])

    def step(self) -> np.ndarray:
        """One decode step of every sequence; its tokens on the host."""
        nxt, self.cache = self.step_fn(self.weights, self.tok, self.cache)
        host = nxt.cpu().numpy()[:, 0]  # the tokens streamed to users
        self.tok = nxt
        self.batches[-1].append(host)
        return host

    def warm(self, steps: int, log=print) -> None:
        """The cell's shapes once: a request batch of its own, ``steps``
        steps, then the batches are forgotten."""
        t = time.perf_counter()
        self.start_batch(WARM_BATCH)
        for _ in range(steps):
            self.step()
        self.sync()
        self.batches.clear()
        log(f"set-up: {steps} warm steps in {time.perf_counter() - t:.3f} s")

    def run_window(self, seconds: float, at_half=None) -> Window:
        """Request batches until ``seconds`` have passed: the window ends
        with the step that crosses it.  ``at_half()``, where given, runs
        once between the steps where half of ``seconds`` is crossed (the
        traced run starts its profiler there); the window's clock stops
        while it runs."""
        clock = time.perf_counter
        gaps, positions = [], []
        half = t_half = None
        t0 = last = clock()
        self.start_batch(0)
        j = 0
        while True:
            self.step()
            t = clock()
            gaps.append(t - last)
            positions.append(self.P + j)
            last = t
            j += 1
            if t - t0 >= seconds:
                break
            if at_half is not None and half is None and t - t0 >= seconds / 2:
                at_half()
                half, t_half = len(gaps), clock()
                t0 += t_half - t  # the pause is not the window's
                last = t_half
            if j == self.n:
                self.start_batch(len(self.batches))
                j = 0
        return Window(t0, last, gaps, positions, self.batches, len(gaps),
                      half, t_half)

    def finish(self) -> None:
        """The request batch in flight decodes to its end (after the
        window: its tokens are not counted, only checked)."""
        while len(self.batches[-1]) < self.n + 1:
            self.step()
        self.sync()

    def written_kv(self, rows: list) -> tuple:
        """The K/V the last request batch wrote for ``rows``: (k, v), each
        (len(rows), L, new_tokens, KV, D), copied out of the cache."""
        idx = torch.tensor(rows, device=self.device)
        sl = slice(self.P, self.P + self.n)
        return (self.cache["k"][:, :, sl].index_select(1, idx).transpose(0, 1)
                .clone(),
                self.cache["v"][:, :, sl].index_select(1, idx).transpose(0, 1)
                .clone())

    def close(self) -> None:
        """Free the program's state (the weights are the benchmark's)."""
        self.cache = None
        self.step_fn = None
        self.tok = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def distinct_tokens(batches: list, steps: int) -> list:
    """How many distinct tokens each of the first ``steps`` steps took in."""
    out = []
    for b in batches:
        for row in b[:-1]:
            if len(out) == steps:
                return out
            out.append(len(np.unique(row)))
    return out


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def summary_line(window: Window, B: int) -> str:
    g = np.asarray(window.gaps) * 1e3
    fifths = [float(np.mean(p)) for p in np.array_split(g, 5) if len(p)]
    return (f"window: {window.steps} steps, {window.steps * B} tokens in "
            f"{window.t_end - window.t0:.6f} s; step ms median "
            f"{float(np.median(g)):.4f}, max {float(g.max()):.4f}, mean by "
            f"fifths of the steps {[round(x, 3) for x in fifths]}; request "
            f"batches {len(window.batches)}")
