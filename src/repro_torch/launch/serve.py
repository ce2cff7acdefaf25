"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the LifeRaft multi-tenant engine against a Poisson/Zipf request trace
with real decode steps of a model; ``--policy`` flips between the paper's
schedulers.  The port of ``repro.launch.serve``, with the same trace, the
same engine and the same decode work: every scheduled batch runs
``quantum`` greedy decode steps of ``DECODE_BATCH`` sequences from zero
tokens, into a fresh ``MAX_SEQ``-slot cache.  Weights come from
``init_params`` with a generator seeded 0 on the device.  ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu`` runs the
plain PyTorch versions of the kernels.

The dense (``codeqwen1.5-7b``) and MoE (``moonshot-v1-16b-a3b``,
``mixtral-8x22b``) families decode; the others raise.

    python -m repro_torch.launch.serve --arch codeqwen1.5-7b --device cpu
    python -m repro_torch.launch.serve --arch codeqwen1.5-7b --full-config
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --device cpu
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --full-config
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config, list_archs, smoke_config
from ..device import resolve_device
from ..models import registry as R
from ..serving import AdapterSpec, LifeRaftEngine, Request, ServeConfig
from ..training.train_step import make_serve_step

__all__ = ["DECODE_BATCH", "MAX_SEQ", "DecodeStats", "build_parser",
           "make_requests", "make_decode_fn", "make_engine", "serve", "main"]

DECODE_BATCH = 8  # sequences decoded per call (B)
MAX_SEQ = 64  # cache slots per sequence


@dataclasses.dataclass
class DecodeStats:
    """What the decode did: calls, steps, tokens and (on the card, when
    asked) each step's CUDA-event time."""

    calls: int = 0
    steps: int = 0
    request_tokens: int = 0  # sum of len(batch) * quantum: the engine's tokens
    padded_tokens: int = 0  # DECODE_BATCH * steps: the rows actually decoded
    events: list = dataclasses.field(default_factory=list)

    def step_ms(self) -> list[float]:
        """Each timed step's milliseconds (synchronises the device)."""
        if not self.events:
            return []
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LifeRaft-PyTorch serving engine")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--policy", default="liferaft",
                    choices=["liferaft", "rr", "noshare"])
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--no-decode", action="store_true",
                    help="scheduling simulation only (no device compute)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    return ap


def make_requests(n: int, tenants: int, rate: float) -> list[Request]:
    """The reference launcher's trace: Poisson arrivals, Zipf(1.5) tenants,
    prompts of 8-63 tokens, 16 new tokens each (numpy seed 0)."""
    rng = np.random.default_rng(0)
    w = 1.0 / np.arange(1, tenants + 1) ** 1.5
    w /= w.sum()
    t, reqs = 0.0, []
    for i in range(n):
        t += rng.exponential(1.0 / rate)
        reqs.append(Request(i, int(rng.choice(tenants, p=w)), t,
                            int(rng.integers(8, 64)), 16))
    return reqs


def make_decode_fn(cfg, params: dict, device: torch.device,
                   stats: DecodeStats, time_steps: bool = False):
    """The engine's ``decode_batch_fn``: ``quantum`` greedy steps of
    ``DECODE_BATCH`` sequences from zero tokens into a fresh cache.  With
    ``time_steps`` (on the card) each step is bracketed by CUDA events."""
    step = make_serve_step(cfg, MAX_SEQ)

    def decode_fn(adapter_id, batch, quantum):
        cache = R.make_cache(cfg, DECODE_BATCH, MAX_SEQ, device=device)
        tok = torch.zeros((DECODE_BATCH, 1), dtype=torch.int32, device=device)
        for _ in range(quantum):
            if time_steps:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                tok, cache = step(params, tok, cache)
                end.record()
                stats.events.append((start, end))
            else:
                tok, cache = step(params, tok, cache)
        stats.calls += 1
        stats.steps += quantum
        stats.request_tokens += len(batch) * quantum
        stats.padded_tokens += DECODE_BATCH * quantum

    return decode_fn


def serve(args: argparse.Namespace, params: Optional[dict] = None,
          time_steps: bool = False) -> tuple[dict, DecodeStats]:
    """Run the engine over the trace; returns (engine summary, decode
    stats).  ``params`` overrides the seeded weights (they must be on
    ``args.device``)."""
    cfg = get_config(args.arch) if args.full_config else smoke_config(args.arch)
    stats = DecodeStats()
    decode_fn = None
    if not args.no_decode:
        device = resolve_device(args.device)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(0)
            params = R.init_params(cfg, gen)
        decode_fn = make_decode_fn(cfg, params, device, stats,
                                   time_steps and device.type == "cuda")
    engine = make_engine(args, decode_fn)
    summary = engine.run(make_requests(args.requests, args.tenants, args.rate))
    return summary, stats


def make_engine(args: argparse.Namespace, decode_fn=None) -> LifeRaftEngine:
    """The launcher's engine: a 4 GiB adapter a tenant, a third of them
    resident, ``args.policy`` at ``args.alpha``; ``decode_fn`` (None: no
    device compute) runs each scheduled batch."""
    return LifeRaftEngine(
        [AdapterSpec(a, 4 << 30) for a in range(args.tenants)],
        ServeConfig(policy=args.policy, alpha=args.alpha,
                    adapter_slots=max(args.tenants // 3, 1)),
        decode_batch_fn=decode_fn,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    s, stats = serve(args)
    if not args.no_decode and args.device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, v in s.items():
        print(f"  {k:20s} {v}")
    if not args.no_decode:
        print(f"decode: {stats.calls} calls, {stats.steps} steps, "
              f"{stats.request_tokens} request tokens, {stats.padded_tokens} "
              f"decoded rows, {wall:.3f}s wall")


if __name__ == "__main__":
    main()
