"""Multi-tenant serving with LifeRaft batching + REAL decode steps.

The port of ``examples/serve_multitenant.py``.  A reduced moonshot-family
MoE model (``smoke_config("moonshot-v1-16b-a3b")``) decodes actual tokens
through ``make_serve_step`` -- paged decode attention (K4) and the
grouped expert matmuls (K5) on ``cuda`` -- while the LifeRaft engine
schedules which tenant's (adapter's) batch runs next: buckets are adapter
weight groups, the cache is HBM adapter slots.  The step runs eagerly
(``jax.jit`` has no counterpart here).  Weights and the tenants' adapter
deltas are drawn from seeded ``torch.Generator``\\ s on the CPU (seed 0;
10 + adapter) and moved to the device.

With ``--adaptive`` the closed-loop control plane (docs/adaptive.md)
retunes alpha / fuse_k / §6 spill every scheduling round from live queue
telemetry instead of running the static knobs.  ``--per-tenant`` goes one
further: adapters 0-1 are the *interactive* class (alpha pinned high --
arrival order), the rest are *batch* (alpha low -- data-driven), each
class running its own control vector with the §6 byte budget arbitrated
between them.

``--metrics`` attaches the observability layer (docs/observability.md)
and dumps the Prometheus text exposition after the run; add
``--metrics-json PATH`` for the consolidated JSON snapshot (metrics +
control-explain + trace rollup).  Metrics ride the side-channel taps, so
the schedule is identical with or without them.  The summary, the decode
counts and the wall go to ``--out``.

    python -m repro_torch.examples.serve_multitenant [--policy liferaft]
    python -m repro_torch.examples.serve_multitenant --adaptive
    python -m repro_torch.examples.serve_multitenant --per-tenant
    python -m repro_torch.examples.serve_multitenant --adaptive --metrics
    python -m repro_torch.examples.serve_multitenant --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ..benchmarks.common import device_record, write_report
from ..configs import smoke_config
from ..core import ControlConfig, TenantPolicy
from ..device import resolve_device
from ..models import registry as R
from ..serving import AdapterSpec, LifeRaftEngine, Request, ServeConfig
from ..training.train_step import make_serve_step

__all__ = ["ARCH", "N_ADAPTERS", "build_parser", "make_params",
           "make_deltas", "run", "main"]

ARCH = "moonshot-v1-16b-a3b"
N_ADAPTERS = 6
MAX_SEQ, MAX_BATCH = 64, 8


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="liferaft",
                    choices=["liferaft", "rr", "noshare"])
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--adaptive", action="store_true",
                    help="closed-loop alpha/fuse_k/spill control per round")
    ap.add_argument("--per-tenant", action="store_true",
                    help="one control vector per adapter class "
                         "(interactive vs batch) + arbitrated byte budget")
    ap.add_argument("--metrics", action="store_true",
                    help="attach observability taps and print the "
                         "Prometheus text exposition after the run")
    ap.add_argument("--metrics-json", metavar="PATH", default=None,
                    help="also write the consolidated obs snapshot "
                         "(implies --metrics)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_serve_multitenant.json")
    return ap


def make_params(cfg, device) -> dict:
    """The model's weights, seeded 0 on the CPU, on ``device``."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = R.init_params(cfg, gen)
    return _to(params, device)


def make_deltas(params: dict, device) -> list:
    """Per-tenant adapters: additive deltas on the unembed (kept tiny here;
    rank-decomposed in a real deployment), seeded 10 + adapter."""
    shape = params["unembed"].shape
    return [
        (0.01 * torch.randn(shape, generator=torch.Generator(
            device="cpu").manual_seed(10 + a))).to(device)
        for a in range(N_ADAPTERS)
    ]


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def run(args: argparse.Namespace, params: Optional[dict] = None,
        deltas: Optional[list] = None, verbose: bool = True) -> dict:
    """Serve the trace; returns the report.  ``params`` and ``deltas``
    override the seeded weights and adapter deltas (on ``args.device``)."""
    if args.metrics_json:
        args.metrics = True
    dev = resolve_device(args.device)
    obs = None
    if args.metrics:
        from ..obs import Observability

        obs = Observability()

    cfg = smoke_config(ARCH)
    if params is None:
        params = make_params(cfg, dev)
    if deltas is None:
        deltas = make_deltas(params, dev)
    serve_step = make_serve_step(cfg, MAX_SEQ)
    decoded_tokens = {a: 0 for a in range(N_ADAPTERS)}
    decode = dict(calls=0, steps=0)

    def decode_batch(adapter_id, batch, quantum):
        """Real decode: swap in the tenant delta, run `quantum` steps."""
        p = dict(params)
        p["unembed"] = params["unembed"] + deltas[adapter_id].to(
            params["unembed"].dtype
        )
        B = MAX_BATCH
        cache = R.make_cache(cfg, B, MAX_SEQ, device=dev)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        for _ in range(quantum):
            tok, cache = serve_step(p, tok, cache)
        decoded_tokens[adapter_id] += quantum * len(batch)
        decode["calls"] += 1
        decode["steps"] += quantum

    rng = np.random.default_rng(0)
    zipf = 1.0 / np.arange(1, N_ADAPTERS + 1) ** 1.5
    zipf /= zipf.sum()
    t, reqs = 0.0, []
    for i in range(args.requests):
        t += rng.exponential(1 / 50.0)
        reqs.append(Request(i, int(rng.choice(N_ADAPTERS, p=zipf)), t,
                            int(rng.integers(8, 32)), 16))

    tenant_policies = None
    if args.per_tenant:
        tenant_policies = (
            TenantPolicy("interactive", ControlConfig(
                alpha_init=0.9, alpha_min=0.7, alpha_max=1.0,
                rate_knee=200.0, depth_knee=64.0, fuse_k_max=2,
            )),
            TenantPolicy("batch", ControlConfig(
                alpha_init=0.2, alpha_min=0.0, alpha_max=0.4,
                rate_knee=200.0, depth_knee=64.0, fuse_k_max=4,
            ), weight=2.0),
        )
    engine = LifeRaftEngine(
        [AdapterSpec(a, 2 << 30,
                     tenant=("interactive" if a < 2 else "batch")
                     if args.per_tenant else "default")
         for a in range(N_ADAPTERS)],
        ServeConfig(policy=args.policy, alpha=args.alpha, adapter_slots=2,
                    max_batch=MAX_BATCH, decode_quantum=16,
                    adaptive=args.adaptive, fuse_k_max=4,
                    spill_budget=4 * MAX_BATCH, spill_penalty_s=5e-3,
                    tenant_policies=tenant_policies,
                    spill_budget_bytes=4096.0 if args.per_tenant else None,
                    kv_bytes_per_token=2.0),
        decode_batch_fn=decode_batch,
        obs=obs,
    )
    mode = ("per-tenant control plane" if args.per_tenant
            else "adaptive closed-loop" if args.adaptive else args.policy)
    if verbose:
        print(f"serving {len(reqs)} requests across {N_ADAPTERS} tenants "
              f"({mode}, reduced moonshot MoE, real decode)...")
    t0 = time.perf_counter()
    s = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    controller = None
    if args.adaptive and engine.control is not None and engine.control.last:
        vec = engine.control.last
        controller = dict(alpha=vec.alpha, fuse_k=vec.fuse_k,
                          rounds=engine.control.rounds)
    if verbose:
        print(f"  completed         : {s['n_completed']}")
        print(f"  token throughput  : {s['token_throughput']:.1f} tok/s (simulated clock)")
        print(f"  mean response     : {s['mean_response']:.3f}s  p95={s['p95_response']:.3f}s")
        print(f"  adapter cache hit : {s['cache_hit_rate']:.2f}")
        if args.per_tenant and s["per_tenant"]:
            print("  per-tenant stats  :")
            print(json.dumps(s["per_tenant"], indent=4))
        elif controller is not None:
            print(f"  controller        : alpha={controller['alpha']:.2f} "
                  f"fuse_k={controller['fuse_k']} "
                  f"rounds={controller['rounds']} spilled={s['spilled']}")
        print(f"  real tokens decoded per tenant: {decoded_tokens}")
        print(f"  decode: {decode['calls']} calls, {decode['steps']} steps, "
              f"{wall:.3f}s wall on {dev.type}")
    if obs is not None:
        if verbose:
            print("\n--- Prometheus exposition " + "-" * 40)
            print(obs.prometheus(), end="")
        if args.metrics_json:
            with open(args.metrics_json, "w") as fh:
                json.dump(obs.snapshot(), fh, indent=1)
                fh.write("\n")
            if verbose:
                print(f"--- snapshot written to {args.metrics_json}")
    report = {
        "mode": mode,
        "requests": args.requests,
        "summary": s,
        "controller": controller,
        "decoded_tokens": {str(a): n for a, n in decoded_tokens.items()},
        "decode_calls": decode["calls"],
        "decode_steps": decode["steps"],
        "layers": cfg.n_layers,
        "wall_s": wall,
        "device": device_record(dev),
    }
    if args.out:
        write_report(args.out, report)
    return report


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
