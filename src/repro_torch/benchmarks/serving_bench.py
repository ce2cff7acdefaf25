"""Beyond-paper: LifeRaft continuous batching for multi-tenant LLM serving.

The port of ``benchmarks/serving_bench.py`` (host only: the engine's
simulated clock, no decode).  Buckets = LoRA-adapter weight groups (8 GB
tenant state), cache = 4 HBM slots, trace = Zipf tenant popularity with
Poisson arrivals.  Compares NoShare (per-request FCFS), RR, LifeRaft
greedy / aged -- same four systems as the paper's Fig. 7, on the serving
side.  ``python -m repro_torch.benchmarks.serving_bench``"""
from __future__ import annotations

import argparse

import numpy as np

from ..device import resolve_device
from ..serving import AdapterSpec, LifeRaftEngine, Request, ServeConfig
from .common import device_record, emit, write_report

__all__ = ["make_requests", "run", "main"]


def make_requests(n=600, n_adapters=16, rate=150.0, zipf=1.4, seed=5):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_adapters + 1) ** zipf
    w /= w.sum()
    t = 0.0
    out = []
    for i in range(n):
        t += rng.exponential(1.0 / rate)
        out.append(
            Request(
                request_id=i,
                adapter_id=int(rng.choice(n_adapters, p=w)),
                arrival_time=t,
                prompt_len=int(rng.integers(16, 256)),
                max_new_tokens=32,
            )
        )
    return out


def run(verbose: bool = True, device=None,
        out_path: str | None = "BENCH_torch_serving_bench.json") -> dict:
    dev = resolve_device(device)
    adapters = [AdapterSpec(i, 8 << 30) for i in range(16)]
    rows = {}
    for policy, alpha in [
        ("noshare", 0.0), ("rr", 0.0),
        ("liferaft", 0.0), ("liferaft", 0.25), ("liferaft", 1.0),
    ]:
        eng = LifeRaftEngine(
            adapters, ServeConfig(policy=policy, alpha=alpha, adapter_slots=4)
        )
        s = eng.run(make_requests())
        key = f"{policy}(a={alpha})" if policy == "liferaft" else policy
        rows[key] = s
        if verbose:
            print(
                f"  {key:16s} tok/s={s['token_throughput']:9.1f} "
                f"resp={s['mean_response']:7.3f}s p95={s['p95_response']:7.3f}s "
                f"hit={s['cache_hit_rate']:5.3f} batches={s['batches']} "
                f"indexed={s['indexed_batches']}"
            )
    speedup = rows["liferaft(a=0.0)"]["token_throughput"] / max(
        rows["noshare"]["token_throughput"], 1e-9
    )
    emit("serving_bench", 0.0, f"liferaft/noshare_tokens={speedup:.2f}x")
    report = {"policies": rows, "liferaft_over_noshare_tokens": speedup,
              "device": device_record(dev)}
    if out_path:
        write_report(out_path, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="BENCH_torch_serving_bench.json")
    args, _ = ap.parse_known_args(argv)
    return run(device=args.device, out_path=args.out)


if __name__ == "__main__":
    main()
