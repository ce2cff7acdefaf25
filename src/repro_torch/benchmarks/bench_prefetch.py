"""BENCH_prefetch: scan-horizon prefetch pipeline vs the reactive LRU.

Emits ``BENCH_torch_prefetch.json`` with four measurements:

1. ``staged_throughput`` — the same deep-queue trace through the
   simulator with prefetch off (reactive LRU, every miss paid inline)
   and on (scan-horizon staging overlapping compute) at EQUAL cache
   capacity (acceptance: >= 1.3x simulated object throughput).
2. ``decision_equivalence`` — incremental vs naive-oracle scheduler
   replaying the prefetch-ON trace in lockstep through the recorded
   decision logs; the staged residency, peeked horizons and stall
   accounting must not move a single decision between the two paths
   (acceptance: 0 mismatches).
3. ``adaptive_horizon`` — informational: the ControlLoop's AIMD H law on
   a stall-heavy trace (final H, stall rounds before/after deepening).
4. ``serving_overlap`` — informational: the serving engine staging
   adapter weights into HBM slots ahead of dispatch.

The port of ``benchmarks/bench_prefetch.py`` (host only), with the
reference's gates.

Run: ``python -m repro_torch.benchmarks.bench_prefetch [--device cpu] [--out PATH]``
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from ..core import (
    ControlConfig,
    ControlLoop,
    CostModel,
    PrefetchConfig,
    run_policy,
)
from ..core.workload import Query

from ..device import resolve_device
from .common import device_record, emit

THROUGHPUT_GATE = 1.3


def _identity_range(lo, hi):
    return np.arange(lo, hi + 1)


def _deep_trace(seed, n=220, buckets=50, gap=0.05, depth=(50, 400)):
    """Deep queues make per-bucket compute comparable to T_b — the regime
    where staging the next read behind the current compute pays (a
    T_b-dominated trace is channel-bound either way; a T_m-dominated one
    barely misses)."""
    rng = np.random.default_rng(seed)
    qs, t = [], 0.0
    for qid in range(n):
        t += float(rng.exponential(gap))
        b = int(rng.integers(0, buckets))
        ks = np.full(int(rng.integers(*depth)), b, dtype=np.uint64)
        qs.append(Query(qid, t, ks, ks))
    return qs


# ------------------------------------------------------- 1. staged throughput
def bench_throughput(seed=7) -> dict:
    cost = CostModel(T_b=0.08, T_m=2e-4)
    qs = _deep_trace(seed)
    common = dict(alpha=0.25, cache_capacity=8)
    off = run_policy("liferaft", qs, _identity_range, cost, **common)
    on = run_policy(
        "liferaft", qs, _identity_range, cost, **common,
        prefetch=PrefetchConfig(horizon=4, depth=4),
    )
    assert off.n_queries == on.n_queries  # same completions, different clock
    return {
        "trace_queries": len(qs),
        "cache_capacity": 8,
        "reactive": {
            "makespan": off.makespan,
            "object_throughput": off.object_throughput,
            "cache_hit_rate": off.cache_hit_rate,
        },
        "prefetch": {
            "makespan": on.makespan,
            "object_throughput": on.object_throughput,
            "cache_hit_rate": on.cache_hit_rate,
            **on.prefetch,
        },
        "throughput_gain": on.object_throughput / off.object_throughput,
        "gate": THROUGHPUT_GATE,
        "passed": on.object_throughput >= THROUGHPUT_GATE * off.object_throughput,
    }


# ------------------------------------------------- 2. decision equivalence
def bench_equivalence(seed=23, n=160) -> dict:
    """Both schedulers drive their own full prefetch pipeline over the
    same trace; the decision logs (bucket, score, residency, cost) must
    be bit-identical — peek_topk, staged residency churn and stall
    charging all preserve the incremental-vs-oracle invariant."""
    cost = CostModel(T_b=0.08, T_m=2e-4)
    qs = _deep_trace(seed, n=n, depth=(20, 250))
    logs = {}
    for policy in ("liferaft", "liferaft-naive"):
        entries = []

        def rec(outcome, entries=entries):
            entries.append(
                (
                    tuple(
                        (d.bucket_id, d.score, d.in_cache, d.queue_size)
                        for d in outcome.decisions
                    ),
                    outcome.cost,
                    outcome.stall,
                )
            )

        run_policy(
            policy, qs, _identity_range, cost, alpha=0.25, cache_capacity=8,
            normalized=True, fuse_k=2,
            prefetch=PrefetchConfig(horizon=4, depth=4), on_round=rec,
        )
        logs[policy] = entries
    inc, nai = logs["liferaft"], logs["liferaft-naive"]
    mismatches = sum(1 for e, g in zip(inc, nai) if e != g)
    mismatches += abs(len(inc) - len(nai))
    return {
        "trace_queries": n,
        "rounds": len(inc),
        "stall_rounds": sum(1 for e in inc if e[2] > 0.0),
        "mismatches": mismatches,
        "bit_identical": mismatches == 0,
    }


# ------------------------------------------------- 3. adaptive horizon law
def bench_adaptive_horizon(seed=59) -> dict:
    cost = CostModel(T_b=0.08, T_m=2e-4)
    qs = _deep_trace(seed, n=200, buckets=48, gap=0.012, depth=(1, 60))
    ctl = ControlLoop(ControlConfig(
        alpha_init=0.5, alpha_step=0.2, halflife_s=2.0, rate_knee=12.0,
        depth_knee=1_500.0, fuse_k_max=3,
        prefetch_horizon_init=1, prefetch_horizon_max=8,
    ))
    r = run_policy(
        "liferaft", qs, _identity_range, cost, cache_capacity=8,
        normalized=True, control=ctl,
        prefetch=PrefetchConfig(horizon=1, depth=4),
    )
    return {
        "final_horizon": ctl.last.horizon if ctl.last else 0,
        "makespan": r.makespan,
        **r.prefetch,
    }


# ---------------------------------------------------- 4. serving overlap
def bench_serving(seed=61) -> dict:
    from ..serving import AdapterSpec, LifeRaftEngine, Request, ServeConfig

    n_adapters = 8
    w = 1.0 / np.arange(1, n_adapters + 1) ** 1.5
    w /= w.sum()
    adapters = [AdapterSpec(i, 48 << 30) for i in range(n_adapters)]
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for i in range(200):
        t += float(rng.exponential(1.0 / 300.0))
        reqs.append(
            Request(i, int(rng.choice(n_adapters, p=w)), t,
                    int(rng.integers(16, 96)), 32)
        )
    out = {}
    for label, pf in (("reactive", False), ("prefetch", True)):
        eng = LifeRaftEngine(
            adapters,
            ServeConfig(
                policy="liferaft", alpha=0.25, fuse_k=2, max_batch=8,
                prefetch=pf, prefetch_depth=4,
            ),
        )
        s = eng.run([
            Request(r.request_id, r.adapter_id, r.arrival_time,
                    r.prompt_len, r.max_new_tokens)
            for r in reqs
        ])
        out[label] = {
            "makespan": s["makespan"],
            "token_throughput": s["token_throughput"],
            "cache_hit_rate": s["cache_hit_rate"],
            **s["prefetch"],
        }
    out["speedup"] = (
        out["prefetch"]["token_throughput"] / out["reactive"]["token_throughput"]
    )
    return out


def run(out_path: str = "BENCH_torch_prefetch.json", verbose: bool = True,
        device=None) -> dict:
    dev = resolve_device(device)
    report = {
        "staged_throughput": bench_throughput(),
        "decision_equivalence": bench_equivalence(),
        "adaptive_horizon": bench_adaptive_horizon(),
        "serving_overlap": bench_serving(),
    }
    st = report["staged_throughput"]
    eq = report["decision_equivalence"]
    report["device"] = device_record(dev)
    pathlib.Path(out_path).write_text(json.dumps(report, indent=2) + "\n")
    if verbose:
        print(
            f"  staged throughput: {st['throughput_gain']:.2f}x vs reactive "
            f"(gate {st['gate']}x; hit {st['prefetch']['cache_hit_rate']:.2f} "
            f"vs {st['reactive']['cache_hit_rate']:.2f})"
        )
        print(
            f"  equivalence: {eq['rounds']} rounds "
            f"({eq['stall_rounds']} stalled), {eq['mismatches']} mismatches"
        )
        print(
            f"  adaptive H -> {report['adaptive_horizon']['final_horizon']}, "
            f"serving speedup {report['serving_overlap']['speedup']:.3f}x"
        )
        print(f"  wrote {out_path}")
    emit(
        "bench_prefetch",
        st["throughput_gain"],
        f"gain={st['throughput_gain']:.2f}x;mismatches={eq['mismatches']}",
    )
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_prefetch.json")
    # Tolerate stray argv (argparse's SystemExit would kill benchmarks.run).
    args, _ = ap.parse_known_args(argv)
    report = run(args.out, device=args.device)
    assert report["staged_throughput"]["passed"], report["staged_throughput"]
    assert report["decision_equivalence"]["bit_identical"]


if __name__ == "__main__":
    main()
