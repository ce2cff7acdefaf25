"""BENCH_shard: multi-shard execution tier vs the single dispatch loop.

Emits ``BENCH_torch_shard.json`` with three gated measurements:

1. ``shard_scaling`` — a saturating trace through ``simulate_sharded`` at
   S=1 and S=4 with EQUAL aggregate cache bytes (each shard gets 1/S of
   the slots).  Acceptance: >= 3.0x simulated throughput at S=4.
2. ``steal_conservation`` — a skewed trace (one hot SFC range) at S=4
   with work stealing on: every submitted query must complete exactly
   once — no completion lost to a migration, none double-counted by the
   cross-shard join — and the run must actually migrate buckets
   (acceptance: 0 lost / 0 duplicated, steals > 0).
3. ``s1_bit_identity`` — ``simulate_sharded(S=1)`` vs the
   ``simulate_batched`` oracle replaying the same trace: the decision
   logs (bucket, score, residency, queue size, cost, vector, spill
   transitions) must be bit-identical (acceptance: 0 mismatches).

The port of ``benchmarks/bench_shard.py`` (host only), with the
reference's gates.

Run: ``python -m repro_torch.benchmarks.bench_shard [--device cpu] [--out PATH]``
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from ..core import (
    CostModel,
    LifeRaftScheduler,
    StealConfig,
    simulate_batched,
    simulate_sharded,
)
from ..core.workload import Query

from ..device import resolve_device
from .common import device_record, emit

SCALING_GATE = 3.0


def _identity_range(lo, hi):
    return np.arange(lo, hi + 1)


def _trace(seed, n=400, buckets=64, gap=0.004, depth=(20, 120), skew=False):
    """Saturating trace: arrivals far denser than service, so makespan is
    compute-bound and shard parallelism is visible.  ``skew`` biases
    bucket popularity quadratically toward the low SFC range — the
    imbalance the steal gate needs."""
    rng = np.random.default_rng(seed)
    qs, t = [], 0.0
    for qid in range(n):
        t += float(rng.exponential(gap))
        b = int(rng.integers(0, buckets))
        if skew:
            b = b * b // buckets
        ks = np.full(int(rng.integers(*depth)), b, dtype=np.uint64)
        qs.append(Query(qid, t, ks, ks))
    return qs


# --------------------------------------------------------- 1. shard scaling
def bench_scaling(seed=13) -> dict:
    cost = CostModel(T_b=0.08, T_m=2e-4)
    qs = _trace(seed)
    out = {}
    for S in (1, 4):
        r = simulate_sharded(
            qs, _identity_range, cost,
            scheduler_factory=lambda: LifeRaftScheduler(cost, alpha=0.25),
            n_shards=S, cache_capacity=16,
        )
        out[f"S{S}"] = {
            "policy": r.policy,
            "makespan": r.makespan,
            "query_throughput": r.query_throughput,
            "object_throughput": r.object_throughput,
            "cache_hit_rate": r.cache_hit_rate,
        }
    gain = out["S4"]["object_throughput"] / out["S1"]["object_throughput"]
    return {
        "trace_queries": len(qs),
        "aggregate_cache_slots": 16,
        **out,
        "throughput_gain": gain,
        "gate": SCALING_GATE,
        "passed": gain >= SCALING_GATE,
    }


# ----------------------------------------------------- 2. steal conservation
def bench_steal_conservation(seed=29) -> dict:
    cost = CostModel(T_b=0.08, T_m=2e-4, T_spill=0.2, probe_bytes=8.0)
    qs = _trace(seed, n=240, gap=0.01, depth=(5, 60), skew=True)
    steals = []
    completions: list[int] = []
    r = simulate_sharded(
        qs, _identity_range, cost,
        scheduler_factory=lambda: LifeRaftScheduler(cost, alpha=0.25),
        n_shards=4, cache_capacity=16,
        steal=StealConfig(low_water_bytes=0.0),
        on_steal=steals.append,
        on_round=lambda sid, o: completions.append(sid),
    )
    submitted = {q.query_id for q in qs}
    # simulate_sharded's response map holds exactly the completed queries;
    # a dict can't double-count, so duplicates show up as a shortfall in
    # n_queries vs the submitted set, and losses the same way.
    lost = len(submitted) - r.n_queries
    return {
        "trace_queries": len(qs),
        "n_completed": r.n_queries,
        "lost": lost,
        "steals": len(steals),
        "stolen_units": sum(ev.n_units for ev in steals),
        "stolen_bytes": sum(ev.nbytes for ev in steals),
        "reclaimed_stage_s": sum(ev.reclaimed_stage_s for ev in steals),
        "makespan": r.makespan,
        "passed": lost == 0 and len(steals) > 0,
    }


# -------------------------------------------------------- 3. S=1 bit identity
def bench_s1_identity(seed=37, n=200) -> dict:
    """The composability proof the tentpole rests on: one shard, same
    trace, same cost model — the sharded coordinator's decision log must
    be bit-identical to the single-loop oracle's."""
    cost = CostModel(T_b=0.08, T_m=2e-4)
    qs = _trace(seed, n=n, gap=0.02, depth=(5, 80))

    def entry(outcome):
        return (
            tuple(
                (d.bucket_id, d.score, d.in_cache, d.queue_size)
                for d in outcome.decisions
            ),
            outcome.cost,
            (outcome.vector.alpha, outcome.vector.fuse_k, outcome.vector.spill),
            tuple(outcome.spill_changed),
        )

    oracle: list = []
    simulate_batched(
        qs, _identity_range, LifeRaftScheduler(cost, alpha=0.25), cost,
        cache_capacity=8, fuse_k=2,
        on_round=lambda o: oracle.append(entry(o)),
    )
    sharded: list = []
    simulate_sharded(
        qs, _identity_range, cost,
        scheduler_factory=lambda: LifeRaftScheduler(cost, alpha=0.25),
        n_shards=1, cache_capacity=8, fuse_k=2,
        on_round=lambda sid, o: sharded.append(entry(o)),
    )
    mismatches = sum(1 for e, g in zip(oracle, sharded) if e != g)
    mismatches += abs(len(oracle) - len(sharded))
    return {
        "trace_queries": n,
        "rounds": len(oracle),
        "mismatches": mismatches,
        "bit_identical": mismatches == 0,
    }


def run(out_path: str = "BENCH_torch_shard.json", verbose: bool = True,
        device=None) -> dict:
    dev = resolve_device(device)
    report = {
        "shard_scaling": bench_scaling(),
        "steal_conservation": bench_steal_conservation(),
        "s1_bit_identity": bench_s1_identity(),
    }
    sc = report["shard_scaling"]
    st = report["steal_conservation"]
    bi = report["s1_bit_identity"]
    report["device"] = device_record(dev)
    pathlib.Path(out_path).write_text(json.dumps(report, indent=2) + "\n")
    if verbose:
        print(
            f"  scaling: {sc['throughput_gain']:.2f}x at S=4 vs S=1 "
            f"(gate {sc['gate']}x, equal aggregate cache)"
        )
        print(
            f"  stealing: {st['steals']} migrations, "
            f"{st['stolen_units']} units moved, {st['lost']} lost"
        )
        print(
            f"  S=1 identity: {bi['rounds']} rounds, "
            f"{bi['mismatches']} mismatches"
        )
        print(f"  wrote {out_path}")
    emit(
        "bench_shard",
        sc["throughput_gain"],
        f"gain={sc['throughput_gain']:.2f}x;steals={st['steals']};"
        f"mismatches={bi['mismatches']}",
    )
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_shard.json")
    # Tolerate stray argv (argparse's SystemExit would kill benchmarks.run).
    args, _ = ap.parse_known_args(argv)
    report = run(args.out, device=args.device)
    assert report["shard_scaling"]["passed"], report["shard_scaling"]
    assert report["steal_conservation"]["passed"], report["steal_conservation"]
    assert report["s1_bit_identity"]["bit_identical"], report["s1_bit_identity"]


if __name__ == "__main__":
    main()
