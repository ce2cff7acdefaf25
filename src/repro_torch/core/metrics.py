"""Workload-throughput and aged-workload-throughput metrics (paper §3.2-3.3).

Eq. 1:  U_t(i) = |W_i| / (T_b * phi(i) + T_m * |W_i| + T_spill * sigma(i))
Eq. 2:  U_a(i) = U_t(i) * (1 - alpha_i) + A(i) * alpha_i

with |W_i| the bucket's pending-object count, T_b the bucket read cost,
T_m the per-object match cost, phi(i) = 0 iff the bucket is cached,
sigma(i) in [0, 1] the *fraction* of the bucket's workload bytes spilled
to host (§6 workload overflow: a spilled workload pays a pro-rated
read-back surcharge, so it is deprioritized until its age term reclaims
it; whole-queue spill is the sigma = 1 special case and reproduces the
historical boolean semantics bit for bit), and A(i) the age (ms) of the
oldest pending request.  ``alpha_i`` is per-bucket when the multi-tenant
control plane is active (each tenant class runs its own alpha law) and
the scalar Eq. 2 blend otherwise.

The paper combines U_t (objects/sec) and A (ms) on raw scales; we reproduce
that faithfully (``normalized=False``) and additionally offer a
scale-normalized blend (``normalized=True``).  Normalization used to divide
each term by its max over the candidate set, which coupled every score
through two global maxima and forced the scheduler back to O(B) rescans.
It is now *monotone rebased*: U_t is divided by its supremum 1/T_m (so the
throughput term lands in (0, 1]) and A by the fixed ``age_scale_ms``
horizon — both are per-bucket quantities, so argmax U_a still admits a
now-independent rebased key and the incremental heap path applies
(docs/perf.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional, Union

__all__ = [
    "CostModel",
    "workload_throughput",
    "aged_workload_throughput",
    "per_tenant_latency",
    "dispatch_stats",
    "PAPER_COST_MODEL",
]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Empirical cost constants (paper §5: T_b=1.2 s, T_m=0.13 ms on SDSS).

    For the TPU serving instantiation these are derived from the roofline:
    T_b = bucket_bytes / HBM_bw (state residency cost) and
    T_m = max(flops/peak, bytes/bw) per request.

    ``T_spill`` is the §6 overflow read-back surcharge a *fully* spilled
    workload queue pays on top of the bucket read (0 disables the score
    effect); a partially spilled queue pays it pro-rated by its spilled
    byte fraction sigma.  ``age_scale_ms`` is the fixed age-normalization
    horizon used by ``normalized=True`` scoring.  ``probe_bytes`` is the
    size of one pending probe object's host-side state — the §6 overflow
    budget is denominated in these actual bytes, not object counts — and
    ``min_unit_bytes`` floors each pending unit's price (>= 1 byte by
    default) so degenerate units (e.g. zero-length serving prompts)
    cannot free-ride the budget and sigma at zero cost.
    """

    T_b: float = 1.2  # seconds to read one bucket from backing store
    T_m: float = 0.13e-3  # seconds to match one object in memory
    T_spill: float = 0.0  # seconds to page a fully spilled queue back in
    age_scale_ms: float = 1e3  # normalized=True age horizon (ms)
    probe_bytes: float = 1.0  # bytes of spillable state per pending object
    min_unit_bytes: float = 1.0  # floor per pending unit (§6 budget currency)

    def batch_cost(
        self, queue_size: int, in_cache: bool,
        spilled: Union[bool, float] = False,
    ) -> float:
        """Wall-clock cost of servicing one bucket batch (denominator of
        Eq. 1).  ``spilled`` is the spilled byte fraction sigma in [0, 1];
        booleans are accepted for the legacy whole-queue semantics (True
        multiplies by exactly 1.0, so scores are bit-identical)."""
        cost = self.T_b * (0.0 if in_cache else 1.0) + self.T_m * queue_size
        if spilled:
            cost += self.T_spill * float(spilled)
        return cost


PAPER_COST_MODEL = CostModel(T_b=1.2, T_m=0.13e-3)


def workload_throughput(
    queue_size: int, in_cache: bool, cost: CostModel,
    spilled: Union[bool, float] = False,
) -> float:
    """Eq. 1 — objects consumed per second if this bucket is scheduled now.

    ``spilled`` is the spilled byte fraction sigma (bool == legacy whole-
    queue semantics, numerically identical to sigma = 1.0)."""
    if queue_size <= 0:
        return 0.0
    return queue_size / cost.batch_cost(queue_size, in_cache, spilled)


def aged_workload_throughput(
    queue_sizes: Mapping[int, int],
    ages_ms: Mapping[int, float],
    cached: Mapping[int, bool],
    cost: CostModel,
    alpha: float,
    normalized: bool = False,
    spilled: Optional[Mapping[int, Union[bool, float]]] = None,
    alpha_by_bucket: Optional[Mapping[int, float]] = None,
) -> dict[int, float]:
    """Eq. 2 for every candidate bucket; returns {bucket_id: U_a}.

    ``alpha`` = 0 -> pure greedy (most contentious data first);
    ``alpha`` = 1 -> arrival order (oldest request first), I/O sharing intact.
    ``alpha_by_bucket`` overrides the scalar per bucket — the multi-tenant
    control plane's per-tenant alpha laws land here (a bucket owned by the
    interactive tenant class blends with that tenant's alpha while a batch
    bucket in the same candidate set blends with its own).
    ``spilled`` maps bucket -> sigma, the spilled byte fraction (bools
    accepted for whole-queue legacy semantics).

    NOTE: the ``normalized=True`` arithmetic below (multiply by ``cost.T_m``
    and by the reciprocal of ``cost.age_scale_ms``, then blend) is the
    oracle expression the incremental scheduler's finalist re-rank
    reproduces term for term — keep them in lockstep or decision
    bit-identity breaks (see ``LifeRaftScheduler._select_one``).
    """
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0,1], got {alpha}")
    ut = {
        b: workload_throughput(
            n,
            bool(cached.get(b, False)),
            cost,
            spilled.get(b, False) if spilled else False,
        )
        for b, n in queue_sizes.items()
    }
    age = {b: float(ages_ms.get(b, 0.0)) for b in queue_sizes}
    if normalized:
        inv_age = 1.0 / cost.age_scale_ms
        ut = {b: v * cost.T_m for b, v in ut.items()}
        age = {b: v * inv_age for b, v in age.items()}
    if alpha_by_bucket is None:
        return {b: ut[b] * (1.0 - alpha) + age[b] * alpha for b in queue_sizes}
    out = {}
    for b in queue_sizes:
        a = float(alpha_by_bucket.get(b, alpha))
        if not 0.0 <= a <= 1.0:
            raise ValueError(f"alpha[{b}] must be in [0,1], got {a}")
        out[b] = ut[b] * (1.0 - a) + age[b] * a
    return out


def dispatch_stats(loop) -> dict[str, float]:
    """Device-dispatch rollup for a DispatchLoop — the shared-plan win
    surface: ``device_dispatches`` counts actual kernel launches (a shared
    plan issues fewer than one per bucket or per predicate class) and
    ``shared_batch_occupancy`` the mean query fill of the shared calls."""
    return {
        "batches": int(loop.batches),
        "dispatches": int(loop.dispatches),
        "device_dispatches": int(getattr(loop, "device_dispatches", 0)),
        "shared_batch_occupancy": float(
            getattr(loop, "shared_batch_occupancy", 0.0)
        ),
    }


def per_tenant_latency(
    response_s: Mapping[int, float],
    tenant_of: Union[Mapping[int, str], Callable[[int], str]],
    makespan: float,
    tenants: Iterable[str] = (),
) -> dict[str, dict]:
    """Per-tenant-class latency/throughput rollup over completed queries.

    ``response_s`` maps query/request id -> response seconds;
    ``tenant_of`` maps the id to its tenant class (mapping or callable).
    Returns ``{tenant: {n, p50_response, p95_response, mean_response,
    throughput}}`` — the per-class SLO surface the multi-tenant control
    plane is steering (interactive p95 vs batch throughput).  ``tenants``
    seeds classes that should appear even with zero completions.

    A tenant with **no completed queries** reports ``n=0`` and ``None``
    for every latency stat — a slice with nothing in it has no latency,
    and reporting 0.0 made it indistinguishable from true zero latency
    (summaries must skip or surface it, never average it in).
    """
    import numpy as np

    lookup = tenant_of if callable(tenant_of) else (
        lambda qid: tenant_of.get(qid, "default")  # type: ignore[union-attr]
    )
    groups: dict[str, list[float]] = {t: [] for t in tenants}
    for qid, resp in response_s.items():
        groups.setdefault(lookup(qid), []).append(float(resp))
    makespan = max(makespan, 1e-9)
    out = {}
    for tenant, resp in sorted(groups.items()):
        if not resp:
            out[tenant] = {
                "n": 0,
                "p50_response": None,
                "p95_response": None,
                "max_response": None,
                "mean_response": None,
                "throughput": 0.0,
            }
            continue
        arr = np.asarray(sorted(resp), dtype=np.float64)
        out[tenant] = {
            "n": int(len(arr)),
            "p50_response": float(np.percentile(arr, 50)),
            "p95_response": float(np.percentile(arr, 95)),
            "max_response": float(arr[-1]),
            "mean_response": float(arr.mean()),
            "throughput": len(arr) / makespan,
        }
    return out
