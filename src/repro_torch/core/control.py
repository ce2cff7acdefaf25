"""Closed-loop adaptive control plane (paper §4 adaptation + §6 overflow).

The paper's headline mechanism is *adaptation*: LifeRaft "adaptively and
incrementally trades off processing queries in arrival order and
data-driven batch processing" based on workload saturation and queuing
times.  This module centralizes every run-time knob into one feedback
loop so both engines and the simulator make identical control decisions:

    telemetry (per scheduling round)          ControlVector (per round)
    ------------------------------------      -------------------------
    arrival rate   <- SaturationEstimator     alpha   (Eq. 2 blend)
    queue depth/age <- WorkloadManager    ->  fuse_k  (buckets/dispatch)
    cache hit rate <- BucketCache             spill   (§6 overflow)
    batch occupancy <- executor

* ``alpha`` follows the paper's §4 rule when a ``TradeoffTable`` of
  offline curves is available (min response s.t. throughput >= (1-tol) *
  max), and otherwise a table-free fallback that maps EWMA saturation
  (arrival rate + backlog depth) onto [alpha_min, alpha_max]: idle ->
  arrival order (low response), saturated -> data-driven (throughput).
  Either way the step per round is rate-limited (``alpha_step``) so the
  scheduler shifts *gradually*, per the paper's framing.
* ``fuse_k`` is AIMD on batch occupancy: when dispatches run underfull
  and several queues are pending, fuse one more bucket into the next
  grouped device call; when dispatches saturate, back off.
* ``spill`` engages §6 workload overflow (with hysteresis) when resident
  pending probe *bytes* exceed the budget (``spill_budget_bytes``; the
  object-count proxy survives as the legacy ``spill_budget_objects``
  mode); ``apply_spill`` enforces it by walking victim queues
  youngest-first and spilling exactly the deficit — whole queues, then a
  *partial* spill of the boundary victim whose oldest units stay resident
  (spilled bytes pay a pro-rated T_spill surcharge in the scheduler
  score, so they are deprioritized until age reclaims them — never
  starved).

``TenantControlPlane`` lifts all of this to multi-tenant: one ControlLoop
per tenant class (interactive vs batch — CasJobs' queue split, SharedDB's
per-class SLOs) over per-tenant telemetry slices, one shared
SaturationEstimator, and a budget arbiter that waterfills the global §6
byte budget across tenants by weight.

``DispatchLoop`` (core/dispatch.py) is the single consumer: it snapshots
telemetry, calls :meth:`ControlLoop.update` (or the plane's) once per
scheduling round, and applies the resulting vector(s).  Engines never
touch the knobs directly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence

from .adaptive import SaturationEstimator, TradeoffTable

__all__ = [
    "ControlVector",
    "Telemetry",
    "ControlConfig",
    "ControlLoop",
    "TenantPolicy",
    "TenantControlPlane",
    "ShardGrant",
    "ShardControlPlane",
    "AdmissionQuota",
    "AdmissionRejected",
    "AdmissionController",
    "apply_spill",
    "unspill_price",
    "waterfill",
]


@dataclasses.dataclass(frozen=True)
class ControlVector:
    """One scheduling round's control decision, applied by DispatchLoop."""

    alpha: float  # Eq. 2 in-order vs data-driven blend, in [0, 1]
    fuse_k: int  # buckets serviced per fused dispatch, >= 1
    spill: bool  # engage §6 workload overflow this round
    horizon: int = 0  # prefetch lookahead H (0: law disabled, use static H)
    share_width: int = 0  # queries per shared-plan call (0: law disabled)


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Per-round sensor snapshot fed to the controller.  Under the
    multi-tenant plane, one snapshot per tenant class (queues owned by
    that tenant only)."""

    now: float
    arrival_rate: float  # EWMA queries/sec (SaturationEstimator)
    pending_objects: int  # total pending work units across queues
    resident_objects: int  # pending objects NOT spilled to host
    n_queues: int  # nonempty workload queues
    oldest_age_ms: float  # age of the oldest pending request
    cache_hit_rate: float  # BucketCache lifetime hit rate
    occupancy: float  # last dispatch's batch fill fraction, [0, 1]
    pending_bytes: float = 0.0  # total pending probe bytes
    resident_bytes: float = 0.0  # probe bytes NOT spilled (§6 budget target)
    # -- prefetch pipeline signals (all zero without a pipeline) --------------
    prefetch_stall_frac: float = 0.0  # last round's stall share of round time
    prefetch_wasted: int = 0  # prefetched fills evicted untouched last round
    prefetch_inflight: int = 0  # stages in flight on the staging channel
    # -- shared-plan signals (zero without a shared executor) -----------------
    shared_occupancy: float = 0.0  # queries / (chunks * share_width), [0, 1]


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    # -- alpha ---------------------------------------------------------------
    table: Optional[TradeoffTable] = None  # offline §4 curves (preferred)
    tolerance: float = 0.2  # throughput loss tolerated for response
    alpha_init: float = 0.5
    alpha_min: float = 0.0
    alpha_max: float = 1.0
    alpha_step: float = 0.1  # max |d alpha| per round (rate limit)
    halflife_s: float = 30.0  # arrival-rate EWMA halflife
    rate_knee: float = 0.5  # qps at which the fallback saturates
    depth_knee: float = 2_000.0  # backlog at which the fallback saturates
    depth_smoothing: float = 0.2  # EWMA weight for the backlog signal
    # -- fuse_k --------------------------------------------------------------
    fuse_k_init: int = 1
    fuse_k_max: int = 8
    occ_low: float = 0.5  # below: dispatches underfull -> fuse more
    occ_high: float = 0.95  # above: dispatches saturated -> back off
    # -- share_width (shared query plans) -------------------------------------
    share_width_init: int = 8
    share_width_max: int = 0  # 0 disables the law (static width applies)
    share_occ_low: float = 0.5  # below: mostly padding -> narrow the plan
    share_occ_high: float = 0.95  # above: chunks saturate width -> widen
    # -- prefetch horizon H ---------------------------------------------------
    prefetch_horizon_init: int = 4
    prefetch_horizon_max: int = 0  # 0 disables the law (static H applies)
    stall_high: float = 0.05  # stall share of round time: above -> deepen H
    stall_low: float = 1e-3  # at/below this AND fills wasted -> shrink H
    # -- spill ---------------------------------------------------------------
    spill_budget_objects: Optional[int] = None  # legacy object-count budget
    spill_budget_bytes: Optional[float] = None  # byte-accurate §6 budget
    #   (preferred; enables *partial* queue spill — see apply_spill)
    spill_low_water: float = 0.8  # disengage below this fraction
    # Price the *spill* victim walk by each queue's T_spill
    # wait-cost-per-byte (lowest relief-per-byte evicted first), mirroring
    # the unspill-grant pricing.  On by default since the PR 6 golden
    # waiver (see docs/adaptive.md): the goldens of byte-mode scenarios
    # with T_spill > 0 were deliberately re-recorded under the priced
    # walk.  Unpriced walks (no cost model or T_spill == 0) are
    # youngest-first either way; set False to replay pre-waiver traces.
    price_spill_victims: bool = True
    # Legacy unspill: page each spilled queue's whole suffix back in one
    # shot instead of the paged oldest-first protocol.  Wholesale paging
    # is all-or-nothing per queue: a big queue either blocks the walk or
    # lands entirely at once — keep it off unless replaying old traces.
    wholesale_unspill: bool = False


class ControlLoop:
    """The one feedback loop driving alpha, fuse_k, and spill.

    ``observe_arrival`` is O(1) and called on every query/request intake;
    ``update`` is called once per scheduling round by the DispatchLoop and
    returns the ControlVector for that round.
    """

    def __init__(
        self,
        config: ControlConfig = ControlConfig(),
        estimator: Optional[SaturationEstimator] = None,
    ) -> None:
        self.cfg = config
        # ``estimator`` may be shared (TenantControlPlane: one arrival
        # stream feeds every tenant's saturation signal).
        self.estimator = estimator or SaturationEstimator(config.halflife_s)
        self._alpha = min(max(config.alpha_init, config.alpha_min), config.alpha_max)
        self._fuse_k = max(1, int(config.fuse_k_init))
        self._share_width = max(1, int(config.share_width_init))
        self._horizon = max(1, int(config.prefetch_horizon_init))
        self._depth_ewma = 0.0
        self._spilling = False
        self.rounds = 0
        self.last: Optional[ControlVector] = None

    # -- sensors ----------------------------------------------------------------
    def observe_arrival(self, t: float) -> float:
        return self.estimator.observe_arrival(t)

    @property
    def arrival_rate(self) -> float:
        return self.estimator.rate

    # -- the loop ---------------------------------------------------------------
    def update(self, tel: Telemetry) -> ControlVector:
        vec = ControlVector(
            alpha=self._update_alpha(tel),
            fuse_k=self._update_fuse_k(tel),
            spill=self._update_spill(tel),
            horizon=self._update_horizon(tel),
            share_width=self._update_share_width(tel),
        )
        self.last = vec
        self.rounds += 1
        return vec

    # -- alpha law --------------------------------------------------------------
    def _update_alpha(self, tel: Telemetry) -> float:
        cfg = self.cfg
        target = None
        if cfg.table is not None:
            try:
                target = cfg.table.select_alpha(tel.arrival_rate, cfg.tolerance)
            except ValueError:  # empty table -> table-free fallback
                target = None
        if target is None:
            target = self._fallback_target(tel)
        target = min(max(target, cfg.alpha_min), cfg.alpha_max)
        delta = max(-cfg.alpha_step, min(cfg.alpha_step, target - self._alpha))
        self._alpha = min(max(self._alpha + delta, 0.0), 1.0)
        return self._alpha

    def _fallback_target(self, tel: Telemetry) -> float:
        """Table-free EWMA law: saturation in [0,1] from arrival rate and
        backlog depth; idle -> alpha_max (arrival order), saturated ->
        alpha_min (data-driven batch)."""
        cfg = self.cfg
        w = cfg.depth_smoothing
        self._depth_ewma += w * (tel.pending_objects - self._depth_ewma)
        sat = max(
            tel.arrival_rate / cfg.rate_knee if cfg.rate_knee > 0 else 0.0,
            self._depth_ewma / cfg.depth_knee if cfg.depth_knee > 0 else 0.0,
        )
        sat = min(sat, 1.0)
        return cfg.alpha_max - (cfg.alpha_max - cfg.alpha_min) * sat

    # -- fuse_k law -------------------------------------------------------------
    def _update_fuse_k(self, tel: Telemetry) -> int:
        """AIMD on batch occupancy: underfull dispatches with pending breadth
        fuse one more bucket; saturated dispatches back off."""
        cfg = self.cfg
        k = self._fuse_k
        if tel.occupancy < cfg.occ_low and tel.n_queues > k:
            k += 1
        elif tel.occupancy > cfg.occ_high and k > 1:
            k -= 1
        k = max(1, min(k, cfg.fuse_k_max, max(tel.n_queues, 1)))
        self._fuse_k = k
        return k

    # -- share_width law ---------------------------------------------------------
    def _update_share_width(self, tel: Telemetry) -> int:
        """AIMD ceiling on queries per shared-plan device call, bounding
        the pow2 compile shapes the shared kernel can reach.  Polarity is
        the *reverse* of fuse_k's: high shared occupancy means demand
        saturates the current width (the executor is splitting query
        batches into extra chunks) — widen to cut chunk count; low
        occupancy means the last chunk was mostly padding — narrow, so
        compile shapes shrink back.  Disabled (returns 0) unless
        ``share_width_max`` is set, keeping vectors inert for
        configurations without a shared executor."""
        cfg = self.cfg
        if cfg.share_width_max <= 0:
            return 0
        w = self._share_width
        if tel.shared_occupancy > cfg.share_occ_high:
            w += 1
        elif tel.shared_occupancy < cfg.share_occ_low and w > 1:
            w -= 1
        w = max(1, min(w, cfg.share_width_max))
        self._share_width = w
        return w

    # -- prefetch-horizon law -----------------------------------------------------
    def _update_horizon(self, tel: Telemetry) -> int:
        """AIMD-style H sizing, mirroring the fuse_k law: a round that
        stalled on an in-flight stage means the pipeline looked ahead too
        shallowly — deepen the horizon; stall-free rounds that *wasted*
        fills (prefetched buckets evicted untouched) mean it looked too
        far — back off.  Disabled (returns 0) unless
        ``prefetch_horizon_max`` is set, so vectors stay inert for
        configurations without a pipeline."""
        cfg = self.cfg
        if cfg.prefetch_horizon_max <= 0:
            return 0
        h = self._horizon
        if tel.prefetch_stall_frac > cfg.stall_high:
            h += 1
        elif (
            tel.prefetch_stall_frac <= cfg.stall_low
            and tel.prefetch_wasted > 0
            and h > 1
        ):
            h -= 1
        h = max(1, min(h, cfg.prefetch_horizon_max))
        self._horizon = h
        return h

    # -- spill law --------------------------------------------------------------
    def _update_spill(self, tel: Telemetry) -> bool:
        cfg = self.cfg
        if cfg.spill_budget_bytes is not None:
            # Byte-accurate budget (preferred): resident probe bytes vs the
            # §6 memory budget, same hysteresis shape as the legacy law.
            if tel.resident_bytes > cfg.spill_budget_bytes:
                self._spilling = True
            elif tel.pending_bytes <= cfg.spill_budget_bytes * cfg.spill_low_water:
                self._spilling = False
            return self._spilling
        if cfg.spill_budget_objects is None:
            return False
        if tel.resident_objects > cfg.spill_budget_objects:
            self._spilling = True
        elif tel.pending_objects <= cfg.spill_budget_objects * cfg.spill_low_water:
            self._spilling = False
        return self._spilling

    # -- state snapshot -----------------------------------------------------------
    def state(self) -> dict:
        """Plain-data view of the loop's evolving law state (everything a
        future ``update`` depends on besides the telemetry), for the
        durability tier's replayed-state == live-state assertions."""
        return {
            "alpha": self._alpha,
            "fuse_k": self._fuse_k,
            "share_width": self._share_width,
            "horizon": self._horizon,
            "depth_ewma": self._depth_ewma,
            "spilling": self._spilling,
            "rounds": self.rounds,
            "rate": self.estimator.rate,
        }


# --------------------------------------------------------------------------
# Per-tenant admission control (ahead of the spill path)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdmissionQuota:
    """One tenant class's intake limits, checked at submit time — *before*
    work enters the workload manager.  §6 spill absorbs overload that is
    already admitted; admission control is the layer that refuses overload
    at the door (CasJobs-style: a batch service says 429, it does not
    queue unboundedly).  ``None`` disables a dimension."""

    max_queue_depth: Optional[int] = None  # pending objects, both sides
    max_pending_bytes: Optional[float] = None  # pending probe bytes


class AdmissionRejected(Exception):
    """429-style typed rejection raised by ``submit`` when a tenant's
    quota would be exceeded.  Carries enough to journal the decision and
    re-raise it bit-identically on replay."""

    status = 429

    def __init__(
        self, tenant: str, reason: str, observed: float, limit: float
    ) -> None:
        self.tenant = tenant
        self.reason = reason  # "queue_depth" | "pending_bytes"
        self.observed = observed
        self.limit = limit
        super().__init__(
            f"tenant {tenant!r} over {reason} quota: "
            f"{observed!r} + submission > {limit!r}"
        )


class AdmissionController:
    """Per-tenant-class quota check.  ``quotas`` maps tenant -> quota;
    ``default`` applies to unlisted tenants (``None``: unlisted tenants
    are unlimited).  Deterministic: the verdict is a pure function of the
    tenant's current pending state and the submission's size, so a
    journal replay reproduces every rejection exactly."""

    def __init__(
        self,
        quotas: Optional[Mapping[str, AdmissionQuota]] = None,
        default: Optional[AdmissionQuota] = None,
    ) -> None:
        self.quotas = dict(quotas or {})
        self.default = default

    def quota_for(self, tenant: str) -> Optional[AdmissionQuota]:
        return self.quotas.get(tenant, self.default)

    def check(
        self,
        tenant: str,
        pending_objects: int,
        pending_bytes: float,
        add_objects: int = 1,
        add_bytes: float = 0.0,
    ) -> None:
        """Raise :class:`AdmissionRejected` iff admitting a submission of
        ``add_objects``/``add_bytes`` would push the tenant past its
        quota.  Admission counts *total* pending state (resident +
        spilled): spilling must not launder quota headroom."""
        quota = self.quota_for(tenant)
        if quota is None:
            return
        if (
            quota.max_queue_depth is not None
            and pending_objects + add_objects > quota.max_queue_depth
        ):
            raise AdmissionRejected(
                tenant, "queue_depth", float(pending_objects),
                float(quota.max_queue_depth),
            )
        if (
            quota.max_pending_bytes is not None
            and pending_bytes + add_bytes > quota.max_pending_bytes
        ):
            raise AdmissionRejected(
                tenant, "pending_bytes", float(pending_bytes),
                float(quota.max_pending_bytes),
            )


def unspill_price(q, cost, now: Optional[float] = None) -> float:
    """The §6 wait-cost-per-byte of leaving queue ``q`` spilled — the
    arbiter's unspill-grant priority.

    Each service of a spilled queue pays ``T_spill * sigma`` on top of the
    bucket read (Eq. 1), with ``sigma = spilled_bytes / nbytes``; paging
    one byte back in therefore saves ``T_spill / nbytes`` seconds of
    read-back surcharge per future service.  Small queues clear their
    whole surcharge with few bytes, so they page in first — maximum
    surcharge relief per granted byte.

    With ``now`` the price is *deadline-aware*: the base rate is scaled by
    ``1 + age_ms / age_scale_ms``, the same normalization the Eq. 2 age
    term uses, so a spilled queue approaching the §6 starvation bound
    (age ~ ``age_scale_ms``) outbids a cheap young one for the grant —
    and, symmetrically, costs more to evict in the priced victim walk.
    ``now=None`` is the ageless historical price.

    Returns 0.0 (unpriced — walk falls back to oldest-first, which
    already favors the old) without a cost model or with ``T_spill == 0``.
    """
    if cost is None or getattr(cost, "T_spill", 0.0) <= 0.0:
        return 0.0
    base = cost.T_spill / q.nbytes if q.nbytes else 0.0
    if now is None:
        return base
    age_scale = getattr(cost, "age_scale_ms", 0.0)
    if age_scale <= 0.0:
        return base
    age_ms = max(0.0, (now - q.oldest_arrival) * 1e3)
    return base * (1.0 + age_ms / age_scale)


def apply_spill(
    wm,
    vector: ControlVector,
    config: ControlConfig,
    *,
    budget_bytes: Optional[float] = None,
    only: Optional[Callable[[int], bool]] = None,
    cost=None,
    now: Optional[float] = None,
) -> list[int]:
    """Enforce the §6 overflow budget on a workload manager.

    Byte mode (``config.spill_budget_bytes`` set, or ``budget_bytes``
    override from the TenantControlPlane arbiter): the budget is actual
    resident probe bytes.  When ``vector.spill``: walk victim queues
    youngest-first (their requesters have waited least; the age term
    reclaims them later) and spill *exactly* the deficit — whole queues
    while the deficit exceeds them, then a partial ``spill_bucket(b,
    frac)`` on the boundary victim, whose oldest units stay resident.  The
    oldest queue is never fully spilled, so resident work always remains.
    When disengaged: page spilled work back in *paged* — queues ordered
    by their ``T_spill`` wait-cost-per-byte (highest first; see
    ``unspill_price``, fed by ``cost`` — typically the scheduler's
    CostModel — and oldest-first when unpriced), each granted only the
    remaining low-water headroom via ``unspill_bucket(b, budget_bytes=…)``
    so the paged-in bytes can never re-exceed the budget
    (``config.wholesale_unspill`` restores the legacy whole-queue walk).
    ``only`` restricts the walk to one tenant's buckets (per-tenant
    enforcement under the shared loop).  ``now`` (the dispatch clock)
    makes both priced walks deadline-aware — see ``unspill_price``.

    Legacy object mode (``spill_budget_objects``): whole-queue spill on
    the object-count proxy, bit-for-bit the historical behavior.

    Returns the bucket ids whose spill state changed this round.
    """
    if not hasattr(wm, "spill_bucket"):
        return []
    if budget_bytes is not None or config.spill_budget_bytes is not None:
        budget = budget_bytes if budget_bytes is not None else config.spill_budget_bytes
        return _apply_spill_bytes(wm, vector, config, budget, only, cost, now)
    budget = config.spill_budget_objects
    if budget is None:
        return []
    changed: list[int] = []
    nonempty = [
        (q.oldest_arrival, q.bucket_id, q.size)
        for q in wm.nonempty_queues()
        if only is None or only(q.bucket_id)
    ]
    resident = [(t, b, n) for t, b, n in nonempty if not wm.is_spilled(b)]
    resident_total = sum(n for _, _, n in resident)
    if vector.spill:
        # Youngest first == largest oldest_arrival first.
        for t, b, n in sorted(resident, reverse=True):
            if resident_total <= budget or len(resident) - len(changed) <= 1:
                break
            if wm.spill_bucket(b):
                changed.append(b)
                resident_total -= n
    else:
        low = budget * config.spill_low_water
        spilled = sorted(
            (t, b, n) for t, b, n in nonempty if wm.is_spilled(b)
        )  # oldest first
        for t, b, n in spilled:
            if resident_total + n > low:
                break
            if wm.unspill_bucket(b):
                changed.append(b)
                resident_total += n
    return changed


def _apply_spill_bytes(
    wm, vector: ControlVector, config: ControlConfig, budget: float, only,
    cost=None, now: Optional[float] = None,
) -> list[int]:
    """Byte-accurate partial-spill enforcement (see apply_spill)."""
    changed: list[int] = []
    queues = [
        q for q in wm.nonempty_queues() if only is None or only(q.bucket_id)
    ]
    resident_total = sum(q.resident_bytes for q in queues)
    if vector.spill:
        deficit = resident_total - budget
        # Victims youngest-first == largest oldest_arrival first; the
        # oldest queue is walked last and only ever spilled partially.
        victims = sorted(
            (q for q in queues if q.resident_bytes > 0),
            key=lambda q: (q.oldest_arrival, q.bucket_id),
            reverse=True,
        )
        if config.price_spill_victims and victims:
            # Priced walk (mirrors the unspill-grant pricing): evict the
            # queue whose spilled state will cost the *least* future wait
            # per byte freed — lowest T_spill wait-cost-per-byte
            # (== largest nbytes) first, youngest-first on ties, so the
            # unpriced case (no cost model / T_spill == 0) degenerates to
            # the legacy order exactly.  The oldest queue still walks
            # last (and is only ever spilled partially): pricing must not
            # buy throughput with starvation.
            victims.sort(
                key=lambda q: (
                    unspill_price(q, cost, now), -q.oldest_arrival, -q.bucket_id
                )
            )
            oldest = min(victims, key=lambda q: (q.oldest_arrival, q.bucket_id))
            victims.remove(oldest)
            victims.append(oldest)
        for i, q in enumerate(victims):
            if deficit <= 0:
                break
            b = q.bucket_id
            is_last_resident = i == len(victims) - 1
            if q.resident_bytes <= deficit and not is_last_resident:
                frac = 1.0  # whole-queue victim
            else:
                # Boundary victim: spill only the deficit (unit granularity
                # rounds up inside spill_youngest; oldest units stay).
                frac = min(
                    (q.spilled_bytes + deficit) / q.nbytes if q.nbytes else 0.0,
                    1.0 - 1e-12,  # keep_oldest engages even on exact fits
                )
            before = q.resident_bytes
            if wm.spill_bucket(b, frac):
                changed.append(b)
                deficit -= before - q.resident_bytes
    else:
        low = budget * config.spill_low_water
        spilled = [q for q in queues if q.spilled_bytes > 0]
        if config.wholesale_unspill:
            # Legacy whole-queue walk, oldest first: a queue pages back
            # all-or-nothing while its whole suffix fits under low water.
            spilled.sort(key=lambda q: (q.oldest_arrival, q.bucket_id))
            for q in spilled:
                if resident_total + q.spilled_bytes > low:
                    break
                gain = q.spilled_bytes
                if wm.unspill_bucket(q.bucket_id):
                    changed.append(q.bucket_id)
                    resident_total += gain
            return changed
        # Paged unspill: grants priced by T_spill wait-cost-per-byte
        # (highest first; oldest-first tie-break doubles as the whole
        # order when unpriced).  Each queue pages back only the remaining
        # low-water headroom, oldest units first, so no single grant —
        # and no round — can push residency back over the budget.
        spilled.sort(
            key=lambda q: (
                -unspill_price(q, cost, now), q.oldest_arrival, q.bucket_id
            )
        )
        headroom = low - resident_total
        for q in spilled:
            if headroom <= 0.0:
                break
            before = q.resident_bytes
            if wm.unspill_bucket(
                q.bucket_id, budget_bytes=min(q.spilled_bytes, headroom)
            ):
                changed.append(q.bucket_id)
                headroom -= q.resident_bytes - before
    return changed


def waterfill(
    demand: Mapping, weights: Mapping, budget: float
) -> dict:
    """Weighted waterfill of a byte budget over demands — the one arbiter
    both arbitration axes share (tenants within a host, shards across the
    tier).

    Parties demanding less than their weighted share are granted their
    demand; the freed headroom is re-shared (by weight) among the
    still-unsatisfied parties until none remain, and any final slack is
    distributed (by weight) on top of the grants of parties with *nonzero*
    demand, so the grants always sum to *exactly* the budget.  The slack
    matters: it is the headroom that lets a previously spilling party's
    low-water disengage test (``pending <= grant * low_water``) pass once
    global pressure subsides — a grant capped at demand can never satisfy
    it.  Zero-demand parties are excluded from slack (their share is
    re-shared among the demanders): an idle shard/tenant granted phantom
    bytes would carry inflated low-water headroom into its next engaged
    round.  Only when *every* party is zero-demand does the slack fall
    back to all of them, preserving the sum invariant.  Invariants:
    sum(grants) == budget (work-conserving), every grant >= its party's
    satisfied demand.  Missing weights default to 1.0.
    """
    remaining = float(budget)
    # Insertion-ordered list, NOT a set: the float sums below depend on
    # iteration order, and set order over str tenant keys is salted by
    # PYTHONHASHSEED — a recovery replay in a fresh process would derive
    # different grants (det-set-order).  The caller's dict order is
    # deterministic.
    active = list(demand)
    grants: dict = {}
    while active:
        wsum = sum(weights.get(t, 1.0) for t in active)
        if wsum <= 0.0:  # degenerate zero weights: equal shares
            share = {t: remaining / len(active) for t in active}
        else:
            share = {
                t: remaining * weights.get(t, 1.0) / wsum for t in active
            }
        satisfied = [t for t in active if demand[t] <= share[t]]
        if not satisfied:
            grants.update(share)  # everyone over-demands: cap at share
            remaining = 0.0
            break
        for t in satisfied:
            grants[t] = demand[t]
            remaining -= demand[t]
        done = set(satisfied)
        active = [t for t in active if t not in done]
    if remaining > 0.0 and grants:
        takers = [t for t in grants if demand[t] > 0.0] or list(grants)
        wsum = sum(weights.get(t, 1.0) for t in takers)
        for t in takers:
            grants[t] += (
                remaining * weights.get(t, 1.0) / wsum
                if wsum > 0.0
                else remaining / len(takers)
            )
    return grants


# --------------------------------------------------------------------------
# Multi-tenant control plane
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant class's position on the throughput/response dial.

    ``config`` sets the tenant's own feedback laws (an interactive class
    pins ``alpha_min`` high so it never drifts into deep batching; a batch
    class pins ``alpha_max`` low and tolerates spill).  ``weight`` is the
    tenant's share of the *global* §6 byte budget under contention — the
    arbiter's waterfill unit.
    """

    tenant: str
    config: ControlConfig = ControlConfig()
    weight: float = 1.0


class TenantControlPlane:
    """One ControlLoop per tenant class + the §6 budget arbiter.

    CasJobs runs separate batch and interactive queues; SharedDB shows
    shared-work systems still owe per-class latency isolation.  This plane
    is that idea applied to LifeRaft's control loop: every tenant class
    (interactive vs batch — adapter class in the serving engine, query tag
    in the cross-match engine) runs its *own* alpha / fuse_k / spill laws
    over its own telemetry slice, while one shared ``SaturationEstimator``
    sees the global arrival stream (saturation is a property of the
    machine, not of one tenant).

    The **budget arbiter** reconciles per-tenant spill demands against the
    single global byte budget: tenants whose resident bytes fit their
    waterfilled share keep everything resident; surplus is redistributed
    by weight to over-demand tenants, who spill down to their grant.  The
    grants always sum to at most the global budget, so byte-accounted
    residency never exceeds it once enforcement converges (modulo the
    oldest-unit guards that prevent starvation).  Per-tenant hysteresis
    (each policy's ``spill_low_water``) keeps the spill bit from
    oscillating round to round.

    ``DispatchLoop`` consumes this exactly like a ControlLoop, except
    ``update`` takes one Telemetry per tenant and returns one
    ControlVector per tenant.
    """

    def __init__(
        self,
        policies: Sequence[TenantPolicy],
        global_budget_bytes: Optional[float] = None,
        halflife_s: float = 30.0,
    ) -> None:
        if not policies:
            raise ValueError("TenantControlPlane needs at least one policy")
        names = [p.tenant for p in policies]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant policies: {names}")
        self.policies: dict[str, TenantPolicy] = {p.tenant: p for p in policies}
        self.estimator = SaturationEstimator(halflife_s)
        self.loops: dict[str, ControlLoop] = {
            p.tenant: ControlLoop(p.config, estimator=self.estimator)
            for p in policies
        }
        self.global_budget_bytes = global_budget_bytes
        self.granted_bytes: dict[str, float] = {}
        self._engaged: dict[str, bool] = {t: False for t in self.policies}
        self.rounds = 0
        self.last: dict[str, ControlVector] = {}

    # -- sensors ----------------------------------------------------------------
    def observe_arrival(self, t: float) -> float:
        """All tenants' arrivals feed the one shared saturation signal."""
        return self.estimator.observe_arrival(t)

    @property
    def arrival_rate(self) -> float:
        return self.estimator.rate

    def tenants(self) -> list[str]:
        return list(self.policies)

    # -- the loop ---------------------------------------------------------------
    def register_tenant(self, tenant: str, policy: Optional[TenantPolicy] = None) -> None:
        """Add a tenant class at run time.  ``update`` calls this lazily
        for telemetry of unknown classes (default policy, weight 1.0) so
        that *every* observed tenant counts against the global byte budget
        and is spill-enforceable — an untagged class must not be able to
        grow resident state outside the arbiter's books."""
        if tenant in self.policies:
            return
        policy = policy or TenantPolicy(tenant)
        self.policies[tenant] = policy
        self.loops[tenant] = ControlLoop(policy.config, estimator=self.estimator)
        self._engaged[tenant] = False

    def update(self, tels: Mapping[str, Telemetry]) -> dict[str, ControlVector]:
        """One scheduling round: run every tenant's feedback laws on its
        telemetry slice, then arbitrate spill against the global budget."""
        for t in tels:
            self.register_tenant(t)  # unknown classes join the books
        vecs: dict[str, ControlVector] = {}
        for tenant, loop in self.loops.items():
            tel = tels.get(tenant)
            if tel is None:  # idle tenant: empty slice, laws still step
                tel = Telemetry(0.0, self.arrival_rate, 0, 0, 0, 0.0, 0.0, 0.0)
            vecs[tenant] = loop.update(tel)
        if self.global_budget_bytes is not None:
            resident = {
                t: (tels[t].resident_bytes if t in tels else 0.0)
                for t in self.policies
            }
            pending = {
                t: (tels[t].pending_bytes if t in tels else 0.0)
                for t in self.policies
            }
            # Demand is *pending* bytes — what the tenant needs to hold
            # everything resident.  (Using resident bytes here makes the
            # grant chase post-spill residency, so the low-water disengage
            # test `pending <= grant*lw` could never pass and spilled work
            # would stay on host until fully drained by service.)
            self.granted_bytes = self._waterfill(pending)
            for t, vec in vecs.items():
                grant = self.granted_bytes[t]
                low = grant * self.policies[t].config.spill_low_water
                if resident[t] > grant:
                    self._engaged[t] = True
                elif pending[t] <= low:
                    self._engaged[t] = False
                vecs[t] = dataclasses.replace(vec, spill=self._engaged[t])
        self.rounds += 1
        self.last = vecs
        return vecs

    # -- the arbiter -------------------------------------------------------------
    def _waterfill(self, demand: Mapping[str, float]) -> dict[str, float]:
        """Weighted waterfill of the global byte budget over tenant
        demands — the module-level :func:`waterfill` with this plane's
        policy weights (the same arbiter ``ShardControlPlane`` runs over
        shards)."""
        return waterfill(
            demand,
            {t: p.weight for t, p in self.policies.items()},
            float(self.global_budget_bytes or 0.0),
        )


# --------------------------------------------------------------------------
# Cross-shard control tier
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardGrant:
    """One shard's per-round byte grants from the global tier.

    ``spill_bytes`` overrides the shard-local §6 budget for this round
    (None: no global spill budget — the shard's own config governs);
    ``engaged`` is the tier's hysteresis bit for the shard (the local
    spill law is bypassed exactly as the tenant plane bypasses the
    per-loop law).  ``prefetch_bytes`` caps the bytes the shard's
    prefetch pipeline may commit to its staging channel this round
    (None: uncapped).
    """

    spill_bytes: Optional[float] = None
    engaged: bool = False
    prefetch_bytes: Optional[float] = None


class ShardControlPlane:
    """The global control tier over shard-local dispatch loops.

    Shards are an *outer* arbitration axis: exactly as the
    ``TenantControlPlane`` waterfills the §6 byte budget across tenant
    classes within one loop, this plane waterfills the global spill and
    prefetch byte budgets across shards, from per-shard ``Telemetry``
    slices.  Demand on both axes is the shard's *pending* probe bytes —
    what it needs to hold everything resident, and the best available
    proxy for how much staging its queues can absorb (a shard with no
    pending work needs neither residency nor lookahead).  Per-shard
    hysteresis mirrors the tenant plane's: residency above the grant
    engages spill; pending at or below the grant's low-water mark
    disengages it.

    The shard tier (``core/shard.py``) consumes grants by overriding each
    shard loop's spill budget/engagement for the round and capping its
    pipeline's staging bytes; with both budgets ``None`` the plane is
    inert and every shard runs its local laws untouched.
    """

    def __init__(
        self,
        n_shards: int,
        spill_budget_bytes: Optional[float] = None,
        prefetch_budget_bytes: Optional[float] = None,
        weights: Optional[Mapping[int, float]] = None,
        spill_low_water: float = 0.8,
    ) -> None:
        if n_shards < 1:
            raise ValueError(f"need at least one shard, got {n_shards}")
        self.n_shards = int(n_shards)
        self.spill_budget_bytes = spill_budget_bytes
        self.prefetch_budget_bytes = prefetch_budget_bytes
        self.weights = {
            s: (weights.get(s, 1.0) if weights else 1.0)
            for s in range(self.n_shards)
        }
        self.spill_low_water = float(spill_low_water)
        self._engaged: dict[int, bool] = {s: False for s in self.weights}
        self.granted_spill: dict[int, float] = {}
        self.granted_prefetch: dict[int, float] = {}
        self.rounds = 0
        self.last: dict[int, ShardGrant] = {}

    def update(self, tels: Mapping[int, Telemetry]) -> dict[int, ShardGrant]:
        """One global round: waterfill both budgets over the shards'
        telemetry slices and return a grant per shard."""
        pending = {
            s: (tels[s].pending_bytes if s in tels else 0.0)
            for s in self.weights
        }
        resident = {
            s: (tels[s].resident_bytes if s in tels else 0.0)
            for s in self.weights
        }
        grants: dict[int, ShardGrant] = {}
        if self.spill_budget_bytes is not None:
            self.granted_spill = waterfill(
                pending, self.weights, self.spill_budget_bytes
            )
        if self.prefetch_budget_bytes is not None:
            self.granted_prefetch = waterfill(
                pending, self.weights, self.prefetch_budget_bytes
            )
        for s in self.weights:
            spill_grant = (
                self.granted_spill.get(s, 0.0)
                if self.spill_budget_bytes is not None
                else None
            )
            if spill_grant is not None:
                if resident[s] > spill_grant:
                    self._engaged[s] = True
                elif pending[s] <= spill_grant * self.spill_low_water:
                    self._engaged[s] = False
            grants[s] = ShardGrant(
                spill_bytes=spill_grant,
                engaged=self._engaged[s],
                prefetch_bytes=(
                    self.granted_prefetch.get(s, 0.0)
                    if self.prefetch_budget_bytes is not None
                    else None
                ),
            )
        self.rounds += 1
        self.last = grants
        return grants
