"""Tap adapters: the only place observability touches the engines.

Everything here *consumes* the existing side-channel taps —
``DispatchLoop.add_round_tap``, the sharded coordinators' ``on_round`` /
``on_steal``, ``Journal.obs_tap``, and the daemon's admission outcome —
and only ever **reads** the objects it is handed (``DispatchOutcome``,
``StealEvent``, loop/cache/workload state).  Mutating a tapped outcome
would corrupt the journal and the goldens, which consume the same objects;
the ``obs-tap-pure`` lint rule (tools/analysis) enforces this for every
registered tap, including these.

Design constraints (see docs/observability.md):

* **Decision-path untouched** — no tap changes scheduler, cache, workload
  or controller state; every golden replays bit-identically with obs on
  (tested across all scenarios in tests/test_torch_obs.py).
* **Cheap per round** — child metrics are resolved once at attach time;
  the per-round tap is counter adds, up to three histogram bisects, one
  tuple append, and a vector-change tuple compare.  The O(queues) tenant
  walk is sampled every ``ObsConfig.age_sample_every`` rounds (round-count
  based, so virtual-clock determinism is preserved).  The obs-on/obs-off
  throughput ratio is gated >= 0.97x in benchmarks/bench_obs.py.
* **Deterministic on virtual clocks** — nothing wall-clock enters the
  registry unless the tap was attached with ``clock="wall"`` (crossmatch)
  or feeds from real I/O (journal fsync), so simulate/serving snapshots
  are run-to-run identical.
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Optional

from .exporters import metrics_snapshot, perfetto_trace, prometheus_text
from .registry import DEFAULT_TIME_BUCKETS, MetricsRegistry
from .tracer import ControlExplain, RoundTracer

__all__ = ["ObsConfig", "Observability", "ensure"]

# Queue ages span ms .. minutes, not the sub-ms tail the time ladder has.
_AGE_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 300.0,
)

_VEC_FIELDS = ("alpha", "fuse_k", "spill", "share_width", "horizon")
# What telemetry signal drives each control law (docs/adaptive.md): the
# explain message leads with the field's own trigger.
_FIELD_SIGNAL = {
    "alpha": "saturation",
    "fuse_k": "occupancy",
    "spill": "pending_bytes",
    "share_width": "shared_occupancy",
    "horizon": "stall_frac",
}


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Knobs for the observability layer (all bounded, all default-on)."""

    trace: bool = True  # record round spans / steal arrows
    trace_limit: int = 100_000  # spans kept before counting drops
    explain_limit: int = 10_000
    age_sample_every: int = 16  # rounds between O(queues) tenant walks


def ensure(obs) -> Optional["Observability"]:
    """Coerce an ``obs=`` argument: falsy -> None, True -> fresh instance,
    an :class:`Observability` passes through (the way to export later)."""
    if not obs:
        return None
    if obs is True:
        return Observability()
    return obs


class Observability:
    """One registry + tracer + explain channel, attachable to many taps."""

    def __init__(self, config: Optional[ObsConfig] = None) -> None:
        self.config = config or ObsConfig()
        self.registry = MetricsRegistry()
        self.tracer = (
            RoundTracer(limit=self.config.trace_limit)
            if self.config.trace else None
        )
        self.explain = ControlExplain(limit=self.config.explain_limit)
        self._steal_m = None
        self._journal_m = None

    # -- attach points -----------------------------------------------------
    def attach_loop(
        self, loop, *, track: int = 0, clock: str = "virtual",
        name: Optional[str] = None,
    ) -> "_LoopTap":
        """Chain a metrics/tracing tap onto ``loop`` via ``add_round_tap``.

        ``clock="virtual"`` stamps spans on the loop's simulated clock;
        ``clock="wall"`` (crossmatch/daemon) uses ``perf_counter`` marks
        between taps, which additionally measures host-side select time.
        """
        tap = _LoopTap(self, loop, int(track), wall=(clock == "wall"))
        loop.add_round_tap(tap)
        if self.tracer is not None:
            self.tracer.name_track(track, name or f"shard-{track}")
        return tap

    def note_steal(self, ev) -> None:
        """``on_steal`` tap: one work-steal migration (reads ``ev`` only)."""
        m = self._steal_m
        if m is None:
            reg = self.registry
            m = self._steal_m = (
                reg.counter(
                    "liferaft_steals_total",
                    "Work-steal migrations between shards",
                ),
                reg.counter(
                    "liferaft_steal_units_total",
                    "Work units migrated by stealing",
                ),
                reg.counter(
                    "liferaft_steal_bytes_total",
                    "Bytes of pending work migrated by stealing",
                ),
                reg.counter(
                    "liferaft_steal_reclaimed_seconds_total",
                    "Channel seconds refunded by canceling in-flight "
                    "prefetch stages of stolen buckets",
                ),
            )
        m[0].inc()
        m[1].inc(int(ev.n_units))
        m[2].inc(float(getattr(ev, "nbytes", 0.0)))
        m[3].inc(float(getattr(ev, "reclaimed_stage_s", 0.0)))
        if self.tracer is not None:
            self.tracer.note_steal(
                int(ev.victim), int(ev.thief),
                float(getattr(ev, "clock", 0.0)),
                int(ev.bucket_id), int(ev.n_units),
            )

    def chain_steal_tap(self, prev):
        """Return an ``on_steal`` callable firing ``prev`` first (mirrors
        ``add_round_tap`` ordering), then this instance's steal tap."""
        if prev is None:
            return self.note_steal

        def chained(ev, _prev=prev, _obs=self):
            _prev(ev)
            _obs.note_steal(ev)

        return chained

    def attach_journal(self, journal) -> None:
        """Install the append/fsync latency tap (``Journal.obs_tap``)."""
        journal.obs_tap = self._on_journal

    def _on_journal(self, rtype: str, total_s: float, fsync_s) -> None:
        m = self._journal_m
        if m is None:
            reg = self.registry
            m = self._journal_m = (
                reg.histogram(
                    "liferaft_journal_append_seconds",
                    "Wall latency of one journal append (write+flush"
                    "+fsync when synced)",
                ),
                reg.histogram(
                    "liferaft_journal_fsync_seconds",
                    "Wall latency of the fsync barrier on synced appends",
                ),
                {},
            )
        m[0].observe(total_s)
        if fsync_s is not None:
            m[1].observe(fsync_s)
        key = (rtype or "?", fsync_s is not None)
        c = m[2].get(key)
        if c is None:
            c = m[2][key] = self.registry.counter(
                "liferaft_journal_appends_total",
                "Journal records appended",
                type=key[0], synced=str(key[1]).lower(),
            )
        c.inc()

    def note_admission(
        self, tenant: str, accepted: bool, reason: Optional[str] = None,
    ) -> None:
        """Admission-control outcome for one submission."""
        verdict = "accepted" if accepted else "rejected"
        self.registry.counter(
            "liferaft_admission_total",
            "Admission-control verdicts per tenant",
            tenant=tenant, verdict=verdict,
        ).inc()
        if not accepted:
            self.registry.counter(
                "liferaft_admission_rejected_total",
                "Admission rejections by quota reason",
                tenant=tenant, reason=reason or "?",
            ).inc()

    def note_recovery(self, records: int, rounds: int) -> None:
        """Startup recovery scope (journal records / replayed rounds)."""
        reg = self.registry
        reg.gauge(
            "liferaft_recovery_records",
            "Journal records read during startup recovery",
        ).set(records)
        reg.gauge(
            "liferaft_recovery_replayed_rounds",
            "Dispatch rounds re-executed and diffed during recovery",
        ).set(rounds)

    # -- exports -----------------------------------------------------------
    def prometheus(self) -> str:
        return prometheus_text(self.registry)

    def snapshot(self) -> dict:
        out = {
            "metrics": metrics_snapshot(self.registry),
            "control_explain": list(self.explain.events),
        }
        if self.tracer is not None:
            out["trace"] = {
                "rounds": len(self.tracer.rounds),
                "steals": len(self.tracer.steals),
                "dropped": self.tracer.dropped,
                "tracks": self.tracer.tracks(),
            }
        return out

    def perfetto(self) -> dict:
        if self.tracer is None:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        return perfetto_trace(self.tracer)


class _LoopTap:
    """The per-round tap chained onto one DispatchLoop.

    Reads the outcome and the loop's public state; never writes either.
    All child metrics are resolved in ``__init__`` so ``__call__`` stays
    allocation-light.
    """

    __slots__ = (
        "obs", "loop", "track", "wall", "tracer", "explain",
        "age_every", "_round_i",
        "m_rounds", "m_buckets", "m_dev", "h_cost", "h_stall", "h_exec",
        "h_select", "h_wall", "g_hit", "_cache", "_cache_m", "_cache_last",
        "_dev_last", "g_vec", "_vec_last", "_tvec_last",
        "m_spill", "m_spill_bytes", "_tenant_m", "_epoch", "_mark",
    )

    def __init__(self, obs: Observability, loop, track: int, wall: bool):
        reg = obs.registry
        t = str(track)
        self.obs = obs
        self.loop = loop
        self.track = track
        self.wall = wall
        self.tracer = obs.tracer
        self.explain = obs.explain
        self.age_every = max(1, obs.config.age_sample_every)
        self._round_i = 0
        self.m_rounds = reg.counter(
            "liferaft_rounds_total", "Scheduling rounds dispatched",
            track=t,
        )
        self.m_buckets = reg.counter(
            "liferaft_buckets_serviced_total",
            "Bucket batches serviced (fused rounds count each bucket)",
            track=t,
        )
        self.m_dev = reg.counter(
            "liferaft_device_dispatches_total",
            "Device calls issued (< buckets under shared plans)",
            track=t,
        )
        self.h_cost = reg.histogram(
            "liferaft_round_cost_seconds",
            "Total engine-clock cost of one round (stall + execute)",
            track=t,
        )
        self.h_stall = reg.histogram(
            "liferaft_round_stall_seconds",
            "Residual prefetch stall paid by the round (nonzero only)",
            track=t,
        )
        self.h_exec = reg.histogram(
            "liferaft_round_execute_seconds",
            "Execute portion of the round (cost - stall)",
            track=t,
        )
        self.h_select = reg.histogram(
            "liferaft_round_select_seconds",
            "Measured host-side select/plan overhead (wall-clock taps "
            "only; the virtual clock prices selection at zero)",
            track=t,
        ) if wall else None
        self.h_wall = reg.histogram(
            "liferaft_round_wall_seconds",
            "Wall time between consecutive rounds (wall-clock taps only)",
            track=t,
        ) if wall else None
        self.g_hit = reg.gauge(
            "liferaft_cache_hit_ratio", "Cumulative cache hit rate",
            track=t,
        )
        cache = getattr(loop, "cache", None)
        self._cache = getattr(cache, "stats", None)
        self._cache_m = (
            reg.counter(
                "liferaft_cache_demand_hits_total",
                "Cache hits on demand-resident buckets", track=t,
            ),
            reg.counter(
                "liferaft_cache_prefetch_hits_total",
                "Cache hits satisfied by a prefetched fill", track=t,
            ),
            reg.counter(
                "liferaft_cache_misses_total", "Cache misses", track=t,
            ),
            reg.counter(
                "liferaft_cache_evictions_total", "Cache evictions",
                track=t,
            ),
            reg.counter(
                "liferaft_cache_prefetch_unused_total",
                "Prefetched fills evicted untouched", track=t,
            ),
        )
        self._cache_last = self._cache_snapshot()
        self._dev_last = loop.device_dispatches
        self.g_vec = {
            f: reg.gauge(
                f"liferaft_control_{f}",
                f"Applied ControlVector {f} (merged vector under the "
                f"tenant plane)",
                track=t,
            )
            for f in _VEC_FIELDS
        }
        self._vec_last = None
        self._tvec_last: dict = {}
        self.m_spill = (
            reg.counter(
                "liferaft_spill_transitions_total",
                "Buckets spilled to the overflow tier", track=t,
                direction="spill",
            ),
            reg.counter(
                "liferaft_spill_transitions_total",
                "Buckets spilled to the overflow tier", track=t,
                direction="unspill",
            ),
        )
        self.m_spill_bytes = (
            reg.counter(
                "liferaft_spill_bytes_total",
                "Bytes moved across the spill boundary", track=t,
                direction="spill",
            ),
            reg.counter(
                "liferaft_spill_bytes_total",
                "Bytes moved across the spill boundary", track=t,
                direction="unspill",
            ),
        )
        self._tenant_m: dict = {}
        self._epoch = perf_counter() if wall else 0.0
        self._mark = 0.0

    def _cache_snapshot(self):
        st = self._cache
        if st is None:
            return None
        return (
            st.demand_hits, st.prefetch_hits, st.misses,
            st.evictions, st.prefetch_unused,
        )

    # -- the tap (chained after any pre-existing on_round consumers) -------
    def __call__(self, outcome) -> None:
        loop = self.loop
        cost = outcome.cost
        stall = outcome.stall
        exe = cost - stall
        ndec = len(outcome.decisions)
        self.m_rounds.inc()
        self.m_buckets.inc(ndec)
        self.h_cost.observe(cost)
        self.h_exec.observe(exe)
        if stall:
            self.h_stall.observe(stall)
        dd = loop.device_dispatches
        if dd != self._dev_last:
            self.m_dev.inc(dd - self._dev_last)
            self._dev_last = dd
        cur = self._cache_snapshot()
        if cur is not None:
            last = self._cache_last
            if cur != last:
                for m, c, prev in zip(self._cache_m, cur, last):
                    if c != prev:
                        m.inc(c - prev)
                self._cache_last = cur
            self.g_hit.set(self._cache.hit_rate)
        if outcome.spill_changed:
            self._note_spill(outcome.spill_changed)
        vec = outcome.vector
        key = (
            vec.alpha, vec.fuse_k, vec.spill,
            getattr(vec, "share_width", 0), getattr(vec, "horizon", 0),
        )
        if key != self._vec_last:
            self._note_vector(key, self._vec_last, track=str(self.track))
            self._vec_last = key
        tvecs = outcome.tenant_vectors
        if tvecs:
            self._note_tenant_vectors(tvecs)
        self._round_i += 1
        if self._round_i % self.age_every == 0:
            self._sample_tenants()
        tr = self.tracer
        if tr is None:
            return
        if self.wall:
            now = perf_counter() - self._epoch
            wall_dur = now - self._mark
            sel = max(0.0, wall_dur - cost)
            if self.h_select is not None:
                self.h_select.observe(sel)
                self.h_wall.observe(wall_dur)
            # Wall spans: the measured interval, with the select child the
            # slice the cost model cannot see.  Model stall/execute don't
            # nest on the wall axis, so they ride in args via the round
            # histograms instead of as children.
            tr.note_round(
                self.track, self._mark, wall_dur,
                (("select", sel),) if sel > 0.0 else (),
                ndec,
            )
            self._mark = now
        else:
            t1 = loop.clock  # the round just advanced it by cost
            children = (
                (("prefetch_stall", stall), ("execute", exe))
                if stall else (("execute", exe),)
            )
            tr.note_round(self.track, t1 - cost, cost, children, ndec)

    # -- slow paths (change- or sample-triggered) --------------------------
    def _note_spill(self, changed) -> None:
        wm = self.loop.wm
        spilled_frac = getattr(wm, "spilled_fraction", None)
        queues = getattr(wm, "queues", None)
        for b in changed:
            frac = spilled_frac(b) if spilled_frac is not None else 0.0
            q = queues.get(b) if queues is not None else None
            if frac > 0.0:
                self.m_spill[0].inc()
                if q is not None:
                    self.m_spill_bytes[0].inc(
                        float(getattr(q, "spilled_bytes", 0.0))
                    )
            else:
                self.m_spill[1].inc()
                if q is not None:
                    self.m_spill_bytes[1].inc(
                        float(getattr(q, "resident_bytes", 0.0))
                    )

    def _reason(self, field: str, tel) -> str:
        lead = _FIELD_SIGNAL.get(field, "telemetry")
        return (
            f"{lead} moved (rate={tel.arrival_rate:.3g}/s"
            f" depth={tel.pending_objects}"
            f" oldest={tel.oldest_age_ms:.0f}ms"
            f" hit={tel.cache_hit_rate:.2f}"
            f" occ={tel.occupancy:.2f}"
            f" stall={tel.prefetch_stall_frac:.2f})"
        )

    def _note_vector(self, key, last, track: str) -> None:
        gauges = self.g_vec
        tel = None
        for i, f in enumerate(_VEC_FIELDS):
            v = float(key[i])
            gauges[f].set(v)
            if last is not None and key[i] != last[i]:
                if tel is None:
                    tel = self.loop.telemetry()  # pure read; change-rate only
                self.explain.note(
                    track, self.loop.clock, f,
                    float(last[i]), v, self._reason(f, tel),
                )

    def _note_tenant_vectors(self, tvecs) -> None:
        for tname, v in tvecs.items():
            key = (
                v.alpha, v.fuse_k, v.spill,
                getattr(v, "share_width", 0), getattr(v, "horizon", 0),
            )
            last = self._tvec_last.get(tname)
            if key == last:
                continue
            self._tvec_last[tname] = key
            if last is not None:
                tel = self.loop.telemetry()
                for i, f in enumerate(_VEC_FIELDS):
                    if key[i] != last[i]:
                        self.explain.note(
                            f"{self.track}:{tname}", self.loop.clock, f,
                            float(last[i]), float(key[i]),
                            self._reason(f, tel),
                        )

    def _sample_tenants(self) -> None:
        tels = self.loop._tenant_telemetry()  # one O(queues) read-only pass
        reg = self.obs.registry
        for tname in sorted(tels):
            tel = tels[tname]
            m = self._tenant_m.get(tname)
            if m is None:
                m = self._tenant_m[tname] = (
                    reg.histogram(
                        "liferaft_tenant_queue_age_seconds",
                        "Oldest pending-unit age per tenant (sampled "
                        "every age_sample_every rounds)",
                        buckets=_AGE_BUCKETS, tenant=tname,
                    ),
                    reg.gauge(
                        "liferaft_tenant_pending_objects",
                        "Pending objects per tenant", tenant=tname,
                    ),
                    reg.gauge(
                        "liferaft_tenant_pending_bytes",
                        "Pending bytes per tenant", tenant=tname,
                    ),
                )
            m[0].observe(tel.oldest_age_ms / 1e3)
            m[1].set(tel.pending_objects)
            m[2].set(tel.pending_bytes)
