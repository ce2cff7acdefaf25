"""Prefetch pipeline: stage the committed scan horizon ahead of compute.

The reactive loop pays every bucket miss inline: select, discover the
miss, read for ``T_b`` seconds while the device idles, compute.  The
paper's data-driven ordering makes the *next* reads predictable, so this
module overlaps them with the current round's compute — CasJobs' "stage
the data before the batch window" discipline driven by LifeRaft's own
priority heap.

``PrefetchPipeline`` sits between select and execute in the
``DispatchLoop`` round:

1. **harvest** — stages whose I/O completed by ``now`` land in the
   ``BucketCache`` via ``insert_prefetched`` (a fill, not an access — the
   hit-rate split in ``CacheStats`` stays honest);
2. **resolve demand** — a bucket selected *this* round while still in
   flight is force-completed; the round pays only the *residual* stall
   (``eta - now``), not the full ``T_b`` — the partial win of a prefetch
   that started early but not early enough;
3. **recommit** — the ``ScanPlanner`` commits a fresh horizon from the
   scheduler's top-H peek, the first ``depth`` non-resident horizon
   buckets are issued on the staging channel (double-buffered by
   default: the next bucket loads while the current one computes), and
   the horizon is eviction-protected in the cache.

The staging channel is modeled as ONE serial device (the disk head / the
host->HBM DMA engine): stages queue behind each other on a virtual I/O
clock (``eta = max(channel_free, now) + t_stage``), entirely
deterministic, so decision traces with prefetch on are replayable and
golden-pinnable.  With a real ``fetch`` callable (the cross-match
engine's bucket reads), payload I/O additionally runs on a thread pool —
the *cost accounting* stays on the virtual clock while the bytes move in
the background; harvesting blocks on the future only when the virtual
clock says the stage is due, so threading never perturbs the trace.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Union

from .scanplan import ScanPlanConfig, ScanPlanner

__all__ = [
    "PrefetchConfig", "PrefetchPipeline", "build_pipeline", "prefetch_stats",
]


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    """Prefetch knobs, shared by both engines and the simulator.

    ``horizon`` seeds the planner's lookahead H (the ControlLoop's AIMD
    law may resize it per round); ``depth`` bounds stages in flight on
    the serial channel (2 == classic double buffering); ``t_stage``
    overrides the virtual seconds per staged bucket (default: the cost
    model's ``T_b``); ``workers`` sizes the thread pool when a real
    ``fetch`` is wired in.  ``layout_of`` maps bucket id -> physical file
    position for the planner's elevator sweep (default: the id itself,
    i.e. logical order == physical order).
    """

    horizon: int = 4
    depth: int = 2
    starvation_deferrals: int = 3
    t_stage: Optional[float] = None
    workers: int = 2
    layout_of: Optional[Callable[[int], float]] = None


@dataclasses.dataclass
class _Stage:
    bucket_id: int
    eta: float  # virtual completion time on the serial staging channel
    future: Optional[Future] = None  # real payload read (engines only)
    t_stage: float = 0.0  # service time — the channel interval is [eta - t, eta]

    def payload(self) -> object:
        return self.future.result() if self.future is not None else None


class PrefetchPipeline:
    """Asynchronous bucket staging driven by the committed scan horizon."""

    def __init__(
        self,
        cache,
        planner: ScanPlanner,
        t_stage: Union[float, Callable[[int], float]],
        *,
        fetch: Optional[Callable[[int], object]] = None,
        depth: int = 2,
        workers: int = 2,
    ) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.cache = cache
        self.planner = planner
        self._t_stage = t_stage if callable(t_stage) else (lambda b: float(t_stage))
        self._fetch = fetch
        self.depth = depth
        self._workers = max(1, workers)
        self._pool: Optional[ThreadPoolExecutor] = None  # lazy (see _submit)
        self._inflight: dict[int, _Stage] = {}
        self._io_free = 0.0  # virtual time the staging channel frees up
        self.last_horizon: tuple[int, ...] = ()
        # Per-round staging byte cap from the cross-shard arbiter (None:
        # uncapped — the default, and the whole story off the shard tier).
        # Needs ``nbytes_of`` to price a stage; without one the cap is
        # ignored rather than guessed.
        self.grant_bytes: Optional[float] = None
        self.nbytes_of: Optional[Callable[[int], float]] = None
        # -- telemetry ----------------------------------------------------------
        self.stall_s = 0.0  # cumulative residual stall paid on demand
        self.last_stall = 0.0
        self.staged = 0  # stages issued
        self.fills = 0  # stages landed in the cache
        self.refused = 0  # fills the cache refused (no evictable slot)
        self.demand_waits = 0  # rounds that hit an in-flight stage
        self.canceled = 0  # in-flight stages abandoned (demand disappeared)
        self.reclaimed_s = 0.0  # channel seconds returned by cancels

    # -- the per-round stage (DispatchLoop: between select and execute) ---------
    def stage(
        self, wm, now: float, decisions: Sequence, horizon: Optional[int] = None
    ) -> float:
        """One prefetch round.  Returns the residual stall (seconds) the
        round must pay for decision buckets still in flight; the executor
        then sees them resident and charges no ``T_b``."""
        self._harvest(now)
        stall = 0.0
        demanded = {d.bucket_id for d in decisions}
        waited = False
        for b in list(self._inflight):
            if b in demanded:
                st = self._inflight.pop(b)
                # Charge the residual stall only when the fill actually
                # lands; a refused landing (admission control) means the
                # executor pays its ordinary inline miss — charging the
                # stall on top would bill the round twice for one read.
                if self._land(st):
                    stall = max(stall, st.eta - now)
                    waited = True
        stall = max(0.0, stall)
        if waited:
            self.demand_waits += 1
            self.stall_s += stall
        self.last_stall = stall
        # Recommit the horizon and top up the staging channel.  H counts
        # buckets *beyond* the current dispatch: the peek must reach past
        # the demanded buckets (already being serviced — their I/O is this
        # round's demand read, not lookahead) or a fused round would
        # swallow the whole lookahead and nothing would ever stage.
        h = int(horizon) if horizon else self.planner.cfg.horizon
        plan = self.planner.plan(wm, self.cache, now, h + len(demanded))
        plan = [b for b in plan if b not in demanded]
        self.last_horizon = tuple(plan)
        can_admit = getattr(self.cache, "can_admit_prefetch", None)
        grant = self.grant_bytes if self.nbytes_of is not None else None
        issued_bytes = 0.0
        for b in plan:
            if len(self._inflight) >= self.depth:
                break
            if b in self._inflight or self.cache.contains(b):
                continue
            if can_admit is not None and not can_admit():
                break  # a refused fill would waste the serial channel
            if grant is not None:
                nb = float(self.nbytes_of(b))
                if issued_bytes + nb > grant:
                    break  # arbiter grant exhausted for this round
                issued_bytes += nb
            t = self._t_stage(b)
            eta = max(self._io_free, now) + t
            fut = self._submit(b)
            self._inflight[b] = _Stage(b, eta, fut, t)
            self._io_free = eta
            self.staged += 1
        self.cache.protect(list(plan) + list(self._inflight))
        return stall

    def cancel(self, bucket_id: int, now: float) -> float:
        """Abandon an in-flight stage whose demand disappeared (a stolen
        bucket's pending units left this shard — the fill would land in a
        dead slot).  Charges only the channel time already *spent*: the
        residual service (the part of ``[eta - t_stage, eta]`` after
        ``now``, capped at the full service time if the stage had not yet
        reached the channel head) is reclaimed — every later stage's eta,
        and the channel's free time, shift earlier by it.  Returns the
        reclaimed seconds (0.0 when the bucket is not in flight or its
        I/O already completed)."""
        st = self._inflight.pop(bucket_id, None)
        if st is None or st.eta <= now:
            if st is not None:
                # I/O already done: land it anyway — paid in full, and a
                # resident fill is still a fill (the thief may never come,
                # or the bucket may return).
                self._land(st)
            return 0.0
        reclaimed = min(st.t_stage, st.eta - now)
        if st.future is not None:
            st.future.cancel()
        for other in self._inflight.values():
            if other.eta > st.eta:
                other.eta -= reclaimed
        self._io_free = max(now, self._io_free - reclaimed)
        self.canceled += 1
        self.reclaimed_s += reclaimed
        return reclaimed

    def note_serviced(self, decisions: Sequence) -> None:
        """Forward serviced buckets to the planner (sweep head advance +
        deferral resets)."""
        self.planner.note_serviced([d.bucket_id for d in decisions])

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def close(self) -> None:
        """Reap the worker threads.  Idempotent, and not terminal: the
        pool respawns lazily if more staging arrives (an engine reused
        after ``run()`` keeps working) — callers that drive ``round()``
        directly should close when done rather than leak workers for the
        engine's lifetime."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def _submit(self, bucket_id: int) -> Optional[Future]:
        if self._fetch is None:
            return None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self._workers)
        return self._pool.submit(self._fetch, bucket_id)

    # -- internals ---------------------------------------------------------------
    def _harvest(self, now: float) -> None:
        due = sorted(
            (st for st in self._inflight.values() if st.eta <= now),
            key=lambda st: st.eta,
        )
        for st in due:
            del self._inflight[st.bucket_id]
            self._land(st)

    def _land(self, st: _Stage) -> bool:
        result = self.cache.insert_prefetched(st.bucket_id, st.payload())
        if result is None:
            self.refused += 1
            return False
        self.fills += 1
        return True


def prefetch_stats(pipe: "PrefetchPipeline", cache) -> dict:
    """Rollup of one run's prefetch activity + the honest hit split
    (``SimResult.prefetch`` / the serving ``summary()['prefetch']``)."""
    return {
        "staged": pipe.staged,
        "fills": pipe.fills,
        "refused": pipe.refused,
        "demand_waits": pipe.demand_waits,
        "stall_s": pipe.stall_s,
        "canceled": pipe.canceled,
        "prefetch_hits": cache.stats.prefetch_hits,
        "demand_hits": cache.stats.demand_hits,
        "prefetch_unused": cache.stats.prefetch_unused,
    }


def build_pipeline(
    prefetch: Union[bool, PrefetchConfig],
    scheduler,
    cache,
    default_t_stage: Union[float, Callable[[int], float]],
    *,
    fetch: Optional[Callable[[int], object]] = None,
    layout_of: Optional[Callable[[int], float]] = None,
) -> Optional[PrefetchPipeline]:
    """Coerce an engine's ``prefetch=`` config value — ``False`` (off, the
    default everywhere), ``True`` (defaults), or a ``PrefetchConfig`` —
    into a wired planner + pipeline.  ``default_t_stage`` is the engine's
    staging cost (normally its cost model's ``T_b``; the serving engine
    passes a per-adapter callable); a config ``t_stage`` overrides it.

    Raises ``ValueError`` for a scheduler without ``peek_topk`` (e.g.
    round-robin): the planner would silently commit empty horizons every
    round — prefetch configured but staging nothing is a
    misconfiguration, not a mode."""
    if not prefetch:
        return None
    if not hasattr(scheduler, "peek_topk"):
        raise ValueError(
            f"prefetch requires a scheduler with peek_topk; "
            f"{type(scheduler).__name__} cannot be peeked"
        )
    cfg = prefetch if isinstance(prefetch, PrefetchConfig) else PrefetchConfig()
    planner = ScanPlanner(
        scheduler,
        ScanPlanConfig(
            horizon=cfg.horizon,
            starvation_deferrals=cfg.starvation_deferrals,
            # A config-level layout wins; the engine's catalog-derived
            # layout (caller kwarg) is the default sweep geometry.
            layout_of=cfg.layout_of or layout_of,
        ),
    )
    t_stage = cfg.t_stage if cfg.t_stage is not None else default_t_stage
    return PrefetchPipeline(
        cache, planner, t_stage, fetch=fetch, depth=cfg.depth,
        workers=cfg.workers,
    )
