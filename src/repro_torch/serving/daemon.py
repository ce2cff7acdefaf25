"""Durable service tier: a restartable daemon over the batch engines.

LifeRaft's production descendant (CasJobs) is a *service*: queries arrive
over the network, the submitter goes away, and the system owes them an
answer even across process crashes.  This module is that contract for the
repo's engines:

* **Write-ahead ack** — ``ServiceDaemon.submit`` appends the submission
  to an on-disk :class:`~repro_torch.core.journal.Journal` and ``fsync``\\ s it
  *before* the engine sees the query.  The returned ack therefore implies
  durability: a ``kill -9`` one instruction later loses nothing that was
  acked.
* **Decision journal** — every scheduling round (and steal) the engine
  executes is appended to the same journal through the golden-trace codec
  (``encode_outcome`` / ``encode_steal``), so the journal doubles as a
  decision log diffable against goldens with ``diff_entries``.
* **Crash recovery by replay** — on startup the daemon replays the
  journal: submissions are re-applied in order and, for each journaled
  round, the engine is stepped and its re-executed decision compared
  bit-for-bit against the journaled one (:class:`RecoveryError` on any
  divergence — a recovery that silently re-decides differently is worse
  than a crash).  Rounds that executed before the crash but whose journal
  record was torn off simply re-execute — deterministically, since the
  engines are pure functions of the (submission, round) sequence — and
  are re-journaled.
* **Idempotent resubmission** — clients supply (or the host derives)
  stable keys.  Resubmitting an acked key returns a ``duplicate`` ack
  without re-enqueueing; resubmitting a rejected key re-raises the
  journaled :class:`~repro_torch.core.control.AdmissionRejected` unless
  ``retry=True``.  A client that crashed mid-ack can therefore blindly
  resubmit everything in flight.
* **Admission control** — an optional
  :class:`~repro_torch.core.control.AdmissionController` is consulted *before*
  the write-ahead append, against the tenant's total pending state (both
  residency sides — §6 spill must not launder quota headroom).
  Rejections are journaled with the same fsync barrier so replay
  reproduces every 429 exactly.

Engines plug in through small host adapters (:class:`ServingHost` for
``LifeRaftEngine`` / ``ShardedServingEngine``, :class:`CrossMatchHost`
for ``CrossMatchEngine``) that own item serialization, tenant accounting,
and the decision tap — the daemon itself is engine-agnostic.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.control import AdmissionController, AdmissionRejected
from ..core.journal import (
    Journal,
    diff_entries,
    encode_outcome,
    encode_steal,
)

__all__ = [
    "RecoveryError",
    "ServingHost",
    "CrossMatchHost",
    "ServiceDaemon",
]


class RecoveryError(RuntimeError):
    """Journal replay re-executed a round whose decision diverged from the
    journaled one (or ran out of work before reproducing it).  The engines
    are deterministic given the journaled operation order, so this means
    the code changed underneath the journal — refuse to 'recover' into a
    different schedule."""


# ------------------------------------------------------------------ hosts
class ServingHost:
    """Daemon adapter for :class:`~repro_torch.serving.engine.LifeRaftEngine`
    and :class:`~repro_torch.serving.engine.ShardedServingEngine` (duck-typed on
    the sharded coordinator's ``engines`` list).  Items are
    :class:`~repro_torch.serving.engine.Request` objects — all fields are
    JSON-simple, so the codec is the plain field list."""

    kind = "serving"

    def __init__(self, engine) -> None:
        self.engine = engine
        self._sharded = hasattr(engine, "engines")
        self._engines = engine.engines if self._sharded else [engine]

    # -- decision tap --------------------------------------------------------
    def install_tap(self, emit) -> None:
        if self._sharded:
            self.engine.on_round = (
                lambda sid, outcome: emit(encode_outcome(outcome, shard=sid))
            )
            self.engine.on_steal = lambda ev: emit(encode_steal(ev))
        else:
            self.engine.loop.add_round_tap(
                lambda outcome: emit(encode_outcome(outcome))
            )

    # -- engine drive --------------------------------------------------------
    def submit(self, req) -> None:
        self.engine.submit(req)

    def step(self):
        return self.engine.step()

    def has_work(self) -> bool:
        return any(e.workload.nonempty_queues() for e in self._engines)

    def clock(self) -> float:
        return max(e.clock for e in self._engines)

    # -- item codec ----------------------------------------------------------
    @staticmethod
    def encode_item(req) -> dict:
        return {
            "request_id": int(req.request_id),
            "adapter_id": int(req.adapter_id),
            "arrival_time": float(req.arrival_time),
            "prompt_len": int(req.prompt_len),
            "max_new_tokens": int(req.max_new_tokens),
        }

    @staticmethod
    def decode_item(item: dict):
        from .engine import Request

        return Request(
            request_id=int(item["request_id"]),
            adapter_id=int(item["adapter_id"]),
            arrival_time=float(item["arrival_time"]),
            prompt_len=int(item["prompt_len"]),
            max_new_tokens=int(item["max_new_tokens"]),
        )

    @staticmethod
    def item_key(req) -> str:
        return f"req-{int(req.request_id)}"

    # -- admission accounting ------------------------------------------------
    def tenant_of(self, req) -> str:
        return self._engines[0].workload.tenant_of_adapter(req.adapter_id)

    def size_of(self, req) -> tuple[int, float]:
        wl = self._engines[0].workload
        return 1, max(req.prompt_len * wl.probe_bytes, wl.min_unit_bytes)

    def pending_for_tenant(self, tenant: str) -> tuple[int, float]:
        objs, nbytes = 0, 0.0
        for e in self._engines:
            o, b = e.workload.tenant_pending(tenant)
            objs += o
            nbytes += b
        return objs, nbytes

    # -- completion / state --------------------------------------------------
    def completed_ids(self) -> set:
        return {
            int(r.request_id)
            for e in self._engines
            for r in e.completed
            if r.finish_time is not None
        }

    def state_fingerprint(self) -> dict:
        fp = {"shards": [_engine_fingerprint(e) for e in self._engines]}
        if self._sharded:
            fp["overrides"] = {
                int(b): int(s)
                for b, s in sorted(self.engine.shard_map.overrides.items())
            }
        return fp


class CrossMatchHost:
    """Daemon adapter for the batch cross-match engine
    (:class:`~repro_torch.crossmatch.engine.CrossMatchEngine`).  Items are
    :class:`~repro_torch.core.workload.Query` objects; the codec carries the key
    ranges and payload/meta arrays as typed nested lists."""

    kind = "crossmatch"

    def __init__(self, engine) -> None:
        self.engine = engine

    # -- decision tap --------------------------------------------------------
    def install_tap(self, emit) -> None:
        self.engine.loop.add_round_tap(
            lambda outcome: emit(encode_outcome(outcome))
        )

    # -- engine drive --------------------------------------------------------
    def submit(self, query) -> None:
        # Batch intake bumps the virtual clock like CrossMatchEngine.run —
        # arrivals never travel backwards in time.
        self.engine.sim_clock = max(
            self.engine.sim_clock, query.arrival_time
        )
        self.engine.submit(query)

    def step(self):
        return self.engine.step()

    def has_work(self) -> bool:
        return bool(self.engine.wm.nonempty_queues())

    def clock(self) -> float:
        return self.engine.sim_clock

    # -- item codec ----------------------------------------------------------
    @staticmethod
    def encode_item(query) -> dict:
        return {
            "query_id": int(query.query_id),
            "arrival_time": float(query.arrival_time),
            "keys_lo": np.asarray(query.keys_lo).tolist(),
            "keys_hi": np.asarray(query.keys_hi).tolist(),
            "payload": {
                k: {"dtype": str(np.asarray(v).dtype),
                    "data": np.asarray(v).tolist()}
                for k, v in (query.payload or {}).items()
            },
            "meta": dict(query.meta or {}),
        }

    @staticmethod
    def decode_item(item: dict):
        from ..core.workload import Query

        return Query(
            query_id=int(item["query_id"]),
            arrival_time=float(item["arrival_time"]),
            keys_lo=np.asarray(item["keys_lo"], dtype=np.int64),
            keys_hi=np.asarray(item["keys_hi"], dtype=np.int64),
            payload={
                k: np.asarray(v["data"], dtype=v["dtype"])
                for k, v in item.get("payload", {}).items()
            },
            meta=dict(item.get("meta", {})),
        )

    @staticmethod
    def item_key(query) -> str:
        return f"q-{int(query.query_id)}"

    # -- admission accounting ------------------------------------------------
    @staticmethod
    def tenant_of(query) -> str:
        return query.tenant

    def size_of(self, query) -> tuple[int, float]:
        wm = self.engine.wm
        return query.n_objects, max(
            query.n_objects * wm.probe_bytes, wm.min_unit_bytes
        )

    def pending_for_tenant(self, tenant: str) -> tuple[int, float]:
        return self.engine.wm.tenant_pending(tenant)

    # -- completion / state --------------------------------------------------
    def completed_ids(self) -> set:
        return {int(qid) for qid in self.engine.wm.completed}

    def state_fingerprint(self) -> dict:
        eng = self.engine
        fp = {
            "clock": float(eng.sim_clock),
            "workload": eng.wm.snapshot(),
            "cache": [int(b) for b in eng.cache._entries],
        }
        state = getattr(eng.loop.control, "state", None)
        if callable(state):
            fp["control"] = state()
        fp["sched"] = _sched_fingerprint(
            eng.scheduler, eng.wm, eng.cache, eng.loop.clock
        )
        return fp


def _sched_fingerprint(scheduler, workload, cache, clock, k: int = 8):
    """Top-k (bucket, score) pairs from the scheduler's non-mutating
    oracle — pins the priority index without disturbing it."""
    peek = getattr(scheduler, "peek_topk", None)
    if peek is None:
        return None
    return [
        [int(d.bucket_id), float(d.score)]
        for d in peek(workload, cache, clock, k)
    ]


def _engine_fingerprint(e) -> dict:
    fp = {
        "clock": float(e.clock),
        "workload": e.workload.snapshot(),
        "cache": [int(a) for a in e.cache._entries],
        "completed": sorted(
            int(r.request_id) for r in e.completed
        ),
    }
    state = getattr(e.control, "state", None)
    if callable(state):
        fp["control"] = state()
    fp["sched"] = _sched_fingerprint(
        e.scheduler, e.workload, e.cache, e.clock
    )
    return fp


# ------------------------------------------------------------------ daemon
class ServiceDaemon:
    """Restartable service wrapper: write-ahead acks, decision journal,
    idempotent resubmission, replay recovery, admission control.

    Construction *is* recovery: if ``journal_dir`` holds segments from a
    previous incarnation, they are replayed into the (fresh) engine before
    the constructor returns, and the daemon continues exactly where the
    journaled schedule left off.  Drive it with ``submit`` + ``pump``::

        daemon = ServiceDaemon(ServingHost(engine), "journal/")
        for req in trace:
            daemon.pump(until=req.arrival_time)   # decode up to arrival
            daemon.submit(req)                    # durable ack
        daemon.pump()                             # drain

    The same loop re-run after a crash-and-recover fast-forwards through
    already-acked work (``pump`` no-ops while the recovered clock is
    ahead; ``submit`` dedupes on the key) and continues bit-identically to
    a never-crashed run.
    """

    def __init__(
        self,
        host,
        journal_dir,
        *,
        admission: Optional[AdmissionController] = None,
        segment_bytes: int = 1 << 20,
        obs=None,
    ) -> None:
        self.host = host
        self.admission = admission
        self.journal = Journal(
            journal_dir, segment_bytes=segment_bytes, kind=host.kind
        )
        self.obs = None
        if obs:
            # Lazy import: the default (obs off) never touches repro_torch.obs.
            # The daemon's contribution is the journal append/fsync
            # latency tap, admission verdict counters, and the served
            # metrics_text/metrics_snapshot endpoints; to also see the
            # engine's round metrics, construct the engine with the same
            # Observability instance.
            from ..obs import ensure as _obs_ensure

            self.obs = _obs_ensure(obs)
            self.obs.attach_journal(self.journal)
        # Full in-memory decision log (same entries the journal holds,
        # including rounds recovered by replay) — diffable against a
        # golden via ``diff_entries``.
        self.entries: list[dict] = []
        self.acked: dict[str, dict] = {}  # key -> journaled item
        self.rejected: dict[str, AdmissionRejected] = {}
        self._recovering = False
        self._tap_buf: list[dict] = []
        host.install_tap(self._emit)
        self._recover()
        if self.obs is not None:
            self.obs.note_recovery(
                self._recovered_records, self._recovered_rounds
            )

    # -- decision tap --------------------------------------------------------
    def _emit(self, entry: dict) -> None:
        self.entries.append(entry)
        if self._recovering:
            self._tap_buf.append(entry)
        else:
            self.journal.append({"type": "entry", "entry": entry})

    # -- recovery ------------------------------------------------------------
    def _recover(self) -> None:
        records = self.journal.replay()
        self._recovered_records = len(records)
        self._recovered_rounds = 0
        if not records:
            return
        self._recovering = True
        try:
            for rec in records:
                rtype = rec.get("type")
                if rtype == "submit":
                    self.host.submit(self.host.decode_item(rec["item"]))
                    self.acked[rec["key"]] = rec["item"]
                    # A journaled resubmission supersedes an earlier 429
                    # for the same key (the client retried into headroom).
                    self.rejected.pop(rec["key"], None)
                elif rtype == "reject":
                    self.rejected[rec["key"]] = AdmissionRejected(
                        rec["tenant"], rec["reason"],
                        rec["observed"], rec["limit"],
                    )
                elif rtype == "entry":
                    self._recovered_rounds += 1
                    expect = rec["entry"]
                    while not self._tap_buf:
                        if self.host.step() is None:
                            raise RecoveryError(
                                "journal holds more rounds than the "
                                "replayed workload can produce — journal "
                                "and engine disagree"
                            )
                    got = self._tap_buf.pop(0)
                    diff = diff_entries([expect], [got])
                    if diff:
                        raise RecoveryError(
                            "replayed decision diverged from journal:\n"
                            + "\n".join(diff)
                        )
        finally:
            self._recovering = False
        # Rounds that executed pre-crash but whose journal record was torn
        # off were just re-executed (deterministically) during the final
        # journaled round's catch-up stepping; persist them now.
        for entry in self._tap_buf:
            self.journal.append({"type": "entry", "entry": entry})
        self._tap_buf = []

    # -- intake --------------------------------------------------------------
    def submit(self, item, *, key: Optional[str] = None,
               retry: bool = False) -> dict:
        """Durable, idempotent intake.  Returns ``{"key", "status"}`` with
        status ``acked`` (newly durable) or ``duplicate`` (key already
        acked — the engine is not touched).  Raises
        :class:`~repro_torch.core.control.AdmissionRejected` on quota (journaled
        before raising; resubmits re-raise the cached rejection unless
        ``retry=True``)."""
        key = key if key is not None else self.host.item_key(item)
        if key in self.acked:
            return {"key": key, "status": "duplicate"}
        cached = self.rejected.get(key)
        if cached is not None and not retry:
            raise cached
        if self.admission is not None:
            tenant = self.host.tenant_of(item)
            add_objs, add_bytes = self.host.size_of(item)
            objs, nbytes = self.host.pending_for_tenant(tenant)
            try:
                self.admission.check(
                    tenant, objs, nbytes,
                    add_objects=add_objs, add_bytes=add_bytes,
                )
            except AdmissionRejected as exc:
                # 429s are decisions too: journal with the same fsync
                # barrier so replay reproduces them exactly.
                self.journal.append(
                    {
                        "type": "reject", "key": key, "tenant": exc.tenant,
                        "reason": exc.reason, "observed": exc.observed,
                        "limit": exc.limit,
                    },
                    sync=True,
                )
                self.rejected[key] = exc
                if self.obs is not None:
                    self.obs.note_admission(exc.tenant, False, exc.reason)
                raise
            if self.obs is not None:
                self.obs.note_admission(tenant, True)
        # Write-ahead barrier: the record is fsync'd before the engine
        # sees the item, so the ack below implies durability.
        self.journal.append(
            {"type": "submit", "key": key, "item": self.host.encode_item(item)},
            sync=True,
        )
        self.host.submit(item)
        self.acked[key] = self.host.encode_item(item)
        self.rejected.pop(key, None)
        return {"key": key, "status": "acked"}

    # -- drive ---------------------------------------------------------------
    def pump(self, until: Optional[float] = None) -> int:
        """Run scheduling rounds while work is pending (and, with
        ``until``, while the engine clock is behind it).  Returns the
        number of rounds serviced."""
        serviced = 0
        while self.host.has_work():
            if until is not None and self.host.clock() >= until:
                break
            if self.host.step() is None:
                break
            serviced += 1
        return serviced

    # -- introspection -------------------------------------------------------
    def disposition(self, key: str) -> Optional[str]:
        if key in self.acked:
            return "acked"
        if key in self.rejected:
            return "rejected"
        return None

    def completed(self) -> set:
        """Ids of items whose work has fully completed."""
        return self.host.completed_ids()

    def state_fingerprint(self) -> dict:
        """Plain-data view of the engine's full scheduling state — the
        durability property tests assert replayed == live at every
        truncation point of a recorded run."""
        return self.host.state_fingerprint()

    # -- observability endpoints ---------------------------------------------
    def metrics_text(self) -> str:
        """Prometheus text exposition of the attached Observability (empty
        without ``obs=`` — scraping a dark daemon is not an error)."""
        return self.obs.prometheus() if self.obs is not None else ""

    def metrics_snapshot(self) -> dict:
        """JSON-safe metrics + ControlExplain + trace rollup snapshot."""
        return self.obs.snapshot() if self.obs is not None else {}

    def close(self) -> None:
        self.journal.close()
