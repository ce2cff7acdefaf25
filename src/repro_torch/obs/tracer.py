"""Span-tree round tracer + the ControlExplain change log.

The tracer records each scheduling round as one span on its track (track =
shard id; unsharded loops are track 0) with nested child spans for the
round's latency breakdown, all on the **engine clock**:

* virtual engines (simulate/serving) — span boundaries are exact virtual
  seconds: ``[clock - cost, clock]`` with ``prefetch_stall`` / ``execute``
  children partitioning the interval (selection is free on the cost
  model's clock, so there is no ``select`` child);
* wall-clock engines (crossmatch, daemon) — span boundaries are
  ``perf_counter`` marks between consecutive taps, so the leading
  ``select`` child is the *measured* host-side select/plan overhead the
  virtual clock cannot see.

Storage is append-only tuples (the tap adapters are on the per-round path;
event-dict construction is deferred to export time — see
``exporters.perfetto_trace``).  Both stores are bounded: past ``limit``
events are counted in ``dropped`` instead of growing without bound under a
long-lived daemon.

``ControlExplain`` is the "why did the controller move" channel: one entry
per ControlVector field change, stamped with the engine clock and a
telemetry-derived reason string ("alpha 0.2->0.35: rate=12/s oldest=514ms").
"""
from __future__ import annotations

__all__ = ["RoundTracer", "ControlExplain"]


class RoundTracer:
    """Bounded store of round spans and steal arrows, keyed by track."""

    __slots__ = ("limit", "dropped", "rounds", "steals", "track_names")

    def __init__(self, limit: int = 100_000) -> None:
        self.limit = int(limit)
        self.dropped = 0
        # (track, t0, dur, children, n_buckets); children is a tuple of
        # (name, dur) pairs laid out consecutively from t0.
        self.rounds: list = []
        # (victim, thief, t, bucket_id, n_units)
        self.steals: list = []
        self.track_names: dict[int, str] = {}

    def name_track(self, track: int, name: str) -> None:
        self.track_names.setdefault(int(track), str(name))

    def note_round(
        self, track: int, t0: float, dur: float, children, n_buckets: int,
    ) -> None:
        if len(self.rounds) >= self.limit:
            self.dropped += 1
            return
        self.rounds.append((track, t0, dur, children, n_buckets))

    def note_steal(
        self, victim: int, thief: int, t: float, bucket_id: int, n_units: int,
    ) -> None:
        if len(self.steals) >= self.limit:
            self.dropped += 1
            return
        self.steals.append((victim, thief, t, bucket_id, n_units))

    def tracks(self) -> list:
        ts = {r[0] for r in self.rounds}
        for v, t, *_ in self.steals:
            ts.add(v)
            ts.add(t)
        return sorted(ts)


class ControlExplain:
    """One entry per ControlVector field change, with the trigger signal."""

    __slots__ = ("limit", "dropped", "events")

    def __init__(self, limit: int = 10_000) -> None:
        self.limit = int(limit)
        self.dropped = 0
        self.events: list = []

    def note(
        self, track, clock: float, field: str, old, new, reason: str,
    ) -> None:
        if len(self.events) >= self.limit:
            self.dropped += 1
            return
        self.events.append({
            "track": track,
            "clock": clock,
            "field": field,
            "from": old,
            "to": new,
            "message": f"{field} {old:g}->{new:g}: {reason}",
        })
