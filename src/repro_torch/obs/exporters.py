"""Exporters: Prometheus text exposition, JSON snapshot, Perfetto trace.

All three are pure functions over the registry/tracer stores — exporting
never mutates observability state, so a snapshot can be taken mid-run (the
daemon serves these) and the output is deterministic for virtual-clocked
runs (sorted iteration everywhere; see ``registry.MetricsRegistry``).

The Perfetto export is the Chrome trace-event JSON object format
(``{"traceEvents": [...]}``, timestamps in microseconds): one named thread
per track (an S-track timeline for a sharded run), complete ``"X"`` spans
for rounds and their latency-breakdown children, and flow events
(``"s"``/``"f"``, ``cat == "steal"``) drawing each work-steal migration as
an arrow from the victim's track to the thief's.  Loadable directly in
https://ui.perfetto.dev or chrome://tracing.
"""
from __future__ import annotations

__all__ = ["prometheus_text", "metrics_snapshot", "perfetto_trace"]

_US = 1e6  # seconds -> trace microseconds


def _esc_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v) -> str:
    # Prometheus floats: ints render bare, floats via repr (shortest
    # round-trip, so snapshots diff bit-identically).
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


def _series_name(name: str, labels, extra=()) -> str:
    items = list(labels) + list(extra)
    if not items:
        return name
    body = ",".join(f'{k}="{_esc_label(str(v))}"' for k, v in items)
    return f"{name}{{{body}}}"


def prometheus_text(registry) -> str:
    """Prometheus text exposition (version 0.0.4) of the registry."""
    out: list[str] = []
    for name, typ, help_, series in registry.families():
        if help_:
            out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {typ}")
        for key, m in series:
            if typ == "histogram":
                for le, cum in m.cumulative():
                    out.append(
                        f"{_series_name(name + '_bucket', key, [('le', le)])}"
                        f" {cum}"
                    )
                out.append(f"{_series_name(name + '_sum', key)} {_fmt(m.sum)}")
                out.append(f"{_series_name(name + '_count', key)} {m.count}")
            else:
                out.append(f"{_series_name(name, key)} {_fmt(m.value)}")
    return "\n".join(out) + "\n"


def metrics_snapshot(registry) -> dict:
    """JSON-safe snapshot (deterministic ordering); see registry.snapshot."""
    return registry.snapshot()


def perfetto_trace(tracer, *, process_name: str = "liferaft") -> dict:
    """Chrome-trace-event/Perfetto JSON for the recorded spans + steals."""
    events: list[dict] = [{
        "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    for track in tracer.tracks():
        tname = tracer.track_names.get(track, f"shard-{track}")
        events.append({
            "ph": "M", "name": "thread_name", "pid": 1, "tid": track,
            "args": {"name": tname},
        })
        events.append({
            "ph": "M", "name": "thread_sort_index", "pid": 1, "tid": track,
            "args": {"sort_index": track},
        })
    for track, t0, dur, children, n_buckets in tracer.rounds:
        events.append({
            "ph": "X", "name": "round", "cat": "round",
            "pid": 1, "tid": track,
            "ts": t0 * _US, "dur": dur * _US,
            "args": {"buckets": n_buckets},
        })
        t = t0
        for cname, cdur in children:
            if cdur <= 0.0:
                continue
            events.append({
                "ph": "X", "name": cname, "cat": "round",
                "pid": 1, "tid": track,
                "ts": t * _US, "dur": cdur * _US,
            })
            t += cdur
    for i, (victim, thief, t, bucket_id, n_units) in enumerate(tracer.steals):
        ts = t * _US
        args = {"bucket": bucket_id, "units": n_units}
        # Instant markers on both tracks make the migration visible even
        # when a renderer hides flows; the s/f pair draws the arrow.
        events.append({
            "ph": "i", "s": "t", "name": "steal", "cat": "steal",
            "pid": 1, "tid": victim, "ts": ts, "args": args,
        })
        events.append({
            "ph": "s", "id": i, "name": "steal", "cat": "steal",
            "pid": 1, "tid": victim, "ts": ts,
        })
        events.append({
            "ph": "f", "bp": "e", "id": i, "name": "steal", "cat": "steal",
            "pid": 1, "tid": thief, "ts": ts,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
