"""Write-ahead decision journal + the shared trace-entry codec.

Two things live here because they share one schema:

* **Entry codec** (``encode_outcome`` / ``encode_steal`` / ``format_entry``
  / ``diff_entries`` / ``save_trace`` / ``load_trace``) — the plain-data
  serialization of a ``DispatchOutcome`` that the golden-trace harness
  (``tests/replay.py``) records.  Scores are float64 and
  survive JSON round-trips exactly (``repr`` shortest-round-trip), so a
  diff is a *bit* diff, not an approx one.  Promoting the codec out of the
  test tree means the goldens and the recovery journal are literally the
  same format: a journal segment's ``entry`` records can be diffed against
  a golden with the same ``diff_entries`` call the replay tests use.

* **``Journal``** — an append-only, segmented, JSON-lines write-ahead log
  of a service daemon's externally visible decisions: acked submissions,
  admission rejections, and per-round dispatch entries.  Appends flush to
  the OS on every record (a ``kill -9`` of the process loses at most the
  one record currently being written); submission acks additionally
  ``fsync`` so an ack implies durability.  Segments are fsync'd and closed
  at ``segment_bytes``; a restart never appends into an old segment, so a
  torn tail can only ever be the final line of the final segment — the
  reader drops exactly that line and raises ``JournalCorrupt`` on damage
  anywhere else.  Before a restart opens its first segment it ends the old
  last segment at a line boundary: a torn final line would otherwise end
  up mid-journal and make the next restart's replay raise (the reference's
  journal leaves it there).

Record shapes (one JSON object per line)::

    {"type": "open",   "schema": 1, "kind": "..."}          # segment header
    {"type": "submit", "key": "...", "item": {...}}         # durable ack
    {"type": "reject", "key": "...", "tenant": "...",
     "reason": "...", "observed": ..., "limit": ...}        # admission 429
    {"type": "entry",  "entry": {...}}                      # round or steal

``entry`` payloads are exactly the codec format, including the conditional
``stall`` / ``share_width`` / ``shard`` / ``steal`` keys.
"""
from __future__ import annotations

import json
import os
import pathlib
from time import perf_counter
from typing import Callable, Iterable, Optional

__all__ = [
    "TRACE_SCHEMA_VERSION",
    "encode_outcome",
    "encode_steal",
    "format_entry",
    "diff_entries",
    "save_trace",
    "load_trace",
    "Journal",
    "JournalCorrupt",
]

TRACE_SCHEMA_VERSION = 1


# --------------------------------------------------------------- entry codec
def encode_outcome(outcome, shard: Optional[int] = None) -> dict:
    """Serialize one ``DispatchOutcome`` into a plain-data trace entry.

    This is the golden-trace format: decisions (bucket id, score,
    residency, queue size), the applied ControlVector, the round cost, and
    spill transitions.  ``shard`` tags the entry with its originating
    shard id (sharded coordinators interleave rounds across shard-local
    loops, so the tag pins the interleaving)."""
    entry = {
        "decisions": [
            [
                int(d.bucket_id),
                float(d.score),
                bool(d.in_cache),
                int(d.queue_size),
            ]
            for d in outcome.decisions
        ],
        "cost": float(outcome.cost),
        "vector": [
            float(outcome.vector.alpha),
            int(outcome.vector.fuse_k),
            bool(outcome.vector.spill),
        ],
        "spill_changed": [int(b) for b in outcome.spill_changed],
    }
    # Residual prefetch stall: only emitted when nonzero, so goldens
    # recorded before the pipeline existed replay byte-identically (their
    # rounds never stall) while prefetch-on goldens pin it.
    stall = float(getattr(outcome, "stall", 0.0))
    if stall:
        entry["stall"] = stall
    # Shared-plan width: same conditional-emit discipline as ``stall`` —
    # goldens recorded before shared plans existed (share_width == 0 on
    # every round) replay byte-identically, while shared-plan-on goldens
    # pin the AIMD width trajectory.
    share_width = int(getattr(outcome.vector, "share_width", 0))
    if share_width:
        entry["share_width"] = share_width
    if shard is not None:
        entry["shard"] = int(shard)
    return entry


def encode_steal(ev) -> dict:
    """Serialize one ``StealEvent`` into its in-order trace entry."""
    return {
        "steal": [
            int(ev.bucket_id),
            int(ev.victim),
            int(ev.thief),
            int(ev.n_units),
        ]
    }


def format_entry(entry: dict) -> str:
    if "steal" in entry:
        b, v, t, n = entry["steal"]
        return f"steal b{b}: shard {v} -> shard {t} ({n} units)"
    ds = ", ".join(
        f"b{b}:s={s!r}:c={int(c)}:n={n}" for b, s, c, n in entry["decisions"]
    )
    a, k, sp = entry["vector"]
    shard = f" shard={entry['shard']}" if "shard" in entry else ""
    return (
        f"[{ds}] cost={entry['cost']!r}"
        f" vec=(a={a!r},k={k},spill={int(sp)}){shard}"
    )


def diff_entries(expect: list, got: list) -> list:
    """Structural diff of two decision logs.  Empty list == bit-identical.

    Each divergence names the round, the field, and both sides, so a
    regression reads as 'round 17: decisions expect [...] got [...]'
    instead of a bare assert."""
    out: list[str] = []
    if len(expect) != len(got):
        out.append(f"length: expect {len(expect)} rounds, got {len(got)}")
    for i, (e, g) in enumerate(zip(expect, got)):
        for field in (
            "decisions", "cost", "vector", "spill_changed", "stall",
            "share_width", "shard", "steal",
        ):
            if e.get(field) != g.get(field):
                out.append(
                    f"round {i} {field}:\n  expect {format_entry(e)}"
                    f"\n  got    {format_entry(g)}"
                )
                break
        if len(out) >= 5:  # enough context; don't flood
            out.append("... (further divergence suppressed)")
            break
    return out


def save_trace(path, entries: list, meta: Optional[dict] = None) -> None:
    doc = {
        "schema": TRACE_SCHEMA_VERSION,
        "meta": meta or {},
        "rounds": entries,
    }
    pathlib.Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def load_trace(path) -> list:
    doc = json.loads(pathlib.Path(path).read_text())
    assert doc["schema"] == TRACE_SCHEMA_VERSION, doc["schema"]
    return doc["rounds"]


# --------------------------------------------------------------- journal WAL
def _seal_tail(seg: pathlib.Path) -> None:
    """End ``seg`` at a line boundary, keeping what ``replay`` read: a final
    line without its newline that decodes is a whole record (the crash cut
    only the newline) and gets it back; one that does not was torn
    mid-append, was never acked, and is cut off."""
    with open(seg, "rb+") as fh:
        data = fh.read()
        end = data.rfind(b"\n") + 1
        if end == len(data):
            return
        try:
            json.loads(data[end:])
        except ValueError:  # JSONDecodeError, or UTF-8 torn mid-character
            fh.truncate(end)
        else:
            fh.write(b"\n")
        fh.flush()
        os.fsync(fh.fileno())


class JournalCorrupt(RuntimeError):
    """A journal segment is damaged somewhere other than the final line of
    the final segment (which is the only place a crash can tear)."""


class Journal:
    """Append-only segmented JSON-lines write-ahead log.

    ``append`` writes one record and flushes it to the OS; pass
    ``sync=True`` on records whose durability is acked to a client (the
    submit/reject barrier) to force ``fsync``.  A fresh ``Journal`` over an
    existing directory never appends to prior segments — it opens a new
    one — so replay's torn-tail tolerance stays confined to the last line
    on disk at crash time; its first append seals that line before the new
    segment would bury it."""

    _SEG_FMT = "seg-{:08d}.jsonl"

    def __init__(self, path, *, segment_bytes: int = 1 << 20,
                 kind: str = "journal") -> None:
        self.dir = pathlib.Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.kind = kind
        segs = self.segments()
        self._seq = (
            int(segs[-1].stem.split("-", 1)[1]) + 1 if segs else 0
        )
        self._fh = None  # opened lazily on first append
        # The previous incarnation's last segment, which the first rotation
        # ends at a line boundary (a crash may have torn its tail).
        self._prior = segs[-1] if segs else None
        self.appended = 0
        # Optional latency tap: ``fn(record_type, total_s, fsync_s)`` with
        # ``fsync_s is None`` on unsynced appends.  Purely observational —
        # installed by ``repro_torch.obs`` (Observability.attach_journal); when
        # None (the default) append takes no timestamps at all.
        self.obs_tap: Optional[Callable[[str, float, Optional[float]], None]] = None

    def segments(self) -> list:
        return sorted(self.dir.glob("seg-*.jsonl"))

    # -- writing -----------------------------------------------------------
    def append(self, record: dict, *, sync: bool = False) -> None:
        tap = self.obs_tap
        t0 = perf_counter() if tap is not None else 0.0
        line = json.dumps(record, separators=(",", ":")) + "\n"
        if self._fh is None or self._fh.tell() >= self.segment_bytes:
            self._rotate()
        self._fh.write(line)
        self._fh.flush()
        tf = perf_counter() if (tap is not None and sync) else 0.0
        if sync:
            os.fsync(self._fh.fileno())
        self.appended += 1
        if tap is not None:
            t1 = perf_counter()
            tap(record.get("type", ""), t1 - t0, (t1 - tf) if sync else None)

    def _rotate(self) -> None:
        self._close_segment()
        if self._prior is not None:
            _seal_tail(self._prior)
            self._prior = None
        path = self.dir / self._SEG_FMT.format(self._seq)
        self._seq += 1
        self._fh = open(path, "a", encoding="utf-8")
        header = {"type": "open", "schema": TRACE_SCHEMA_VERSION,
                  "kind": self.kind}
        self._fh.write(json.dumps(header, separators=(",", ":")) + "\n")
        self._fh.flush()

    def _close_segment(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None

    def sync(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        self._close_segment()

    # -- reading -----------------------------------------------------------
    def replay(self) -> list:
        """All records across segments, in append order.

        The final line of the final segment may be torn by a crash
        mid-write; it is silently dropped (its record was never acked —
        ``append`` returns only after the full line is flushed).  Damage
        anywhere else raises :class:`JournalCorrupt`."""
        records: list[dict] = []
        segs = self.segments()
        for si, seg in enumerate(segs):
            text = seg.read_text(encoding="utf-8")
            lines = text.split("\n")
            if lines and lines[-1] == "":
                lines.pop()  # trailing newline, not a torn record
            for li, line in enumerate(lines):
                torn_ok = si == len(segs) - 1 and li == len(lines) - 1
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    if torn_ok:
                        break
                    raise JournalCorrupt(
                        f"{seg.name} line {li + 1}: undecodable record "
                        f"mid-journal"
                    ) from None
                if rec.get("type") == "open":
                    if rec.get("schema") != TRACE_SCHEMA_VERSION:
                        raise JournalCorrupt(
                            f"{seg.name}: schema {rec.get('schema')!r} != "
                            f"{TRACE_SCHEMA_VERSION}"
                        )
                    continue
                records.append(rec)
        return records
