"""Metrics primitives: counters, gauges, bounded-bucket histograms.

The registry is deliberately tiny and stdlib-only.  Two properties matter
more than features:

* **Hot-tap cheapness** — tap adapters resolve their child metrics *once*
  at attach time (``registry.counter(name, help, **labels)`` returns the
  labeled child directly), so the per-round work is a float add or a
  bisect, never a dict/label allocation.
* **Deterministic snapshots** — ``snapshot()`` and the exporters iterate
  families and label sets in sorted order and store only plain floats/ints,
  so two runs of the same virtual-clocked simulation produce *equal*
  snapshot dicts (a tested property; see tests/test_torch_obs.py).

Histograms use a fixed, bounded bucket ladder (no dynamic resize): an
observation lands in the first bucket whose upper bound is ``>= v``
(Prometheus ``le`` semantics) and anything beyond the last bound lands in
the overflow bucket.  Quantiles are the usual linear-interpolation
estimate over the cumulative counts, clamped to the last finite bound for
overflow mass.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Optional

__all__ = [
    "DEFAULT_TIME_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]

# Log-spaced seconds ladder: covers sub-ms fsyncs up to multi-second
# spill-heavy rounds.  14 bounds + overflow keeps every histogram bounded.
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Counter:
    """Monotonic counter (floats allowed: byte totals, seconds totals)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded-bucket histogram with Prometheus ``le`` semantics."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds=DEFAULT_TIME_BUCKETS) -> None:
        bounds = tuple(float(b) for b in bounds)
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram bounds must be ascending: {bounds}")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = overflow (+Inf)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile estimate (0 when empty)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev_cum = cum
            cum += c
            if cum >= target:
                if i >= len(self.bounds):  # overflow: clamp to last bound
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (target - prev_cum) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
        return self.bounds[-1]

    def cumulative(self) -> list:
        """``[(le, cumulative_count), ...]`` ending with ``("+Inf", count)``."""
        out = []
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            out.append((b, cum))
        out.append(("+Inf", self.count))
        return out


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    __slots__ = ("name", "type", "help", "buckets", "series")

    def __init__(self, name, typ, help_, buckets) -> None:
        self.name = name
        self.type = typ
        self.help = help_
        self.buckets = buckets
        self.series: dict = {}  # sorted label-items tuple -> metric


class MetricsRegistry:
    """Name -> family of labeled children.  See module docstring."""

    def __init__(self) -> None:
        self._families: dict[str, _Family] = {}

    def _child(self, typ: str, name: str, help_: str, buckets, labels):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(name, typ, help_, buckets)
        elif fam.type != typ:
            raise ValueError(
                f"metric {name!r} already registered as {fam.type}, not {typ}"
            )
        elif typ == "histogram" and buckets is not None and fam.buckets != buckets:
            raise ValueError(f"metric {name!r} bucket ladder mismatch")
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        child = fam.series.get(key)
        if child is None:
            if typ == "histogram":
                child = Histogram(buckets or DEFAULT_TIME_BUCKETS)
            else:
                child = _TYPES[typ]()
            fam.series[key] = child
        return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child("counter", name, help, None, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child("gauge", name, help, None, labels)

    def histogram(
        self, name: str, help: str = "",
        buckets: Optional[tuple] = None, **labels,
    ) -> Histogram:
        if buckets is not None:
            buckets = tuple(float(b) for b in buckets)
        return self._child("histogram", name, help, buckets, labels)

    def families(self) -> list:
        """``(name, type, help, [(label_items, metric), ...])`` sorted for
        deterministic export."""
        out = []
        for name in sorted(self._families):
            fam = self._families[name]
            series = sorted(fam.series.items())
            out.append((fam.name, fam.type, fam.help, series))
        return out

    def snapshot(self) -> dict:
        """Plain-data, deterministically ordered dump (JSON-safe)."""
        out: dict = {}
        for name, typ, help_, series in self.families():
            rows = []
            for key, m in series:
                labels = {k: v for k, v in key}
                if typ == "histogram":
                    rows.append({
                        "labels": labels,
                        "buckets": [
                            [le, c] for le, c in m.cumulative()
                        ],
                        "sum": m.sum,
                        "count": m.count,
                        "p50": m.quantile(0.50),
                        "p95": m.quantile(0.95),
                    })
                else:
                    rows.append({"labels": labels, "value": m.value})
            out[name] = {"type": typ, "help": help_, "series": rows}
        return out
