"""Workload-adaptive alpha selection (paper §4, Figs. 4 & 8).

The paper derives throughput-vs-response trade-off curves offline for a set
of saturation levels (queries/sec), then at run time: (1) estimate current
saturation, (2) look up the nearest curve, (3) pick the alpha that minimizes
response time subject to throughput >= (1 - tolerance) * max_throughput.

``SaturationEstimator`` is an EWMA over inter-arrival gaps;
``TradeoffTable`` stores the offline curves (built by
``benchmarks/fig8_tradeoff.py`` or user traces); ``AlphaController`` glues
them together and is what the engines consult between batches.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Sequence

__all__ = ["SaturationEstimator", "TradeoffPoint", "TradeoffTable", "AlphaController"]


class SaturationEstimator:
    """EWMA arrival-rate estimator (queries/second)."""

    def __init__(self, halflife_s: float = 60.0, initial_rate: float = 0.0):
        self.halflife_s = halflife_s
        self._rate = initial_rate
        self._last: float | None = None

    def observe_arrival(self, t: float) -> float:
        if self._last is not None:
            gap = max(t - self._last, 1e-9)
            inst = 1.0 / gap
            w = 1.0 - math.exp(-math.log(2.0) * gap / self.halflife_s)
            self._rate += w * (inst - self._rate)
        self._last = t
        return self._rate

    @property
    def rate(self) -> float:
        return self._rate


@dataclasses.dataclass(frozen=True)
class TradeoffPoint:
    alpha: float
    throughput: float  # queries/sec (absolute, normalized internally)
    response: float  # mean response seconds


class TradeoffTable:
    """{saturation -> [TradeoffPoint...]} measured offline (Fig. 4/8)."""

    def __init__(self) -> None:
        self._curves: dict[float, list[TradeoffPoint]] = {}

    def add(self, saturation: float, points: Sequence[TradeoffPoint]) -> None:
        self._curves[float(saturation)] = sorted(points, key=lambda p: p.alpha)

    def saturations(self) -> list[float]:
        return sorted(self._curves)

    def curve(self, saturation: float) -> list[TradeoffPoint]:
        """Curve at the nearest measured saturation."""
        sats = self.saturations()
        if not sats:
            raise ValueError("empty trade-off table")
        i = bisect.bisect_left(sats, saturation)
        if i == 0:
            return self._curves[sats[0]]
        if i == len(sats):
            return self._curves[sats[-1]]
        lo, hi = sats[i - 1], sats[i]
        return self._curves[lo if saturation - lo <= hi - saturation else hi]

    def select_alpha(self, saturation: float, tolerance: float) -> float:
        """Paper §4: min response s.t. throughput >= (1-tol)*max_throughput."""
        pts = self.curve(saturation)
        tmax = max(p.throughput for p in pts)
        ok = [p for p in pts if p.throughput >= (1.0 - tolerance) * tmax]
        best = min(ok, key=lambda p: (p.response, p.alpha))
        return best.alpha


class AlphaController:
    """Run-time alpha adaptation: saturation EWMA -> table lookup.

    ``update_on_arrival`` is O(1); the chosen alpha changes incrementally
    (rate-limited by ``max_step``) so the scheduler shifts *gradually*
    between in-order and data-driven processing, per the paper's
    "adaptively and incrementally trades-off" framing.
    """

    def __init__(
        self,
        table: TradeoffTable,
        tolerance: float = 0.2,
        halflife_s: float = 60.0,
        initial_alpha: float = 0.5,
        max_step: float = 0.1,
    ) -> None:
        self.table = table
        self.tolerance = tolerance
        self.estimator = SaturationEstimator(halflife_s)
        self.alpha = initial_alpha
        self.max_step = max_step

    def update_on_arrival(self, t: float) -> float:
        rate = self.estimator.observe_arrival(t)
        try:
            target = self.table.select_alpha(rate, self.tolerance)
        except ValueError:
            return self.alpha
        delta = max(-self.max_step, min(self.max_step, target - self.alpha))
        self.alpha += delta
        return self.alpha
