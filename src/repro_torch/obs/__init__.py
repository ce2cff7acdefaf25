"""repro_torch.obs — metrics, round tracing and exporters off the decision taps.

The observability layer is fed **exclusively** through the engines' side
channels (``DispatchLoop.add_round_tap``, the sharded ``on_round`` /
``on_steal`` callbacks, ``Journal.obs_tap``, the daemon's admission
outcome): the decision path neither knows nor cares it exists, every
golden replays bit-identically with it on, and with ``obs=`` off (the
default everywhere) this package is never imported — the engines import
it lazily inside their enabled branch only.

Public surface:

* :class:`Observability` — one registry + tracer + ControlExplain bundle,
  attachable to any number of loops/journals/daemons; pass it as the
  ``obs=`` argument of ``simulate_batched`` / ``simulate_sharded`` /
  ``run_policy`` / ``LifeRaftEngine`` / ``ShardedServingEngine`` /
  ``CrossMatchEngine`` / ``ServiceDaemon``.
* :class:`ObsConfig` — bounds and sampling knobs.
* :class:`MetricsRegistry` / :class:`RoundTracer` / :class:`ControlExplain`
  — the underlying stores.
* ``prometheus_text`` / ``metrics_snapshot`` / ``perfetto_trace`` — pure
  exporters (also reachable as ``Observability.prometheus`` /
  ``.snapshot`` / ``.perfetto``).

See docs/observability.md for the metric catalog, span schema and the
taps-only design rationale.
"""
from .adapters import Observability, ObsConfig, ensure
from .exporters import metrics_snapshot, perfetto_trace, prometheus_text
from .registry import (
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .tracer import ControlExplain, RoundTracer

__all__ = [
    "Observability",
    "ObsConfig",
    "ensure",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "DEFAULT_TIME_BUCKETS",
    "RoundTracer",
    "ControlExplain",
    "prometheus_text",
    "metrics_snapshot",
    "perfetto_trace",
]
