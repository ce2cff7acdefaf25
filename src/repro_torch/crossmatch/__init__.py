"""Faithful application: SkyQuery-style astronomy cross-match, on PyTorch."""
from .catalog import SkyCatalog, make_catalog
from .convert import catalog_from_arrays, queries_from_records
from .engine import CrossMatchEngine, MatchResult, ShardedCrossMatch
from .trace import TraceConfig, cone_sample, make_trace, workload_stats

__all__ = [
    "SkyCatalog",
    "make_catalog",
    "catalog_from_arrays",
    "queries_from_records",
    "CrossMatchEngine",
    "MatchResult",
    "ShardedCrossMatch",
    "TraceConfig",
    "cone_sample",
    "make_trace",
    "workload_stats",
]
