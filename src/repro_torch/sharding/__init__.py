"""Logical-axis sharding of the port on ``DeviceMesh`` and DTensor."""
from .logical import (
    DEFAULT_RULES,
    DECODE_RULES,
    NamedSharding,
    PartitionSpec,
    ShardingRules,
    activate,
    current_rules,
    logical_to_spec,
    named_sharding,
    shard_hint,
)

__all__ = [
    "DEFAULT_RULES", "DECODE_RULES", "NamedSharding", "PartitionSpec",
    "ShardingRules", "activate", "current_rules", "logical_to_spec",
    "named_sharding", "shard_hint",
]
