"""The serving substrate of the port: the LifeRaft multi-tenant engine
(a JAX-free copy of the reference's), the paged KV pool, and the durable
service daemon over the serving and cross-match engines."""
from .daemon import CrossMatchHost, RecoveryError, ServiceDaemon, ServingHost
from .engine import (
    AdapterSpec,
    AdapterWorkload,
    LifeRaftEngine,
    Request,
    ServeConfig,
    ShardedServingEngine,
)
from .kvcache import PagePool, SequenceAllocation

__all__ = ["AdapterSpec", "AdapterWorkload", "LifeRaftEngine", "Request",
           "ServeConfig", "ShardedServingEngine", "PagePool",
           "SequenceAllocation", "ServiceDaemon", "ServingHost",
           "CrossMatchHost", "RecoveryError"]
