"""The serving substrate of the port: the LifeRaft multi-tenant engine
(a JAX-free copy of the reference's) and the paged KV pool.  The service
daemon is not ported yet."""
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
           "SequenceAllocation"]
