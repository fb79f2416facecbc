"""PD-disaggregated serving runtime on the port's engines (paper §2.1, §5.4);
the port's copy of ``repro.serving.disagg``.

Prefill and decode run on separate engine pools; KV-cache pages migrate
prefill→decode over the topology-modelled compute network; the autoscaler
drives decode pre-scaling and prefill→decode instance *mutation* so decode
scale-ups never incast-collide with live KVCache migration traffic.
"""

from repro_torch.serving.disagg.kv_migration import (
    KVMigrationChannel,
    MigrationPayload,
    payload_bytes,
)
from repro_torch.serving.disagg.pools import EnginePool, PooledEngine
from repro_torch.serving.disagg.runtime import ClusterRuntime, RuntimeStats

__all__ = [
    "ClusterRuntime",
    "EnginePool",
    "KVMigrationChannel",
    "MigrationPayload",
    "PooledEngine",
    "RuntimeStats",
    "payload_bytes",
]
