"""Continuous-batching serving over paged KV (port of ``repro.serving``).

Layers: ``kv_pool`` (paged KV accounting with COW forks and rollback-aware
reclamation, plus the on-device swap store), ``decode_state`` (the paged
per-row state), ``device_loop`` (the device-resident sampling and verify
functions), ``batched_engine`` (batched decoders, the SpS and the
SpecBranch engines), ``batch_scheduler`` (step-granularity admission,
retirement and preemption) and ``metrics``.
"""
from repro_torch.serving.batch_scheduler import (ContinuousBatchScheduler,
                                                 ServeRequest)
from repro_torch.serving.batched_engine import (BatchedDecoder,
                                                BatchedSpecBranchEngine,
                                                BatchedSpSEngine)
from repro_torch.serving.kv_pool import (PagedKVPool, PagedStore,
                                         PoolExhausted, PoolGroup)
from repro_torch.serving.metrics import ServingMetrics

__all__ = ["ContinuousBatchScheduler", "ServeRequest", "BatchedDecoder",
           "BatchedSpecBranchEngine", "BatchedSpSEngine", "PagedKVPool",
           "PagedStore", "PoolExhausted", "PoolGroup", "ServingMetrics"]
