"""The serving tier of the port: the continuous-batching engine over the
paged KV pool, its scheduler and its metrics, and the MoE engine on a
TP×SP×EP mesh (counterpart of ``triton_dist_tpu/serving``: the
single-device core and the sharded engine)."""

from triton_dist_tpu_torch.serving.deadline import (Backoff, Deadline,
                                                    EngineStallError)
from triton_dist_tpu_torch.serving.engine import ServingEngine
from triton_dist_tpu_torch.serving.kv_pool import (KVPagePool,
                                                   PageLedgerError,
                                                   cache_to_pages,
                                                   page_pool_pspec,
                                                   pages_to_cache,
                                                   shard_pool_arrays)
from triton_dist_tpu_torch.serving.metrics import Histogram, ServingMetrics
from triton_dist_tpu_torch.serving.sharded import (MESH_AXES,
                                                   ReplicatedDecisionError,
                                                   ShardedServingEngine,
                                                   serving_mesh)
from triton_dist_tpu_torch.serving.scheduler import (
    AdmissionRejected, ClassSpec, ContinuousBatchingScheduler, Request,
    RequestState, SLOPolicy, TtlExpired)

__all__ = ["AdmissionRejected", "Backoff", "ClassSpec",
           "ContinuousBatchingScheduler", "Deadline", "EngineStallError",
           "Histogram", "KVPagePool", "PageLedgerError", "Request",
           "RequestState", "SLOPolicy", "ServingEngine", "ServingMetrics",
           "MESH_AXES", "ReplicatedDecisionError", "ShardedServingEngine",
           "serving_mesh", "TtlExpired", "cache_to_pages", "page_pool_pspec",
           "pages_to_cache", "shard_pool_arrays"]
