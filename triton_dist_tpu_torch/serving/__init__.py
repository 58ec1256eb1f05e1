"""The serving tier of the port: the continuous-batching engine over the
paged KV pool, its scheduler and its metrics, the MoE engine on a
TP×SP×EP mesh and the disaggregated prefill/decode engine (counterpart of
``triton_dist_tpu/serving``: the single-device core, the sharded engine
and disaggregated serving)."""

from triton_dist_tpu_torch.serving.deadline import (Backoff, Deadline,
                                                    EngineStallError)
from triton_dist_tpu_torch.serving.disagg import (ChunkSignalLedger,
                                                  DisaggServingEngine,
                                                  MigrationSignalTimeout,
                                                  PageMigrationChannel,
                                                  SignalProtocolError)
from triton_dist_tpu_torch.serving.engine import ServingEngine
from triton_dist_tpu_torch.serving.kv_pool import (KVPagePool,
                                                   PageLedgerError,
                                                   cache_to_pages,
                                                   page_pool_pspec,
                                                   pages_to_cache,
                                                   shard_pool_arrays)
from triton_dist_tpu_torch.serving.metrics import Histogram, ServingMetrics
from triton_dist_tpu_torch.serving.sharded import (FD_FIT, MESH_AXES,
                                                   ReplicatedDecisionError,
                                                   ShardedServingEngine,
                                                   fd_attn_split_us,
                                                   serving_mesh)
from triton_dist_tpu_torch.serving.scheduler import (
    AdmissionRejected, ClassSpec, ContinuousBatchingScheduler, Request,
    RequestState, SLOPolicy, TtlExpired)

__all__ = ["AdmissionRejected", "Backoff", "ChunkSignalLedger", "ClassSpec",
           "ContinuousBatchingScheduler", "Deadline", "DisaggServingEngine",
           "EngineStallError", "FD_FIT", "Histogram", "KVPagePool",
           "MigrationSignalTimeout", "PageLedgerError",
           "PageMigrationChannel", "Request", "RequestState", "SLOPolicy",
           "ServingEngine", "ServingMetrics", "SignalProtocolError",
           "MESH_AXES", "ReplicatedDecisionError", "ShardedServingEngine",
           "fd_attn_split_us", "serving_mesh", "TtlExpired",
           "cache_to_pages", "page_pool_pspec", "pages_to_cache",
           "shard_pool_arrays"]
