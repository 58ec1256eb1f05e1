from triton_dist_tpu_torch.models.convert import (packed_from_jax,
                                                  params_from_jax)
from triton_dist_tpu_torch.models.llama import (LlamaConfig, block_apply,
                                                decode_multistep_paged,
                                                decode_step, decode_step_paged,
                                                decode_step_sp, forward,
                                                forward_tp_overlap, generate,
                                                init_kv_cache, init_page_pool,
                                                init_params, mlp_tp_overlap,
                                                prefill, prefill_chunk_paged,
                                                shard_kv_cache)
from triton_dist_tpu_torch.models.moe import (MoEConfig, init_moe_params,
                                              moe_mlp_ep_overlap,
                                              moe_mlp_tp_overlap)

__all__ = ["LlamaConfig", "MoEConfig", "block_apply",
           "decode_multistep_paged", "decode_step", "decode_step_paged",
           "decode_step_sp", "forward", "forward_tp_overlap", "generate",
           "init_kv_cache", "init_moe_params", "init_page_pool",
           "init_params", "mlp_tp_overlap", "moe_mlp_ep_overlap",
           "moe_mlp_tp_overlap", "packed_from_jax",
           "params_from_jax", "prefill", "prefill_chunk_paged",
           "shard_kv_cache"]
