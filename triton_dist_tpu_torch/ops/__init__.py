from triton_dist_tpu_torch.ops.allgather import (AgLLContext, all_gather,
                                                 all_gather_ll,
                                                 all_gather_plain, broadcast,
                                                 create_ag_ll_workspace)
from triton_dist_tpu_torch.ops.common import barrier_all_op, barrier_all_plain
from triton_dist_tpu_torch.ops.allgather_gemm import (
    AgGemmContext, ag_gemm, ag_gemm_plain, ag_gemm_ws, create_ag_gemm_context,
    create_ag_gemm_workspace, tp_column_linear)
from triton_dist_tpu_torch.ops.all_to_all import (
    Ep2dAllToAllContext, EpAllToAllContext, QuantTokens, combine, combine_2d,
    create_all_to_all_context, create_all_to_all_context_2d, dispatch,
    dispatch_2d, ep_combine, ep_combine_plain, ep_dispatch, ep_dispatch_plain,
    route_tokens, route_tokens_2d)
from triton_dist_tpu_torch.ops.autodiff import ag_gemm_diff, gemm_rs_diff
from triton_dist_tpu_torch.ops.flash_decode import (
    FD_EMPTY, NEG_INF, SPLIT_KEYS, decode_combine, decode_combine_plain,
    fd_fold_plain, fd_page_partials, fd_page_partials_plain,
    fd_partials_fold, fd_partials_fold_plain, flash_decode_dist,
    gqa_decode_paged, gqa_decode_paged_plain, gqa_decode_partial,
    gqa_decode_partial_plain, ll_ag_merge, ll_ag_merge_plain, ll_merge,
    ll_merge_plain, paged_kv_write, pool_ag_start_local,
    pool_ag_start_local_plain, sp_gqa_flash_decode)
from triton_dist_tpu_torch.ops.lend_pages import lend_pages
from triton_dist_tpu_torch.ops.page_migrate import (migrate_pages,
                                                    paged_transport,
                                                    paged_transport_plain)
from triton_dist_tpu_torch.ops.gemm import (GemmConfig, matmul, matmul_plain,
                                            slot_reduce, slot_reduce_plain)
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import (
    GemmRsContext, create_gemm_rs_context, create_gemm_rs_workspace, gemm_rs,
    gemm_rs_plain, gemm_rs_ws)
from triton_dist_tpu_torch.ops.group_gemm import (
    PackedGatedWeights, align_tokens_by_expert, apply_grouped,
    expert_alignment, grouped_gemm, grouped_gemm_gated,
    grouped_gemm_gated_plain, grouped_gemm_plain, moe_ffn_local,
    pack_gated_weights, unpack_gated_weights, used_block_count)
from triton_dist_tpu_torch.ops.moe import ag_moe_group_gemm, moe_reduce_rs
from triton_dist_tpu_torch.ops.reduce_scatter import (reduce_scatter,
                                                      reduce_scatter_plain)
from triton_dist_tpu_torch.ops.ring_attention import (
    ring_attention, ring_attention_bwd, ring_attention_bwd_plain,
    ring_attention_fwd, ring_attention_fwd_plain, zigzag_indices)

__all__ = ["AgGemmContext", "AgLLContext", "Ep2dAllToAllContext",
           "EpAllToAllContext", "PackedGatedWeights", "QuantTokens",
           "combine", "combine_2d", "create_all_to_all_context",
           "create_all_to_all_context_2d", "dispatch", "dispatch_2d",
           "pack_gated_weights", "route_tokens", "route_tokens_2d",
           "unpack_gated_weights", "all_gather_ll", "broadcast",
           "create_ag_ll_workspace", "FD_EMPTY", "GemmConfig", "GemmRsContext",
           "NEG_INF", "SPLIT_KEYS", "ag_gemm", "ag_moe_group_gemm", "ag_gemm_diff", "ag_gemm_ws",
           "align_tokens_by_expert", "all_gather", "all_gather_plain",
           "ag_gemm_plain", "barrier_all_op", "barrier_all_plain",
           "create_ag_gemm_context", "create_ag_gemm_workspace",
           "create_gemm_rs_context", "create_gemm_rs_workspace", "gemm_rs",
           "gemm_rs_diff", "gemm_rs_plain", "gemm_rs_ws", "matmul",
           "matmul_plain",
           "slot_reduce", "slot_reduce_plain", "tp_column_linear",
           "apply_grouped", "decode_combine", "decode_combine_plain",
           "ep_combine", "ep_combine_plain", "ep_dispatch",
           "ep_dispatch_plain", "expert_alignment", "fd_fold_plain",
           "fd_page_partials", "fd_page_partials_plain", "fd_partials_fold",
           "fd_partials_fold_plain", "flash_decode_dist",
           "gqa_decode_paged", "gqa_decode_paged_plain",
           "gqa_decode_partial", "gqa_decode_partial_plain",
           "lend_pages", "ll_ag_merge", "ll_ag_merge_plain", "ll_merge",
           "ll_merge_plain", "migrate_pages", "paged_transport",
           "paged_transport_plain", "pool_ag_start_local",
           "pool_ag_start_local_plain",
           "grouped_gemm",
           "grouped_gemm_gated", "grouped_gemm_gated_plain",
           "grouped_gemm_plain", "moe_ffn_local", "moe_reduce_rs",
           "paged_kv_write", "reduce_scatter", "reduce_scatter_plain",
           "sp_gqa_flash_decode",
           "used_block_count", "ring_attention", "ring_attention_bwd",
           "ring_attention_bwd_plain", "ring_attention_fwd",
           "ring_attention_fwd_plain", "zigzag_indices"]
