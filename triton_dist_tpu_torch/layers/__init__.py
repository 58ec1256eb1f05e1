from triton_dist_tpu_torch.layers.allgather_layer import AllGatherLayer
from triton_dist_tpu_torch.layers.ep_a2a_layer import EPAll2AllLayer
from triton_dist_tpu_torch.layers.sp_flash_decode_layer import (
    PagedGQADecodeAttention, SpGQAFlashDecodeAttention)
from triton_dist_tpu_torch.layers.tp_linear import (ColumnParallelLinear,
                                                    RowParallelLinear)

__all__ = ["AllGatherLayer", "ColumnParallelLinear", "EPAll2AllLayer", "PagedGQADecodeAttention",
           "RowParallelLinear", "SpGQAFlashDecodeAttention"]
