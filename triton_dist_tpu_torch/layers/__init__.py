from triton_dist_tpu_torch.layers.sp_flash_decode_layer import (
    PagedGQADecodeAttention, SpGQAFlashDecodeAttention)

__all__ = ["PagedGQADecodeAttention", "SpGQAFlashDecodeAttention"]
