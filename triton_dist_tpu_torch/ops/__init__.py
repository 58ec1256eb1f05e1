from triton_dist_tpu_torch.ops.flash_decode import (NEG_INF, gqa_decode_paged,
                                                    gqa_decode_paged_plain,
                                                    paged_kv_write)
from triton_dist_tpu_torch.ops.ring_attention import (
    ring_attention, ring_attention_bwd, ring_attention_bwd_plain,
    ring_attention_fwd, ring_attention_fwd_plain, zigzag_indices)

__all__ = ["NEG_INF", "gqa_decode_paged", "gqa_decode_paged_plain",
           "paged_kv_write", "ring_attention", "ring_attention_bwd",
           "ring_attention_bwd_plain", "ring_attention_fwd",
           "ring_attention_fwd_plain", "zigzag_indices"]
