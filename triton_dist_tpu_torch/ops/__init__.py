from triton_dist_tpu_torch.ops.flash_decode import (NEG_INF, gqa_decode_paged,
                                                    gqa_decode_paged_plain,
                                                    paged_kv_write)

__all__ = ["NEG_INF", "gqa_decode_paged", "gqa_decode_paged_plain",
           "paged_kv_write"]
