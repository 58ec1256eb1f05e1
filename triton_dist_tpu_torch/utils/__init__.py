from triton_dist_tpu_torch.utils.env import (default_device, set_tf32,
                                             tf32_flags)
from triton_dist_tpu_torch.utils.perf import perf_func

__all__ = ["default_device", "perf_func", "set_tf32", "tf32_flags"]
