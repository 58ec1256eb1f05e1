from triton_dist_tpu_torch.shmem.context import (ShmemContext,
                                                 initialize_distributed)

__all__ = ["ShmemContext", "initialize_distributed"]
