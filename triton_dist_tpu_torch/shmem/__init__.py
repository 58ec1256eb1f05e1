from triton_dist_tpu_torch.shmem.context import (MAX_RANKS, SPIN_BUDGET_S,
                                                 ShmemContext,
                                                 initialize_distributed)
from triton_dist_tpu_torch.shmem.device import (ShmemError, check_errors,
                                                ring_ping, ring_ping_plain)

__all__ = ["MAX_RANKS", "SPIN_BUDGET_S", "ShmemContext", "ShmemError", "check_errors",
           "initialize_distributed", "ring_ping", "ring_ping_plain"]
