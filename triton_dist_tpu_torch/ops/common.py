"""What the collective ops share: the host-level barrier (TPU kernel B14),
the signal pad of each kernel family, and the rule for the ranks a
collective spans: a group along an axis of the mesh, or several axes
(``shmem.device.group_plan``: one launch covers every rank, each rank talks
to its own group only).

Counterpart of ``triton_dist_tpu/ops/common.py``. The JAX package keys each
kernel family's barrier semaphore by a stable ``collective_id_for(name)``;
the port gives each family its own symmetric signal pad
(``ShmemContext.signal_pad``), named ``<family>_<axis>``, so two families
never share a flag word.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.shmem import device as shd

def family_pad(ctx, family: str, axis, words: int) -> torch.Tensor:
    """The signal pad of ``family`` over ``axis`` (at least ``words``
    int32 words a rank)."""
    if axis is not None and not isinstance(axis, str):
        axis = "_".join(axis)
    name = family if axis is None else f"{family}_{axis}"
    return ctx.signal_pad(name, words)


def barrier_all_plain(n: int, device="cpu"):
    """The plain version of the barrier: every rank's 1."""
    return torch.ones(n, dtype=torch.int32, device=device)


def barrier_all_op(ctx, axis: str | None = None):
    """A host-level barrier across ``axis`` (every axis for None; inside a
    multi-axis mesh, each group along ``axis`` apart): returns a callable
    that runs it and returns int32 ones [N], one per rank of the mesh. Each
    rank signals every other member of its group and waits for their
    arrivals, in one launch of ``csrc/shmem.cu`` covering every rank (on a
    CUDA context; it adds one to ``barrier_all_op.launches``). A CPU
    context runs the plain version."""
    group = shd.group_plan(ctx, axis)[1]
    N = ctx.num_ranks

    def barrier():
        if ctx.device.type == "cpu":
            return barrier_all_plain(N)
        out = torch.zeros(N, dtype=torch.int32, device=ctx.device)
        pad = family_pad(ctx, "barrier_all", axis, 1)
        (pads,) = shd.tables(ctx, pad)
        lib = shd.shmem_lib()
        args = shd.launch_args(ctx)
        with csrc.current_on(ctx.device):
            rc = lib.tdt_barrier_all(pads, N, out.data_ptr(),
                                     ctypes.byref(group), *args)
        csrc.check(lib, rc, "barrier_all_op")
        barrier_all_op.launches += 1
        return out

    return barrier


barrier_all_op.launches = 0

__all__ = ["barrier_all_op", "barrier_all_plain",
           "family_pad"]
