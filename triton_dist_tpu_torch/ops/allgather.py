"""The push and ring all-gathers (TPU kernel B9).

Counterpart of ``all_gather`` in ``triton_dist_tpu/ops/allgather.py`` with
the methods ``push`` and ``ring``, and ``auto``, which picks between them as
``_auto_method`` does (``push`` at up to four ranks or a shard of up to 256
KiB, else ``ring``). Each rank's shard [m, ...] lands in its slot of every
rank's gathered [n * m, ...]: the push kernel puts its shard into slot
``me`` of every peer, the ring forwards the newest segment to its right
neighbour. On a CUDA tensor the gather is a hand-written Hopper kernel
(``csrc/allgather.cu``): at one rank the copy of the shard into slot 0, at
n ranks one launch covering every rank of the mesh on the card (see
``shmem/context.py``). Over an axis inside a multi-axis mesh the gather
runs in groups (``shmem.device.group_plan``): each rank gathers its own
group's shards and talks to its group only. On a CPU tensor it runs its
plain PyTorch version (``all_gather_plain``). The low-latency (B10), 2-D (B11, ``ring_2d``) and
broadcast (B12) forms raise ``NotImplementedError``: ROADMAP.md Queue A,
item 5 "collectives".
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.common import COLLECTIVES, family_pad
from triton_dist_tpu_torch.shmem import device as shd
from triton_dist_tpu_torch.shmem.device import group_plan

_P = ctypes.c_void_p
_GATHER_SIG = [_P, _P, ctypes.c_longlong, ctypes.c_int, _P, ctypes.c_int, _P] \
    + shd.LAUNCH_SIG                      # in out nbytes lanes pads n group ...
# shard, out, nbytes, slot, stream
_SIGNATURES = {"tdt_ag_copy": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P],
               "tdt_ag_push": _GATHER_SIG, "tdt_ag_ring": _GATHER_SIG}
METHODS = ("auto", "push", "ring")
# below this shard size the gather is latency-bound and the one-hop push
# wins (the JAX package's _PUSH_BYTES_CEILING)
PUSH_BYTES_CEILING = 256 * 1024
# bytes of a shard one block moves at least
LANE_BYTES = 64 * 1024


def all_gather_plain(x, n: int = 1):
    """The plain PyTorch version of ``all_gather``: at one rank the copy of
    the shard; at n ranks every rank's replica of ``x``, [n, *x.shape]."""
    if n == 1:
        out = torch.empty_like(x)
        out.copy_(x)
        return out
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone()


def auto_method(ctx, x, axis) -> str:
    """``_auto_method``'s pick on one axis: ``push`` at up to four ranks or
    a shard of up to ``PUSH_BYTES_CEILING``, else ``ring``."""
    n = ctx.axis_size(axis)
    shard_bytes = (x.numel() // max(n, 1)) * x.element_size()
    if n <= 4 or shard_bytes <= PUSH_BYTES_CEILING:
        return "push"
    return "ring"


def lanes_for(nbytes: int) -> int:
    """Blocks a rank's shard is cut into: one per ``LANE_BYTES``. The
    launch cuts them to what the card keeps resident at once over all n
    ranks (``resident_lanes`` in ``csrc/shmem.cuh``), so the signal pad
    sized for these is large enough."""
    return max(1, -(-nbytes // LANE_BYTES))


def all_gather(ctx, x, axis: str | None = None, method: str = "auto"):
    """Gather every rank's shard along ``axis`` (the context's first axis by
    default; a tuple of axes is one group over them, major to minor). ``x``
    [n * m, ...] holds the n shards of a group rank-major (index r's at rows
    ``r * m .. (r + 1) * m``: the JAX package's global view of an array
    sharded on dim 0 over ``axis`` and replicated over the other axes). At
    one rank along ``axis`` it returns the gathered [m, ...]; at n it
    returns every rank of the mesh's replica, [N, n * m, ...] (N the mesh's
    ranks), each the concatenation of its group's shards bit for bit.

    A CPU tensor runs the plain version. A CUDA tensor (contiguous, 16-byte
    aligned, any type) launches the kernel, adding one to
    ``all_gather.launches``, or raises. Methods other than ``auto``,
    ``push`` and ``ring`` raise ``NotImplementedError``. With ``axis=None``
    on a mesh of two or more axes, ``push`` and ``ring`` raise
    ``ValueError`` (they need ``axis=``, as the reference's do) and
    ``auto`` raises ``NotImplementedError``: the reference's gathers over
    every axis (``push_2d`` / ``ring_2d``) are not ported."""
    if method not in METHODS:
        raise NotImplementedError(
            f"all_gather: method {method!r} is not ported (the port takes "
            f"{METHODS}; the low-latency, 2-D and broadcast gathers wait for "
            f"{COLLECTIVES})")
    if axis is None and len(ctx.axis_names) > 1:
        # the reference's auto picks push_2d / ring_2d over every axis
        if method == "auto":
            raise NotImplementedError(
                f"all_gather(axis=None) on the multi-axis mesh "
                f"{tuple(ctx.axis_names)} gathers over every axis (push_2d /"
                f" ring_2d), not ported yet: {COLLECTIVES}")
        raise ValueError(
            f"all_gather(method={method!r}) on a multi-axis mesh "
            f"{tuple(ctx.axis_names)} requires an explicit axis=")
    axis = axis or ctx.axis_names[0]
    n, group, _, _ = group_plan(ctx, axis)
    N = ctx.num_ranks
    if method == "auto":
        method = auto_method(ctx, x, axis)
    if x.shape[0] % n:
        raise ValueError(f"all_gather: {x.shape[0]} rows do not split over "
                         f"{n} ranks")
    if x.device.type == "cpu":
        return all_gather_plain(x, 1 if n == 1 else N)
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() == 0:
        raise ValueError(f"all_gather: the shards {tuple(x.shape)} must be "
                         f"non-empty, contiguous and 16-byte aligned")
    nbytes = x.numel() // n * x.element_size()
    if n == 1:
        out = torch.empty_like(x)
        lib = csrc.load("allgather", _SIGNATURES)
        stream = torch.cuda.current_stream(out.device).cuda_stream
        with csrc.current_on(out.device):
            rc = lib.tdt_ag_copy(x.data_ptr(), out.data_ptr(), nbytes, 0,
                                 stream)
    else:
        out = torch.empty((N,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        lanes = lanes_for(nbytes)
        pad = family_pad(ctx, f"ag_{method}", axis, (n + 1) * lanes)
        ins = shd.group_table(ctx, x.view(n, -1), axis)
        outs, pads = shd.tables(ctx, out, pad)
        lib = csrc.load("allgather", _SIGNATURES)
        args = shd.launch_args(ctx)
        with csrc.current_on(out.device):
            rc = getattr(lib, f"tdt_ag_{method}")(ins, outs, nbytes, lanes,
                                                  pads, N, ctypes.byref(group),
                                                  *args)
    csrc.check(lib, rc, f"all_gather ({method})")
    all_gather.launches += 1
    return out


all_gather.launches = 0

__all__ = ["METHODS", "PUSH_BYTES_CEILING", "all_gather", "all_gather_plain",
           "auto_method"]
