"""The ring reduce-scatter (TPU kernel B13).

Counterpart of ``reduce_scatter`` in ``triton_dist_tpu/ops/reduce_scatter.py``
with the method ``ring`` (``auto`` picks it on one axis). Each rank holds a
full-size contribution of n segments; segment j starts at rank j + 1 and
travels n - 1 right-hops to its owner j, each rank adding its contribution
as it passes, in the contribution's own type (a bf16 ring rounds at every
hop, as the JAX kernel does). On a CUDA tensor it is one launch of a
hand-written Hopper kernel covering every rank on the card
(``csrc/reduce_scatter.cu``); on a CPU tensor its plain PyTorch version
(``reduce_scatter_plain``), the same order and rounding. ``ring_2d`` (the
hierarchical scatter) and ``xla`` raise ``NotImplementedError``: ROADMAP.md
Queue A, item 5 "collectives".
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.allgather import lanes_for
from triton_dist_tpu_torch.ops.common import (COLLECTIVES, family_pad,
                                              spans_every_rank)
from triton_dist_tpu_torch.shmem import device as shd

_P = ctypes.c_void_p
_RS_SIG = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, ctypes.c_int] \
    + shd.LAUNCH_SIG                 # in out comm seg_vecs lanes pads n ...
_ENTRIES = {torch.float32: "tdt_rs_ring_f32",
            torch.bfloat16: "tdt_rs_ring_bf16"}
METHODS = ("auto", "ring")


def reduce_scatter_plain(x, n: int):
    """The plain PyTorch version of ``reduce_scatter``: segment j's ring,
    started by rank j + 1 and summed rank by rank up to its owner j, each
    sum rounded to x's type."""
    segs = x.reshape(n, n, -1)                  # [rank, segment, elements]
    j = torch.arange(n)
    acc = segs[(j + 1) % n, j]
    for s in range(2, n + 1):
        acc = acc + segs[(j + s) % n, j]
    return acc.reshape((x.shape[0] // n,) + tuple(x.shape[1:]))


def reduce_scatter(ctx, x, axis: str | None = None, method: str = "auto"):
    """Reduce (sum) and scatter over ``axis``. ``x`` [n * M, ...] holds
    every rank's full-size contribution [M, ...] rank-major (the JAX
    package's global view of an array sharded on dim 0); rank r receives
    the sum of every contribution's segment r. Returns [M, ...], rank r's
    segment at rows ``r * M / n .. (r + 1) * M / n`` (the global view of the
    scattered result).

    A CPU tensor runs the plain version. A CUDA tensor (f32 or bf16,
    contiguous, segments of whole 16-byte vectors) launches the kernel,
    adding one to ``reduce_scatter.launches``, or raises."""
    if method not in METHODS:
        raise NotImplementedError(
            f"reduce_scatter: method {method!r} is not ported (the port takes "
            f"{METHODS}; ring_2d and xla wait for {COLLECTIVES})")
    if axis is not None and not isinstance(axis, str):
        raise NotImplementedError(
            f"reduce_scatter over the axes {tuple(axis)} (the hierarchical "
            f"ring_2d) is not ported yet: {COLLECTIVES}")
    axis = axis or ctx.axis_names[0]
    n = spans_every_rank(ctx, axis, "reduce_scatter")
    if x.shape[0] % (n * n):
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows are not {n} "
                         f"contributions of {n} segments")
    if x.device.type == "cpu":
        return reduce_scatter_plain(x, n)
    shd.cuda_checks("reduce_scatter", x)
    if x.dtype not in _ENTRIES:
        raise TypeError(f"reduce_scatter: f32 or bf16, got {x.dtype}")
    seg_bytes = x.numel() // (n * n) * x.element_size()
    if seg_bytes % 16 or seg_bytes == 0 or x.data_ptr() % 16:
        raise ValueError(f"reduce_scatter: a segment of {seg_bytes} bytes; "
                         f"the kernel moves whole 16-byte vectors")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    comm = torch.empty((n, 2 * seg_bytes // x.element_size()),
                       dtype=x.dtype, device=x.device)
    lanes = lanes_for(seg_bytes)
    pad = family_pad(ctx, "rs_ring", axis, 4 * lanes)
    ins, outs, comms, pads = shd.tables(ctx, x.view(n, -1), out.view(n, -1),
                                        comm, pad)
    lib = csrc.load("reduce_scatter",
                    {name: _RS_SIG for name in _ENTRIES.values()})
    args = shd.launch_args(ctx)
    with csrc.current_on(x.device):
        rc = getattr(lib, _ENTRIES[x.dtype])(ins, outs, comms,
                                             seg_bytes // 16, lanes, pads, n,
                                             *args)
    csrc.check(lib, rc, "reduce_scatter")
    reduce_scatter.launches += 1
    return out


reduce_scatter.launches = 0

__all__ = ["METHODS", "reduce_scatter", "reduce_scatter_plain"]
