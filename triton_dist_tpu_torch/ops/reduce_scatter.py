"""The ring reduce-scatter (TPU kernel B13), over groups and across axes.

Counterpart of ``reduce_scatter`` in ``triton_dist_tpu/ops/reduce_scatter.py``
with the methods ``ring``, ``ring_2d``, ``xla`` and ``auto`` (``ring_2d``
with no axis on a multi-axis mesh, else ``ring``). Each rank holds a
full-size contribution of n segments; segment j starts at rank j + 1 and
travels n - 1 right-hops to its owner j, each rank adding its contribution
as it passes, in the contribution's own type (a bf16 ring rounds at every
hop, as the JAX kernel does). Over an axis inside a multi-axis mesh the
rings run in groups (``shmem.device.group_plan``). ``ring_2d`` is the
hierarchical scatter over every axis: each contribution's segment blocks
pre-permuted to ``[n_{k-1}, ..., n_0, seg]``, then the ring once per axis,
innermost first, each stage on every rank's own result of the last. It sums
in another order than one ring over the flattened mesh, so it is not that
ring's bits. ``xla``, which the reference leaves to XLA, is plain torch sums
over the groups, outermost first.

On a CUDA tensor each ring is one launch of a hand-written Hopper kernel
covering every rank on the card (``csrc/reduce_scatter.cu``); on a CPU
tensor its plain PyTorch version (``reduce_scatter_plain``; for ``ring_2d``
``reduce_scatter_2d_plain``, stage by stage), the same order and rounding.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.allgather import lanes_for
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.shmem import device as shd
from triton_dist_tpu_torch.shmem.device import group_plan

_P = ctypes.c_void_p
_I = ctypes.c_int
# in out comm seg_vecs lanes pads n group silent, then the launch arguments
_RS_SIG = [_P, _P, _P, ctypes.c_longlong, _I, _P, _I, _P, _I] \
    + shd.LAUNCH_SIG
_ENTRIES = {torch.float32: "tdt_rs_ring_f32",
            torch.bfloat16: "tdt_rs_ring_bf16"}
METHODS = ("auto", "ring", "ring_2d", "xla")


def reduce_scatter_plain(x, n: int):
    """The plain PyTorch version of one ring: segment j's ring, started by
    rank j + 1 and summed rank by rank up to its owner j, each sum rounded
    to x's type. ``x`` [n * M, ...], the n contributions rank-major."""
    segs = x.reshape(n, n, -1)                  # [rank, segment, elements]
    j = torch.arange(n)
    acc = segs[(j + 1) % n, j]
    for s in range(2, n + 1):
        acc = acc + segs[(j + s) % n, j]
    return acc.reshape((x.shape[0] // n,) + tuple(x.shape[1:]))


def _groups_plain(ctx, per_rank, axis):
    """The plain version of one ring over ``axis``'s groups: every rank's
    contribution ``per_rank`` [N, k] -> its reduced segment [N, k / n]."""
    n = ctx.axis_size(axis)
    return torch.stack([
        reduce_scatter_plain(per_rank[ctx.group_members(r, axis)].reshape(-1),
                             n).view(n, -1)[ctx.my_pe(r, ctx.group_axes(axis))]
        for r in range(ctx.num_ranks)])


def _ring(ctx, ins, seg_elems: int, like, axis, silent) -> torch.Tensor:
    """One launch of the ring over ``axis``'s groups: ``ins`` every rank's
    contribution of n segments of ``seg_elems`` (a peer table); returns
    every rank's reduced segment, [N, seg_elems]."""
    if like.dtype not in _ENTRIES:
        raise TypeError(f"reduce_scatter: f32 or bf16, got {like.dtype}")
    seg_bytes = seg_elems * like.element_size()
    if seg_bytes % 16 or seg_bytes == 0:
        raise ValueError(f"reduce_scatter: a segment of {seg_bytes} bytes; "
                         f"the kernel moves whole 16-byte vectors")
    _, group, _, _ = group_plan(ctx, axis)
    N = ctx.num_ranks
    out = torch.empty((N, seg_elems), dtype=like.dtype, device=like.device)
    comm = torch.empty((N, 2 * seg_elems), dtype=like.dtype,
                       device=like.device)
    lanes = lanes_for(seg_bytes)
    pad = family_pad(ctx, "rs_ring", axis, 4 * lanes)
    outs, comms, pads = shd.tables(ctx, out, comm, pad)
    lib = csrc.load("reduce_scatter",
                    {name: _RS_SIG for name in _ENTRIES.values()})
    args = shd.launch_args(ctx)
    with csrc.current_on(like.device):
        rc = getattr(lib, _ENTRIES[like.dtype])(
            ins, outs, comms, seg_bytes // 16, lanes, pads, N,
            ctypes.byref(group), -1 if silent is None else int(silent), *args)
    csrc.check(lib, rc, "reduce_scatter")
    reduce_scatter.launches += 1
    return out


def _cuda_input(x) -> None:
    shd.cuda_checks("reduce_scatter", x)
    if x.data_ptr() % 16:
        raise ValueError("reduce_scatter: the contributions must be 16-byte "
                         "aligned")


def reduce_scatter(ctx, x, axis=None, method: str = "auto",
                   silent_rank: int | None = None):
    """Reduce (sum) and scatter. ``x`` [n * M, ...] holds every rank's
    full-size contribution [M, ...] rank-major (the JAX package's global
    view of an array sharded on dim 0 over the axes and replicated over the
    others); rank r receives the sum of every contribution's segment r.
    Returns [M, ...], rank r's segment at rows ``r * M / n .. (r + 1) * M /
    n`` (the global view of the scattered result).

    ``axis``: a name (the ring over its groups), None (every axis on a
    multi-axis mesh for ``auto``, ``ring_2d`` and ``xla``; the first axis
    for ``ring``), or the tuple of every axis of the mesh in order (the same
    as None; a subset or a reorder raises ``ValueError``, as the
    reference's does). ``ring_2d`` with a named axis, or on a one-axis mesh,
    and an unknown method raise ``ValueError``.

    A CPU tensor runs the plain version. A CUDA tensor (f32 or bf16,
    contiguous, segments of whole 16-byte vectors) launches the kernel once
    a ring (``ring_2d``: once an axis), adding one to
    ``reduce_scatter.launches`` each time, or raises. ``silent_rank`` (n >
    1, the card) names a rank that never signals its deliveries: the call
    then raises ``ShmemError`` once the spin budget has passed."""
    names = tuple(ctx.axis_names)
    if axis is not None and not isinstance(axis, str):
        if tuple(axis) != names:
            raise ValueError(f"a reduce_scatter over several axes spans every "
                             f"axis of the mesh {names}, in order; got "
                             f"{tuple(axis)!r}")
        axis = None
    if method not in METHODS:
        raise ValueError(f"unknown reduce_scatter method {method!r}; expected "
                         f"one of {METHODS}")
    if method == "xla":
        return _rs_xla(ctx, x, names if axis is None else (axis,))
    if method == "auto":
        method = "ring_2d" if axis is None and len(names) > 1 else "ring"
    if method == "ring_2d":
        if axis is not None:
            raise ValueError(f"ring_2d reduce_scatter spans every axis of the "
                             f"mesh; it takes no axis={axis!r} (use "
                             f"method='ring' over one axis)")
        if len(names) < 2:
            raise ValueError(f"ring_2d reduce_scatter needs a mesh of two or "
                             f"more axes; the mesh's axes are {names}")
        return _rs_ring_2d(ctx, x, silent_rank)
    axis = axis or names[0]
    n = ctx.axis_size(axis)
    if x.shape[0] % (n * n):
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows are not {n} "
                         f"contributions of {n} segments")
    if x.device.type == "cpu":
        return reduce_scatter_plain(x, n)
    _cuda_input(x)
    out = _ring(ctx, shd.group_table(ctx, x.view(n, -1), axis),
                x.numel() // (n * n), x, axis, silent_rank)
    members = list(group_plan(ctx, axis)[3])
    if len(members) < ctx.num_ranks:
        out = out[members]                      # rank 0's group's segments
    return out.view((x.shape[0] // n,) + tuple(x.shape[1:]))


reduce_scatter.launches = 0


def _rs_xla(ctx, x, involved: tuple):
    """``method="xla"``: the reference leaves the scatter over ``involved``
    to XLA's ``psum_scatter``, outermost first; here plain torch sums over
    each axis's groups in that order give the global view."""
    sizes = tuple(ctx.axis_size(a) for a in involved)
    n = ctx.axis_size(involved)
    if x.shape[0] % (n * n):
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows are not {n} "
                         f"contributions of {n} segments")
    y = x.reshape(sizes + (x.shape[0] // n,) + tuple(x.shape[1:]))
    for _ in involved:
        y = y.sum(0)
    return y


def _permuted_contributions(ctx, x):
    """Every rank's contribution of ``x`` [N * M, ...] with its segment
    blocks pre-permuted to ``[n_{k-1}, ..., n_0, seg]``, flattened: [N,
    M * ...]. Peeling one axis a stage, innermost first, then leaves rank
    (c_0, ..., c_{k-1}) with the row-major ``P(axes)`` segment."""
    sizes = tuple(ctx.axis_size(a) for a in ctx.axis_names)
    N = ctx.num_ranks
    if x.shape[0] % (N * N):
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows are not {N} "
                         f"contributions of {N} segments")
    k = len(sizes)
    xr = x.reshape((N,) + sizes + (x.shape[0] // (N * N),)
                   + tuple(x.shape[1:]))
    perm = (0,) + tuple(range(k, 0, -1)) + tuple(range(k + 1, xr.dim()))
    return xr.permute(perm).reshape(N, -1).contiguous()


def reduce_scatter_2d_plain(ctx, x):
    """The plain version of ``ring_2d``: the pre-permute, then one plain
    ring over each axis's groups, innermost first, each sum rounded to x's
    type. Returns the global view [M, ...]."""
    per_rank = _permuted_contributions(ctx, x)
    for ax in reversed(ctx.axis_names):
        per_rank = _groups_plain(ctx, per_rank, ax)
    return per_rank.reshape((x.shape[0] // ctx.num_ranks,)
                            + tuple(x.shape[1:]))


def _rs_ring_2d(ctx, x, silent_rank=None):
    """The hierarchical scatter over every axis: B13 along each axis,
    innermost first, each stage on every rank's own result of the stage
    before (axes of one rank skipped)."""
    if x.device.type == "cpu":
        return reduce_scatter_2d_plain(ctx, x)
    _cuda_input(x)
    per_rank = _permuted_contributions(ctx, x)
    for ax in reversed(ctx.axis_names):
        n = ctx.axis_size(ax)
        if n > 1:
            (ins,) = shd.tables(ctx, per_rank)
            per_rank = _ring(ctx, ins, per_rank.shape[1] // n, x, ax,
                             silent_rank)
    return per_rank.reshape((x.shape[0] // ctx.num_ranks,)
                            + tuple(x.shape[1:]))


__all__ = ["METHODS", "reduce_scatter", "reduce_scatter_2d_plain",
           "reduce_scatter_plain"]
