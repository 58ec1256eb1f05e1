"""The all-gathers (TPU kernels B9, B10, B11) and the broadcast (B12).

Counterpart of ``triton_dist_tpu/ops/allgather.py``:

- ``all_gather`` with the methods ``push`` and ``ring`` (B9) over one axis
  or one group of axes; ``push_2d`` (B11), the 2-tier relay over several
  axes in one kernel; ``ring_2d``, B9's ring once per axis, innermost
  first; ``xla``, which the reference leaves to XLA and the port to plain
  torch ops; and ``auto``, which picks as ``_auto_method`` does (over
  several axes ``push_2d`` up to a shard of 256 KiB, else ``ring_2d``; over
  one axis ``push`` at up to four ranks or up to 256 KiB, else ``ring``);
- ``all_gather_ll`` (B10), the barrier-free low-latency push into a
  persistent workspace keyed by the call's parity, with
  ``create_ag_ll_workspace`` and ``AgLLContext``, which owns the workspace
  and the call count;
- ``broadcast`` (B12), the root's block into every rank's output.

Each rank's shard [m, ...] lands in its slot of every rank's gathered
[n * m, ...]. On a CUDA tensor each is a hand-written Hopper kernel
(``csrc/allgather.cu``, the relay in ``csrc/ag_relay_2d.cuh``): at one rank
the copy of the shard into slot 0, at n ranks one launch covering every rank
of the mesh on the card (see ``shmem/context.py``). Over an axis inside a
multi-axis mesh a gather runs in groups (``shmem.device.group_plan``): each
rank gathers its own group's shards and talks to its group only. On a CPU
tensor each runs its plain PyTorch version. An unknown method raises
``ValueError``, as the reference's ``_ag_call`` does, and so do
``push_2d``/``ring_2d`` on a one-axis mesh.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.shmem import device as shd
from triton_dist_tpu_torch.shmem.device import group_plan

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# in out nbytes lanes pads n group silent, then the launch arguments
_GATHER_SIG = [_P, _P, _L, _I, _P, _I, _P, _I] + shd.LAUNCH_SIG
_SIGNATURES = {"tdt_ag_copy": [_P, _P, _L, _I, _P],    # shard out nbytes slot
               "tdt_ag_push": _GATHER_SIG, "tdt_ag_ring": _GATHER_SIG,
               "tdt_ag_push_2d": _GATHER_SIG,
               # in ws out nbytes lanes phase pads n group silent ...
               "tdt_ag_ll": [_P, _P, _P, _L, _I, _I, _P, _I, _P, _I]
               + shd.LAUNCH_SIG,
               # in out nbytes lanes root pads n group silent ...
               "tdt_bcast": [_P, _P, _L, _I, _I, _P, _I, _P, _I]
               + shd.LAUNCH_SIG}
METHODS = ("auto", "push", "ring", "push_2d", "ring_2d", "xla")
# below this shard size the gather is latency-bound and the one-hop push
# wins (the JAX package's _PUSH_BYTES_CEILING)
PUSH_BYTES_CEILING = 256 * 1024
# bytes of a shard one block moves at least
LANE_BYTES = 64 * 1024
# the same for the low-latency gather, whose payloads are 4-64 KiB
LL_LANE_BYTES = 8 * 1024


def _lib():
    return csrc.load("allgather", _SIGNATURES)


def _silent(rank) -> int:
    return -1 if rank is None else int(rank)


def all_gather_plain(x, n: int = 1):
    """The plain PyTorch version of ``all_gather``: at one rank the copy of
    the shard; at n ranks every rank's replica of ``x``, [n, *x.shape]."""
    if n == 1:
        out = torch.empty_like(x)
        out.copy_(x)
        return out
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone()


def broadcast_plain(x, root: int, n: int):
    """The plain version of ``broadcast``: every rank's copy of
    ``x[root]``, [n, ...]."""
    return x[root].unsqueeze(0).expand((n,) + tuple(x.shape[1:])).clone()


def _spans_axes(ctx, axis) -> bool:
    return (axis is None and len(ctx.axis_names) > 1) or (
        isinstance(axis, tuple) and len(axis) > 1)


def auto_method(ctx, x, axis) -> str:
    """``_auto_method``'s pick: over several axes (``axis=None`` on a
    multi-axis mesh, or a tuple) ``push_2d`` up to a shard of
    ``PUSH_BYTES_CEILING``, else ``ring_2d``; over one axis ``push`` at up
    to four ranks or that shard size, else ``ring``."""
    n = ctx.axis_size(axis)
    shard_bytes = (x.numel() // max(n, 1)) * x.element_size()
    if _spans_axes(ctx, axis):
        return "push_2d" if shard_bytes <= PUSH_BYTES_CEILING else "ring_2d"
    if n <= 4 or shard_bytes <= PUSH_BYTES_CEILING:
        return "push"
    return "ring"


def lanes_for(nbytes: int, lane_bytes: int = LANE_BYTES) -> int:
    """Blocks a rank's shard is cut into: one per ``lane_bytes``. The
    launch cuts them to what the card keeps resident at once over all n
    ranks (``resident_lanes`` in ``csrc/shmem.cuh``), so the signal pad
    sized for these is large enough."""
    return max(1, -(-nbytes // lane_bytes))


def _cuda_shards(name: str, x) -> None:
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() == 0:
        raise ValueError(f"{name}: the shards {tuple(x.shape)} must be "
                         f"non-empty, contiguous and 16-byte aligned")


def _rows(name: str, x, n: int) -> None:
    if x.shape[0] % n:
        raise ValueError(f"{name}: {x.shape[0]} rows do not split over {n} "
                         f"ranks")


def _copy(x):
    """The gather at one rank: the copy of the shard into slot 0 (B9's
    one-rank form on the card)."""
    if x.device.type == "cpu":
        return all_gather_plain(x)
    _cuda_shards("all_gather", x)
    out = torch.empty_like(x)
    lib = _lib()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with csrc.current_on(out.device):
        rc = lib.tdt_ag_copy(x.data_ptr(), out.data_ptr(),
                             x.numel() * x.element_size(), 0, stream)
    csrc.check(lib, rc, "all_gather (copy)")
    all_gather.launches += 1
    return out


def _gather(ctx, method: str, ins, nbytes: int, axis, out, silent) -> None:
    """One launch of B9's ``method`` over ``axis``'s groups: ``ins`` every
    rank's shard of ``nbytes`` (a peer table), ``out`` [N, n * nbytes]
    every rank's replica."""
    n, group, _, _ = group_plan(ctx, axis)
    lanes = lanes_for(nbytes)
    pad = family_pad(ctx, f"ag_{method}", axis, (n + 1) * lanes)
    outs, pads = shd.tables(ctx, out, pad)
    lib = _lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(out.device):
        rc = getattr(lib, f"tdt_ag_{method}")(ins, outs, nbytes, lanes, pads,
                                              ctx.num_ranks,
                                              ctypes.byref(group),
                                              _silent(silent), *args)
    csrc.check(lib, rc, f"all_gather ({method})")
    all_gather.launches += 1


def _rank_rows(ctx, x, axis):
    """Every rank's own shard of ``x`` [n * m, ...] (sharded over ``axis``,
    replicated over the other axes), flattened: [N, m * ...]."""
    n, _, index, _ = group_plan(ctx, axis)
    return x.reshape(n, -1)[list(index)]


def _gather_groups_plain(ctx, per_rank, axis):
    """The plain version of one group gather: every rank's concatenation of
    its group's rows along ``axis``, [N, k] -> [N, n * k]."""
    return torch.stack([per_rank[ctx.group_members(r, axis)].reshape(-1)
                        for r in range(ctx.num_ranks)])


def all_gather(ctx, x, axis=None, method: str = "auto",
               silent_rank: int | None = None):
    """Gather every rank's shard along ``axis``: a name, a tuple of names
    (one group over them, major to minor), or None (a one-axis mesh's axis;
    on a multi-axis mesh every axis, for the methods that span several).
    ``x`` [n * m, ...] holds the n shards of a group rank-major (index r's
    at rows ``r * m .. (r + 1) * m``: the JAX package's global view of an
    array sharded on dim 0 over the axes and replicated over the others). At
    one rank along the axes it returns the gathered [m, ...]; at n it
    returns every rank of the mesh's replica, [N, n * m, ...] (N the mesh's
    ranks), each the concatenation of its group's shards bit for bit.

    ``method``: ``push``/``ring`` (B9) over one group, and with
    ``axis=None`` on a multi-axis mesh they raise ``ValueError`` (they need
    ``axis=``, as the reference's do); ``push_2d`` (B11) and ``ring_2d``
    over the tuple ``axis`` (the mesh's axes for a name or None, as the
    reference takes them; outer axis first), which raise ``ValueError`` on
    a one-axis mesh; ``xla`` (plain torch); ``auto`` (``auto_method``). An
    unknown method raises ``ValueError``.

    A CPU tensor runs the plain version. A CUDA tensor (contiguous, 16-byte
    aligned, any type) launches the kernel or raises: B9's launches add to
    ``all_gather.launches`` (``ring_2d`` is one a non-trivial axis), B11's
    to ``all_gather_push_2d.launches``. ``silent_rank`` (n > 1, the card)
    names a rank that puts but never signals: the call then raises
    ``ShmemError`` once the spin budget has passed."""
    names = tuple(ctx.axis_names)
    if method not in METHODS:
        raise ValueError(f"unknown allgather method {method!r}; expected one "
                         f"of {METHODS}")
    if isinstance(axis, list):
        axis = tuple(axis)
    if axis is None and len(names) == 1:
        axis = names[0]
    if method == "xla":
        involved = axis if isinstance(axis, tuple) \
            else names if axis is None else (axis,)
        return _ag_xla(ctx, x, involved)
    if method == "auto":
        method = auto_method(ctx, x, axis)
    if method in ("push_2d", "ring_2d"):
        if len(names) < 2 and not (isinstance(axis, tuple) and len(axis) > 1):
            raise ValueError(f"{method} all_gather needs a mesh of two or "
                             f"more axes; the mesh's axes are {names}")
        axes = axis if isinstance(axis, tuple) else names
        if method == "push_2d":
            return all_gather_push_2d(ctx, x, axes, silent_rank=silent_rank)
        return _ag_ring_2d(ctx, x, axes, silent_rank)
    if axis is None:
        raise ValueError(f"all_gather(method={method!r}) on a multi-axis mesh "
                         f"{names} requires an explicit axis=")
    n = ctx.axis_size(axis)
    _rows("all_gather", x, n)
    if n == 1:
        return _copy(x)
    if x.device.type == "cpu":
        return all_gather_plain(x, ctx.num_ranks)
    _cuda_shards("all_gather", x)
    out = torch.empty((ctx.num_ranks,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    ins = shd.group_table(ctx, x.view(n, -1), axis)
    _gather(ctx, method, ins, x.numel() // n * x.element_size(), axis, out,
            silent_rank)
    return out


all_gather.launches = 0


def _ag_xla(ctx, x, involved: tuple):
    """``method="xla"``: the reference leaves the gather over ``involved``
    to XLA's collectives; here plain torch ops give every rank's replica."""
    n = ctx.axis_size(involved)
    _rows("all_gather", x, n)
    return all_gather_plain(x, 1 if n == 1 else ctx.num_ranks)


def all_gather_push_2d(ctx, x, axes, silent_rank: int | None = None):
    """``all_gather(method="push_2d")`` over the tuple ``axes`` (outer
    first): the 2-tier relay in one kernel (B11). ``x`` [n * m, ...] sharded
    rank-major over the flattened axes (``P(axes)``); returns [N, n * m,
    ...], every rank's replica. A CUDA tensor launches the kernel, adding
    one to ``all_gather_push_2d.launches``."""
    axes = tuple(axes)
    n = ctx.axis_size(axes)
    _rows("all_gather", x, n)
    if n == 1:
        return _copy(x)
    if x.device.type == "cpu":
        return all_gather_plain(x, ctx.num_ranks)
    _cuda_shards("all_gather push_2d", x)
    N = ctx.num_ranks
    out = torch.empty((N,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    nbytes = x.numel() // n * x.element_size()
    lanes = lanes_for(nbytes)
    pad = family_pad(ctx, "ag_push_2d", axes, lanes + N + 1)
    ins = shd.group_table(ctx, x.view(n, -1), axes)
    outs, pads = shd.tables(ctx, out, pad)
    relay = shd.relay_plan(ctx, axes)
    lib = _lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(out.device):
        rc = lib.tdt_ag_push_2d(ins, outs, nbytes, lanes, pads, N,
                                ctypes.byref(relay), _silent(silent_rank),
                                *args)
    csrc.check(lib, rc, "all_gather (push_2d)")
    all_gather_push_2d.launches += 1
    return out


all_gather_push_2d.launches = 0


def _ag_ring_2d(ctx, x, axes: tuple, silent_rank=None):
    """``ring_2d``: B9's ring along each of ``axes``, innermost first. Stage
    k gathers, in each rank's group along its axis, every member's own
    stage k - 1 result (each rank's replica, never a shared copy), so the
    rows end in the ``P(axes)`` order. Axes of one rank are skipped."""
    n = ctx.axis_size(axes)
    _rows("all_gather", x, n)
    if n == 1:
        return _copy(x)
    N = ctx.num_ranks
    if x.device.type == "cpu":
        cur = _rank_rows(ctx, x, axes)
        for ax in reversed(axes):
            cur = _gather_groups_plain(ctx, cur, ax)
        return cur.view((N,) + tuple(x.shape))
    _cuda_shards("all_gather ring_2d", x)
    nbytes = x.numel() // n * x.element_size()
    ins = shd.group_table(ctx, x.view(n, -1), axes)
    out = None
    for ax in reversed(axes):
        k = ctx.axis_size(ax)
        if k == 1:
            continue
        out = torch.empty((N, k * nbytes), dtype=torch.uint8, device=x.device)
        _gather(ctx, "ring", ins, nbytes, ax, out, silent_rank)
        (ins,) = shd.tables(ctx, out)
        nbytes *= k
    return out.view(x.dtype).view((N,) + tuple(x.shape))


def create_ag_ll_workspace(ctx, m_local: int, trailing: tuple, dtype,
                           axis: str | None = None):
    """The symmetric workspace of ``all_gather_ll``: every rank's [2, n,
    m_local, *trailing] (an arrival slot per parity and segment), [N, 2, n,
    m_local, ...] in all, zeros."""
    n = ctx.axis_size(axis or ctx.axis_names[0])
    return ctx.create_symm_tensor((2, n, m_local) + tuple(trailing), dtype)


def all_gather_ll(ctx, x, ws, phase, axis: str | None = None,
                  silent_rank: int | None = None):
    """The low-latency all-gather (B10) of small (4-64 KiB a rank) shards:
    one barrier-free launch whose arrivals land in the persistent
    workspace ``ws`` (``create_ag_ll_workspace``) at the slots of the call's
    parity ``phase`` (an int or a one-element tensor: the call count modulo
    2; the caller alternates it every call, as ``AgLLContext`` does). ``x``
    [n * m, ...] as in ``all_gather``. Returns ``(out, ws)``: every rank's
    replica [N, n * m, ...] (at one rank the copy, [m, ...]), and the
    workspace, written in place (rank r's slot (phase, s) holds shard s for
    every s but r's own index).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``csrc/allgather.cu``), adding one to ``all_gather_ll.launches``, or
    raises. ``silent_rank`` as in ``all_gather``.

    The parity guards the TPU's one-call-ahead race (a peer's next call
    putting into a slot of this one), which cannot show while every rank
    runs in one launch. Its signals live in the family's own pad
    (``family_pad``), so the TPU kernel's interleaving hazard, its
    semaphores aliasing another kernel's between paired calls, cannot arise
    either."""
    axis = axis or ctx.axis_names[0]
    n, group, index, _ = group_plan(ctx, axis)
    N = ctx.num_ranks
    _rows("all_gather_ll", x, n)
    phase = int(phase.reshape(-1)[0]) if torch.is_tensor(phase) \
        else int(phase)
    if phase not in (0, 1):
        raise ValueError(f"all_gather_ll: phase {phase} is not 0 or 1")
    m = x.shape[0] // n
    want = (N, 2, n, m) + tuple(x.shape[1:])
    if tuple(ws.shape) != want or ws.dtype != x.dtype:
        raise ValueError(f"all_gather_ll: the workspace must be {want} "
                         f"{x.dtype}, got {tuple(ws.shape)} {ws.dtype}")
    if n == 1:
        return _copy(x), ws
    shards = x.view((n, m) + tuple(x.shape[1:]))
    if x.device.type == "cpu":
        for r in range(N):
            for s in range(n):
                if s != index[r]:
                    ws[r, phase, s] = shards[s]
        return all_gather_plain(x, N), ws
    _cuda_shards("all_gather_ll", x)
    shd.cuda_checks("all_gather_ll", x, ws)
    out = torch.empty((N,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    nbytes = x.numel() // n * x.element_size()
    lanes = lanes_for(nbytes, LL_LANE_BYTES)
    pad = family_pad(ctx, "ag_ll", axis, 2 * n * lanes)
    ins = shd.group_table(ctx, x.view(n, -1), axis)
    wss, outs, pads = shd.tables(ctx, ws, out, pad)
    lib = _lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(out.device):
        rc = lib.tdt_ag_ll(ins, wss, outs, nbytes, lanes, phase, pads, N,
                           ctypes.byref(group), _silent(silent_rank), *args)
    csrc.check(lib, rc, "all_gather_ll")
    all_gather_ll.launches += 1
    return out, ws


all_gather_ll.launches = 0


class AgLLContext:
    """``all_gather_ll`` with its state: the workspace and the call count,
    whose parity keys each call's slots and signal words (the reference's
    LL contexts keep the same parity). Eager, as every op of the port."""

    def __init__(self, ctx, m_local: int, trailing: tuple, dtype,
                 axis: str | None = None):
        self.ctx = ctx
        self.axis = axis or ctx.axis_names[0]
        self.ws = create_ag_ll_workspace(ctx, m_local, trailing, dtype,
                                         self.axis)
        self.calls = 0

    def __call__(self, x, silent_rank: int | None = None):
        out, self.ws = all_gather_ll(self.ctx, x, self.ws, self.calls % 2,
                                     self.axis, silent_rank=silent_rank)
        self.calls += 1
        return out


def broadcast(ctx, x, axis: str | None = None, root: int = 0,
              silent_rank: int | None = None):
    """Broadcast the block of the rank at index ``root`` along ``axis`` to
    every member of its group (B12). ``x`` [n, ...] holds one candidate
    block per index (sharded over ``axis``, replicated over the other
    axes); returns every rank's copy of ``x[root]``, [N, ...] (at one rank
    the copy, [...]). A root outside [0, n) raises ``ValueError``.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``csrc/allgather.cu``: after an entry barrier the root puts its block
    into every member's output, each member waits for one delivery),
    adding one to ``broadcast.launches``, or raises. ``silent_rank`` as in
    ``all_gather``."""
    axis = axis or ctx.axis_names[0]
    n, group, _, _ = group_plan(ctx, axis)
    N = ctx.num_ranks
    if not 0 <= root < n:
        raise ValueError(f"broadcast: root {root} is not a rank of the {n} "
                         f"along {axis!r}")
    if x.shape[0] != n:
        raise ValueError(f"broadcast: {x.shape[0]} candidate blocks for {n} "
                         f"ranks")
    if n == 1:
        return x[root].clone()
    if x.device.type == "cpu":
        return broadcast_plain(x, root, N)
    _cuda_shards("broadcast", x)
    out = torch.empty((N,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    nbytes = x[0].numel() * x.element_size()
    lanes = lanes_for(nbytes)
    pad = family_pad(ctx, "bcast", axis, 2 * lanes)
    ins = shd.group_table(ctx, x, axis)
    outs, pads = shd.tables(ctx, out, pad)
    lib = _lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(out.device):
        rc = lib.tdt_bcast(ins, outs, nbytes, lanes, root, pads, N,
                           ctypes.byref(group), _silent(silent_rank), *args)
    csrc.check(lib, rc, "broadcast")
    broadcast.launches += 1
    return out


broadcast.launches = 0

__all__ = ["AgLLContext", "METHODS", "PUSH_BYTES_CEILING", "all_gather",
           "all_gather_ll", "all_gather_plain", "all_gather_push_2d",
           "auto_method", "broadcast", "broadcast_plain",
           "create_ag_ll_workspace"]
