"""The device half of the shmem layer, named for Python readers, its error
report, and the ring ping that is its first gate.

Counterpart of ``triton_dist_tpu/shmem/device.py`` and ``language.py``. The
device functions themselves are CUDA, in ``csrc/shmem.cuh``, and the
collective kernels include them:

- identity: ``my_pe`` (the rank, the launch's ``blockIdx.y``), ``n_pes``,
  ``pe_at``; the host-side flat ids are ``ShmemContext.my_pe`` /
  ``pe_at`` / ``pe_at_group``, row-major over the axes as JAX's are;
- puts: ``putmem_block``, ``putmem_nbi_block`` (block-cooperative stores
  into a peer's buffer, reached through a ``PeerTable``),
  ``putmem_signal_block``;
- signals: ``signal_op`` (ADD or SET, with a release),
  ``signal_wait_until`` (an acquire spin that consumes what it waited for,
  as JAX's ``semaphore_wait`` does), ``signal_op_block`` / ``wait_block``
  (the block-wide producer and consumer halves);
- ordering and barriers: ``quiet``, ``fence``, ``barrier_all_block``,
  ``barrier_pair_block``;
- the reference's ``dl`` names: ``dl::rank``, ``num_ranks``, ``wait``,
  ``consume_token``, ``notify``, ``symm_at``.

Every spin is bounded by ``SPIN_BUDGET_S`` (a second). A spin that runs
out writes the kernel, rank and signal into a report in mapped host memory;
``check_errors`` reads it (after a synchronisation) and raises
``ShmemError``, and every collective wrapper reads it, without a
synchronisation, before it launches. The starved call itself returns its
output unfinished: work queued after it without a synchronisation runs on
that output, so a caller that uses a result calls ``check_errors`` first
(after a decode loop, say).

``ring_ping`` is the port of ``tutorials/t01_notify_wait.py``: each rank
puts its block into its right neighbour's buffer and signals, and waits for
its left neighbour's; afterwards rank r holds rank r-1's block.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.shmem.context import (MAX_RANKS, SPIN_BUDGET_S,
                                                 clear_live_signal_pads, watch)

# csrc/shmem.cuh's Kernel ids
KERNELS = {1: "barrier_all_op", 2: "ring_ping", 3: "all_gather push",
           4: "all_gather ring", 5: "reduce_scatter ring", 6: "ll_ag_merge",
           7: "ag_gemm", 8: "gemm_rs", 9: "all_to_all_push",
           10: "all_to_all_push_seg", 11: "flash_decode_dist fold",
           12: "pool_ag_start_local", 13: "paged_transport",
           14: "ag_moe_group_gemm", 15: "moe_reduce_rs",
           16: "all_gather_ll", 17: "all_gather push_2d", 18: "broadcast",
           19: "ag_gemm 2-tier", 20: "ag_moe_group_gemm 2-tier",
           21: "ring_attention_fwd", 22: "ring_attention_bwd",
           23: "sigcheck gallery"}
_REPORT_WORDS = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
# the launch arguments every kernel of the layer ends with
LAUNCH_SIG = [_P, _P, _U, _P]                 # claim report budget_ns stream
_SIGNATURES = {
    "tdt_barrier_all": [_P, _I, _P, _P] + LAUNCH_SIG,
    "tdt_ring_ping": [_P, _P, _L, _P, _I, _I] + LAUNCH_SIG,
    "tdt_shmem_host_alloc": [_I, _P, _P],
}


class Group(ctypes.Structure):
    """``csrc/shmem.cuh``'s Group: the groups of a launch over every rank
    of a mesh. Rank r is member ``index[r]`` of a group of ``n``, whose
    member i is flat rank ``pe[r][i]``."""

    _fields_ = [("n", ctypes.c_int),
                ("index", ctypes.c_byte * MAX_RANKS),
                ("pe", (ctypes.c_byte * MAX_RANKS) * MAX_RANKS)]


def group_struct(ctx, axis) -> Group:
    """The Group of ``axis`` (a name, a tuple of names, or None for the
    whole mesh) over every rank of ``ctx``."""
    g = Group()
    g.n = ctx.axis_size(axis)
    for r in range(ctx.num_ranks):
        g.index[r] = ctx.my_pe(r, ctx.group_axes(axis))
        for i, pe in enumerate(ctx.group_members(r, axis)):
            g.pe[r][i] = pe
    return g


_plans: dict = {}


def group_plan(ctx, axis) -> tuple:
    """(ranks in each group along ``axis``, the launch's ``Group``, every
    rank's index in its group, rank 0's group's flat ids), made once per
    mesh shape and axis. ``axis`` is a name, a tuple of names (flattened
    major to minor, as JAX's ``pe_at_group``), or None for the whole mesh;
    the groups are the ranks that share every other coordinate, and one
    launch covers every rank of the mesh."""
    if axis is not None and not isinstance(axis, str):
        axis = tuple(axis)
    key = (tuple(ctx.axis_names), tuple(ctx.mesh_shape), axis)
    plan = _plans.get(key)
    if plan is None:
        axes = ctx.group_axes(axis)
        plan = _plans[key] = (
            ctx.axis_size(axis), group_struct(ctx, axis),
            tuple(ctx.my_pe(r, axes) for r in range(ctx.num_ranks)),
            tuple(ctx.group_members(0, axis)))
    return plan


_group_ids: dict = {}


def group_ids(ctx, axis) -> tuple[int, ...]:
    """Every rank's group number along ``axis`` (as ``group_plan`` takes
    it): the groups numbered in the order of their lowest flat id, so rank
    0's group is group 0. An op over a group inside a multi-axis mesh
    writes one result a group (``[G, ...]``, G = ranks / group size) and
    each rank's kernel finds its group's through these numbers."""
    if axis is not None and not isinstance(axis, str):
        axis = tuple(axis)
    key = (tuple(ctx.axis_names), tuple(ctx.mesh_shape), axis)
    ids = _group_ids.get(key)
    if ids is None:
        firsts = [min(ctx.group_members(r, axis))
                  for r in range(ctx.num_ranks)]
        order = sorted(set(firsts))
        ids = _group_ids[key] = tuple(order.index(f) for f in firsts)
    return ids


def group_order(ctx, axis) -> tuple[int, ...]:
    """The flat ids of every group along ``axis``, group by group (in
    ``group_ids``' numbering), each in group-index order: ``x[order]`` of a
    per-rank result [N, ...] is every group's global view, [G * n, ...]."""
    ids = group_ids(ctx, axis)
    reps = {}
    for r, g in enumerate(ids):
        reps.setdefault(g, r)
    return tuple(p for g in range(len(reps))
                 for p in ctx.group_members(reps[g], axis))


def group_rows(ctx, x, axis, offsets=None):
    """The table of one result a group: ``x`` [G, ...] contiguous, every
    rank pointing at its group's row (``group_ids``), plus its own byte
    offset ``offsets[r]`` when given."""
    ids = group_ids(ctx, axis)
    if x.shape[0] != max(ids) + 1 or not x.is_contiguous():
        raise ValueError(f"one result a group is contiguous [{max(ids) + 1},"
                         f" ...] over {axis!r}, got {tuple(x.shape)}")
    watch(x)
    step = x.numel() // x.shape[0] * x.element_size()
    return (ctypes.c_void_p * ctx.num_ranks)(*(
        x.data_ptr() + g * step + (offsets[r] if offsets else 0)
        for r, g in enumerate(ids)))


class Relay2d(ctypes.Structure):
    """``csrc/ag_relay_2d.cuh``'s Relay2d: the tiers of a 2-tier relay over
    axes ``(outer, *inner)``, each a ``Group`` over every rank of the mesh:
    the whole group over the axes, the outer axis, the flattened inner
    axes."""

    _fields_ = [("all", Group), ("outer", Group), ("inner", Group)]


_relays: dict = {}


def relay_plan(ctx, axes) -> Relay2d:
    """The ``Relay2d`` of the tuple ``axes`` (outer first) over every rank
    of ``ctx``, made once per mesh shape and axes."""
    axes = tuple(axes)
    key = (tuple(ctx.axis_names), tuple(ctx.mesh_shape), axes)
    relay = _relays.get(key)
    if relay is None:
        relay = _relays[key] = Relay2d(group_struct(ctx, axes),
                                       group_struct(ctx, axes[0]),
                                       group_struct(ctx, axes[1:]))
    return relay


class ShmemError(RuntimeError):
    """A spin of a collective kernel ran out of its budget."""


_reports: dict = {}


def _key(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def shmem_lib():
    return csrc.load("shmem", _SIGNATURES)


def _report(device: torch.device):
    """(device claim word, host report address, device report address, the
    report's words as seen from the host) of ``device``, made at first
    use."""
    key = _key(device)
    rep = _reports.get(key)
    if rep is None:
        lib = shmem_lib()
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        with csrc.current_on(device):
            rc = lib.tdt_shmem_host_alloc(_REPORT_WORDS, ctypes.byref(host),
                                          ctypes.byref(dev))
        csrc.check(lib, rc, "shmem error report")
        # a normal tensor even when the first launch runs under
        # torch.inference_mode: raise_pending zeroes it in place later
        with torch.inference_mode(False):
            claim = torch.zeros(1, dtype=torch.int32, device=device)
        words = (ctypes.c_int * _REPORT_WORDS).from_address(host.value)
        rep = _reports[key] = (claim, host.value, dev.value, words)
    return rep


def launch_args(ctx) -> tuple:
    """The arguments a kernel of the layer ends with (claim, report,
    budget in ns, stream), after raising any error an earlier launch
    reported."""
    raise_pending(ctx)
    claim, _, dev, _ = _report(ctx.device)
    stream = torch.cuda.current_stream(ctx.device).cuda_stream
    return (claim.data_ptr(), dev, int(SPIN_BUDGET_S * 1e9), stream)


def _read(ctx) -> list[int] | None:
    if ctx.device.type != "cuda":
        return None
    rep = _reports.get(_key(ctx.device))
    if rep is None or not rep[3][0]:
        return None
    return list(rep[3])


def raise_pending(ctx) -> None:
    """Raise ``ShmemError`` if a finished launch reported a starved spin
    (reads the mapped report; no synchronisation). The report names no
    context, so the pads of every live context are zeroed first: the
    starved launch's may hold signals that no wait took."""
    words = _read(ctx)
    if words is None:
        return
    torch.cuda.synchronize(ctx.device)      # let the failed launch end
    claim, host, _, _ = _reports[_key(ctx.device)]
    ctypes.memset(host, 0, _REPORT_WORDS * 4)
    claim.zero_()
    clear_live_signal_pads()
    _, kernel, rank, signal = words
    raise ShmemError(f"{KERNELS.get(kernel, kernel)}: rank {rank} waited "
                     f"past its budget of {SPIN_BUDGET_S} s on signal word "
                     f"{signal}")


def check_errors(ctx) -> None:
    """Synchronise the card, then raise ``ShmemError`` if a spin of any
    launch so far ran out."""
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        raise_pending(ctx)


def tables(ctx, *symm) -> list:
    """Each symmetric tensor's peer table as a ctypes array of pointers."""
    n = ctx.num_ranks
    return [(ctypes.c_void_p * n)(*ctx.peer_table(t)) for t in symm]


def group_table(ctx, x, axis):
    """The peer table of an input sharded over ``axis`` and replicated over
    the other axes: ``x`` [n_axis, ...] (one buffer per group index), and
    every rank of the mesh points at the buffer of its own index, so the
    ranks that hold the same shard share one buffer (nothing writes it)."""
    n, _, index, _ = group_plan(ctx, axis)
    if x.shape[0] != n or not x.is_contiguous():
        raise ValueError(f"a sharded input is contiguous [{n}, ...] over "
                         f"{axis!r}, got {tuple(x.shape)}")
    watch(x)
    step = x.numel() // n * x.element_size()
    base = x.data_ptr()
    return (ctypes.c_void_p * ctx.num_ranks)(*(base + i * step
                                               for i in index))


def cuda_checks(name: str, *tensors) -> None:
    """The collective kernels take contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous and on one "
                             f"device")


def ring_ping_plain(blocks):
    """The plain version of ``ring_ping``: rank r receives rank r-1's
    block."""
    return torch.roll(blocks, 1, dims=0)


def ring_ping(ctx, blocks, silent_rank: int | None = None):
    """Tutorial 01's ring ping over every rank of ``ctx``: ``blocks``
    [n, ...] holds each rank's block; returns [n, ...] where row r is the
    block rank r received from its left neighbour (the kernel's delivery
    signal is what rank r waited for). ``silent_rank`` names a rank that
    puts its block but never signals, so its right neighbour's wait runs
    out: the call then raises ``ShmemError`` once the budget has passed.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``csrc/shmem.cu``), adding one to ``ring_ping.launches``."""
    n = ctx.num_ranks
    if blocks.shape[0] != n:
        raise ValueError(f"ring_ping: expected {n} blocks, got "
                         f"{blocks.shape[0]}")
    if blocks.device.type == "cpu":
        return ring_ping_plain(blocks)
    cuda_checks("ring_ping", blocks)
    out = torch.empty_like(blocks)
    pad = ctx.signal_pad("ring_ping", 2)
    src, dst, pads = tables(ctx, blocks, out, pad)
    lib = shmem_lib()
    args = launch_args(ctx)
    with csrc.current_on(blocks.device):
        rc = lib.tdt_ring_ping(src, dst, blocks[0].numel()
                               * blocks.element_size(), pads, n,
                               -1 if silent_rank is None else silent_rank,
                               *args)
    csrc.check(lib, rc, "ring_ping")
    ring_ping.launches += 1
    return out


ring_ping.launches = 0

__all__ = ["KERNELS", "Group", "Relay2d", "ShmemError", "check_errors",
           "group_ids", "group_order", "group_plan", "group_rows",
           "group_struct",
           "group_table", "launch_args",
           "raise_pending", "relay_plan", "ring_ping", "ring_ping_plain",
           "tables"]
