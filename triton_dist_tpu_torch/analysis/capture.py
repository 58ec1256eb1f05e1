"""Capture on the card: run an op with the traced kernels, read their log,
and turn it into per-actor event streams.

Counterpart of ``triton_dist_tpu/analysis/capture.py``. The reference
replays each rank's kernel body in Python with fake refs; the port runs the
real kernels instead, built with ``-DTDT_SHMEM_TRACE`` (``csrc/shmem.cuh``):
every signal, wait, put, barrier and marked read or write appends a record
to a log in device memory, and a traced wait neither spins nor consumes, so
a broken protocol still runs to its end. ``capture_op(run, mesh)`` runs
``run(ctx)`` on a real ``ShmemContext`` of that mesh with the traced
libraries loaded (``csrc.tracing``), reads the log back, names each
address through the port's known allocations (a family's signal pad,
``ops/common.py`` ``family_pad``, is a ``SemId`` alloc and its word the
cell; a tensor a peer table was made of is a buffer, each of its rows, a
rank's, a ``Region`` buffer of its own, and a byte interval the region),
zeroes every pad the call touched, and returns one dict of per-actor
streams a launch: the launches of one stream run one after another, so
each is checked on its own.

``decode`` is the part that needs no card: the CPU tests drive it with a
log built in numpy.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from triton_dist_tpu_torch.analysis.events import Event, Region, SemId

# csrc/shmem.cuh TraceKind
TRACE_KINDS = {1: "signal", 2: "signal", 3: "wait", 4: "wait_peek",
               5: "put", 6: "read", 7: "write"}
RECORD_WORDS = 10      # seq rank lane kind word value dst src bytes launch
CAPACITY = 1 << 18     # records a capture may take

Actor = Tuple[int, int]
Streams = Dict[Actor, List[Event]]


class CaptureError(RuntimeError):
    """The log cannot be turned into streams (an unknown signal word, an
    overflow)."""


@dataclasses.dataclass(frozen=True)
class Allocation:
    """A tensor the log's addresses may fall in: ``rows`` rows of
    ``row_bytes`` from ``base``; a signal pad when ``family`` is set."""

    name: str
    base: int
    rows: int
    row_bytes: int
    family: str | None = None

    @property
    def end(self) -> int:
        return self.base + self.rows * self.row_bytes


class Allocations:
    """The known allocations, by address."""

    def __init__(self, allocs: Sequence[Allocation] = ()):
        self._by_base: Dict[int, Allocation] = {}
        for a in allocs:
            self.add(a)

    def add(self, a: Allocation) -> None:
        old = self._by_base.get(a.base)
        if old is None or a.end > old.end or a.family:
            self._by_base[a.base] = a

    def find(self, addr: int) -> Allocation | None:
        """The allocation holding ``addr`` (a pad before a buffer; the
        innermost of nested views), or None."""
        bases = sorted(self._by_base)
        for i in range(bisect.bisect_right(bases, addr) - 1, -1, -1):
            a = self._by_base[bases[i]]
            if addr < a.end:
                return a
        return None


def _region(allocs: Allocations, addr: int, nbytes: int):
    """(Region, row) of ``[addr, addr + nbytes)``: a buffer's row and the
    byte interval in it, or the raw address interval (row None)."""
    a = allocs.find(addr)
    if a is None or a.family is not None:
        return Region("mem", ((addr, addr + nbytes),)), None
    row, off = divmod(addr - a.base, a.row_bytes)
    return Region(f"{a.name}[{row}]", ((off, off + nbytes),)), row


def _word(allocs: Allocations, addr: int) -> Tuple[SemId, int]:
    a = allocs.find(addr)
    if a is None or a.family is None:
        raise CaptureError(f"signal word at {addr:#x} lies in no known pad")
    row, off = divmod(addr - a.base, a.row_bytes)
    return SemId(a.family, (off // 4,)), row


def decode(records: np.ndarray, allocs: Allocations,
           n: int) -> List[Streams]:
    """The traced log ``records`` [k, RECORD_WORDS] int64 as one dict of
    per-actor streams a launch, in launch order. Every rank of the ``n``
    has a stream in each launch (an empty one for a rank that logged
    nothing); puts, reads and writes of no bytes are dropped."""
    records = np.asarray(records, dtype=np.int64).reshape(-1, RECORD_WORDS)
    records = records[np.argsort(records[:, 0], kind="stable")]
    launches: Dict[int, Streams] = {}
    for rec in records.tolist():
        seq, rank, lane, kind, word, value, dst, src, nbytes, launch = rec
        name = TRACE_KINDS.get(kind)
        if name is None:
            raise CaptureError(f"record {seq}: unknown kind {kind}")
        if not 0 <= rank < n:
            raise CaptureError(f"record {seq}: rank {rank} outside 0..{n - 1}")
        kw = {}
        if name in ("signal", "wait", "wait_peek"):
            sem, owner = _word(allocs, word)
            kw = dict(sem=sem, value=int(value))
            if name == "signal":
                kw["dst_rank"] = owner
            elif owner != rank:
                kw["dst_rank"] = owner
        else:
            if nbytes <= 0:
                continue
            if name == "put":
                dregion, drow = _region(allocs, dst, nbytes)
                kw = dict(dst=dregion, src=_region(allocs, src, nbytes)[0],
                          dst_rank=drow, value=int(nbytes))
            elif name == "read":
                kw = dict(src=_region(allocs, src, nbytes)[0])
            else:
                kw = dict(dst=_region(allocs, dst, nbytes)[0])
        streams = launches.setdefault(launch, {})
        streams.setdefault((rank, lane), []).append(
            Event(rank=rank, seq=seq, kind=name, grid=(lane,),
                  site=f"launch{launch}", **kw))
    out = []
    for launch in sorted(launches):
        streams = launches[launch]
        for r in range(n):
            if not any(a[0] == r for a in streams):
                streams[(r, 0)] = []
        out.append(dict(sorted(streams.items())))
    return out


def merge_launches(launches: Sequence[Streams]) -> Streams:
    """One stream an actor over every launch (for the peer-pattern summary
    and the event counts)."""
    out: Streams = {}
    for streams in launches:
        for actor, events in streams.items():
            out.setdefault(actor, []).extend(events)
    return out


class _Watcher:
    """Collects every pad and peer-table tensor made while it is installed
    (``shmem.context.WATCHERS``), keeping them alive so no address is
    reused during the capture."""

    def __init__(self):
        self.allocs = Allocations()
        self.tensors: list = []
        self._names: Dict[int, str] = {}

    def __call__(self, tensor, family=None):
        base = tensor.data_ptr()
        rows = tensor.shape[0] if tensor.dim() else 1
        row_bytes = tensor.numel() * tensor.element_size() // max(rows, 1)
        if family is None:
            name = self._names.setdefault(base, f"buf{len(self._names)}")
        else:
            name = family
        self.tensors.append(tensor)
        self.allocs.add(Allocation(name, base, rows, row_bytes, family))


_logs: dict = {}


def _log(device):
    """(records [CAPACITY, RECORD_WORDS] int64, count, launch counter) on
    ``device``, made at first use."""
    import torch

    key = str(device)
    log = _logs.get(key)
    if log is None:
        log = _logs[key] = (
            torch.zeros(CAPACITY, RECORD_WORDS, dtype=torch.int64,
                        device=device),
            torch.zeros(1, dtype=torch.int64, device=device),
            torch.zeros(1, dtype=torch.int64, device=device))
    return log


def capture_op(run: Callable, mesh_shape: Dict[str, int] | Sequence,
               device=None) -> List[Streams]:
    """Run ``run(ctx)`` on a ``ShmemContext`` of ``mesh_shape`` (every rank
    on ``device``, the card unless named) with the traced kernels, and
    return its log as one dict of per-actor streams a launch. Every pad the
    call touched is zero afterwards. Raises ``CaptureError`` off the card:
    the traced kernels run only there."""
    import torch

    from triton_dist_tpu_torch import csrc
    from triton_dist_tpu_torch.shmem import context
    from triton_dist_tpu_torch.shmem.context import initialize_distributed

    axes = tuple(mesh_shape.items()) if isinstance(mesh_shape, dict) \
        else tuple(mesh_shape)
    ctx = initialize_distributed(tuple(a for a, _ in axes),
                                 tuple(s for _, s in axes), device)
    if ctx.device.type != "cuda":
        raise CaptureError("capture runs the traced kernels on the card; "
                           f"got a {ctx.device.type} context")
    records, count, launch = _log(ctx.device)
    count.zero_()
    launch.zero_()
    watcher = _Watcher()
    context.WATCHERS.append(watcher)
    try:
        with csrc.tracing(records.data_ptr(), count.data_ptr(), CAPACITY,
                          launch.data_ptr()):
            run(ctx)
        torch.cuda.synchronize(ctx.device)
    finally:
        context.WATCHERS.remove(watcher)
        ctx.clear_signal_pads()
    taken = int(count.item())
    if taken > CAPACITY:
        raise CaptureError(f"the traced log took {taken} records, past its "
                           f"{CAPACITY}: capture a smaller call")
    return decode(records[:taken].cpu().numpy(), watcher.allocs,
                  ctx.num_ranks)


__all__ = ["Allocation", "Allocations", "CAPACITY", "CaptureError",
           "RECORD_WORDS", "TRACE_KINDS", "capture_op", "decode",
           "merge_launches"]
