"""Broken-kernel gallery (B26): known-bad signal protocols sigcheck must
flag.

Counterpart of ``triton_dist_tpu/analysis/gallery.py``: the TPU kernels
``_dma_call`` (:213, its ``pallas_call`` at :222) and ``_flag_call``
(:239, :248) over the eight specimens (:36-196). Each specimen is a
deliberately miswired protocol, one defect each, written by hand for the
card in ``csrc/sigcheck_gallery.cu`` over ``shmem.cuh`` as the port's B9
push and the counted-signal families write theirs. The quick tier asserts
that every specimen is flagged WITH ITS EXPECTED KIND: if a checker change
stops catching one, that is a checker regression, not a cleaner gallery.

``run_specimen(ctx, name)`` launches one specimen over every rank of
``ctx`` (a CUDA context; ``run_specimen.launches[name]`` counts the
launches). Its plain version, ``plain_streams(name, n)``, is the per-rank
event stream the specimen's protocol gives, one lane a rank, exactly as the
traced build logs it; the CPU tests check those.

The reference's ninth entry, ``psum_hot_loop``, is a JAX-trace lint
specimen (``analysis/lint.py``), not a Pallas kernel; it is not ported
here.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from triton_dist_tpu_torch.analysis.checker import (DEADLOCK, OVER_SIGNAL,
                                                    UNDER_SIGNAL,
                                                    UNORDERED_READ)
from triton_dist_tpu_torch.analysis.events import Event, Region, SemId

ROWS, COLS = 8, 128            # f32 rows of a rank's shard (the reference's _M)
SHARD_BYTES = ROWS * COLS * 4
PAD_WORDS = 9              # word 0, and 1 + s for a slot s < 8
# csrc/sigcheck_gallery.cu Specimen, in order
SPECIMENS = ("missing_wait", "dropped_signal", "seg_dropped_signal",
             "lend_dropped_last_signal", "fold_dropped_slice_signal",
             "over_signal", "swapped_sem", "wait_cycle")
# the specimens whose untraced run starves a wait
STARVED = ("dropped_signal", "seg_dropped_signal", "lend_dropped_last_signal",
           "fold_dropped_slice_signal", "wait_cycle")
# the names the decoded log gives the specimen's tensors: its input, its
# output (the order shmem.device.tables sees them)
IN_BUF, OUT_BUF = "buf0", "buf1"


def family(name: str) -> str:
    """The signal pad family of a specimen."""
    return f"gallery_{name}"


class _Stream:
    """One rank's events, in program order."""

    def __init__(self, name: str, rank: int):
        self.fam = family(name)
        self.rank = rank
        self.events: List[Event] = []

    def _add(self, kind: str, **kw) -> None:
        self.events.append(Event(rank=self.rank, seq=len(self.events),
                                 kind=kind, grid=(0,), **kw))

    def signal(self, word: int, dst: int, value: int = 1) -> None:
        self._add("signal", sem=SemId(self.fam, (word,)), dst_rank=dst,
                  value=value)

    def wait(self, word: int, value: int) -> None:
        self._add("wait", sem=SemId(self.fam, (word,)), value=value)

    def barrier(self, n: int) -> None:
        for p in range(n):
            if p != self.rank:
                self.signal(0, p)
        self.wait(0, n - 1)

    def put(self, dst: int, off: int, src_off: int, nbytes: int) -> None:
        self._add("put", dst=Region(f"{OUT_BUF}[{dst}]", ((off, off + nbytes),)),
                  src=Region(f"{IN_BUF}[{self.rank}]",
                             ((src_off, src_off + nbytes),)),
                  dst_rank=dst, value=nbytes)

    def read(self, off: int, nbytes: int) -> None:
        self._add("read", src=Region(f"{OUT_BUF}[{self.rank}]",
                                     ((off, off + nbytes),)))

    def write(self, off: int, nbytes: int) -> None:
        self._add("write", dst=Region(f"{OUT_BUF}[{self.rank}]",
                                      ((off, off + nbytes),)))


def _protocol(name: str, s: _Stream, n: int) -> None:
    """Rank ``s.rank``'s protocol of specimen ``name``: what
    ``csrc/sigcheck_gallery.cu`` logs, call for call."""
    me, B = s.rank, SHARD_BYTES
    if name == "missing_wait":
        s.barrier(n)
        s.put(me, me * B, 0, B)
        for p in range(1, n):
            dst = (me + p) % n
            s.put(dst, me * B, 0, B)
            s.signal(1 + me, dst)
        # BUG: no wait before slot 0 is read
        s.read(0, B)
        s.write(me * B, B)
    elif name == "dropped_signal":
        for p in range(1, n):
            s.signal(0, (me + p) % n)
        s.wait(0, n)
    elif name == "seg_dropped_signal":
        for p in range(1, n):
            for _ in range(2 - 1):
                s.signal(0, (me + p) % n)
        s.wait(0, 2 * (n - 1))
    elif name == "lend_dropped_last_signal":
        if me == 0:
            for _ in range(3 - 1):
                s.signal(0, 1)
        if me == 1:
            s.wait(0, 3)
    elif name == "fold_dropped_slice_signal":
        if me != 0:
            for p in range(1, n):
                s.signal(0, (me + p) % n)
        for _ in range(n - 1):
            s.wait(0, 1)
    elif name == "over_signal":
        for p in range(1, n):
            s.signal(0, (me + p) % n, 2)
        s.wait(0, n - 1)
    elif name == "swapped_sem":
        s.barrier(n)
        right, half = (me + 1) % n, B // 2
        s.put(right, half, half, half)
        s.signal(2, right)
        s.put(right, 0, 0, half)
        s.signal(1, right)
        # BUG: the low half's read waits on the high half's word
        s.wait(2, 1)
        s.read(0, half)
        s.write(0, half)
        s.wait(1, 1)
        s.read(half, half)
        s.write(half, half)
    elif name == "wait_cycle":
        s.wait(0, 1)
        s.signal(0, (me + 1) % n)
    else:
        raise ValueError(f"no gallery specimen {name!r}; one of {SPECIMENS}")


def plain_streams(name: str, n: int) -> Dict[tuple, List[Event]]:
    """The plain version of specimen ``name`` at ``n`` ranks: each rank's
    event stream, one lane a rank, keyed ``(rank, 0)``."""
    out = {}
    for r in range(n):
        s = _Stream(name, r)
        _protocol(name, s, n)
        out[(r, 0)] = s.events
    return out


def plain_capture(name: str) -> Callable:
    """A ``capture(run, mesh)`` for ``api.sigcheck`` that gives the plain
    streams of ``name`` (one launch) in place of a traced run."""

    def capture(run, mesh) -> list:
        n = 1
        for size in mesh.values():
            n *= int(size)
        return [plain_streams(name, n)]

    return capture


def protocol_of(streams) -> Dict[int, list]:
    """Each rank's protocol as (kind, sem cell, dst_rank, value) tuples:
    what a traced run and the plain version must agree on."""
    out: Dict[int, list] = {}
    for (rank, _), events in sorted(streams.items()):
        out.setdefault(rank, []).extend(
            (e.kind, None if e.sem is None else (e.sem.alloc, e.sem.cell),
             e.dst_rank, e.value) for e in events)
    return out


_SIGNATURES = {"tdt_sigcheck_gallery": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_ulonglong, ctypes.c_void_p]}


def run_specimen(ctx, name: str):
    """Launch specimen ``name`` over every rank of ``ctx`` (one block a
    rank) on zeroed inputs, and return its output [n, n * ROWS, COLS] f32.
    A CPU context runs the plain version: the specimen's per-rank event
    streams (``plain_streams``). On the card each launch adds one to
    ``run_specimen.launches[name]``; a starved specimen's call returns, and
    the next launch (or ``shmem.check_errors``) raises ``ShmemError``."""
    import torch

    from triton_dist_tpu_torch import csrc
    from triton_dist_tpu_torch.ops.common import family_pad
    from triton_dist_tpu_torch.shmem import device as shd

    if name not in SPECIMENS:
        raise ValueError(f"no gallery specimen {name!r}; one of {SPECIMENS}")
    n = ctx.num_ranks
    if n < 2:
        raise ValueError(f"a gallery specimen runs on 2 or more ranks, got {n}")
    if ctx.device.type == "cpu":
        return plain_streams(name, n)
    x = torch.zeros(n, ROWS, COLS, dtype=torch.float32, device=ctx.device)
    out = torch.zeros(n, n * ROWS, COLS, dtype=torch.float32,
                      device=ctx.device)
    pad = family_pad(ctx, family(name), None, PAD_WORDS)
    ins, outs, pads = shd.tables(ctx, x, out, pad)
    lib = csrc.load("sigcheck_gallery", _SIGNATURES)
    args = shd.launch_args(ctx)
    with csrc.current_on(ctx.device):
        rc = lib.tdt_sigcheck_gallery(SPECIMENS.index(name), ins, outs,
                                      SHARD_BYTES, pads, n, *args)
    csrc.check(lib, rc, f"sigcheck gallery {name}")
    run_specimen.launches[name] += 1
    return out


run_specimen.launches = dict.fromkeys(SPECIMENS, 0)


@dataclasses.dataclass
class GalleryEntry:
    name: str
    expected: str                      # finding kind that MUST be reported
    run: Optional[Callable] = None
    meshes: Sequence[Dict[str, int]] = ({"x": 2},)


def _entry(name: str, expected: str, meshes=({"x": 2},)) -> GalleryEntry:
    return GalleryEntry(name, expected,
                        run=lambda ctx: run_specimen(ctx, name),
                        meshes=meshes)


_ENTRIES = [
    _entry("missing_wait", UNORDERED_READ),
    _entry("dropped_signal", UNDER_SIGNAL),
    _entry("seg_dropped_signal", UNDER_SIGNAL),
    _entry("lend_dropped_last_signal", UNDER_SIGNAL),
    _entry("fold_dropped_slice_signal", UNDER_SIGNAL),
    _entry("over_signal", OVER_SIGNAL),
    _entry("swapped_sem", UNORDERED_READ),
    _entry("wait_cycle", DEADLOCK, meshes=({"x": 2}, {"x": 3})),
]

GALLERY: Dict[str, GalleryEntry] = {e.name: e for e in _ENTRIES}

__all__ = ["GALLERY", "GalleryEntry", "IN_BUF", "OUT_BUF", "PAD_WORDS",
           "ROWS", "SHARD_BYTES", "SPECIMENS", "STARVED",
           "family", "plain_capture", "plain_streams", "protocol_of",
           "run_specimen"]
