"""Symbolic protocol-event model shared by capture and checker.

Counterpart of ``triton_dist_tpu/analysis/events.py``, a copy with one
more event kind (``wait_peek``). One :class:`Event` stands for one
shmem-primitive call of one actor: a lane (a block, ``blockIdx.x``) of a
rank (``blockIdx.y``), as the traced build of ``csrc/shmem.cuh`` logs it
(``capture``). ``Event.rank`` is the owning rank and ``Event.grid`` holds
``(lane,)``. Identities are deterministic strings: a signal word is the
family's pad (``SemId.alloc``) and its word (``cell``), a buffer is the
symmetric tensor it lies in, so the same word or buffer has the same id on
every rank and the checker matches producer and consumer sites across
ranks by them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SemId:
    """One semaphore *cell*: the allocation (scratch slot or barrier
    collective) plus the concrete element coordinates within it."""

    alloc: str                  # e.g. "call0:ag_push/scratch1", "barrier:123"
    cell: Tuple[int, ...]       # fully-resolved element coords, () for scalar
    kind: str = "regular"       # "regular" | "dma" | "barrier"

    def __str__(self) -> str:
        c = "" if not self.cell else "[" + ",".join(map(str, self.cell)) + "]"
        return f"{self.alloc}{c}"


@dataclasses.dataclass(frozen=True)
class Region:
    """A rectangular byte region: buffer id + per-dimension half-open
    element intervals over the *base* buffer shape (squeezed dims kept as
    size-1 intervals so overlap tests stay dimension-aligned)."""

    buffer: str
    intervals: Tuple[Tuple[int, int], ...]

    def overlaps(self, other: "Region") -> bool:
        if self.buffer != other.buffer:
            return False
        if len(self.intervals) != len(other.intervals):
            # different views of the same buffer should never disagree on
            # rank; treat conservatively as overlapping
            return True
        for (a0, a1), (b0, b1) in zip(self.intervals, other.intervals):
            if a1 <= b0 or b1 <= a0:
                return False
        return True

    def covers(self, other: "Region") -> bool:
        if self.buffer != other.buffer:
            return False
        if len(self.intervals) != len(other.intervals):
            return False
        return all(a0 <= b0 and b1 <= a1 for (a0, a1), (b0, b1)
                   in zip(self.intervals, other.intervals))

    def __str__(self) -> str:
        dims = ",".join(f"{a}:{b}" for a, b in self.intervals)
        return f"{self.buffer}[{dims}]"


# Event kinds:
#   put        one-sided copy; dst_rank may equal rank (local async copy).
#              Credits ``sem`` (the DMA recv semaphore at dst_rank) with
#              ``value`` = nbytes when delivered; ``send_sem`` at the source
#              tracks local completion (rdma_id joins it to wait_send).
#              The port's puts are stores (``sem`` None): a later signal of
#              the same actor releases them.
#   wait_recv  consume ``value`` = nbytes from DMA ``sem``; ``dst`` is the
#              region whose delivery the protocol believes this covers.
#   signal     credit ``value`` = inc onto ``sem`` at ``dst_rank``
#              (None → own rank).
#   wait       consume ``value`` from REGULAR/barrier ``sem`` (decrements).
#   wait_peek  block until ``sem`` holds ``value``, without consuming it:
#              the port's many-lane waits on one count (``dl::wait``,
#              ``wait_block(..., consume=false)``); the count is consumed
#              later by one ``wait`` of the rank's last lane.
#   wait_send  local send-completion wait for put ``rdma_id``.
#   read       kernel reads ``src`` region (compute input).
#   write      kernel writes ``dst`` region (compute output).
#   sem_read   non-destructive semaphore poll.
#   fence      ordering no-op, kept for completeness.
@dataclasses.dataclass
class Event:
    rank: int
    seq: int
    kind: str
    sem: Optional[SemId] = None
    send_sem: Optional[SemId] = None
    dst_rank: Optional[int] = None
    value: int = 0
    src: Optional[Region] = None
    dst: Optional[Region] = None
    rdma_id: Optional[int] = None
    grid: Optional[Tuple[int, ...]] = None
    site: str = ""              # call-site label for findings

    def describe(self) -> str:
        bits = [f"r{self.rank}#{self.seq} {self.kind}"]
        if self.sem is not None:
            bits.append(f"sem={self.sem}")
        if self.dst_rank is not None:
            bits.append(f"to=r{self.dst_rank}")
        if self.value:
            bits.append(f"v={self.value}")
        if self.src is not None:
            bits.append(f"src={self.src}")
        if self.dst is not None:
            bits.append(f"dst={self.dst}")
        if self.grid:
            bits.append(f"grid={self.grid}")
        return " ".join(bits)
