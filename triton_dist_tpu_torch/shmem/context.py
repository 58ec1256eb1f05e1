"""The mesh of the shmem layer: its axes, its ranks, and their symmetric
buffers.

Counterpart of ``triton_dist_tpu/shmem/context.py``. The JAX context wraps a
``jax.sharding.Mesh`` whose devices each hold one rank's shard. The port
runs every rank of the mesh in one process on one card (the analog of the
JAX package's single-process cluster of virtual CPU devices): flat rank ids
are row-major over the axes, as JAX's are, and a *symmetric tensor* is one
allocation ``[n, *local]`` whose row r is rank r's buffer. A collective
kernel reaches a peer only through the table of the n row addresses
(``peer_table``), never by offsetting its own, so that addresses mapped
from other processes or cards can fill the same table later. Each kernel
family has its own symmetric signal pad (``signal_pad``), the analog of
the JAX package's ``collective_id_for``: two families never share a word.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Sequence

import torch

from triton_dist_tpu_torch.utils.env import default_device

# the most ranks one launch covers (csrc/shmem.cuh kMaxPes)
MAX_RANKS = 8
# how long a collective kernel's spin waits before it reports its kernel,
# rank and signal and its call raises (shmem/device.py)
SPIN_BUDGET_S = 1.0

# every live context by id: a starved spin may leave signals in the pads of
# whichever context launched it, and the report does not say which
_LIVE: weakref.WeakValueDictionary = weakref.WeakValueDictionary()

# callables shown every tensor a kernel's peer table is made of and every
# signal pad made, as ``watcher(tensor, family)`` (family None for a
# buffer): analysis/capture.py names the addresses of a traced log by them
WATCHERS: list = []


def watch(tensor: torch.Tensor, family: str | None = None) -> None:
    for watcher in WATCHERS:
        watcher(tensor, family)


@dataclasses.dataclass(frozen=True)
class ShmemContext:
    """The mesh's axis names and sizes, the device that holds every rank,
    and the per-family signal pads."""

    axis_names: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    device: torch.device
    _pads: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False, hash=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.mesh_shape):
            raise ValueError(f"axis names {self.axis_names} and mesh shape "
                             f"{self.mesh_shape} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names {self.axis_names} repeat")
        if any(n < 1 for n in self.mesh_shape):
            raise ValueError(f"mesh shape {self.mesh_shape} has an empty axis")
        if self.num_ranks > MAX_RANKS:
            raise ValueError(f"a mesh of {self.num_ranks} ranks: one card "
                             f"runs at most {MAX_RANKS}")
        _LIVE[id(self)] = self

    @property
    def num_ranks(self) -> int:
        return math.prod(self.mesh_shape)

    def axis_size(self, axis: str | Sequence[str] | None = None) -> int:
        """Ranks along ``axis``: a name, a tuple of names (their product),
        or None (the whole mesh)."""
        if axis is None:
            return self.num_ranks
        names = self.group_axes(axis)
        return math.prod(self.mesh_shape[self.axis_names.index(a)]
                         for a in names)

    # -- rank ids (row-major over the axes, as JAX's flat logical ids) -----

    def coords(self, rank: int) -> dict[str, int]:
        """Rank ``rank``'s coordinate on every axis."""
        out = {}
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.mesh_shape)):
            out[name] = rank % size
            rank //= size
        return out

    def flat_id(self, coords: dict[str, int]) -> int:
        pid = 0
        for name, size in zip(self.axis_names, self.mesh_shape):
            pid = pid * size + coords[name]
        return pid

    def my_pe(self, rank: int, axis: str | Sequence[str]) -> int:
        """Rank ``rank``'s index along ``axis`` (or flattened over several
        axes, major to minor): JAX ``shmem/device.py::my_pe``."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        c = self.coords(rank)
        pid = 0
        for name in names:
            pid = pid * self.axis_size(name) + c[name]
        return pid

    def pe_at(self, rank: int, axis: str, index: int) -> int:
        """The flat id of the rank whose coordinate on ``axis`` is ``index``
        and whose other coordinates are ``rank``'s: JAX ``pe_at``."""
        c = self.coords(rank)
        c[axis] = index
        return self.flat_id(c)

    def pe_at_group(self, rank: int, group_axes: str | Sequence[str],
                    index: int) -> int:
        """The flat id of the rank at the flattened coordinate ``index``
        over ``group_axes`` (major to minor), other coordinates ``rank``'s:
        JAX ``pe_at_group``."""
        names = (group_axes,) if isinstance(group_axes, str) \
            else tuple(group_axes)
        c = self.coords(rank)
        for name in reversed(names):
            size = self.axis_size(name)
            c[name] = index % size
            index //= size
        return self.flat_id(c)

    def group_axes(self, axis: str | Sequence[str] | None) -> tuple[str, ...]:
        """The axes of a group: one name, a tuple of names (major to
        minor), or None for every axis of the mesh."""
        if axis is None:
            return self.axis_names
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def group_members(self, rank: int,
                      axis: str | Sequence[str] | None) -> list[int]:
        """The flat ids of ``rank``'s group along ``axis`` (None: the
        whole mesh), in group-index order: ``pe_at_group`` of every index.
        Rank r is member ``my_pe(r, axis)`` of its group."""
        axes = self.group_axes(axis)
        return [self.pe_at_group(rank, axes, i)
                for i in range(self.axis_size(axes))]

    # -- symmetric tensors ---------------------------------------------------

    def create_symm_tensor(self, shape: Sequence[int], dtype) -> torch.Tensor:
        """A symmetric tensor of zeros: ``[n, *shape]`` on the context's
        device, rank r's buffer at row r."""
        return torch.zeros((self.num_ranks,) + tuple(shape), dtype=dtype,
                           device=self.device)

    def peer_table(self, symm: torch.Tensor) -> tuple[int, ...]:
        """The address of every rank's buffer of ``symm`` (rank-major, one
        row per rank): what a kernel gets in place of its peers' buffers."""
        if symm.shape[0] != self.num_ranks or not symm.is_contiguous():
            raise ValueError(f"a symmetric tensor is contiguous [n = "
                             f"{self.num_ranks}, ...], got "
                             f"{tuple(symm.shape)}")
        watch(symm)
        step = symm.numel() // self.num_ranks * symm.element_size()
        return tuple(symm.data_ptr() + r * step
                     for r in range(self.num_ranks))

    def signal_pad(self, family: str, words: int) -> torch.Tensor:
        """The signal pad of one kernel family: ``[n, >= words]`` int32,
        zero between calls (every wait consumes its signal). Made at first
        use, and made again larger when a call needs more words."""
        pad = self._pads.get(family)
        if pad is None or pad.shape[1] < words:
            pad = torch.zeros(self.num_ranks, max(words, 64),
                              dtype=torch.int32, device=self.device)
            self._pads[family] = pad
            watch(pad, family)
        return pad

    def clear_signal_pads(self) -> None:
        """Zero every pad: after a spin ran out, a pad may hold signals that
        no wait took."""
        for pad in self._pads.values():
            pad.zero_()


def clear_live_signal_pads() -> None:
    """Zero the pads of every live context (after a spin ran out in a
    launch of any of them)."""
    for ctx in list(_LIVE.values()):
        ctx.clear_signal_pads()


def initialize_distributed(axis_names: Sequence[str] = ("x",),
                           mesh_shape: Sequence[int] | None = None,
                           device=None) -> ShmemContext:
    """The context of a mesh over ``axis_names`` (each of size 1 unless
    ``mesh_shape`` says otherwise) whose ranks all run on ``device``
    (``cuda`` unless the caller names another)."""
    names = tuple(axis_names)
    shape = tuple(mesh_shape) if mesh_shape is not None else (1,) * len(names)
    return ShmemContext(names, shape, default_device(device))


__all__ = ["MAX_RANKS", "SPIN_BUDGET_S", "ShmemContext",
           "clear_live_signal_pads", "initialize_distributed"]
