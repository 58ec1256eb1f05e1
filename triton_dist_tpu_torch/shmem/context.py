"""The device mesh of the shmem layer, in its one-rank form.

Counterpart of ``triton_dist_tpu/shmem/context.py``: ``ShmemContext`` names
the mesh axes and their sizes, and ``initialize_distributed`` builds it.
The JAX context wraps a ``jax.sharding.Mesh`` whose symmetric buffers and
``shard_map`` launch the collective kernels. On one card every axis has
size 1, the collectives are identities, and the context only carries the
axis names and the device. An axis of size above 1 raises: the symmetric
tensors, the process group and the transports are ROADMAP.md Queue A,
item 4 "shmem layer across ranks".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from triton_dist_tpu_torch.utils.env import default_device


def _multi_rank(mesh_shape) -> None:
    raise NotImplementedError(
        f"a mesh of shape {tuple(mesh_shape)} spans more than one rank; the "
        "port runs one rank until the shmem layer (symmetric tensors, the "
        "process group and its transports) is ported: ROADMAP.md Queue A, "
        "item 4 \"shmem layer across ranks\"")


@dataclasses.dataclass(frozen=True)
class ShmemContext:
    """The mesh's axis names and sizes, and the device of this rank."""

    axis_names: tuple[str, ...]
    mesh_shape: tuple[int, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.mesh_shape):
            raise ValueError(f"axis names {self.axis_names} and mesh shape "
                             f"{self.mesh_shape} differ in length")
        if any(n != 1 for n in self.mesh_shape):
            _multi_rank(self.mesh_shape)

    @property
    def num_ranks(self) -> int:
        return math.prod(self.mesh_shape)

    def axis_size(self, axis: str | Sequence[str] | None = None) -> int:
        """Ranks along ``axis``: a name, a tuple of names (their product),
        or None (the whole mesh)."""
        if axis is None:
            return self.num_ranks
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return math.prod(self.mesh_shape[self.axis_names.index(a)]
                         for a in names)


def initialize_distributed(axis_names: Sequence[str] = ("x",),
                           mesh_shape: Sequence[int] | None = None,
                           device=None) -> ShmemContext:
    """The context of a one-rank mesh over ``axis_names`` (each of size 1
    unless ``mesh_shape`` says otherwise, which raises above 1) on
    ``device`` (``cuda`` unless the caller names another)."""
    names = tuple(axis_names)
    shape = tuple(mesh_shape) if mesh_shape is not None else (1,) * len(names)
    if any(n != 1 for n in shape):
        _multi_rank(shape)
    return ShmemContext(names, shape, default_device(device))


__all__ = ["ShmemContext", "initialize_distributed"]
