"""The all-gather module layer.

Counterpart of ``triton_dist_tpu/layers/allgather_layer.py``: one method per
all-gather algorithm over ``ops.allgather.all_gather``. The push, ring and
auto gathers run at every rank count (B9, ``csrc/allgather.cu``: at one
rank the copy of the shard, at n ranks the puts across ranks); the 2-D
gathers (B11's relay and the per-axis rings) span every axis of a
multi-axis mesh, and raise ``ValueError`` on a one-axis mesh, as the
reference's do. Each returns what ``all_gather`` returns (every rank's
replica at n ranks).
"""

from __future__ import annotations

import dataclasses

from triton_dist_tpu_torch.ops.allgather import all_gather


@dataclasses.dataclass(frozen=True)
class AllGatherLayer:
    """Method-per-algorithm wrapper over ``all_gather`` on ``ctx``'s
    ``axis`` (None: a one-axis mesh's axis; on a multi-axis mesh ``auto``
    then spans every axis). Each call returns a new output tensor, so no
    staging buffers are kept."""

    ctx: object
    axis: str | None = None

    def forward_push(self, x):
        """The full-mesh one-hop push."""
        return all_gather(self.ctx, x, axis=self.axis, method="push")

    def forward_ring(self, x):
        """The 1-D ring."""
        return all_gather(self.ctx, x, axis=self.axis, method="ring")

    def forward_ring_2d(self, x):
        """The hierarchical ring over every axis of the mesh, innermost
        first: bandwidth-oriented."""
        return all_gather(self.ctx, x, method="ring_2d")

    def forward_push_2d(self, x):
        """The 2-tier relay over every axis of the mesh in one kernel (an
        outer ring of same-inner-index relays and an inner push):
        latency-oriented."""
        return all_gather(self.ctx, x, method="push_2d")

    def __call__(self, x):
        """``auto``: with no ``axis`` on a multi-axis mesh it gathers over
        every axis (``push_2d`` or ``ring_2d`` by the shard's size), as the
        reference does."""
        return all_gather(self.ctx, x, axis=self.axis, method="auto")


__all__ = ["AllGatherLayer"]
