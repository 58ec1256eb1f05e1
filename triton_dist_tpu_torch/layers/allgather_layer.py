"""The all-gather module layer.

Counterpart of ``triton_dist_tpu/layers/allgather_layer.py``: one method per
all-gather algorithm over ``ops.allgather.all_gather``. The push, ring and
auto gathers run at every rank count (B9, ``csrc/allgather.cu``: at one
rank the copy of the shard, at n ranks the puts across ranks); they return
what ``all_gather`` returns (every rank's replica at n ranks). The 2-D
gathers span a multi-axis mesh and raise ``NotImplementedError``
(ROADMAP.md Queue A, item 5 "collectives").
"""

from __future__ import annotations

import dataclasses

from triton_dist_tpu_torch.ops.allgather import all_gather


def _two_d(method: str):
    raise NotImplementedError(
        f"AllGatherLayer.forward_{method}: the 2-D all-gathers span a "
        "multi-axis mesh and are not ported yet: ROADMAP.md Queue A, item 5 "
        "\"collectives\"")


@dataclasses.dataclass(frozen=True)
class AllGatherLayer:
    """Method-per-algorithm wrapper over ``all_gather`` on ``ctx``'s
    ``axis`` (its first axis by default). Each call returns a new output
    tensor, so no staging buffers are kept."""

    ctx: object
    axis: str | None = None

    def forward_push(self, x):
        """The full-mesh one-hop push."""
        return all_gather(self.ctx, x, axis=self.axis, method="push")

    def forward_ring(self, x):
        """The 1-D ring."""
        return all_gather(self.ctx, x, axis=self.axis, method="ring")

    def forward_ring_2d(self, x):
        _two_d("ring_2d")

    def forward_push_2d(self, x):
        _two_d("push_2d")

    def __call__(self, x):
        """``auto``: with no ``axis`` on a multi-axis mesh the reference
        gathers over every axis (the 2-D gathers), so this raises as
        ``all_gather`` does."""
        return all_gather(self.ctx, x, axis=self.axis, method="auto")


__all__ = ["AllGatherLayer"]
