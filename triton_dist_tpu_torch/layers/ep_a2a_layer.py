"""The EP all-to-all module layer.

Counterpart of ``triton_dist_tpu/layers/ep_a2a_layer.py``: it holds the
static EP context (``ops.all_to_all.EpAllToAllContext``, or over a pair of
axes the 2-tier ``Ep2dAllToAllContext``) and runs ``preprocess`` (the
routing plan), ``dispatch`` and ``combine`` over it. The routing layout
goes back to the caller from ``dispatch`` and into ``combine``; the layer
keeps no per-call state.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops import all_to_all as a2a_ops


@dataclasses.dataclass(frozen=True)
class EPAll2AllLayer:
    """The EP context and its dispatch/combine pair."""

    a2a: a2a_ops.EpAllToAllContext | a2a_ops.Ep2dAllToAllContext

    @classmethod
    def create(cls, ctx, max_tokens: int, hidden: int, topk: int,
               num_experts: int, capacity: int | None = None, axis=None,
               dtype=torch.bfloat16, wire_dtype=None,
               quant_edge: str = "fused", dequant_edge: str = "post",
               expert_major: bool = False):
        """``wire_dtype`` (fp8 e4m3fn or int8, or "auto" over one axis)
        quantises the wire with its f32 scale wire. ``axis`` is one mesh
        axis, or a pair (major, minor): the 2-tier dispatch and combine,
        ``capacity`` then its tier-1 slots, the rows quantised once at
        their source on a quantised wire. ``expert_major`` (one axis only:
        tier 2 re-slots arrivals by rank, not by expert) lays each (src,
        dst) block out per local expert."""
        if axis is not None and not isinstance(axis, str):
            axes = tuple(axis)
            if len(axes) != 2:
                raise ValueError(f"the 2-tier EP layer takes (major, minor), "
                                 f"got {axes}")
            if expert_major:
                raise ValueError("expert_major is a layout of the one-axis "
                                 "context (the 2-tier re-slot would have to "
                                 "regroup arrivals per expert)")
            return cls(a2a_ops.create_all_to_all_context_2d(
                ctx, max_tokens, hidden, topk, num_experts, axes=axes,
                cap1=capacity, dtype=dtype, wire_dtype=wire_dtype,
                quant_edge=quant_edge, dequant_edge=dequant_edge))
        return cls(a2a_ops.create_all_to_all_context(
            ctx, max_tokens, hidden, topk, num_experts, capacity=capacity,
            axis=axis, dtype=dtype, wire_dtype=wire_dtype,
            quant_edge=quant_edge,
            dequant_edge=dequant_edge, expert_major=expert_major))

    @property
    def is_2d(self) -> bool:
        return isinstance(self.a2a, a2a_ops.Ep2dAllToAllContext)

    def preprocess(self, topk_ids):
        """The routing plan (dest, slot, valid) of every rank's ``topk_ids``
        [n * T, k], each [n * T, k]: slots are counted per source rank, as
        ``dispatch`` counts them. On two tiers it is tier 1's plan (tier
        2's re-slots what arrives: ``dispatch`` returns it)."""
        a = self.a2a
        n, T = a.n_ranks, a.max_tokens
        route = a2a_ops.route_tokens_2d if self.is_2d else a2a_ops.route_tokens
        plan = route(a, topk_ids.view(n, T, a.topk))
        return tuple(x.reshape(n * T, a.topk) for x in plan)

    def dispatch(self, tokens, topk_ids):
        """(recv_tokens, recv_ids, layout); pass ``layout`` to
        ``combine``."""
        if self.is_2d:
            return a2a_ops.dispatch_2d(self.a2a, tokens, topk_ids)
        return a2a_ops.dispatch(self.a2a, tokens, topk_ids)

    def combine(self, processed, layout, topk_weights):
        if self.is_2d:
            return a2a_ops.combine_2d(self.a2a, processed, layout,
                                      topk_weights)
        return a2a_ops.combine(self.a2a, processed, layout, topk_weights)


__all__ = ["EPAll2AllLayer"]
