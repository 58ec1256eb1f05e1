"""The EP all-to-all module layer.

Counterpart of ``triton_dist_tpu/layers/ep_a2a_layer.py``: it holds the
static EP context (``ops.all_to_all.EpAllToAllContext``) and runs
``preprocess`` (the routing plan), ``dispatch`` and ``combine`` over it.
The routing layout goes back to the caller from ``dispatch`` and into
``combine``; the layer keeps no per-call state. A 2-tuple axis (the 2-tier
dispatch of ``Ep2dAllToAllContext``) raises ``NotImplementedError``:
ROADMAP.md Queue A, item 7 "MoE / EP across ranks".
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops import all_to_all as a2a_ops


@dataclasses.dataclass(frozen=True)
class EPAll2AllLayer:
    """The EP context and its dispatch/combine pair."""

    a2a: a2a_ops.EpAllToAllContext

    @classmethod
    def create(cls, ctx, max_tokens: int, hidden: int, topk: int,
               num_experts: int, capacity: int | None = None, axis=None,
               dtype=torch.bfloat16, wire_dtype=None,
               quant_edge: str = "fused", dequant_edge: str = "post",
               expert_major: bool = False):
        """``wire_dtype`` (fp8 e4m3fn or int8, or "auto") quantises the wire
        with its f32 scale wire. ``axis`` is one mesh axis; a tuple of two
        (the 2-tier path) raises ``NotImplementedError``."""
        if axis is not None and not isinstance(axis, str):
            raise NotImplementedError(
                f"EPAll2AllLayer over the axes {tuple(axis)} (the 2-tier "
                f"dispatch) is not ported yet: {a2a_ops.EP_ITEM}")
        return cls(a2a_ops.create_all_to_all_context(
            ctx, max_tokens, hidden, topk, num_experts, capacity=capacity,
            axis=axis, dtype=dtype, wire_dtype=wire_dtype,
            quant_edge=quant_edge,
            dequant_edge=dequant_edge, expert_major=expert_major))

    @property
    def is_2d(self) -> bool:
        return False

    def preprocess(self, topk_ids):
        """The routing plan (dest, slot, valid) of every rank's ``topk_ids``
        [n * T, k], each [n * T, k]: slots are counted per source rank, as
        ``dispatch`` counts them."""
        a = self.a2a
        n, T = a.n_ranks, a.max_tokens
        dest, slot, valid = a2a_ops.route_tokens(
            a, topk_ids.view(n, T, a.topk))
        return tuple(x.reshape(n * T, a.topk) for x in (dest, slot, valid))

    def dispatch(self, tokens, topk_ids):
        """(recv_tokens, recv_ids, layout); pass ``layout`` to
        ``combine``."""
        return a2a_ops.dispatch(self.a2a, tokens, topk_ids)

    def combine(self, processed, layout, topk_weights):
        return a2a_ops.combine(self.a2a, processed, layout, topk_weights)


__all__ = ["EPAll2AllLayer"]
