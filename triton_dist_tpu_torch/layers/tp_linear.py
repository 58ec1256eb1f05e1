"""Tensor-parallel linear layers over the overlap ops.

Counterpart of ``triton_dist_tpu/layers/tp_linear.py``:
``ColumnParallelLinear`` runs AG-GEMM (B15), ``RowParallelLinear`` GEMM-RS
(B16). With ``persistent=True`` a layer keeps one workspace context per
shape and reuses it on every call (the reference's create-the-context-once
pattern); without it each call allocates a fresh workspace. Both run at
one rank, and at n ranks over an axis (the whole mesh, or a group inside a
multi-axis mesh) or a tuple of axes (the 2-tier forms), every rank on the
one card and one launch of the overlap kernel a call (over a tuple GEMM-RS
adds B13's ring over the outer axis); a reused workspace is guarded across
calls by the kernel's entry barrier.
"""

from __future__ import annotations

import dataclasses

from triton_dist_tpu_torch.ops.allgather_gemm import (ag_gemm,
                                                      create_ag_gemm_context,
                                                      norm_axis)
from triton_dist_tpu_torch.ops.gemm import GemmConfig
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import (
    create_gemm_rs_context, gemm_rs)


@dataclasses.dataclass
class ColumnParallelLinear:
    """y = all_gather(x) @ W with W column-sharded: the first Megatron
    linear, through the AG-GEMM op."""

    ctx: object
    axis: object = None
    cfg: GemmConfig | None = None
    persistent: bool = False
    _ag_ctxs: dict = dataclasses.field(default_factory=dict)

    def __call__(self, x, w, out_dtype=None):
        if self.persistent:
            n = self.ctx.axis_size(norm_axis(self.ctx, self.axis))
            key = (x.shape[0] // n, x.shape[1], x.dtype)
            agc = self._ag_ctxs.get(key)
            if agc is None:
                agc = self._ag_ctxs[key] = create_ag_gemm_context(
                    self.ctx, key[0], key[1], x.dtype, axis=self.axis)
            return agc(x, w, cfg=self.cfg, out_dtype=out_dtype)
        return ag_gemm(self.ctx, x, w, axis=self.axis, cfg=self.cfg,
                       out_dtype=out_dtype)


@dataclasses.dataclass
class RowParallelLinear:
    """y = reduce_scatter(x @ W) with W row-sharded: the second Megatron
    linear, through the GEMM-RS op."""

    ctx: object
    axis: object = None
    cfg: GemmConfig | None = None
    persistent: bool = False
    _rs_ctxs: dict = dataclasses.field(default_factory=dict)

    def __call__(self, x, w, out_dtype=None):
        if self.persistent:
            n = self.ctx.axis_size(norm_axis(self.ctx, self.axis))
            out_dt = out_dtype or x.dtype
            key = (x.shape[0] // n, w.shape[1], out_dt)
            rsc = self._rs_ctxs.get(key)
            if rsc is None:
                rsc = self._rs_ctxs[key] = create_gemm_rs_context(
                    self.ctx, key[0], key[1], out_dt, axis=self.axis)
            return rsc(x, w, cfg=self.cfg, out_dtype=out_dtype)
        return gemm_rs(self.ctx, x, w, axis=self.axis, cfg=self.cfg,
                       out_dtype=out_dtype)


__all__ = ["ColumnParallelLinear", "RowParallelLinear"]
