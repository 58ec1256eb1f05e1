"""Differentiable overlap ops: the tensor-parallel linears as autograd
functions whose backward is the other overlap op.

Counterpart of ``triton_dist_tpu/ops/autodiff.py`` (``jax.custom_vjp``).
AG-GEMM and GEMM-RS are each other's adjoints:

    y = AG(a) @ b           (ag_gemm)      da = RS(dy @ b^T)  -> gemm_rs
                                           db = AG(a)^T @ dy  -> all_gather,
                                                                 then a product
    y = RS(x @ w)           (gemm_rs)      dx = AG(dy) @ w^T  -> ag_gemm_ws
                                           dw = x^T @ AG(dy)  -> the workspace
                                                                 rebuilt, then
                                                                 a product

The transposed weights go to the kernel as views (it reads an [N, K]
operand as its transpose). The weight gradients are plain products with f32
sums and one cast, as the JAX ops compute them (``jnp.dot`` outside any
kernel), one per rank on that rank's blocks. At one rank ``all_gather`` is
B9's copy kernel (``ops/allgather.py``) and the rebuilt AG(dy) is dy; at n
ranks every rank gets its replica of AG(a) from the gather over the same
axis or axes (B9's push over one axis, B11 or ``ring_2d`` over a tuple),
and rebuilds AG(dy) from its own workspace slots with its own segment of dy
in slot ``me``, as JAX's ``rebuild`` does; inside a multi-axis mesh the
products run on rank 0's group's blocks (every group holds the same).
"""

from __future__ import annotations

import math

import torch

from triton_dist_tpu_torch.ops.allgather import all_gather
from triton_dist_tpu_torch.ops.allgather_gemm import (ag_gemm, ag_gemm_ws,
                                                      create_ag_gemm_workspace,
                                                      norm_axis)
from triton_dist_tpu_torch.ops.gemm import GemmConfig
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import gemm_rs
from triton_dist_tpu_torch.shmem.device import group_plan


def _bwd_cfg(cfg, rows_local: int, cols: int) -> GemmConfig:
    """The tile config of a backward op, whose output dims are the
    forward's swapped: gcd-clamped so it divides any shape."""
    base = cfg or GemmConfig()
    return GemmConfig(math.gcd(base.block_m, rows_local),
                      math.gcd(base.block_n, cols), base.block_k)


def _wgrad(lhs_t, rhs, dtype):
    """``lhs_t @ rhs`` summed in f32, cast once to ``dtype``."""
    return (lhs_t.float() @ rhs.float()).to(dtype)


class _AgGemmDiff(torch.autograd.Function):
    @staticmethod
    def forward(fctx, sctx, axis, cfg, a, b):
        fctx.sctx, fctx.axis, fctx.cfg = sctx, axis, cfg
        fctx.save_for_backward(a, b)
        return ag_gemm(sctx, a, b, axis=axis, cfg=cfg)

    @staticmethod
    def backward(fctx, dc):
        a, b = fctx.saved_tensors
        sctx, axis = fctx.sctx, norm_axis(fctx.sctx, fctx.axis)
        n = sctx.axis_size(axis)
        # da = reduce_scatter(dc @ b^T): b^T [N, K] is b read transposed
        da = gemm_rs(sctx, dc, b.t(), axis=axis,
                     cfg=_bwd_cfg(fctx.cfg, dc.shape[0] // n, b.shape[0]),
                     out_dtype=a.dtype)
        # db = AG(a)^T @ dc: a re-gathered (rematerialised), then each
        # rank's product on its replica and its column block of dc
        a_g = all_gather(sctx, a.contiguous(), axis=axis)
        if n == 1:
            return None, None, None, da, _wgrad(a_g.t(), dc, b.dtype)
        nl = dc.shape[1] // n
        members = group_plan(sctx, axis)[3]
        db = torch.cat([_wgrad(a_g[q].t(), dc[:, r * nl:(r + 1) * nl],
                               b.dtype) for r, q in enumerate(members)],
                       dim=1)
        return None, None, None, da, db


class _GemmRsDiff(torch.autograd.Function):
    @staticmethod
    def forward(fctx, sctx, axis, cfg, x, w):
        fctx.sctx, fctx.axis, fctx.cfg = sctx, axis, cfg
        fctx.save_for_backward(x, w)
        return gemm_rs(sctx, x, w, axis=axis, cfg=cfg)

    @staticmethod
    def backward(fctx, dy):
        x, w = fctx.saved_tensors
        sctx, axis = fctx.sctx, norm_axis(fctx.sctx, fctx.axis)
        n = sctx.axis_size(axis)
        M, N = dy.shape
        m_local = M // n
        # dx = all_gather(dy) @ w^T through the workspace-threading AG-GEMM,
        # so dw below reuses the gathered segments
        ws = create_ag_gemm_workspace(sctx, m_local, N, dy.dtype, axis=axis)
        dx, ws = ag_gemm_ws(sctx, dy, w.t(), ws, axis=axis,
                            cfg=_bwd_cfg(fctx.cfg, m_local, w.shape[0] // n),
                            out_dtype=x.dtype)
        # AG(dy) rebuilt from the workspace of each rank of rank 0's group:
        # its slot s holds index s's segment, except its own (never copied
        # there), filled from dy; then dw's row block r from index r's x
        # columns and its AG(dy)
        members = group_plan(sctx, axis)[3]
        dy_g = ws.to(dy.dtype, copy=True)
        for r, q in enumerate(members):
            dy_g[q, r] = dy[r * m_local:(r + 1) * m_local]
        kl = x.shape[1] // n
        dw = torch.cat([_wgrad(x[:, r * kl:(r + 1) * kl].t(),
                               dy_g[q].reshape(M, N), w.dtype)
                        for r, q in enumerate(members)])
        return None, None, None, dx, dw


def ag_gemm_diff(ctx, axis, cfg, a, b):
    """Differentiable column-parallel linear: C = all_gather(a) @ b, with
    a [M, K] sharded on rows, b [K, N] on columns."""
    return _AgGemmDiff.apply(ctx, axis, cfg, a, b)


def gemm_rs_diff(ctx, axis, cfg, x, w):
    """Differentiable row-parallel linear: y = reduce_scatter(x @ w), with
    x [M, K] sharded on columns, w [K, N] on rows."""
    return _GemmRsDiff.apply(ctx, axis, cfg, x, w)


__all__ = ["ag_gemm_diff", "gemm_rs_diff"]
