"""GEMM-ReduceScatter (TPU kernel B16), in its one-rank form.

Counterpart of ``triton_dist_tpu/ops/gemm_reduce_scatter.py``. The TPU
kernel has two halves: the producer runs the GEMM (B2, ``emit_gemm``) of
each output segment into a stage slot and puts it to the segment's owner,
its own segment straight into its symmetric slot ``me`` (in f32 for bf16
outputs); then ``emit_slot_reduction`` sums the n slots in f32 and casts to
the output type. At one rank there are no puts: the GEMM writes the f32
partial into slot 0 of the workspace (``gemm_into``), and the slot
reduction (``slot_reduce``) casts it, both kernels of ``csrc/gemm.cu`` on a
CUDA tensor and their plain versions on a CPU tensor. The result equals the
JAX kernel's sum of one slot; the workspace keeps the partial in slot 0 and
the send stage is untouched, as the TPU kernel leaves them at n = 1.

More ranks, tuple axes (the 2-tier ``_gemm_rs_2d``) and slice-crossing
axes (``_gemm_rs_xla``) wait for the puts across ranks over the shmem
layer (ROADMAP.md Queue A, item 6 "TP overlap across ranks") and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops.allgather_gemm import norm_axis, one_rank_axis
from triton_dist_tpu_torch.ops.gemm import (GemmConfig, gemm_into, matmul,
                                            slot_reduce)

_MULTI = "_gemm_rs_2d, _gemm_rs_xla"


def _acc_dtype(out_dtype):
    """The symmetric slots' type: f32 for a bf16 output, else the output's
    (the JAX op's accumulator rule; the port takes bf16 and f32)."""
    return torch.float32 if out_dtype == torch.bfloat16 else out_dtype


def _check(cfg, a, b, m_seg: int):
    M, K = a.shape
    if b.shape[0] != K:
        raise ValueError(f"A/B inner dims {K} vs {b.shape[0]}")
    if cfg is not None:       # the JAX op clamps the tiles to the segment
        GemmConfig(min(cfg.block_m, m_seg),
                   min(cfg.block_n, b.shape[1])).check(m_seg, b.shape[1])


def _gemm_rs_local(a, b, ws, out_dtype):
    """The two halves at one rank: the f32 partial into slot 0 of ``ws``
    [1, M, N], then the slot reduction into ``out_dtype``."""
    before = matmul.launches
    gemm_into(a, b, ws[0])
    out = slot_reduce(ws, out_dtype)
    gemm_rs.launches += matmul.launches - before
    return out


def gemm_rs(ctx, a, b, axis=None, cfg: GemmConfig | None = None,
            out_dtype=None):
    """Row-parallel GEMM + reduce-scatter: ``a`` [M, K] sharded on columns,
    ``b`` [K, N] sharded on rows; returns sum over ranks of a_r @ b_r, its M
    rows scattered over the ranks, in ``out_dtype`` (a's type by default).
    ``cfg``, when given, must divide the segment (the JAX op's
    precondition). Allocates a fresh workspace per call; ``gemm_rs_ws`` and
    ``GemmRsContext`` reuse one. A CUDA tensor launches the GEMM and the slot
    reduction (each B16 call adds one to ``gemm_rs.launches``) or raises."""
    axis = one_rank_axis(ctx, axis, "gemm_rs", _MULTI)
    out_dtype = out_dtype or a.dtype
    n = ctx.axis_size(axis)
    _check(cfg, a, b, a.shape[0] // n)
    ws = torch.empty((n, a.shape[0] // n, b.shape[1]),
                     dtype=_acc_dtype(out_dtype), device=a.device)
    return _gemm_rs_local(a, b, ws, out_dtype)


gemm_rs.launches = 0


def gemm_rs_ws(ctx, a, b, ws, stage, axis=None,
               cfg: GemmConfig | None = None, out_dtype=None):
    """``gemm_rs`` with the symmetric slots ``ws`` [n, n, M/n, N] and the
    send stage ``stage`` [n, 2, M/n, N] (from ``create_gemm_rs_workspace``)
    as explicit operands: returns ``(out, ws, stage)``. At one rank slot 0
    of ``ws`` holds the f32 partial after the call and ``stage`` is
    untouched."""
    axis = one_rank_axis(ctx, axis, "gemm_rs_ws", _MULTI)
    out_dtype = out_dtype or a.dtype
    acc = _acc_dtype(out_dtype)
    n = ctx.axis_size(axis)
    m_seg, N = a.shape[0] // n, b.shape[1]
    _check(cfg, a, b, m_seg)
    if tuple(ws.shape) != (n, n, m_seg, N) or ws.dtype != acc:
        raise ValueError(f"ws {tuple(ws.shape)}/{ws.dtype} != ({n}, {n}, "
                         f"{m_seg}, {N})/{acc}")
    if tuple(stage.shape) != (n, 2, m_seg, N) or stage.dtype != acc:
        raise ValueError(f"stage {tuple(stage.shape)}/{stage.dtype} != ({n}, "
                         f"2, {m_seg}, {N})/{acc}")
    return _gemm_rs_local(a, b, ws[0], out_dtype), ws, stage


def create_gemm_rs_workspace(ctx, m_seg: int, n_cols: int,
                             out_dtype=torch.bfloat16, axis=None):
    """(symmetric partial slots [n, n, m_seg, n_cols], send stage [n, 2,
    m_seg, n_cols]) as zeros in the accumulator type (f32 for a bf16
    output) on the context's device."""
    axis = one_rank_axis(ctx, axis, "create_gemm_rs_workspace",
                         "a 2-tier workspace")
    n = ctx.axis_size(axis)
    acc = _acc_dtype(out_dtype)
    return (torch.zeros((n, n, m_seg, n_cols), dtype=acc, device=ctx.device),
            torch.zeros((n, 2, m_seg, n_cols), dtype=acc, device=ctx.device))


@dataclasses.dataclass
class GemmRsContext:
    """Owns the slots and the send stage and threads them through
    ``gemm_rs_ws`` (see ``AgGemmContext``)."""

    ctx: object
    axis: str
    ws: torch.Tensor
    stage: torch.Tensor

    def __call__(self, a, b, cfg: GemmConfig | None = None, out_dtype=None):
        c, self.ws, self.stage = gemm_rs_ws(self.ctx, a, b, self.ws,
                                            self.stage, axis=self.axis,
                                            cfg=cfg, out_dtype=out_dtype)
        return c


def create_gemm_rs_context(ctx, m_seg: int, n_cols: int,
                           out_dtype=torch.bfloat16,
                           axis=None) -> GemmRsContext:
    axis = norm_axis(ctx, axis)
    ws, stage = create_gemm_rs_workspace(ctx, m_seg, n_cols, out_dtype, axis)
    return GemmRsContext(ctx=ctx, axis=axis, ws=ws, stage=stage)


__all__ = ["GemmRsContext", "create_gemm_rs_context",
           "create_gemm_rs_workspace", "gemm_rs", "gemm_rs_ws"]
