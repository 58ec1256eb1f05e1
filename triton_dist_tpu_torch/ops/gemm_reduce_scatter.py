"""GEMM-ReduceScatter (TPU kernel B16).

Counterpart of ``triton_dist_tpu/ops/gemm_reduce_scatter.py``. The TPU
kernel has two halves: the producer runs the GEMM (B2, ``emit_gemm``) of
each output segment into a stage slot and puts it to the segment's owner,
its own segment straight into its symmetric slot ``me`` (in f32 for bf16
outputs); then ``emit_slot_reduction`` sums the n slots in f32 and casts to
the output type.

- At one rank there are no puts: the GEMM writes the f32 partial into slot
  0 of the workspace (``gemm_into``), and the slot reduction
  (``slot_reduce``) casts it, both kernels of ``csrc/gemm.cu`` on a CUDA
  tensor and their plain versions on a CPU tensor. The workspace keeps the
  partial in slot 0 and the send stage is untouched, as the TPU kernel
  leaves them at n = 1.
- At n ranks, over an axis that spans the whole mesh, one cooperative
  launch of ``csrc/tp_overlap.cu`` covers every rank on the one card: each
  rank computes the f32 partial of every segment over its K/n columns, its
  own segment last, and stores each tile straight into the owner's
  symmetric slot ``me``; then each rank sums its own segment's n slots in
  slot order and casts once. The direct store replaces the TPU kernel's
  double-buffered send stage, which stays scratch: the port leaves it
  unwritten. A CPU tensor runs the plain version (``gemm_rs_plain``): per
  rank, B2's plain f32 partials, summed in slot order.

Inputs and outputs are the JAX package's global views: ``a`` [M, K] with
rank r's columns at block r, ``b`` [K, N] with rank r's rows at block r,
the result [M, N] with rank r's rows at block r. Tuple axes (the 2-tier
``_gemm_rs_2d``), slice-crossing axes (``_gemm_rs_xla``) and a group inside
a multi-axis mesh raise ``NotImplementedError``: ROADMAP.md Queue A, item
6.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.allgather_gemm import (kernel_kind, norm_axis,
                                                      tiles, tp_axis, tp_lib)
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.ops.gemm import (GemmConfig, _b_operand, gemm_into,
                                            matmul, matmul_plain, slot_reduce,
                                            slot_reduce_plain)
from triton_dist_tpu_torch.shmem import device as shd

_MULTI = "_gemm_rs_2d, _gemm_rs_xla"


def _acc_dtype(out_dtype):
    """The symmetric slots' type: f32 for a bf16 output, else the output's
    (the JAX op's accumulator rule; the port takes bf16 and f32)."""
    return torch.float32 if out_dtype == torch.bfloat16 else out_dtype


def _check(cfg, a, b, n: int) -> tuple[int, int]:
    """(rows of a segment M / n, columns N), after checking that the shapes
    split over ``n`` ranks and that ``cfg`` divides the segment."""
    M, K = a.shape
    if b.shape[0] != K:
        raise ValueError(f"A/B inner dims {K} vs {b.shape[0]}")
    if M % n or K % n:
        raise ValueError(f"gemm_rs: M={M} and K={K} must split over {n} "
                         f"ranks")
    m_seg, N = M // n, b.shape[1]
    if cfg is not None:       # the JAX op clamps the tiles to the segment
        GemmConfig(min(cfg.block_m, m_seg),
                   min(cfg.block_n, N)).check(m_seg, N)
    return m_seg, N


def _gemm_rs_local(a, b, ws, out_dtype):
    """The two halves at one rank: the f32 partial into slot 0 of ``ws``
    [1, M, N], then the slot reduction into ``out_dtype``."""
    before = matmul.launches
    gemm_into(a, b, ws[0])
    out = slot_reduce(ws, out_dtype)
    gemm_rs.launches += matmul.launches - before
    return out


def gemm_rs_plain(a, b, n: int, out_dtype=None, ws=None):
    """The plain version of GEMM-RS at ``n`` ranks: rank s's partial is B2's
    plain product (``matmul_plain``) of a's column block s with b's row
    block s, in the slots' type; rank r's output rows are the slot reduction
    (``slot_reduce_plain``) of the n partials of segment r, in slot order.
    With ``ws`` [n, n, M/n, N], rank r's slot s receives rank s's partial of
    segment r, as the kernel's stores leave it."""
    out_dtype = out_dtype or a.dtype
    M, K = a.shape
    m_seg, kl = M // n, K // n
    if ws is None:
        ws = torch.empty((n, n, m_seg, b.shape[1]),
                         dtype=_acc_dtype(out_dtype), device=a.device)
    for s in range(n):
        ks = slice(s * kl, (s + 1) * kl)
        ws[:, s] = matmul_plain(a[:, ks], b[ks], ws.dtype).reshape(
            n, m_seg, -1)
    return torch.cat([slot_reduce_plain(ws[r], out_dtype) for r in range(n)])


def _rs_ranks(ctx, axis, n: int, a, b, ws, out_dtype):
    """GEMM-RS at n > 1 ranks: the plain version on a CPU tensor, else one
    launch of the kernel through the slots ``ws`` [n, n, M/n, N]."""
    if a.device.type == "cpu":
        return gemm_rs_plain(a, b, n, out_dtype, ws)
    if b.dtype != a.dtype or ws.dtype != torch.float32:
        raise TypeError(f"gemm_rs: a {a.dtype} and b {b.dtype} share a "
                        f"type, the slots {ws.dtype} are f32")
    kind = kernel_kind(a.dtype, out_dtype)
    a = a.contiguous()
    b, trans = _b_operand(b)
    shd.cuda_checks("gemm_rs", a, b, ws)
    if ws.data_ptr() % 16:
        raise ValueError("gemm_rs: the slots must be 16-byte aligned")
    M, K = a.shape
    N = b.shape[0] if trans else b.shape[1]
    out = torch.empty(M, N, dtype=out_dtype, device=a.device)
    lanes = n * tiles(M // n, N)
    pad = family_pad(ctx, "gemm_rs", axis, lanes + n + 1)
    slots, pads = shd.tables(ctx, ws, pad)
    lib = tp_lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(a.device):
        rc = lib.tdt_gemm_rs(a.data_ptr(), b.data_ptr(), out.data_ptr(), slots,
                             pads, n, M // n, N, K // n, K, b.stride(0),
                             int(trans), kind, lanes, *args)
    csrc.check(lib, rc, "gemm_rs")
    gemm_rs.launches += 1
    return out


def gemm_rs(ctx, a, b, axis=None, cfg: GemmConfig | None = None,
            out_dtype=None):
    """Row-parallel GEMM + reduce-scatter: ``a`` [M, K] sharded on columns,
    ``b`` [K, N] sharded on rows; returns sum over ranks of a_r @ b_r, its M
    rows scattered over the ranks, in ``out_dtype`` (a's type by default).
    ``cfg``, when given, must divide the segment (the JAX op's
    precondition). Allocates a fresh workspace per call; ``gemm_rs_ws`` and
    ``GemmRsContext`` reuse one. A CUDA tensor launches the kernels (each
    B16 call adds one to ``gemm_rs.launches``) or raises."""
    axis, n = tp_axis(ctx, axis, "gemm_rs", _MULTI)
    out_dtype = out_dtype or a.dtype
    m_seg, N = _check(cfg, a, b, n)
    ws = torch.empty((n, n, m_seg, N), dtype=_acc_dtype(out_dtype),
                     device=a.device)
    if n == 1:
        return _gemm_rs_local(a, b, ws[0], out_dtype)
    return _rs_ranks(ctx, axis, n, a, b, ws, out_dtype)


gemm_rs.launches = 0


def gemm_rs_ws(ctx, a, b, ws, stage, axis=None,
               cfg: GemmConfig | None = None, out_dtype=None):
    """``gemm_rs`` with the symmetric slots ``ws`` [n, n, M/n, N] and the
    send stage ``stage`` [n, 2, M/n, N] (from ``create_gemm_rs_workspace``)
    as explicit operands: returns ``(out, ws, stage)``. At one rank slot 0
    of ``ws`` holds the f32 partial after the call; at n ranks rank r's
    slot s holds rank s's f32 partial of segment r. ``stage`` is never
    written: the kernel stores each partial straight into its owner's
    slot."""
    axis, n = tp_axis(ctx, axis, "gemm_rs_ws", _MULTI)
    out_dtype = out_dtype or a.dtype
    acc = _acc_dtype(out_dtype)
    m_seg, N = _check(cfg, a, b, n)
    if tuple(ws.shape) != (n, n, m_seg, N) or ws.dtype != acc:
        raise ValueError(f"ws {tuple(ws.shape)}/{ws.dtype} != ({n}, {n}, "
                         f"{m_seg}, {N})/{acc}")
    if tuple(stage.shape) != (n, 2, m_seg, N) or stage.dtype != acc:
        raise ValueError(f"stage {tuple(stage.shape)}/{stage.dtype} != ({n}, "
                         f"2, {m_seg}, {N})/{acc}")
    if n == 1:
        return _gemm_rs_local(a, b, ws[0], out_dtype), ws, stage
    return _rs_ranks(ctx, axis, n, a, b, ws, out_dtype), ws, stage


def create_gemm_rs_workspace(ctx, m_seg: int, n_cols: int,
                             out_dtype=torch.bfloat16, axis=None):
    """(symmetric partial slots [n, n, m_seg, n_cols], send stage [n, 2,
    m_seg, n_cols]) as zeros in the accumulator type (f32 for a bf16
    output) on the context's device (at n > 1 ``ctx.create_symm_tensor``)."""
    _, n = tp_axis(ctx, axis, "create_gemm_rs_workspace",
                   "a 2-tier workspace")
    acc = _acc_dtype(out_dtype)
    if n == 1:
        return (torch.zeros((1, 1, m_seg, n_cols), dtype=acc,
                            device=ctx.device),
                torch.zeros((1, 2, m_seg, n_cols), dtype=acc,
                            device=ctx.device))
    return (ctx.create_symm_tensor((n, m_seg, n_cols), acc),
            ctx.create_symm_tensor((2, m_seg, n_cols), acc))


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
           "create_gemm_rs_workspace", "gemm_rs", "gemm_rs_plain",
           "gemm_rs_ws"]
