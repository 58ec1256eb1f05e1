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
- At n ranks over one axis, one cooperative launch of
  ``csrc/tp_overlap.cu`` covers every rank of the mesh on the one card
  (inside a multi-axis mesh the axis's groups side by side, each writing
  its own replica of the result): each rank computes the f32 partial of
  every segment over its K block, its own segment last, and stores each
  tile straight into the owner's symmetric slot ``me``; then each rank
  sums its own segment's n slots in slot order and casts once. The direct
  store replaces the TPU kernel's double-buffered send stage, which stays
  scratch: the port leaves it unwritten.
- Over a tuple of axes ``(outer, *inner)`` (``_gemm_rs_2d``): stage 1 is
  the same kernel over the inner group, where the segment of inner peer j
  is the strided row set ``{(r, j) : r < no}`` laid out outer-major (the
  chunk of ``no * M/n`` rows, ready for the outer ring with no re-permute),
  its K block the rank's index over all the axes; the surviving chunk is
  the f32 slot sum of the ni partials in slot order. Stage 2 is B13's ring
  over the outer group (``ops/reduce_scatter.py``, ``csrc/reduce_scatter
  .cu``) on the f32 chunks, then the cast to the output type. It sums in
  the reference's order, so it is bitwise that composition and not the
  one-axis kernel over the flattened ranks.

A CPU tensor runs the plain version (``gemm_rs_plain``,
``gemm_rs_2d_plain``): B2's plain f32 partials, summed in the same orders.

Inputs and outputs are the JAX package's global views: ``a`` [M, K] with
index r's columns at block r, ``b`` [K, N] with index r's rows at block r,
the result [M, N] with index r's rows at block r (replicated over the
mesh's other axes: the result is rank 0's group's). The slice-crossing
route (``_gemm_rs_xla``) has no counterpart: the port's mesh has no slow
tier (ROADMAP.md Queue A, item 6).
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.allgather_gemm import (_silent, _ws_ranks,
                                                      kernel_kind, norm_axis,
                                                      tiles, tp_axis, tp_lib)
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.ops.gemm import (GemmConfig, _b_operand, gemm_into,
                                            matmul, matmul_plain, slot_reduce,
                                            slot_reduce_plain)
from triton_dist_tpu_torch.shmem import device as shd

# the module, not the function ops/__init__.py exports under its name
_rs = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")


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


def gemm_rs_plain(a, b, n: int, out_dtype=None, ws=None, index=None):
    """The plain version of GEMM-RS at ``n`` ranks: index s's partial is
    B2's plain product (``matmul_plain``) of a's column block s with b's row
    block s, in the slots' type; index r's output rows are the slot
    reduction (``slot_reduce_plain``) of the n partials of segment r, in
    slot order. With ``ws`` [R, n, M/n, N] (R ranks, rank q member
    ``index[q]`` of its group; by default R = n and ``index[q] = q``), rank
    q's slot s receives index s's partial of segment ``index[q]``, as the
    kernel's stores leave it."""
    out_dtype = out_dtype or a.dtype
    M, K = a.shape
    m_seg, kl = M // n, K // n
    acc = ws.dtype if ws is not None else _acc_dtype(out_dtype)
    parts = torch.stack([matmul_plain(a[:, s * kl:(s + 1) * kl],
                                      b[s * kl:(s + 1) * kl], acc)
                         .reshape(n, m_seg, -1) for s in range(n)], dim=1)
    if ws is not None:                          # parts[r, s]: s's of seg r
        for q, me in enumerate(index if index is not None else range(n)):
            ws[q] = parts[me]
    return torch.cat([slot_reduce_plain(parts[r], out_dtype)
                      for r in range(n)])


def _tiers(ctx, axes) -> tuple:
    """(outer axis, inner axes, no, ni) of a tuple of axes."""
    outer, inner = axes[0], tuple(axes[1:])
    return outer, inner, ctx.axis_size(outer), ctx.axis_size(inner)


def gemm_rs_2d_plain(ctx, a, b, axes, out_dtype=None, ws=None):
    """The plain version of GEMM-RS over the tuple ``axes`` (outer first):
    stage 1 per rank, the f32 partials (``matmul_plain`` over the rank's K
    block, its index over all the axes) of each inner peer's strided chunk
    ``{(r, j) : r < no}``, and the chunk of its own inner index reduced in
    inner slot order; stage 2, B13's plain ring over the outer groups
    (``reduce_scatter``'s ``_groups_plain``) on the f32 chunks; then the
    cast. With ``ws`` [R, ni, no * M/n, N], rank q's slot s receives its
    inner peer s's partial of its chunk. Returns (the global view [M, N],
    every rank's stage-1 chunk [R, no * M/n, N] f32)."""
    out_dtype = out_dtype or a.dtype
    outer, inner, no, ni = _tiers(ctx, axes)
    n = no * ni
    M, K = a.shape
    m_seg, kl, N = M // n, K // n, b.shape[1]
    f32 = torch.float32
    R = ctx.num_ranks
    g_all = shd.group_plan(ctx, axes)[2]
    g_in = shd.group_plan(ctx, inner)[2]
    segs = a.reshape(no, ni, m_seg, K)
    chunk = {}                  # (K block g, inner j) -> [no * m_seg, N]
    for g in range(n):
        ks = slice(g * kl, (g + 1) * kl)
        for j in range(ni):
            chunk[g, j] = matmul_plain(segs[:, j, :, ks].reshape(-1, kl),
                                       b[ks], f32)
    red = torch.empty(R, no * m_seg, N, dtype=f32, device=a.device)
    for q in range(R):
        peers = [g_all[p] for p in ctx.group_members(q, inner)]
        slots = torch.stack([chunk[g, g_in[q]] for g in peers])
        if ws is not None:
            ws[q] = slots
        red[q] = slot_reduce_plain(slots, f32)
    out = _rs._groups_plain(ctx, red.view(R, -1), outer) if no > 1 \
        else red.view(R, -1)
    members = shd.group_plan(ctx, axes)[3]
    return out[list(members)].reshape(M, N).to(out_dtype), red


def _rs_ranks(ctx, axis, n: int, a, b, ws, out_dtype, silent_rank=None):
    """GEMM-RS at n > 1 ranks over ``axis`` (a name or a tuple): the plain
    version on a CPU tensor, else one launch of the kernel through the
    slots ``ws`` (over a tuple, the inner-group stage, then B13 over the
    outer groups). Returns every group's replica, [G, M, N]."""
    out_dtype = out_dtype or a.dtype
    G = ctx.num_ranks // n
    if a.device.type == "cpu":
        if isinstance(axis, tuple):
            out = gemm_rs_2d_plain(ctx, a, b, axis, out_dtype, ws)[0]
        else:
            out = gemm_rs_plain(a, b, n, out_dtype, ws,
                                shd.group_plan(ctx, axis)[2])
        return out.unsqueeze(0).expand((G,) + tuple(out.shape))
    if b.dtype != a.dtype or ws.dtype != torch.float32:
        raise TypeError(f"gemm_rs: a {a.dtype} and b {b.dtype} share a "
                        f"type, the slots {ws.dtype} are f32")
    a = a.contiguous()
    b, trans = _b_operand(b)
    shd.cuda_checks("gemm_rs", a, b, ws)
    if ws.data_ptr() % 16:
        raise ValueError("gemm_rs: the slots must be 16-byte aligned")
    M, K = a.shape
    N = b.shape[0] if trans else b.shape[1]
    m_seg = M // n
    R = ctx.num_ranks
    if isinstance(axis, tuple):
        outer, inner, no, ni = _tiers(ctx, axis)
        red = _gemm_rs_stage(ctx, axis, a, b, trans, ws, no, inner,
                             torch.float32, silent_rank)
        gemm_rs.launches_2d += 1
        if no > 1:
            (ins,) = shd.tables(ctx, red)
            red = _rs._ring(ctx, ins, m_seg * N, red, outer, silent_rank)
        order = list(shd.group_order(ctx, axis))
        return red.view(R, m_seg, N)[order].view(G, M, N).to(out_dtype)
    out = torch.empty(G, M, N, dtype=out_dtype, device=a.device)
    _gemm_rs_stage(ctx, axis, a, b, trans, ws, 1, axis, out_dtype,
                   silent_rank, out)
    return out


def _gemm_rs_stage(ctx, axis, a, b, trans, ws, no: int, group_axis,
                   out_dtype, silent_rank, out=None):
    """One launch of the GEMM-RS kernel over ``group_axis``'s groups of ni,
    each rank's K block its index over ``axis``, ``no`` strided segments a
    chunk. With ``out`` [G, M, N] (the 1-tier form) each rank writes its
    segment of its group's row; else it returns every rank's chunk [R, no *
    M/n, N] in ``out_dtype`` (the 2-tier stage, f32)."""
    R = ctx.num_ranks
    M, K = a.shape
    N = b.shape[0] if trans else b.shape[1]
    n = ctx.axis_size(axis)
    ni = ctx.axis_size(group_axis)
    m_seg, k_local = M // n, K // n
    kind = kernel_kind(a.dtype, out_dtype)
    lanes = ni * no * tiles(m_seg, N)
    pad = family_pad(ctx, "gemm_rs", group_axis if no == 1 else axis,
                     lanes + R + 1)
    slots, pads = shd.tables(ctx, ws, pad)
    if out is None:
        res = torch.empty(R, no * m_seg, N, dtype=out_dtype, device=a.device)
        (outs,) = shd.tables(ctx, res)
    else:
        res = out
        index = shd.group_plan(ctx, axis)[2]
        outs = shd.group_rows(ctx, out, axis, [i * m_seg * N
                                               * out.element_size()
                                               for i in index])
    group = shd.group_plan(ctx, group_axis)[1]
    kgroup = shd.group_plan(ctx, axis)[1]
    lib = tp_lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(a.device):
        rc = lib.tdt_gemm_rs(a.data_ptr(), b.data_ptr(), outs, slots, pads,
                             ctypes.byref(group), ctypes.byref(kgroup), no, R,
                             m_seg, N, k_local, K, b.stride(0), int(trans),
                             kind, lanes, _silent(silent_rank), *args)
    csrc.check(lib, rc, "gemm_rs")
    gemm_rs.launches += 1
    return res


def _ws_shapes(ctx, axis, n: int, m_seg: int, N: int) -> tuple:
    """(slots, send stage) shapes of ``axis``: one rank [1, 1 | 2, m_seg,
    N]; an axis [R, n | 2, m_seg, N]; a tuple (outer, *inner) [R, ni | 2,
    no * m_seg, N] (the inner stage's chunks)."""
    R = _ws_ranks(ctx, n)
    if n > 1 and isinstance(axis, tuple):
        _, _, no, ni = _tiers(ctx, axis)
        return (R, ni, no * m_seg, N), (R, 2, no * m_seg, N)
    return (R, n, m_seg, N), (R, 2, m_seg, N)


def gemm_rs(ctx, a, b, axis=None, cfg: GemmConfig | None = None,
            out_dtype=None, silent_rank: int | None = None,
            replicas: bool = False):
    """Row-parallel GEMM + reduce-scatter: ``a`` [M, K] sharded on columns,
    ``b`` [K, N] sharded on rows, over ``axis`` (a name, or a tuple of
    axes, outer first: the 2-tier path); returns sum over ranks of a_r @
    b_r, its M rows scattered over the ranks, in ``out_dtype`` (a's type by
    default). ``cfg``, when given, must divide the segment (the JAX op's
    precondition). Allocates a fresh workspace per call; ``gemm_rs_ws`` and
    ``GemmRsContext`` reuse one. A CUDA tensor launches the kernels (each
    B16 call adds one to ``gemm_rs.launches``; over a tuple its stage also
    to ``gemm_rs.launches_2d``, and B13's ring one to
    ``reduce_scatter.launches``) or raises. ``replicas`` and
    ``silent_rank`` as in ``ag_gemm``."""
    axis, n = tp_axis(ctx, axis)
    out_dtype = out_dtype or a.dtype
    m_seg, N = _check(cfg, a, b, n)
    ws_shape, _ = _ws_shapes(ctx, axis, n, m_seg, N)
    ws = torch.empty(ws_shape, dtype=_acc_dtype(out_dtype), device=a.device)
    if n == 1:
        out = _gemm_rs_local(a, b, ws[0], out_dtype)
        return out[None] if replicas else out
    out = _rs_ranks(ctx, axis, n, a, b, ws, out_dtype, silent_rank)
    return out if replicas else out[0]


gemm_rs.launches = 0
gemm_rs.launches_2d = 0


def gemm_rs_ws(ctx, a, b, ws, stage, axis=None,
               cfg: GemmConfig | None = None, out_dtype=None,
               silent_rank: int | None = None):
    """``gemm_rs`` with the symmetric slots ``ws`` and the send stage
    ``stage`` (from ``create_gemm_rs_workspace``; [N, n, M/n, N_cols] and
    [N, 2, M/n, N_cols] over an axis, [N, ni, no * M/n, N_cols] and [N, 2,
    no * M/n, N_cols] over a tuple (outer, *inner)) as explicit operands:
    returns ``(out, ws, stage)``. At one rank slot 0 of ``ws`` holds the
    f32 partial after the call; at n ranks rank q's slot s holds its group
    member s's f32 partial of q's segment (over a tuple, its inner peer s's
    partial of q's chunk). ``stage`` is never written: the kernel stores
    each partial straight into its owner's slot."""
    axis, n = tp_axis(ctx, axis)
    out_dtype = out_dtype or a.dtype
    acc = _acc_dtype(out_dtype)
    m_seg, N = _check(cfg, a, b, n)
    ws_shape, st_shape = _ws_shapes(ctx, axis, n, m_seg, N)
    if tuple(ws.shape) != ws_shape or ws.dtype != acc:
        raise ValueError(f"ws {tuple(ws.shape)}/{ws.dtype} != "
                         f"{ws_shape}/{acc}")
    if tuple(stage.shape) != st_shape or stage.dtype != acc:
        raise ValueError(f"stage {tuple(stage.shape)}/{stage.dtype} != "
                         f"{st_shape}/{acc}")
    if n == 1:
        return _gemm_rs_local(a, b, ws[0], out_dtype), ws, stage
    return (_rs_ranks(ctx, axis, n, a, b, ws, out_dtype, silent_rank)[0], ws,
            stage)


def create_gemm_rs_workspace(ctx, m_seg: int, n_cols: int,
                             out_dtype=torch.bfloat16, axis=None):
    """(symmetric partial slots, send stage) as zeros in the accumulator
    type (f32 for a bf16 output) on the context's device, one block of each
    per rank of the mesh: [N, n, m_seg, n_cols] and [N, 2, m_seg, n_cols]
    over an axis; over a tuple (outer, *inner) the inner stage's chunks,
    [N, ni, no * m_seg, n_cols] and [N, 2, no * m_seg, n_cols]; at one rank
    [1, 1 | 2, m_seg, n_cols]."""
    axis, n = tp_axis(ctx, axis)
    acc = _acc_dtype(out_dtype)
    ws_shape, st_shape = _ws_shapes(ctx, axis, n, m_seg, n_cols)
    return (torch.zeros(ws_shape, dtype=acc, device=ctx.device),
            torch.zeros(st_shape, dtype=acc, device=ctx.device))


@dataclasses.dataclass
class GemmRsContext:
    """Owns the slots and the send stage and threads them through
    ``gemm_rs_ws`` (see ``AgGemmContext``)."""

    ctx: object
    axis: object
    ws: torch.Tensor
    stage: torch.Tensor

    def __call__(self, a, b, cfg: GemmConfig | None = None, out_dtype=None,
                 silent_rank: int | None = None):
        c, self.ws, self.stage = gemm_rs_ws(self.ctx, a, b, self.ws,
                                            self.stage, axis=self.axis,
                                            cfg=cfg, out_dtype=out_dtype,
                                            silent_rank=silent_rank)
        return c


def create_gemm_rs_context(ctx, m_seg: int, n_cols: int,
                           out_dtype=torch.bfloat16,
                           axis=None) -> GemmRsContext:
    axis = norm_axis(ctx, axis)
    ws, stage = create_gemm_rs_workspace(ctx, m_seg, n_cols, out_dtype, axis)
    return GemmRsContext(ctx=ctx, axis=axis, ws=ws, stage=stage)


__all__ = ["GemmRsContext", "create_gemm_rs_context",
           "create_gemm_rs_workspace", "gemm_rs", "gemm_rs_2d_plain",
           "gemm_rs_plain", "gemm_rs_ws"]
