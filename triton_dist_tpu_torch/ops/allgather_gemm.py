"""AllGather-GEMM (TPU kernel B15), in its one-rank form.

Counterpart of ``triton_dist_tpu/ops/allgather_gemm.py``. The TPU kernel
barriers the ranks, puts the local A shard into every peer's workspace slot
and runs the GEMM (B2, ``emit_gemm``) on each segment as it arrives, its own
first. At one rank the barrier is empty, there are no puts, and the kernel
is the local segment's GEMM: here ``gemm_into`` (``csrc/gemm.cu``) on a CUDA
tensor, its plain version on a CPU tensor. The workspace is carried and
returned unwritten, as the TPU kernel leaves it at n = 1.

More ranks, tuple axes (the 2-tier ``ag_overlap_protocol_2d``) and
slice-crossing axes (``_ag_gemm_dcn``) wait for the puts across ranks
over the shmem layer (ROADMAP.md Queue A, item 6 "TP overlap across
ranks") and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops.gemm import GemmConfig, gemm_into, matmul


def norm_axis(ctx, axis):
    """An op's ``axis`` argument normalised: None is the first mesh axis, a
    1-tuple its name, a longer tuple stays a tuple (the 2-tier path)."""
    if axis is None:
        return ctx.axis_names[0]
    if not isinstance(axis, str):
        axis = tuple(axis)
        return axis[0] if len(axis) == 1 else axis
    return axis


def one_rank_axis(ctx, axis, op: str, multi: str) -> str:
    """``axis`` normalised, when it spans one rank; else raise
    ``NotImplementedError`` naming what waits (``multi``: the op's
    multi-tier paths)."""
    axis = norm_axis(ctx, axis)
    if isinstance(axis, tuple):
        raise NotImplementedError(
            f"{op} over the axis tuple {axis} ({multi}) is not ported yet: "
            "ROADMAP.md Queue A, item 6 \"TP overlap across ranks\"")
    n = ctx.axis_size(axis)
    if n != 1:
        raise NotImplementedError(
            f"{op} over {n} ranks is not ported yet: its puts across ranks "
            "are ROADMAP.md Queue A, item 6 \"TP overlap across ranks\"")
    return axis


def _local_gemm(a, b, cfg, out_dtype):
    """The local segment's GEMM: [M, K] @ [K, N] into ``out_dtype``."""
    if cfg is not None:
        cfg.check(a.shape[0], b.shape[1])
    out = torch.empty(a.shape[0], b.shape[1], dtype=out_dtype or a.dtype,
                      device=a.device)
    before = matmul.launches
    gemm_into(a, b, out)
    ag_gemm.launches += matmul.launches - before
    return out


def ag_gemm(ctx, a, b, axis=None, cfg: GemmConfig | None = None,
            out_dtype=None):
    """C = all_gather(a) @ b: ``a`` [M, K] sharded on rows, ``b`` [K, N]
    sharded on columns; C [M, N] in ``out_dtype`` (a's type by default).
    ``cfg``, when given, must divide the local output (the JAX op's
    precondition). A CUDA tensor launches the GEMM kernel (one launch adds
    one to ``ag_gemm.launches``) or raises."""
    one_rank_axis(ctx, axis, "ag_gemm", "_ag_gemm_dcn, ag_overlap_protocol_2d")
    return _local_gemm(a, b, cfg, out_dtype)


ag_gemm.launches = 0


def ag_gemm_ws(ctx, a, b, ws, axis=None, cfg: GemmConfig | None = None,
               out_dtype=None):
    """``ag_gemm`` with the symmetric workspace ``ws`` [n, n, M/n, K] (from
    ``create_ag_gemm_workspace``) as an explicit operand: returns ``(C,
    ws)``. At one rank no segment travels, so ``ws`` comes back
    unwritten."""
    axis = one_rank_axis(ctx, axis, "ag_gemm_ws",
                         "_ag_gemm_dcn, ag_overlap_protocol_2d")
    n = ctx.axis_size(axis)
    M, K = a.shape
    if tuple(ws.shape) != (n, n, M // n, K) or ws.dtype != a.dtype:
        raise ValueError(
            f"workspace {tuple(ws.shape)}/{ws.dtype} does not match "
            f"({n}, {n}, {M // n}, {K})/{a.dtype}: create it with "
            f"create_ag_gemm_workspace(ctx, m_local={M // n}, k={K}, ...)")
    return _local_gemm(a, b, cfg, out_dtype), ws


def create_ag_gemm_workspace(ctx, m_local: int, k: int,
                             dtype=torch.bfloat16, axis=None):
    """The symmetric AG workspace: [n, n, m_local, k] zeros on the context's
    device, one [n, m_local, k] block of slots per rank."""
    axis = one_rank_axis(ctx, axis, "create_ag_gemm_workspace",
                         "a 2-tier workspace")
    n = ctx.axis_size(axis)
    return torch.zeros((n, n, m_local, k), dtype=dtype, device=ctx.device)


@dataclasses.dataclass
class AgGemmContext:
    """Owns a symmetric workspace and threads it through ``ag_gemm_ws``, so
    repeated calls reuse one buffer. (The JAX context also caches a jitted,
    donating step per shape; PyTorch runs eagerly and updates in place.)"""

    ctx: object
    axis: str
    ws: torch.Tensor

    def __call__(self, a, b, cfg: GemmConfig | None = None, out_dtype=None):
        c, self.ws = ag_gemm_ws(self.ctx, a, b, self.ws, axis=self.axis,
                                cfg=cfg, out_dtype=out_dtype)
        return c


def create_ag_gemm_context(ctx, m_local: int, k: int, dtype=torch.bfloat16,
                           axis=None) -> AgGemmContext:
    axis = norm_axis(ctx, axis)
    ws = create_ag_gemm_workspace(ctx, m_local, k, dtype, axis)
    return AgGemmContext(ctx=ctx, axis=axis, ws=ws)


def tp_column_linear(ctx, h, w, axis: str = "tp", impl: str = "xla",
                     cfg: GemmConfig | None = None):
    """``h @ w`` with ``w`` column-sharded over ``axis``, the output
    gathered back to replicated. At one rank it is ``h @ w``, as in the JAX
    op (a plain product there too, outside any kernel); more ranks raise
    ``NotImplementedError``."""
    n = ctx.axis_size(axis)
    if n != 1:
        raise NotImplementedError(
            f"tp_column_linear over {n} ranks (impl {impl!r}) is not ported "
            "yet: ROADMAP.md Queue A, item 6 \"TP overlap across ranks\"")
    return h @ w


__all__ = ["AgGemmContext", "GemmConfig", "ag_gemm", "ag_gemm_ws",
           "create_ag_gemm_context", "create_ag_gemm_workspace",
           "tp_column_linear"]
