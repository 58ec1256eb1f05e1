"""AllGather-GEMM (TPU kernel B15).

Counterpart of ``triton_dist_tpu/ops/allgather_gemm.py``. The TPU kernel
barriers the ranks, puts the local A shard into every peer's workspace slot
and runs the GEMM (B2, ``emit_gemm``) on each segment as it arrives, its own
first.

- At one rank the barrier is empty, there are no puts, and the kernel is
  the local segment's GEMM: ``gemm_into`` (``csrc/gemm.cu``) on a CUDA
  tensor, its plain version on a CPU tensor. The workspace is carried and
  returned unwritten, as the TPU kernel leaves it at n = 1.
- At n ranks over one axis (``ag_overlap_protocol``) every rank runs on
  the one card (``shmem/context.py``) and one cooperative launch of
  ``csrc/tp_overlap.cu`` covers every rank of the mesh: the entry barrier,
  each rank's puts of its shard into slot ``me`` of every peer's symmetric
  workspace, then each rank's column block of C segment by segment in the
  swizzled order ``me, me+1, ...``. Inside a multi-axis mesh the axis's
  groups run side by side in that launch (``shmem.device.group_plan``),
  each writing its own replica of C.
- Over a tuple of axes ``(outer, *inner)`` (``ag_overlap_protocol_2d``)
  the same launch runs the 2-tier relay of ``csrc/ag_relay_2d.cuh`` with
  B2's tile as its emit: the own shard pushed over the inner group and one
  hop round the outer ring, each relayed segment forwarded before it is
  computed. The rows and columns follow ``P(axes)``: rank (mo, mi) is index
  ``mo * ni + mi``, so over ("a", "b") of (2, 2) the result is bitwise the
  one-axis kernel over 4 ranks.

A CPU tensor runs the plain version (``ag_gemm_plain``): per rank, B2's
plain product of the gathered A into its column block, and the slots
filled as the kernel fills them (the relay fills every slot as the 1-tier
push does).

Inputs and outputs are the JAX package's global views: ``a`` [M, K] with
index r's rows at block r, ``b`` [K, N] and C [M, N] with index r's
columns at block r (replicated over the mesh's other axes: the result is
rank 0's group's). The slice-crossing route (``_ag_gemm_dcn``) has no
counterpart: the port's mesh has no slow tier (ROADMAP.md Queue A, item
6).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.allgather import all_gather
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.ops.gemm import (GemmConfig, _b_operand,
                                            gemm_into, matmul, matmul_plain)
from triton_dist_tpu_torch.shmem import device as shd

TP_OVERLAP = 'ROADMAP.md Queue A, item 6 "TP overlap across ranks"'

_P = ctypes.c_void_p
_I = ctypes.c_int
TP_SIGNATURES = {
    # a b c ws pads group n m_local n_local K ldb b_trans kind lanes silent
    "tdt_ag_gemm": [_P] * 6 + [_I] * 9 + shd.LAUNCH_SIG,
    # a b c ws pads relay, then as tdt_ag_gemm's
    "tdt_ag_gemm_2d": [_P] * 6 + [_I] * 9 + shd.LAUNCH_SIG,
    # a b out ws pads group kgroup no n m_seg N k_local lda ldb b_trans kind
    # lanes silent ...
    "tdt_gemm_rs": [_P] * 7 + [_I] * 11 + shd.LAUNCH_SIG,
}
# rows and columns of the kernels' output tile (csrc/gemm_tile.cuh)
TILE = 128


def tp_lib():
    return csrc.load("tp_overlap", TP_SIGNATURES)


def kernel_kind(in_dtype, out_dtype) -> int:
    """The overlap kernels' type code: bf16 into bf16 (0) or f32 (1), or f32
    throughout (2)."""
    if in_dtype == torch.bfloat16 and out_dtype in (torch.bfloat16,
                                                    torch.float32):
        return int(out_dtype == torch.float32)
    if in_dtype == out_dtype == torch.float32:
        return 2
    raise TypeError(f"the overlap kernels take bf16 into bf16 or f32, or f32 "
                    f"throughout; got {in_dtype} -> {out_dtype}")


def tiles(rows: int, cols: int) -> int:
    """Output tiles of a [rows, cols] block."""
    return -(-rows // TILE) * -(-cols // TILE)


def norm_axis(ctx, axis):
    """An op's ``axis`` argument normalised: None is the first mesh axis, a
    1-tuple its name, a longer tuple stays a tuple (the 2-tier path)."""
    if axis is None:
        return ctx.axis_names[0]
    if not isinstance(axis, str):
        axis = tuple(axis)
        return axis[0] if len(axis) == 1 else axis
    return axis


def tp_axis(ctx, axis) -> tuple:
    """(``axis`` normalised, its ranks) for an overlap op: one rank; an axis
    (a group inside a multi-axis mesh, or the whole mesh); or a tuple of
    axes, outer first (the 2-tier path)."""
    axis = norm_axis(ctx, axis)
    return axis, ctx.axis_size(axis)


def _silent(rank) -> int:
    return -1 if rank is None else int(rank)


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


def _check(a, b, n: int, cfg) -> int:
    """The local rows M / n, after checking that the shapes split over
    ``n`` ranks and that ``cfg`` divides the local output."""
    M, K = a.shape
    if b.shape[0] != K:
        raise ValueError(f"A/B inner dims {K} vs {b.shape[0]}")
    if M % n or b.shape[1] % n:
        raise ValueError(f"ag_gemm: M={M} and N={b.shape[1]} must split "
                         f"over {n} ranks")
    if cfg is not None:
        cfg.check(M // n, b.shape[1] // n)
    return M // n


def ag_gemm_plain(a, b, n: int, out_dtype=None, ws=None, index=None):
    """The plain version of AG-GEMM at ``n`` ranks: index r's column block
    of C is B2's plain product (``matmul_plain``) of the gathered A (``a``
    itself, the shards index-major) with index r's column block of ``b``.
    With ``ws`` [R, n, M/n, K] (R ranks, rank q member ``index[q]`` of its
    group; by default R = n and ``index[q] = q``), rank q's slot s receives
    shard s for every s != index[q], as the kernel's puts (or the 2-tier
    relay) leave it (its own slot is never written)."""
    M, K = a.shape
    nl = b.shape[1] // n
    out = torch.empty(M, b.shape[1], dtype=out_dtype or a.dtype,
                      device=a.device)
    for r in range(n):
        cols = slice(r * nl, (r + 1) * nl)
        out[:, cols] = matmul_plain(a, b[:, cols], out.dtype)
    if ws is not None:
        shards = a.reshape(n, M // n, K)
        for q, me in enumerate(index if index is not None else range(n)):
            for s in range(n):
                if s != me:
                    ws[q, s] = shards[s]
    return out


def _ag_ranks(ctx, axis, n: int, a, b, ws, out_dtype, silent_rank=None):
    """AG-GEMM at n > 1 ranks over ``axis`` (a name or a tuple): the plain
    version on a CPU tensor, else one launch of the kernel (the 2-tier relay
    over a tuple) through the workspace ``ws`` [N, n, M/n, K]. Returns
    every group's replica, [G, M, N]."""
    out_dtype = out_dtype or a.dtype
    index = shd.group_plan(ctx, axis)[2]
    G = ctx.num_ranks // n
    if a.device.type == "cpu":
        c = ag_gemm_plain(a, b, n, out_dtype, ws, index)
        return c.unsqueeze(0).expand((G,) + tuple(c.shape))
    if b.dtype != a.dtype or ws.dtype != a.dtype:
        raise TypeError(f"ag_gemm: a {a.dtype}, b {b.dtype} and the "
                        f"workspace {ws.dtype} must share a type")
    kind = kernel_kind(a.dtype, out_dtype)
    a = a.contiguous()
    b, trans = _b_operand(b)
    shd.cuda_checks("ag_gemm", a, b, ws)
    M, K = a.shape
    N = b.shape[0] if trans else b.shape[1]
    if isinstance(axis, tuple) and (M // n * K * a.element_size()) % 16:
        raise ValueError("ag_gemm over two tiers: a shard must be a whole "
                         "number of 16-byte vectors")
    out = torch.empty(G, M, N, dtype=out_dtype, device=a.device)
    lanes = n * tiles(M // n, N // n)
    R = ctx.num_ranks
    pad = family_pad(ctx, "ag_gemm", axis, lanes + R + 1)
    slots, pads = shd.tables(ctx, ws, pad)
    outs = shd.group_rows(ctx, out, axis)
    if isinstance(axis, tuple):
        entry, plan = "tdt_ag_gemm_2d", shd.relay_plan(ctx, axis)
    else:
        entry, plan = "tdt_ag_gemm", shd.group_plan(ctx, axis)[1]
    lib = tp_lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(a.device):
        rc = getattr(lib, entry)(
            a.data_ptr(), b.data_ptr(), outs, slots, pads, ctypes.byref(plan),
            R, M // n, N // n, K, b.stride(0), int(trans), kind, lanes,
            _silent(silent_rank), *args)
    csrc.check(lib, rc, "ag_gemm")
    ag_gemm.launches += 1
    ag_gemm.launches_2d += int(isinstance(axis, tuple))
    return out


def ag_gemm(ctx, a, b, axis=None, cfg: GemmConfig | None = None,
            out_dtype=None, silent_rank: int | None = None,
            replicas: bool = False):
    """C = all_gather(a) @ b: ``a`` [M, K] sharded on rows, ``b`` [K, N]
    sharded on columns, over ``axis`` (a name, or a tuple of axes, outer
    first: the 2-tier path); C [M, N] sharded on columns, in ``out_dtype``
    (a's type by default). ``cfg``, when given, must divide the local
    output (the JAX op's precondition). At n > 1 ranks a fresh workspace is
    made for the call; ``ag_gemm_ws`` and ``AgGemmContext`` reuse one. A
    CUDA tensor launches the kernel (each B15 call adds one to
    ``ag_gemm.launches``, over a tuple also to ``ag_gemm.launches_2d``) or
    raises. ``replicas``: every group's C, [G, M,
    N] (G groups of the axis in the mesh; their numbering
    ``shmem.device.group_ids``). ``silent_rank`` (n > 1, the card) names a
    rank that puts but never signals: the call then raises ``ShmemError``
    once the spin budget has passed."""
    axis, n = tp_axis(ctx, axis)
    if n == 1:
        c = _local_gemm(a, b, cfg, out_dtype)
        return c[None] if replicas else c
    m_local = _check(a, b, n, cfg)
    ws = (None if a.device.type == "cpu" else
          torch.empty((ctx.num_ranks, n, m_local, a.shape[1]),
                      dtype=a.dtype, device=a.device))
    c = _ag_ranks(ctx, axis, n, a, b, ws, out_dtype, silent_rank)
    return c if replicas else c[0]


ag_gemm.launches = 0
ag_gemm.launches_2d = 0


def _ws_ranks(ctx, n: int) -> int:
    """The leading dim of an overlap op's workspace: one buffer at one
    rank, else one a rank of the mesh."""
    return 1 if n == 1 else ctx.num_ranks


def ag_gemm_ws(ctx, a, b, ws, axis=None, cfg: GemmConfig | None = None,
               out_dtype=None, silent_rank: int | None = None):
    """``ag_gemm`` with the symmetric workspace ``ws`` [N, n, M/n, K] (N the
    mesh's ranks, from ``create_ag_gemm_workspace``) as an explicit operand,
    written in place: returns ``(C, ws)``. At one rank no segment travels,
    so ``ws`` comes back unwritten; at n ranks rank q's slot s holds shard
    s for every s but its own index, and its own slot is left as it was."""
    axis, n = tp_axis(ctx, axis)
    M, K = a.shape
    want = (_ws_ranks(ctx, n), n, M // n, K)
    if tuple(ws.shape) != want or ws.dtype != a.dtype:
        raise ValueError(
            f"workspace {tuple(ws.shape)}/{ws.dtype} does not match "
            f"{want}/{a.dtype}: create it with "
            f"create_ag_gemm_workspace(ctx, m_local={M // n}, k={K}, ...)")
    if n == 1:
        return _local_gemm(a, b, cfg, out_dtype), ws
    _check(a, b, n, cfg)
    return _ag_ranks(ctx, axis, n, a, b, ws, out_dtype, silent_rank)[0], ws


def create_ag_gemm_workspace(ctx, m_local: int, k: int,
                             dtype=torch.bfloat16, axis=None):
    """The symmetric AG workspace: [N, n, m_local, k] zeros on the context's
    device, one [n, m_local, k] block of slots per rank of the mesh (at n >
    1 ``ctx.create_symm_tensor``; at one rank [1, 1, m_local, k])."""
    _, n = tp_axis(ctx, axis)
    if n == 1:
        return torch.zeros((1, 1, m_local, k), dtype=dtype, device=ctx.device)
    return ctx.create_symm_tensor((n, m_local, k), dtype)


@dataclasses.dataclass
class AgGemmContext:
    """Owns a symmetric workspace and threads it through ``ag_gemm_ws``, so
    repeated calls reuse one buffer (the kernel's entry barrier guards it
    across calls). (The JAX context also caches a jitted, donating step per
    shape; PyTorch runs eagerly and updates in place.)"""

    ctx: object
    axis: object
    ws: torch.Tensor

    def __call__(self, a, b, cfg: GemmConfig | None = None, out_dtype=None,
                 silent_rank: int | None = None):
        c, self.ws = ag_gemm_ws(self.ctx, a, b, self.ws, axis=self.axis,
                                cfg=cfg, out_dtype=out_dtype,
                                silent_rank=silent_rank)
        return c


def create_ag_gemm_context(ctx, m_local: int, k: int, dtype=torch.bfloat16,
                           axis=None) -> AgGemmContext:
    axis = norm_axis(ctx, axis)
    ws = create_ag_gemm_workspace(ctx, m_local, k, dtype, axis)
    return AgGemmContext(ctx=ctx, axis=axis, ws=ws)


def column_product_plain(h, w):
    """The plain version of ``column_product``: every output element summed
    over K in order, one f32 multiply and one f32 add a step, cast once.
    Its bits depend on the element's row of ``h`` and column of ``w`` alone,
    never on which other rows or columns share the call."""
    acc = torch.zeros(h.shape[0], w.shape[1], dtype=torch.float32,
                      device=h.device)
    hf = h.float()
    prod = torch.empty_like(acc)
    for k in range(h.shape[1]):
        torch.mul(hf[:, k:k + 1], w[k].float(), out=prod)
        acc.add_(prod)
    return acc.to(h.dtype)


def column_product(h, w):
    """``h @ w`` whose every output element is summed over K in one fixed
    order, whatever rows and columns share the call, so a column block's
    product is bitwise its columns of the whole product: B2 (``matmul``,
    ``csrc/gemm.cu``, reading a column slice of ``w`` in place) on a CUDA
    tensor, ``column_product_plain`` on a CPU tensor."""
    if h.device.type == "cpu":
        return column_product_plain(h, w)
    return matmul(h.contiguous(), w)


def tp_column_linear(ctx, h, w, axis: str = "tp", impl: str = "xla",
                     cfg: GemmConfig | None = None):
    """``h @ w`` with ``w`` [K, N] column-sharded over ``axis`` (rank r's
    columns at block r, views of ``w``), the output gathered back to
    replicated: the JAX ``tp_column_linear``, the sharded serving engine's
    ``linear`` hook at every mesh size.

    ``impl="xla"``: each rank's column block ``column_product(h, w_r)``,
    then the column blocks gathered through B9 (``all_gather`` over
    ``axis``: every rank's replica; the result is rank 0's). Each element
    is summed in one order whatever the split, so the result is bitwise
    the one-rank ``column_product(h, w)``, as the serving contract needs.
    ``impl="ag_gemm"``: the rows (padded with zero rows to a multiple of
    n) through AG-GEMM (B15, ``ag_gemm``), then the same column gather; allclose to ``xla``, not bitwise (its tiles
    sum in another order), as in the reference. ``impl="gemm_rs"`` is
    refused: its reduce-scatter sums partial products across ranks, which
    breaks the bitwise cross-mesh contract."""
    if impl == "gemm_rs":
        raise ValueError(
            "tp_column_linear refuses impl='gemm_rs': its reduce-scatter "
            "sums partial products in rank-varying order, which breaks the "
            "bitwise cross-mesh-size trace contract serving pins. Use 'xla' "
            "(bitwise) or 'ag_gemm' (allclose-only overlap).")
    if impl not in ("xla", "ag_gemm"):
        raise ValueError(f"unknown tp_column_linear impl {impl!r}")
    n = ctx.axis_size(axis)
    if n == 1:
        if impl == "ag_gemm":
            return ag_gemm(ctx, h, w, axis=axis, cfg=cfg)
        return column_product(h, w)
    R, N = h.shape[0], w.shape[1]
    if N % n:
        raise ValueError(f"out dim {N} does not split over |{axis}| = {n}")
    nl = N // n
    if impl == "xla":
        blocks = torch.stack([column_product(h, w[:, r * nl:(r + 1) * nl])
                              for r in range(n)])
    else:
        # AG-GEMM's rows split over the ranks: pad them to a multiple of n
        # with zero rows, and drop their products
        pad = -R % n
        hp = torch.cat([h, h.new_zeros(pad, h.shape[1])]) if pad else h
        c = ag_gemm(ctx, hp.contiguous(), w, axis=axis, cfg=cfg)[:R]
        blocks = c.reshape(R, n, nl).transpose(0, 1).contiguous()
    g = all_gather(ctx, blocks.view(n * R, nl), axis=axis)[0]
    return g.view(n, R, nl).transpose(0, 1).reshape(R, N)


__all__ = ["AgGemmContext", "GemmConfig", "TP_OVERLAP", "ag_gemm",
           "column_product", "column_product_plain",
           "ag_gemm_plain", "ag_gemm_ws", "create_ag_gemm_context",
           "create_ag_gemm_workspace", "tp_column_linear"]
