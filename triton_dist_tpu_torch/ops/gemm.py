"""The dense GEMM that the tensor-parallel overlap ops are built on.

Counterpart of ``triton_dist_tpu/ops/gemm.py``: ``matmul`` is TPU kernel B2
(``emit_gemm`` in a ``pallas_call``), and ``gemm_into`` is the same GEMM
written into a given output, the form that AG-GEMM (B15) and GEMM-RS (B16)
run per segment. On a CUDA tensor both launch the hand-written Hopper kernel
of ``csrc/gemm.cu``; on a CPU tensor they run ``matmul_plain``, the f32
product cast once, which the kernel repeats. ``slot_reduce`` is the second
half of GEMM-RS (``emit_slot_reduction``): the f32 sum of a symmetric
workspace's partial slots, in slot order, cast to the output type; its
kernel lives in the same source.

The kernel sums the whole K in f32 and casts once: bf16 inputs give a bf16
or f32 output, f32 inputs an f32 output. The TPU's K-split path (a
``GemmConfig`` with ``block_k``) rounds each strip's partial into the output
type; the port does not (ROADMAP Queue C). ``GemmConfig``'s tiles are
Mosaic VMEM tiles: the port keeps the class for its API and the
divisibility the JAX op asserts, and the kernel takes its own tile from
``HOPPER_TILES`` (which replaces ``best_gemm_config``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch import csrc

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # a, b, c, M, N, K, b_trans, out_f32, tile_m, stream
    "tdt_gemm_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # a, b, c, M, N, K, b_trans, stream
    "tdt_gemm_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    # a, b, c, M, N, K, ldb, b_trans, out_f32, tile_m, stream
    "tdt_gemm_bf16_ld": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # a, b, c, M, N, K, ldb, b_trans, stream
    "tdt_gemm_f32_ld": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # ws, out, n, elems, out_bf16, stream
    "tdt_slot_reduce": [_P, _P, _I, ctypes.c_longlong, _I, _P],
}
# The kernel's (rows, columns) per block, tried in order: the first whose
# grid fills the card's 132 SMs wins, else the last (small M). The rows
# only change which block computes an output, not its bits.
HOPPER_TILES = ((128, 128), (64, 128))
NUM_SMS = 132


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    """The JAX op's tile config, kept for its API: ``block_m`` and
    ``block_n`` must divide the output's rows and columns (``emit_gemm``
    asserts it), ``block_k`` is accepted and ignored (the kernel sums the
    whole K)."""

    block_m: int = 128
    block_n: int = 128
    block_k: int | None = None

    def check(self, m_rows: int, n_cols: int) -> None:
        """Raise ``ValueError`` unless the tiles divide ``[m_rows,
        n_cols]``."""
        if m_rows % self.block_m or n_cols % self.block_n:
            raise ValueError(
                f"gemm output [{m_rows}, {n_cols}] not divisible by tile "
                f"({self.block_m}, {self.block_n})")


def hopper_tile(m_rows: int, n_cols: int) -> tuple[int, int]:
    """The kernel's tile for an ``[m_rows, n_cols]`` output."""
    for tm, tn in HOPPER_TILES:
        if -(-m_rows // tm) * -(-n_cols // tn) >= NUM_SMS:
            return tm, tn
    return HOPPER_TILES[-1]


def matmul_plain(a, b, out_dtype=None):
    """The plain PyTorch version: ``a @ b`` summed in f32, cast once."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def _b_operand(b):
    """(tensor, transposed) for the kernel: ``b`` itself when row-major,
    its storage as [N, K] when ``b`` is the transpose of a row-major
    matrix, else a row-major copy."""
    if b.is_contiguous():
        return b, False
    if b.t().is_contiguous():
        return b.t(), True
    return b.contiguous(), False


def _b_strided(b):
    """``b``'s leading dimension when it is a block of rows of a wider
    row-major matrix (unit column stride, e.g. a column slice), the kernel
    reading it in place; None otherwise."""
    if b.dim() == 2 and b.stride(1) == 1 and b.stride(0) >= b.shape[1] \
            and not b.is_contiguous():
        return b.stride(0)
    return None


def gemm_into(a, b, out):
    """``out[...] = a @ b`` with f32 sums and one cast to ``out``'s type:
    a [M, K], b [K, N] (row-major, a column block of a row-major matrix,
    read in place, or the transpose of a row-major [N, K]), out [M, N]
    contiguous. Returns ``out``.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (bf16 a and b into a bf16 or f32 out, or f32 throughout) or raises; each
    launch adds one to ``matmul.launches``."""
    M, K = a.shape
    K2, N = b.shape
    if K2 != K or tuple(out.shape) != (M, N):
        raise ValueError(f"gemm shapes a {tuple(a.shape)}, b {tuple(b.shape)},"
                         f" out {tuple(out.shape)} do not chain")
    if a.device.type == "cpu":
        return out.copy_(matmul_plain(a, b, out.dtype))
    if not (a.dtype == b.dtype and (
            (a.dtype == torch.bfloat16
             and out.dtype in (torch.bfloat16, torch.float32))
            or (a.dtype == torch.float32 and out.dtype == torch.float32))):
        raise TypeError(f"gemm takes bf16 a, b into a bf16 or f32 out, or f32 "
                        f"throughout; got {a.dtype}, {b.dtype} -> {out.dtype}")
    if b.device != a.device or out.device != a.device:
        raise ValueError("gemm: a, b and out must lie on one device")
    if not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("gemm: out must be contiguous and 16-byte aligned")
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    a = a.contiguous()
    ldb = _b_strided(b)
    if ldb is None:
        b, trans = _b_operand(b)
        ldb = K if trans else N
    else:
        trans = False
    lib = csrc.load("gemm", _SIGNATURES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with csrc.current_on(a.device):
        if a.dtype == torch.bfloat16:
            rc = lib.tdt_gemm_bf16_ld(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), M, N, K, ldb, int(trans),
                                      int(out.dtype == torch.float32),
                                      hopper_tile(M, N)[0], stream)
        else:
            rc = lib.tdt_gemm_f32_ld(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), M, N, K, ldb, int(trans),
                                     stream)
    csrc.check(lib, rc, "gemm")
    matmul.launches += 1
    return out


def matmul(a, b, cfg: GemmConfig | None = None, out_dtype=None):
    """``a @ b`` for a [M, K], b [K, N]: f32 sums, one cast to
    ``out_dtype`` (a's type by default). ``cfg``, when given, must divide
    the output (the JAX op's precondition); the kernel's tile is its own.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``gemm_into``) or raises."""
    M, N = a.shape[0], b.shape[1]
    if cfg is not None:
        cfg.check(M, N)
    out = torch.empty(M, N, dtype=out_dtype or a.dtype, device=a.device)
    return gemm_into(a, b, out)


matmul.launches = 0


def slot_reduce_plain(ws, out_dtype):
    """The plain version of ``slot_reduce``: the slots summed in order in
    f32, cast once."""
    acc = ws[0].float().clone()
    for s in range(1, ws.shape[0]):
        acc += ws[s].float()
    return acc.to(out_dtype)


def slot_reduce(ws, out_dtype):
    """Sum the partial slots of ``ws`` [n, ...] (f32) in slot order, in f32,
    and cast once to ``out_dtype`` (bf16 or f32): [...].

    A CPU tensor runs the plain version. A CUDA tensor (contiguous, 16-byte
    aligned) launches the kernel or raises; each launch adds one to
    ``slot_reduce.launches``."""
    if ws.device.type == "cpu":
        return slot_reduce_plain(ws, out_dtype)
    if ws.dtype != torch.float32 or out_dtype not in (torch.bfloat16,
                                                      torch.float32):
        raise TypeError(f"slot_reduce takes f32 slots into bf16 or f32, got "
                        f"{ws.dtype} -> {out_dtype}")
    if not ws.is_contiguous() or ws.data_ptr() % 16:
        raise ValueError("slot_reduce: the slots must be contiguous and "
                         "16-byte aligned")
    out = torch.empty(ws.shape[1:], dtype=out_dtype, device=ws.device)
    if out.numel() == 0:
        return out
    lib = csrc.load("gemm", _SIGNATURES)
    with csrc.current_on(ws.device):
        rc = lib.tdt_slot_reduce(ws.data_ptr(), out.data_ptr(), ws.shape[0],
                                 out.numel(), int(out_dtype == torch.bfloat16),
                                 torch.cuda.current_stream(ws.device)
                                 .cuda_stream)
    csrc.check(lib, rc, "slot_reduce")
    slot_reduce.launches += 1
    return out


slot_reduce.launches = 0

__all__ = ["GemmConfig", "HOPPER_TILES", "gemm_into", "hopper_tile", "matmul",
           "matmul_plain", "slot_reduce", "slot_reduce_plain"]
