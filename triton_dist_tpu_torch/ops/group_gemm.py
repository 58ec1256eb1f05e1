"""Grouped (expert) GEMMs and MoE token alignment.

Counterpart of ``triton_dist_tpu/ops/group_gemm.py``. Rows are sorted by
expert and each expert's run is padded to a multiple of ``block_m``, so every
row block belongs to one expert (``align_tokens_by_expert``); the grouped
GEMMs then multiply each block by its expert's weights. On a CUDA tensor
``grouped_gemm`` (TPU kernel B17) and ``grouped_gemm_gated`` (B18) launch the
hand-written Hopper kernels of ``csrc/group_gemm.cu``; on a CPU tensor they
run ``grouped_gemm_plain`` / ``grouped_gemm_gated_plain``, PyTorch loops over
the row blocks that repeat the kernels' arithmetic (f32 sums, one cast).

The used-block bound ``n_blocks_used`` stays on the device: the kernels read
it from device memory, so the MoE layer never waits for the host. Blocks at
or past it do no work; ``masked=True`` returns their rows zeroed and
``masked=False`` leaves them undefined (callers must not read them).

A row's result depends on its own tokens and expert alone, not on
``block_m`` or its neighbours: the kernels sum every output's products in one
fixed order. The column tile is the kernel's own (128); the TPU's
``block_n`` survives as the pack width of the packed gate‖up stream.

The options of the deployed EP block, as the reference has them:
``row_scale`` (an f32 scale a row, the dequantise of a quantised EP wire,
folded into the f32 sums before the one cast; the rows may then be fp8
e4m3fn or int8, read by the kernels at one byte a value), the packed gate‖up
stream (``pack_gated_weights`` / ``PackedGatedWeights``: one [E, H, 2F]
weight array whose column groups alternate ``block_n`` gate and up columns),
``block_k`` (the K extent of one pipeline pass of the kernel; the sums and
their order do not change) and ``prefetch_depth`` (the depth of the
kernel's ring of copies, 2 to 4 stages). The packed stream, every
``block_k`` and every depth give the bits of the two-stream, full-K kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from triton_dist_tpu_torch import csrc

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, wg, wu, be, nb, scale, out, P, K, N, block_m, E, pack_bn, block_k,
# depth, gated, x_kind, out_f32, stream: every launch of the wrappers
_EX = [_P] * 7 + [_I] * 11 + [_P]
# the rows' types the kernels take (csrc/group_gemm_tile.cuh kX; 3: f32)
X_KINDS = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.int8: 2,
           torch.float32: 3}
TILE_N = 128     # output columns per kernel block
TILE_K = 32      # contraction depth per kernel stage
MIN_BLOCK_M = 16
RING_DEPTHS = (2, 3, 4)   # the kernel's ring of copies: stages in flight


# ---------------------------------------------------------------------------
# alignment (plain PyTorch ops, no host sync)
# ---------------------------------------------------------------------------

def _expert_counts(ids, num_experts: int):
    """(valid [T], the ids with invalid rows moved to E, their one-hot
    [T, E + 1]). An id outside [0, E) is an invalid row."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_experts)
    ids_safe = torch.where(valid, ids, torch.full_like(ids, num_experts))
    onehot = F.one_hot(ids_safe, num_experts + 1)
    return valid, ids_safe, onehot


def expert_alignment(ids, num_experts: int, block_m: int):
    """``align_tokens_by_expert``'s layout with its bound and its inverse:
    ``(gather_idx, row_valid, block_expert, n_used, dest_row)``, where
    ``dest_row`` [T] int32 is the aligned row of each row, P for a row that
    goes nowhere (so ``gather_idx[dest_row[t]] == t`` for every routed t).
    ``ids`` as in ``align_tokens_by_expert``. Nothing syncs with the host."""
    if isinstance(ids, np.ndarray):
        ids = torch.from_numpy(np.ascontiguousarray(ids))
    T = ids.shape[0]
    E, bm = num_experts, block_m
    dev = ids.device
    P = -(-T // bm) * bm + E * bm
    valid, ids_safe, onehot = _expert_counts(ids, E)
    rank_in_e = (onehot.cumsum(0) - onehot).gather(1, ids_safe[:, None])[:, 0]
    counts = onehot[:, :E].sum(0)
    blocks_e = (counts + bm - 1) // bm
    block_start = blocks_e.cumsum(0) - blocks_e
    dest_row = torch.where(
        valid, block_start[ids_safe.clamp(max=E - 1)] * bm + rank_in_e,
        torch.full_like(ids_safe, P))
    # invalid rows all land on the extra slot P, which is cut off
    gather_idx = torch.zeros(P + 1, dtype=torch.int32, device=dev).scatter_(
        0, dest_row, torch.arange(T, dtype=torch.int32, device=dev))[:P]
    row_valid = torch.zeros(P + 1, dtype=torch.bool, device=dev).scatter_(
        0, dest_row, torch.ones(T, dtype=torch.bool, device=dev))[:P]
    blk = torch.arange(P // bm, device=dev)
    block_expert = ((block_start + blocks_e)[None, :] <= blk[:, None]).sum(1) \
        .clamp(0, E - 1).to(torch.int32)
    n_used = blocks_e.sum().clamp(min=1).to(torch.int32)
    return (gather_idx, row_valid, block_expert, n_used,
            dest_row.to(torch.int32))


def align_tokens_by_expert(ids, num_experts: int, block_m: int,
                           with_used_count: bool = False):
    """Sort row indices by expert and pad each expert's run to a multiple of
    ``block_m``.

    ``ids`` [T] int: the expert of each row, -1 (or any id outside
    ``[0, E)``) for a row that goes nowhere; a numpy array is taken as a CPU
    tensor. Returns ``(gather_idx [P] int32, row_valid [P] bool,
    block_expert [P // block_m] int32)`` with ``P = round_up(T, block_m) +
    E * block_m``: aligned row j holds row ``gather_idx[j]`` when
    ``row_valid[j]``, and belongs to expert ``block_expert[j // block_m]``.
    Blocks past the used range carry no valid row (and expert E - 1).
    ``with_used_count=True`` appends ``used_block_count``'s 0-d int32 bound.
    """
    layout = expert_alignment(ids, num_experts, block_m)
    return layout[:4] if with_used_count else layout[:3]


def used_block_count(ids, num_experts: int, block_m: int):
    """The number of ``block_m`` row blocks that hold valid rows under
    ``align_tokens_by_expert``'s layout, ``sum_e ceil(count_e / block_m)``,
    at least 1: a 0-d int32 tensor on ``ids``' device."""
    if isinstance(ids, np.ndarray):
        ids = torch.from_numpy(np.ascontiguousarray(ids))
    _, _, onehot = _expert_counts(ids, num_experts)
    counts = onehot[:, :num_experts].sum(0)
    return ((counts + block_m - 1) // block_m).sum().clamp(min=1) \
        .to(torch.int32)


# ---------------------------------------------------------------------------
# the grouped GEMMs: plain versions and kernel wrappers
# ---------------------------------------------------------------------------

def _bound(n_blocks_used, n_blocks: int) -> int:
    if n_blocks_used is None:
        return n_blocks
    return min(int(n_blocks_used), n_blocks)


@dataclasses.dataclass(frozen=True)
class PackedGatedWeights:
    """The packed gate‖up weights ``w`` [E, H, 2F] from
    ``pack_gated_weights`` with the ``block_n`` they were packed with. The
    interleave does not show in the shape, so the pack width travels with
    the array and every consumer checks it against its own."""

    w: torch.Tensor
    block_n: int

    @property
    def shape(self):
        return self.w.shape

    @property
    def dtype(self):
        return self.w.dtype


def pack_gated_weights(w_gate, w_up, block_n: int = 128) -> PackedGatedWeights:
    """Interleave the gate and up weights [E, H, F] into one [E, H, 2F]
    array whose column groups alternate ``block_n`` gate columns and
    ``block_n`` up columns: [g_0 ‖ u_0 ‖ g_1 ‖ u_1 ...], the reference's
    layout, bit for bit. ``block_n`` must divide F (no silent re-tiling).
    Pack once when the weights are loaded."""
    E, H, F = w_gate.shape
    if tuple(w_up.shape) != (E, H, F):
        raise ValueError(f"pack_gated_weights: w_up {tuple(w_up.shape)} "
                         f"against w_gate {tuple(w_gate.shape)}")
    if block_n < 1 or F % block_n:
        raise ValueError(f"pack_gated_weights: block_n={block_n} must divide "
                         f"F={F} exactly (and equal the consumer's block_n)")
    g = w_gate.reshape(E, H, F // block_n, 1, block_n)
    u = w_up.reshape(E, H, F // block_n, 1, block_n)
    return PackedGatedWeights(torch.cat([g, u], 3).reshape(E, H, 2 * F),
                              block_n)


def unpack_gated_weights(w, block_n: int):
    """The (gate, up) weights [E, H, F] of a packed array [E, H, 2F]
    (copies): the inverse of ``pack_gated_weights``."""
    E, H, F2 = w.shape
    v = w.reshape(E, H, F2 // (2 * block_n), 2, block_n)
    return (v[:, :, :, 0].reshape(E, H, F2 // 2),
            v[:, :, :, 1].reshape(E, H, F2 // 2))


def _packed(w_gate, w_up, block_n: int, n_blocks_used):
    """The packed array and its pack width, after the reference's checks:
    ``w_up`` None, the bounded path, the wrapper's width equal to
    ``block_n`` (a bare [E, H, 2F] array is taken as packed at
    ``block_n``), ``block_n`` dividing F."""
    if w_up is not None:
        raise ValueError("packed: the packed array carries gate and up; "
                         "w_up must be None")
    if n_blocks_used is None:
        raise ValueError("packed: the packed gated GEMM runs on the bounded "
                         "path only (pass n_blocks_used)")
    if isinstance(w_gate, PackedGatedWeights):
        if w_gate.block_n != block_n:
            raise ValueError(
                f"PackedGatedWeights packed with block_n={w_gate.block_n} "
                f"but the kernel was asked for block_n={block_n}: the "
                f"interleave would mix gate and up columns")
        w_gate = w_gate.w
    F2 = w_gate.shape[-1]
    if F2 % 2 or (F2 // 2) % block_n:
        raise ValueError(f"packed: block_n={block_n} must divide F={F2 // 2}")
    return w_gate


def _k_split(block_k, H: int):
    """``block_k`` as the kernel takes it: 0 for all of H (None, or at
    least H), else a divisor of H, as the reference asserts."""
    if block_k is None or block_k >= H:
        return 0
    if block_k < 1 or H % block_k:
        raise ValueError(f"block_k={block_k} must divide H={H}")
    return int(block_k)


def _ring_depth(prefetch_depth) -> int:
    """The ring's stages for ``prefetch_depth``: 4 (the deepest) by
    default, 2 for 1 (the shallowest ring the tile allows: one stage
    loads while one is read), 4 for more than 4."""
    if prefetch_depth is None:
        return RING_DEPTHS[-1]
    if int(prefetch_depth) < 1:
        raise ValueError(f"prefetch_depth={prefetch_depth} must be >= 1")
    return min(max(int(prefetch_depth), RING_DEPTHS[0]), RING_DEPTHS[-1])


def _scaled(prod, row_scale, rows):
    """The f32 products of a row block times their rows' scales."""
    if row_scale is None:
        return prod
    return prod * row_scale[rows].float()[:, None]


def grouped_gemm_plain(tokens, weights, block_expert, block_m: int = 128,
                       n_blocks_used=None, out_dtype=None, row_scale=None,
                       block_k: int | None = None):
    """The plain PyTorch version of ``grouped_gemm``: one f32 product per
    used row block, times the rows' ``row_scale`` when given, cast to
    ``out_dtype`` (the tokens' type by default, the weights' when scaled);
    rows past the bound are zero. ``block_k`` is checked and changes
    nothing (the kernel's sums do not depend on it)."""
    P = tokens.shape[0]
    E, H, N = weights.shape
    _k_split(block_k, H)
    out = torch.zeros(P, N, dtype=out_dtype or (
        tokens.dtype if row_scale is None else weights.dtype),
        device=tokens.device)
    nb = _bound(n_blocks_used, P // block_m)
    for i, e in enumerate(block_expert[:nb].clamp(0, E - 1).tolist()):
        rows = slice(i * block_m, (i + 1) * block_m)
        prod = tokens[rows].float() @ weights[e].float()
        out[rows] = _scaled(prod, row_scale, rows).to(out.dtype)
    return out


def grouped_gemm_gated_plain(tokens, w_gate, w_up, block_expert,
                             block_m: int = 128, n_blocks_used=None,
                             row_scale=None, block_k: int | None = None,
                             packed: bool = False, block_n: int = 128,
                             out_dtype=None):
    """The plain PyTorch version of ``grouped_gemm_gated``: per used row
    block, the two f32 products (each times the rows' ``row_scale`` when
    given), ``silu(g) * u``, cast once (to ``out_dtype``: the tokens' type
    by default, the weights' when scaled). ``packed`` reads gate and up out
    of the packed array; ``block_k`` is checked and changes nothing."""
    if packed:
        w_gate, w_up = unpack_gated_weights(
            _packed(w_gate, w_up, block_n, n_blocks_used), block_n)
    P = tokens.shape[0]
    E, H, N = w_gate.shape
    _k_split(block_k, H)
    out = torch.zeros(P, N, dtype=out_dtype or (
        tokens.dtype if row_scale is None else w_gate.dtype),
        device=tokens.device)
    nb = _bound(n_blocks_used, P // block_m)
    for i, e in enumerate(block_expert[:nb].clamp(0, E - 1).tolist()):
        rows = slice(i * block_m, (i + 1) * block_m)
        t = tokens[rows].float()
        g = _scaled(t @ w_gate[e].float(), row_scale, rows)
        u = _scaled(t @ w_up[e].float(), row_scale, rows)
        out[rows] = (F.silu(g) * u).to(out.dtype)
    return out


def _lib():
    """The grouped GEMMs' library, built on first use: its one entry,
    ``tdt_grouped_gemm_ex``, launches every form."""
    return csrc.load("group_gemm", {"tdt_grouped_gemm_ex": _EX})


def _form(tokens, row_scale, packed: bool, block_k: int, depth: int) -> str:
    """The name of a launch's form, the key of ``launches_by_form``: the
    rows' type, then each option taken."""
    parts = [str(tokens.dtype).split(".")[-1]]
    if row_scale is not None:
        parts.append("row_scale")
    if packed:
        parts.append("packed")
    if block_k:
        parts.append(f"block_k={block_k}")
    if depth != RING_DEPTHS[-1]:
        parts.append(f"depth={depth}")
    return " ".join(parts)


def _launch(name: str, tokens, weights: tuple, block_expert, block_m: int,
            n_blocks_used, masked: bool, out_dtype, row_scale=None,
            pack_bn: int = 0, block_k: int = 0, depth: int = 4):
    """Check what the kernel needs to stay in bounds (types, one device,
    shapes, contiguity, alignment), allocate the output and launch one
    grouped kernel on the current stream; raises on what it does not
    take."""
    P, K = tokens.shape
    E, K2, Nw = weights[0].shape
    gated = len(weights) == 2 or pack_bn > 0
    N = Nw // 2 if pack_bn else Nw
    dev = tokens.device
    dt, wdt = tokens.dtype, weights[0].dtype
    if n_blocks_used is not None and not torch.is_tensor(n_blocks_used):
        n_blocks_used = torch.tensor([int(n_blocks_used)], dtype=torch.int32,
                                     device=dev)
    bounded = n_blocks_used is not None
    scaled = row_scale is not None
    tensors = (tokens, *weights, block_expert) + (
        (row_scale,) if scaled else ()) + ((n_blocks_used,) if bounded
                                           else ())
    one_byte = dt in (torch.float8_e4m3fn, torch.int8)
    if wdt == torch.bfloat16:
        ok_types = (dt == wdt or one_byte) and (
            out_dtype == torch.bfloat16
            or (out_dtype == torch.float32 and dt == wdt and not gated))
    else:
        ok_types = wdt == dt == out_dtype == torch.float32
    ok_types = (ok_types and all(w.dtype == wdt for w in weights)
                and block_expert.dtype == torch.int32
                and (not scaled or row_scale.dtype == torch.float32)
                and (not bounded or (n_blocks_used.dtype == torch.int32
                                     and n_blocks_used.numel() == 1)))
    if not ok_types:
        raise TypeError(
            f"{name}: the kernel takes bf16, fp8 e4m3fn or int8 rows with "
            f"bf16 weights into bf16 (bf16 rows of the plain GEMM also into "
            f"f32), or f32 rows and weights into f32; block_expert and "
            f"n_blocks_used int32 (one bound), row_scale f32; got "
            f"{[t.dtype for t in tensors]} -> {out_dtype}")
    bk = block_k or K
    if (K2 != K or any(w.shape != weights[0].shape for w in weights)
            or block_m % MIN_BLOCK_M or P % block_m or P == 0
            or block_expert.shape != (P // block_m,)
            or K % TILE_K or N % TILE_N or bk % TILE_K or K % bk
            or (pack_bn and (pack_bn % 8 or N % pack_bn))
            or (scaled and row_scale.shape != (P,))):
        raise ValueError(
            f"{name}: unsupported shapes tokens {tuple(tokens.shape)}, "
            f"weights {tuple(weights[0].shape)}, block_expert "
            f"{tuple(block_expert.shape)}, block_m {block_m}, block_k "
            f"{block_k}, pack width {pack_bn} (the kernel takes block_m % "
            f"{MIN_BLOCK_M} == 0, K % {TILE_K} == 0, N % {TILE_N} == 0, "
            f"block_k a multiple of {TILE_K} dividing K, a pack width a "
            f"multiple of 8 dividing N, row_scale [P])")
    if any(t.device != dev or not t.is_contiguous() for t in tensors) or any(
            t.data_ptr() % 16 for t in tensors[:1 + len(weights)]):
        raise ValueError(f"{name}: inputs must be on one device, contiguous "
                         f"and (tokens, weights) 16-byte aligned")
    out = (torch.zeros if masked and bounded else torch.empty)(
        P, N, dtype=out_dtype, device=dev)
    lib = _lib()
    wu = weights[1] if len(weights) == 2 else None
    with csrc.current_on(dev):
        rc = lib.tdt_grouped_gemm_ex(tokens.data_ptr(), weights[0].data_ptr(),
                wu.data_ptr() if wu is not None else None,
                block_expert.data_ptr(),
                n_blocks_used.data_ptr() if bounded else None,
                row_scale.data_ptr() if scaled else None, out.data_ptr(),
                P, K, N, block_m, E, pack_bn, block_k, depth, int(gated),
                X_KINDS[dt], int(out_dtype == torch.float32),
                torch.cuda.current_stream(dev).cuda_stream)
    csrc.check(lib, rc, name)
    return out


def grouped_gemm(tokens, weights, block_expert, block_m: int = 128,
                 n_blocks_used=None, row_scale=None, masked: bool = True,
                 block_k: int | None = None, out_dtype=None):
    """``out[rows i] = s * (tokens[rows i] @ weights[block_expert[i]])`` for
    each row block i (rows ``i * block_m`` to ``(i + 1) * block_m``), s the
    rows' ``row_scale`` (1 without it).

    tokens [P, H] (expert-aligned rows), weights [E, H, N], block_expert
    [P // block_m] int32; ``n_blocks_used`` (0-d or [1] int32 tensor, or an
    int) bounds the row blocks at run time. ``row_scale`` [P] f32 folds a
    quantised wire's dequantise into the f32 sums (the tokens may then be
    fp8 e4m3fn or int8 rows). Out [P, N] in ``out_dtype``: the tokens' type
    by default, the weights' with ``row_scale``, or f32 from bf16 tokens
    (the sums are not rounded to bf16; ``ops.moe.moe_reduce_rs``'s f32
    slot). ``block_k`` (dividing H) is the K extent of one pass of the
    kernel's pipeline; the result does not depend on it.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (bf16, fp8 or int8 rows with bf16 weights, or f32; ``block_m % 16 ==
    0``, ``H % 32 == 0``, ``N % 128 == 0``, ``block_k % 32 == 0``) or
    raises; each launch adds one to ``grouped_gemm.launches`` and to its
    form's count in ``grouped_gemm.launches_by_form``, and a bf16-to-f32
    launch also to ``grouped_gemm.f32_out_launches``."""
    out_dtype = out_dtype or (tokens.dtype if row_scale is None
                              else weights.dtype)
    bk = _k_split(block_k, tokens.shape[1])
    if tokens.device.type == "cpu":
        return grouped_gemm_plain(tokens, weights, block_expert, block_m,
                                  n_blocks_used, out_dtype, row_scale,
                                  block_k)
    out = _launch("grouped_gemm", tokens, (weights,), block_expert, block_m,
                  n_blocks_used, masked, out_dtype, row_scale,
                  block_k=bk)
    grouped_gemm.launches += 1
    form = _form(tokens, row_scale, False, bk, RING_DEPTHS[-1])
    grouped_gemm.launches_by_form[form] = \
        grouped_gemm.launches_by_form.get(form, 0) + 1
    if out.dtype == torch.float32 and tokens.dtype == torch.bfloat16:
        grouped_gemm.f32_out_launches += 1
    return out


grouped_gemm.launches = 0
grouped_gemm.launches_by_form = {}
grouped_gemm.f32_out_launches = 0


def grouped_gemm_gated(tokens, w_gate, w_up, block_expert,
                       block_m: int = 128, n_blocks_used=None,
                       row_scale=None, masked: bool = True,
                       block_k: int | None = None, packed: bool = False,
                       prefetch_depth: int | None = None,
                       block_n: int = 128, out_dtype=None):
    """Fused gated grouped GEMM: ``silu(s * (x @ w_gate[e])) * (s * (x @
    w_up[e]))`` per expert-aligned row block, both products summed in f32,
    scaled by the rows' ``row_scale`` (s = 1 without it), the SiLU and the
    product taken in f32 and cast once. w_gate / w_up [E, H, F]; the other
    arguments as in ``grouped_gemm``.

    ``packed=True``: ``w_gate`` is ``pack_gated_weights(..., block_n)``'s
    ``PackedGatedWeights`` (its width checked against ``block_n``) or a
    bare [E, H, 2F] array packed at ``block_n``, ``w_up`` None, and
    ``n_blocks_used`` given (the bounded path, as the reference has it):
    one weight stream instead of two, the same bits. ``prefetch_depth`` is
    the depth of the kernel's ring of copies: 2 to 4 stages, 1 the
    shallowest ring the tile allows (2), more than 4 the deepest (4), None
    4; the result does not depend on it.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    or raises; each launch adds one to ``grouped_gemm_gated.launches`` and
    to its form's count in ``grouped_gemm_gated.launches_by_form``."""
    pack_bn = 0
    if packed:
        w_gate = _packed(w_gate, w_up, block_n, n_blocks_used)
        pack_bn = block_n
    elif w_up is None:
        raise ValueError("grouped_gemm_gated: w_up is None without packed")
    out_dtype = out_dtype or (tokens.dtype if row_scale is None
                              else w_gate.dtype)
    bk = _k_split(block_k, tokens.shape[1])
    depth = _ring_depth(prefetch_depth)
    if tokens.device.type == "cpu":
        return grouped_gemm_gated_plain(
            tokens, w_gate, w_up, block_expert, block_m, n_blocks_used,
            row_scale, block_k, packed, block_n, out_dtype)
    out = _launch("grouped_gemm_gated", tokens,
                  (w_gate,) if packed else (w_gate, w_up), block_expert,
                  block_m, n_blocks_used, masked, out_dtype, row_scale,
                  pack_bn, bk, depth)
    grouped_gemm_gated.launches += 1
    form = _form(tokens, row_scale, packed, bk, depth)
    grouped_gemm_gated.launches_by_form[form] = \
        grouped_gemm_gated.launches_by_form.get(form, 0) + 1
    return out


grouped_gemm_gated.launches = 0
grouped_gemm_gated.launches_by_form = {}


# ---------------------------------------------------------------------------
# the MoE row plumbing around the grouped GEMMs
# ---------------------------------------------------------------------------

def _gather_rows(tokens, idx, valid):
    """``tokens[idx]`` where ``valid``, zero rows elsewhere; rows of one
    byte move as their raw bytes (a zero byte is 0 in fp8 and int8)."""
    src = tokens.view(torch.uint8) if tokens.element_size() == 1 else tokens
    rows = torch.where(valid[:, None], src[idx],
                       torch.zeros((), dtype=src.dtype, device=src.device))
    return rows.view(tokens.dtype) if src is not tokens else rows


def apply_grouped(tokens, ids, num_experts: int, fn, block_m: int = 128,
                  row_scale=None, gather_dtype=None):
    """Align rows by expert, call ``fn(x_aligned, block_expert,
    n_blocks_used) -> y_aligned`` (grouped GEMMs sharing the alignment,
    bounded by the used-block count) and bring the results back to the
    rows' order; rows with an invalid id come back as zeros. tokens [T, H],
    ids [T]; returns [T, N]. Nothing syncs with the host.

    ``row_scale`` [T] f32 (a quantised wire's rows): gathered through the
    same alignment (1 for an empty aligned row) and passed as ``fn(x,
    block_expert, n_blocks_used, scale_aligned)``, for the grouped GEMMs'
    ``row_scale``; the tokens then stay in the wire's type.
    ``gather_dtype`` casts the gathered rows in the gather (the reference
    casts fp8 rows to the compute type there; the port's kernels take fp8
    and int8 rows as they are)."""
    gather_idx, row_valid, block_expert, nb, dest = expert_alignment(
        ids, num_experts, block_m)
    P = gather_idx.shape[0]
    g = gather_idx.long()
    x = _gather_rows(tokens, g, row_valid)
    if gather_dtype is not None:
        x = x.to(gather_dtype)
    if row_scale is not None:
        s = torch.where(row_valid, row_scale.float()[g],
                        torch.ones((), device=row_scale.device))
        y = fn(x, block_expert, nb, s)
    else:
        y = fn(x, block_expert, nb)
    # the inverse permutation: out[t] = y[dest[t]], zeros for dest = P
    dest = dest.long()
    return torch.where((dest < P)[:, None], y[dest.clamp(max=P - 1)],
                       torch.zeros((), dtype=y.dtype, device=y.device))


def moe_ffn_local(tokens, ids, w_up, w_down, block_m: int = 128,
                  activation=F.silu):
    """MoE FFN over local rows: grouped up-projection, the activation in f32
    cast back to the tokens' type, grouped down-projection, rows restored to
    their order; rows with id -1 give zeros."""
    E = w_up.shape[0]

    def ffn(x, block_expert, nb):
        h = grouped_gemm(x, w_up, block_expert, block_m=block_m,
                         n_blocks_used=nb)
        h = activation(h.float()).to(tokens.dtype)
        return grouped_gemm(h, w_down, block_expert, block_m=block_m,
                            n_blocks_used=nb)

    return apply_grouped(tokens, ids, E, ffn, block_m=block_m)


__all__ = ["PackedGatedWeights", "align_tokens_by_expert", "apply_grouped",
           "expert_alignment",
           "grouped_gemm", "grouped_gemm_gated", "grouped_gemm_gated_plain",
           "grouped_gemm_plain", "moe_ffn_local", "pack_gated_weights",
           "unpack_gated_weights", "used_block_count"]
