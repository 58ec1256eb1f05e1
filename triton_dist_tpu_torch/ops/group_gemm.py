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
fixed order. The column tile is the kernel's own (128), so the TPU's
``block_n`` has no counterpart. Left for later slices (ROADMAP Queue B,
B17/B18): ``row_scale`` (it arrives with B21's fp8/int8 wire), the packed
gate‖up layout (``pack_gated_weights``, a TPU DMA-stream layout), and
``block_k`` / ``prefetch_depth`` (Mosaic VMEM workarounds); each raises
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from triton_dist_tpu_torch import csrc

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, w (or wg, wu), be, nb, out, P, K, N, block_m, E, stream
_GEMM = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_GATED = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
# (gated, input type, output type) -> C entry
_ENTRIES = {
    (False, torch.bfloat16, torch.bfloat16): "tdt_grouped_gemm_bf16",
    (False, torch.bfloat16, torch.float32): "tdt_grouped_gemm_bf16_f32",
    (False, torch.float32, torch.float32): "tdt_grouped_gemm_f32",
    (True, torch.bfloat16, torch.bfloat16): "tdt_grouped_gemm_gated_bf16",
    (True, torch.float32, torch.float32): "tdt_grouped_gemm_gated_f32",
}
TILE_N = 128     # output columns per kernel block
TILE_K = 32      # contraction depth per kernel stage
MIN_BLOCK_M = 16


def _later(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue B, B17/B18 options; "
        "Queue A, item 7 \"MoE / EP across ranks\")")


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


def grouped_gemm_plain(tokens, weights, block_expert, block_m: int = 128,
                       n_blocks_used=None, out_dtype=None):
    """The plain PyTorch version of ``grouped_gemm``: one f32 product per
    used row block, cast to ``out_dtype`` (the tokens' type by default);
    rows past the bound are zero."""
    P = tokens.shape[0]
    E, _, N = weights.shape
    out = torch.zeros(P, N, dtype=out_dtype or tokens.dtype,
                      device=tokens.device)
    nb = _bound(n_blocks_used, P // block_m)
    for i, e in enumerate(block_expert[:nb].clamp(0, E - 1).tolist()):
        rows = slice(i * block_m, (i + 1) * block_m)
        out[rows] = (tokens[rows].float() @ weights[e].float()).to(out.dtype)
    return out


def grouped_gemm_gated_plain(tokens, w_gate, w_up, block_expert,
                             block_m: int = 128, n_blocks_used=None):
    """The plain PyTorch version of ``grouped_gemm_gated``: per used row
    block, ``silu(g) * u`` on the two f32 products, cast once."""
    P = tokens.shape[0]
    E, _, N = w_gate.shape
    out = torch.zeros(P, N, dtype=tokens.dtype, device=tokens.device)
    nb = _bound(n_blocks_used, P // block_m)
    for i, e in enumerate(block_expert[:nb].clamp(0, E - 1).tolist()):
        rows = slice(i * block_m, (i + 1) * block_m)
        t = tokens[rows].float()
        g = t @ w_gate[e].float()
        u = t @ w_up[e].float()
        out[rows] = (F.silu(g) * u).to(out.dtype)
    return out


_entries: dict = {}     # _ENTRIES' keys -> C entry, once the library loads


def _entry(key):
    if not _entries:
        lib = csrc.load("group_gemm", {fn: (_GATED if g else _GEMM)
                                       for (g, _, _), fn in _ENTRIES.items()})
        _entries.update({k: getattr(lib, fn)
                         for k, fn in _ENTRIES.items()}, lib=lib)
    return _entries[key]


def _launch(name: str, tokens, weights: tuple, block_expert, block_m: int,
            n_blocks_used, masked: bool, out_dtype=None):
    """Check what the kernel needs to stay in bounds (types, one device,
    shapes, contiguity, alignment), allocate the output and launch one
    grouped kernel on the current stream; raises on what it does not
    take."""
    P, K = tokens.shape
    E, K2, N = weights[0].shape
    dev = tokens.device
    dt = tokens.dtype
    if n_blocks_used is not None and not torch.is_tensor(n_blocks_used):
        n_blocks_used = torch.tensor([int(n_blocks_used)], dtype=torch.int32,
                                     device=dev)
    bounded = n_blocks_used is not None
    gated = len(weights) == 2
    key = (gated, dt, out_dtype or dt)
    tensors = (tokens, *weights, block_expert) + (
        (n_blocks_used,) if bounded else ())
    if (key not in _ENTRIES
            or any(w.dtype != dt for w in weights)
            or block_expert.dtype != torch.int32
            or (bounded and (n_blocks_used.dtype != torch.int32
                             or n_blocks_used.numel() != 1))):
        raise TypeError(f"{name}: tokens and weights must share bf16 or f32 "
                        f"(output in their type, or f32 from bf16 for the "
                        f"plain grouped GEMM) and block_expert, "
                        f"n_blocks_used be int32 (one bound), got "
                        f"{[t.dtype for t in tensors]} -> {out_dtype}")
    if (K2 != K or any(w.shape != weights[0].shape for w in weights)
            or block_m % MIN_BLOCK_M or P % block_m or P == 0
            or block_expert.shape != (P // block_m,)
            or K % TILE_K or N % TILE_N):
        raise ValueError(
            f"{name}: unsupported shapes tokens {tuple(tokens.shape)}, "
            f"weights {tuple(weights[0].shape)}, block_expert "
            f"{tuple(block_expert.shape)}, block_m {block_m} (the kernel "
            f"takes block_m % {MIN_BLOCK_M} == 0, K % {TILE_K} == 0 and "
            f"N % {TILE_N} == 0)")
    if any(t.device != dev or not t.is_contiguous() for t in tensors) or any(
            t.data_ptr() % 16 for t in tensors[:-1 - bounded]):
        raise ValueError(f"{name}: inputs must be on one device, contiguous "
                         f"and (tokens, weights) 16-byte aligned")
    out = (torch.zeros if masked and bounded else torch.empty)(
        P, N, dtype=key[2], device=dev)
    fn = _entry(key)
    with csrc.current_on(dev):
        rc = fn(tokens.data_ptr(), *(w.data_ptr() for w in weights),
                block_expert.data_ptr(),
                n_blocks_used.data_ptr() if bounded else None, out.data_ptr(),
                P, K, N, block_m, E, torch.cuda.current_stream(dev).cuda_stream)
    csrc.check(_entries["lib"], rc, name)
    return out


def grouped_gemm(tokens, weights, block_expert, block_m: int = 128,
                 n_blocks_used=None, row_scale=None, masked: bool = True,
                 block_k: int | None = None, out_dtype=None):
    """``out[rows i] = tokens[rows i] @ weights[block_expert[i]]`` for each
    row block i (rows ``i * block_m`` to ``(i + 1) * block_m``).

    tokens [P, H] (expert-aligned rows), weights [E, H, N], block_expert
    [P // block_m] int32; ``n_blocks_used`` (0-d or [1] int32 tensor, or an
    int) bounds the row blocks at run time. Out [P, N] in ``out_dtype``:
    the tokens' type by default, or f32 from bf16 tokens (the sums are not
    rounded to bf16; ``ops.moe.moe_reduce_rs``'s f32 slot).

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (bf16 or f32, ``block_m % 16 == 0``, ``H % 32 == 0``, ``N % 128 == 0``)
    or raises; each launch adds one to ``grouped_gemm.launches``, and a
    bf16-to-f32 launch also to ``grouped_gemm.f32_out_launches``."""
    if row_scale is not None:
        _later("row_scale")
    if block_k is not None:
        _later("block_k")
    if tokens.device.type == "cpu":
        return grouped_gemm_plain(tokens, weights, block_expert, block_m,
                                  n_blocks_used, out_dtype)
    out = _launch("grouped_gemm", tokens, (weights,), block_expert, block_m,
                  n_blocks_used, masked, out_dtype)
    grouped_gemm.launches += 1
    if out.dtype != tokens.dtype:
        grouped_gemm.f32_out_launches += 1
    return out


grouped_gemm.launches = 0
grouped_gemm.f32_out_launches = 0


def grouped_gemm_gated(tokens, w_gate, w_up, block_expert,
                       block_m: int = 128, n_blocks_used=None,
                       row_scale=None, masked: bool = True,
                       block_k: int | None = None, packed: bool = False,
                       prefetch_depth: int | None = None):
    """Fused gated grouped GEMM: ``silu(x @ w_gate[e]) * (x @ w_up[e])`` per
    expert-aligned row block, both products summed in f32, the SiLU and the
    product taken in f32 and cast once. w_gate / w_up [E, H, F]; the other
    arguments as in ``grouped_gemm``.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    or raises; each launch adds one to ``grouped_gemm_gated.launches``."""
    if row_scale is not None:
        _later("row_scale")
    if packed or w_up is None:
        _later("the packed gate|up layout")
    if block_k is not None:
        _later("block_k")
    if prefetch_depth is not None:
        _later("prefetch_depth")
    if tokens.device.type == "cpu":
        return grouped_gemm_gated_plain(tokens, w_gate, w_up, block_expert,
                                        block_m, n_blocks_used)
    out = _launch("grouped_gemm_gated", tokens, (w_gate, w_up), block_expert,
                  block_m, n_blocks_used, masked)
    grouped_gemm_gated.launches += 1
    return out


grouped_gemm_gated.launches = 0


def pack_gated_weights(w_gate, w_up, block_n: int = 128):
    """The TPU's interleaved gate‖up weight stream; not ported."""
    _later("pack_gated_weights")


class PackedGatedWeights:
    """The TPU's packed gate‖up weights with their pack width; not
    ported."""

    def __init__(self, *args, **kwargs):
        _later("PackedGatedWeights")


# ---------------------------------------------------------------------------
# the MoE row plumbing around the grouped GEMMs
# ---------------------------------------------------------------------------

def apply_grouped(tokens, ids, num_experts: int, fn, block_m: int = 128,
                  row_scale=None):
    """Align rows by expert, call ``fn(x_aligned, block_expert,
    n_blocks_used) -> y_aligned`` (grouped GEMMs sharing the alignment,
    bounded by the used-block count) and bring the results back to the
    rows' order; rows with an invalid id come back as zeros. tokens [T, H],
    ids [T]; returns [T, N]. Nothing syncs with the host."""
    if row_scale is not None:
        _later("row_scale")
    gather_idx, row_valid, block_expert, nb, dest = expert_alignment(
        ids, num_experts, block_m)
    P = gather_idx.shape[0]
    x = torch.where(row_valid[:, None], tokens[gather_idx.long()],
                    torch.zeros((), dtype=tokens.dtype, device=tokens.device))
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
           "used_block_count"]
