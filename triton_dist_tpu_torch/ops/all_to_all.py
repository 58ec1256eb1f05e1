"""The EP all-to-all of the MoE serving path, in its one-rank form.

Counterpart of ``triton_dist_tpu/ops/all_to_all.py`` as ``moe_mlp_ep_overlap``
runs it on one rank. There ``dispatch`` gathers each (token, k) pair's row
into its slot of the send buffer, ``all_to_all_push`` (TPU kernel B21) copies
the slots to the receive buffer (at one rank, slot ``me`` to itself), and the
expert side aligns the slots by expert; ``combine`` pushes the processed
slots back and sums each token's k rows, weighted, in f32. At one rank the
dispatch capacity is drop-proof, so every pair's slot is its own index and
the pushes move nothing. What is left is one row movement each way:

- ``ep_dispatch``: the pairs' rows, straight into the expert-aligned rows
  the grouped GEMMs read;
- ``ep_combine``: the aligned output rows, gathered back per token and
  summed over k in k order in f32 (``combine``'s ``gather_back``), cast once.

On a CUDA tensor each launches its hand-written Hopper kernel
(``csrc/all_to_all.cu``); on a CPU tensor it runs its plain PyTorch version
(``ep_dispatch_plain`` / ``ep_combine_plain``). The wire across ranks, its
fp8/int8 quantisation and the segmented push (B22) wait for ROADMAP.md
Queue A, item 7 "MoE / EP across ranks".
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import csrc

_P = ctypes.c_void_p
_I = ctypes.c_int
# tokens, src, valid, out, P, T, row_bytes, topk, stream
_DISPATCH = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
# y, pos, w, out, P, T, D, topk, stream
_COMBINE = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
_SIGNATURES = {"tdt_ep_dispatch": _DISPATCH,
               "tdt_ep_combine_bf16": _COMBINE,
               "tdt_ep_combine_f32": _COMBINE}
_COMBINE_ENTRIES = {torch.bfloat16: "tdt_ep_combine_bf16",
                    torch.float32: "tdt_ep_combine_f32"}


def _lib():
    return csrc.load("all_to_all", _SIGNATURES)


def _check(name: str, tensors, dtypes) -> None:
    """Raise unless the tensors share one CUDA device, have the given types
    (None: any) and are contiguous, the first (read or written as 16-byte
    vectors) 16-byte aligned."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one device")
        if dt is not None and t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if tensors[0].data_ptr() % 16:
        raise ValueError(f"{name}: {tuple(tensors[0].shape)} rows must be "
                         f"16-byte aligned")


def ep_dispatch_plain(tokens, src_row, row_valid, topk: int):
    """The plain PyTorch version of ``ep_dispatch``."""
    T = tokens.shape[0]
    s = src_row.long()
    ok = row_valid & (s >= 0) & (s < T * topk)
    rows = tokens[(s.clamp(0, T * topk - 1) // topk)]
    return torch.where(ok[:, None], rows,
                       torch.zeros((), dtype=tokens.dtype, device=tokens.device))


def ep_dispatch(tokens, src_row, row_valid, topk: int):
    """Expert-aligned rows of the (token, k) pairs: ``out[r] =
    tokens[src_row[r] // topk]`` where ``row_valid[r]``, zeros elsewhere.

    tokens [T, H]; src_row [P] int32, the pair (``t * topk + j``) of aligned
    row r (``align_tokens_by_expert``'s ``gather_idx`` over the T * topk
    pairs); row_valid [P] bool. An index outside ``[0, T * topk)`` counts as
    a row routed nowhere. Out [P, H] in the tokens' type.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (any type whose rows are a multiple of 16 bytes) or raises; each launch
    adds one to ``ep_dispatch.launches``."""
    if tokens.device.type == "cpu":
        return ep_dispatch_plain(tokens, src_row, row_valid, topk)
    T, H = tokens.shape
    P = src_row.shape[0]
    row_bytes = H * tokens.element_size()
    _check("ep_dispatch", (tokens, src_row, row_valid),
           (None, torch.int32, torch.bool))
    if row_valid.shape != (P,) or row_bytes % 16 or T < 1 or P < 1:
        raise ValueError(f"ep_dispatch: unsupported shapes tokens "
                         f"{tuple(tokens.shape)}, src_row {tuple(src_row.shape)}"
                         f", row_valid {tuple(row_valid.shape)} (rows must be "
                         f"a multiple of 16 bytes)")
    out = torch.empty(P, H, dtype=tokens.dtype, device=tokens.device)
    lib = _lib()
    with csrc.current_on(tokens.device):
        rc = lib.tdt_ep_dispatch(
            tokens.data_ptr(), src_row.data_ptr(), row_valid.data_ptr(),
            out.data_ptr(), P, T, row_bytes, topk,
            torch.cuda.current_stream(tokens.device).cuda_stream)
    csrc.check(lib, rc, "ep_dispatch")
    ep_dispatch.launches += 1
    return out


ep_dispatch.launches = 0


def ep_combine_plain(y, pos, weights):
    """The plain PyTorch version of ``ep_combine``."""
    T, k = weights.shape
    P = y.shape[0]
    p = pos.long().view(T, k)
    ok = (p >= 0) & (p < P)
    rows = torch.where(ok[..., None], y[p.clamp(0, P - 1)].float(),
                       torch.zeros((), device=y.device))
    acc = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    for j in range(k):
        acc = acc + rows[:, j] * weights[:, j:j + 1]
    return acc.to(y.dtype)


def ep_combine(y, pos, weights):
    """Each token's k processed rows, weighted and summed: ``out[t] =
    sum_j weights[t, j] * y[pos[t * k + j]]``, the products and the sum over
    j (in order, from 0) in f32, cast once to y's type.

    y [P, D] (expert-aligned output rows); pos [T * k] int32, the aligned
    row of each (token, k) pair (outside ``[0, P)``: the pair adds 0);
    weights [T, k] f32. Rows of y that no pair names are never read. Out
    [T, D].

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (bf16 or f32, rows a multiple of 16 bytes) or raises; each launch adds
    one to ``ep_combine.launches``."""
    if y.device.type == "cpu":
        return ep_combine_plain(y, pos, weights)
    P, D = y.shape
    T, k = weights.shape
    if y.dtype not in _COMBINE_ENTRIES:
        raise TypeError(f"ep_combine: y must be bf16 or f32, got {y.dtype}")
    _check("ep_combine", (y, pos, weights),
           (None, torch.int32, torch.float32))
    if pos.numel() != T * k or (D * y.element_size()) % 16 or T < 1 or P < 1:
        raise ValueError(f"ep_combine: unsupported shapes y {tuple(y.shape)}, "
                         f"pos {tuple(pos.shape)}, weights "
                         f"{tuple(weights.shape)}")
    out = torch.empty(T, D, dtype=y.dtype, device=y.device)
    lib = _lib()
    with csrc.current_on(y.device):
        rc = getattr(lib, _COMBINE_ENTRIES[y.dtype])(
            y.data_ptr(), pos.data_ptr(), weights.data_ptr(), out.data_ptr(),
            P, T, D, k, torch.cuda.current_stream(y.device).cuda_stream)
    csrc.check(lib, rc, "ep_combine")
    ep_combine.launches += 1
    return out


ep_combine.launches = 0

__all__ = ["ep_combine", "ep_combine_plain", "ep_dispatch",
           "ep_dispatch_plain"]
