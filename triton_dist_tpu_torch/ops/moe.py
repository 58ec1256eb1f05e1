"""The MoE tensor-parallel ops, in their one-rank form.

Counterpart of ``triton_dist_tpu/ops/moe.py``:

- ``ag_moe_group_gemm`` (TPU kernel B19, ``_ag_moe_kernel``): the token
  all-gather over the TP axis overlapped with the grouped up-projection of
  the expert-aligned segments as they arrive. At one rank there is one
  segment, the rank's own: the routing ids go through the port's one-rank
  push ``all_gather`` (B9's copy, as the JAX op gathers them), the tokens
  are aligned by expert on the sender side, the bounded grouped GEMM of
  ``csrc/group_gemm.cu`` (B17's kernel) runs the segment, and the rows go
  back to token order.
- ``moe_reduce_rs`` (B20, ``_moe_rs_kernel``): the grouped down-projection
  per output segment into f32 slots, the ring reduce-scatter of the slots
  and their reduction, then the unscramble and the top-k fold. At one rank:
  the grouped GEMM from bf16 into the f32 slot (its sums never rounded to
  bf16, as the TPU's ``emit_grouped_gemm`` writes the f32 workspace), the
  slot reduction of ``csrc/gemm.cu`` (``ops.gemm.slot_reduce``), the
  unscramble, and the top-k fold in f32, cast once.

Both unscramble by a gather through the inverse permutation
(``expert_alignment``'s ``dest_row``), where the TPU scatter-adds the
aligned rows into zeros: the two agree except that a -0.0 keeps its sign
here. A row with id -1 (padding) goes to no expert and comes back zero.

On a CPU tensor every kernel runs its plain version; on a CUDA tensor each
launches or raises, and each op adds one to its ``launches`` count when it
runs on the card. Tuple (2-tier) axes, and more ranks than one, raise
``NotImplementedError``; the port's mesh has no slice-crossing axis, so the
TPU's XLA route for those (``_ag_moe_xla``, ``_moe_rs_xla``) has no
counterpart yet either.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.allgather import all_gather, all_gather_plain
from triton_dist_tpu_torch.ops.gemm import slot_reduce, slot_reduce_plain
from triton_dist_tpu_torch.ops.group_gemm import (MIN_BLOCK_M,
                                                  expert_alignment,
                                                  grouped_gemm,
                                                  grouped_gemm_plain)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _one_rank_axis(ctx, axis, what: str) -> str:
    """The axis name (the context's first by default), or raise for a tuple
    axis or an axis above one rank."""
    axis = axis or ctx.axis_names[0]
    if not isinstance(axis, str):
        raise NotImplementedError(
            f"{what} over the tuple axis {tuple(axis)} (the 2-tier path) is "
            "not ported yet: ROADMAP.md Queue A, item 7 \"MoE / EP across "
            "ranks\"")
    n = ctx.axis_size(axis)
    if n != 1:
        raise NotImplementedError(
            f"{what} over {n} ranks is not ported yet: ROADMAP.md Queue A, "
            "item 7 \"MoE / EP across ranks\"")
    return axis


def _gather_ids(ctx, ids, axis: str, t_local: int, plain: bool = False):
    """All-gather the [t_local] routing ids over ``axis`` as int32; returns
    the [n, t_local] gathered ids. At one rank the gather is
    ``all_gather``'s one-rank push (a copy), or with ``plain`` its plain
    version."""
    wire = ids.to(torch.int32).contiguous()
    if wire.data_ptr() % 16:            # the copy kernel's alignment
        wire = wire.clone()
    g = all_gather_plain(wire) if plain else all_gather(ctx, wire, axis=axis,
                                                        method="push")
    return g.reshape(ctx.axis_size(axis), t_local)


def _segment_alignment(gids, num_experts: int, block_m: int):
    """Each segment's sender-side alignment from the gathered ids [n, t]:
    ``(gather_idx [n, P], row_valid [n, P], block_expert [n, P / block_m],
    n_blocks_used [n], dest_row [n, t])``, ``expert_alignment`` (the layout
    of ``align_tokens_by_expert`` with its used-block count and inverse)
    per segment."""
    parts = [expert_alignment(g, num_experts, block_m) for g in gids]
    return tuple(torch.stack(t) for t in zip(*parts))


def _unscramble(y, dest):
    """Aligned rows back to their rows' order: ``out[t] = y[dest[t]]``,
    zeros where ``dest[t]`` is past the aligned rows (an id of -1)."""
    P = y.shape[0]
    dest = dest.long()
    return torch.where((dest < P)[:, None], y[dest.clamp(max=P - 1)],
                       torch.zeros((), dtype=y.dtype, device=y.device))


def ag_moe_group_gemm(ctx, tokens, ids, weights, axis: str | None = None,
                      block_m: int = 128, block_n: int | None = None):
    """tokens [T, H] (this rank's rows); ids [T] int32, the expert of each
    row (-1 for padding); weights [E, H, N] (this rank's column shard).
    Returns every rank's rows through their experts' weights, [T * n, N] in
    the tokens' type, rows in token order, padding rows zero. ``block_m`` is
    the aligned row block (a row's result does not depend on it);
    ``block_n``, the TPU's weight-tile width, has no counterpart (the kernel
    tiles N by its own 128). At one rank; see the module docstring."""
    del block_n
    out = _ag_moe(ctx, tokens, ids, weights, axis, block_m, plain=False)
    if tokens.device.type == "cuda":
        ag_moe_group_gemm.launches += 1
    return out


ag_moe_group_gemm.launches = 0


def ag_moe_group_gemm_plain(ctx, tokens, ids, weights,
                            axis: str | None = None, block_m: int = 128):
    """The plain PyTorch version of ``ag_moe_group_gemm``: the same steps
    with every kernel's plain version, on any device."""
    return _ag_moe(ctx, tokens, ids, weights, axis, block_m, plain=True)


def _ag_moe(ctx, tokens, ids, weights, axis, block_m: int, plain: bool):
    axis = _one_rank_axis(ctx, axis, "ag_moe_group_gemm")
    T = tokens.shape[0]
    E = weights.shape[0]
    gids = _gather_ids(ctx, ids, axis, T, plain)
    gi, rv, be, nb, dest = _segment_alignment(gids, E, block_m)
    # sender-side alignment of this rank's segment
    x = torch.where(rv[0][:, None], tokens[gi[0].long()],
                    torch.zeros((), dtype=tokens.dtype, device=tokens.device))
    if plain:
        y = grouped_gemm_plain(x, weights, be[0], block_m, nb[0])
    else:
        y = grouped_gemm(x, weights, be[0], block_m=block_m,
                         n_blocks_used=nb[0], masked=False)
    return _unscramble(y, dest[0])


def moe_reduce_rs(ctx, tokens, ids, topk_weights, weights,
                  axis: str | None = None, block_m: int = 128):
    """tokens [T * topk, K] (the up-projection's activations, one row per
    (token, k) pair, this rank's K shard); ids [T * topk] int32, each row's
    expert (-1 for padding; replicated); topk_weights [T, topk]; weights
    [E, K, N] (this rank's K shard). Returns this rank's tokens [T / n, N]
    in the tokens' type: the grouped down-projection of each row, summed
    over the ranks' K shards, folded over k with the top-k weights in f32
    in k order and cast once. The aligned row block is ``block_m``, cut to
    the rows of one segment rounded up to the kernel's 16. At one rank; see
    the module docstring."""
    out = _moe_rs(ctx, tokens, ids, topk_weights, weights, axis, block_m,
                  plain=False)
    if tokens.device.type == "cuda":
        moe_reduce_rs.launches += 1
    return out


moe_reduce_rs.launches = 0


def moe_reduce_rs_plain(ctx, tokens, ids, topk_weights, weights,
                        axis: str | None = None, block_m: int = 128):
    """The plain PyTorch version of ``moe_reduce_rs``: the same steps with
    every kernel's plain version, on any device."""
    return _moe_rs(ctx, tokens, ids, topk_weights, weights, axis, block_m,
                   plain=True)


def _moe_rs(ctx, tokens, ids, topk_weights, weights, axis, block_m: int,
            plain: bool):
    axis = _one_rank_axis(ctx, axis, "moe_reduce_rs")
    Tk, _ = tokens.shape
    T, topk = topk_weights.shape
    if Tk != T * topk:
        raise ValueError(f"moe_reduce_rs: {Tk} rows for {T} tokens x top-"
                         f"{topk}")
    E = weights.shape[0]
    N = weights.shape[2]
    bm = min(block_m, _round_up(Tk, MIN_BLOCK_M))
    gi, rv, be, nb, dest = _segment_alignment(ids.reshape(1, Tk), E, bm)
    x = torch.where(rv[0][:, None], tokens[gi[0].long().clamp(0, Tk - 1)],
                    torch.zeros((), dtype=tokens.dtype, device=tokens.device))
    # the grouped GEMM into this rank's f32 slot, then the slots' reduction
    if plain:
        slots = grouped_gemm_plain(x, weights, be[0], bm, nb[0],
                                   out_dtype=torch.float32)
        y = slot_reduce_plain(slots[None], torch.float32)
    else:
        slots = grouped_gemm(x, weights, be[0], block_m=bm,
                             n_blocks_used=nb[0], masked=False,
                             out_dtype=torch.float32)
        y = slot_reduce(slots[None], torch.float32)
    rows = _unscramble(y, dest[0]).view(T, topk, N)
    w = topk_weights.float()
    folded = rows[:, 0] * w[:, 0:1]
    for j in range(1, topk):
        folded = folded + rows[:, j] * w[:, j:j + 1]
    return folded.to(tokens.dtype)


__all__ = ["ag_moe_group_gemm", "ag_moe_group_gemm_plain", "moe_reduce_rs",
           "moe_reduce_rs_plain"]
