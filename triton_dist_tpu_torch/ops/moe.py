"""The MoE tensor-parallel ops (TPU kernels B19 and B20).

Counterpart of ``triton_dist_tpu/ops/moe.py``:

- ``ag_moe_group_gemm`` (B19, ``_ag_moe_kernel``): the token all-gather
  over the TP axis overlapped with the grouped up-projection of the
  expert-aligned segments as they arrive.
- ``moe_reduce_rs`` (B20, ``_moe_rs_kernel``): the grouped down-projection
  of every segment over the rank's K shard into f32 slots, the
  reduce-scatter of the slots to their owners and their reduction, then the
  unscramble and the top-k fold in f32, cast once.

Inputs and outputs are the JAX package's global views. B19: tokens [T, H]
rank-major (rank r's rows at block r), ids [T], weights [E, H, N] with rank
r's columns at block r; it returns [T, N], rank r's columns at block r
(``P(None, axis)``). B20: tokens [T * topk, K] with rank r's K columns at
block r, ids replicated, topk_weights [T, topk], weights [E, K, N] with rank
r's K rows at block r; it returns [T, N], rank r's T / n rows at block r
(``P(axis)``).

Routing, as the reference does it: B19's ids are gathered with B9's push
(``ops.allgather``), and every rank's alignment of every segment comes from
the gathered ids (``expert_alignment``); B20's ids are replicated already.
The sender-side gather of the aligned rows and the unscramble through the
inverse permutation (``dest_row``) are torch ops, as they are XLA in the
reference; the unscramble gathers routed rows, so rows past a segment's
used blocks (never written) are never read. A row with id -1 (padding) goes
to no expert and comes back zero; a -0.0 keeps its sign here where the TPU
scatter-adds into zeros.

- At one rank, B19 is the bounded grouped GEMM of ``csrc/group_gemm.cu``
  (B17's kernel) on the one segment, and B20 the grouped GEMM from bf16
  into the f32 slot with the slot reduction of ``csrc/gemm.cu``.
- At n ranks over one axis, every rank runs on the one card and one
  cooperative launch of ``csrc/moe_tp.cu`` covers every rank of the mesh
  (``tdt_ag_moe``, ``tdt_moe_rs``; inside a multi-axis mesh the axis's
  groups side by side, each writing its own replica), its workspace a
  symmetric tensor and its signal pad its family's (``ag_moe``,
  ``moe_rs``). B19 at n ranks is bitwise B17 of each gathered segment
  against index r's columns; B20 is bitwise the slot reduction of the n
  one-rank f32 partials.
- Over a tuple of axes ``(outer, *inner)``: B19 runs the 2-tier relay of
  ``csrc/ag_relay_2d.cuh`` (``tdt_ag_moe_2d``) with B17's tile as its emit,
  over each segment's used rows, and is bitwise its 1-tier form over the
  flattened ranks; its ids are gathered with B11 (``push_2d``), as the
  reference's are. B20's stage 1 is its kernel over the inner group on the
  strided chunks ``{(r, j) : r < no}`` of ``P_seg`` aligned rows each, its
  K block the rank's index over all the axes, the chunk's other rows zero;
  stage 2 B13's ring over the outer group on the f32 chunks
  (``ops/reduce_scatter.py``). It is bitwise that composition, not the
  flat 1-tier kernel.

On a CPU tensor every kernel runs its plain version; on a CUDA tensor each
launches or raises, and each op adds one to its ``launches`` count when it
runs on the card, at every n (over a tuple of axes also one to its
``launches_2d``). The port's mesh has no slice-crossing axis,
so the reference's XLA route for one (``_ag_moe_xla``, ``_moe_rs_xla``) has
no counterpart (ROADMAP.md Queue A, item 7).
"""

from __future__ import annotations

import ctypes
import importlib

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.allgather import all_gather, all_gather_plain
from triton_dist_tpu_torch.ops.allgather_gemm import norm_axis
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.ops.gemm import slot_reduce, slot_reduce_plain
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import _tiers
from triton_dist_tpu_torch.ops.group_gemm import (MIN_BLOCK_M, TILE_K,
                                                  expert_alignment,
                                                  grouped_gemm,
                                                  grouped_gemm_plain)
from triton_dist_tpu_torch.shmem import device as shd

# the module, not the function ops/__init__.py exports under its name
_rs = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")

MOE_EP = 'ROADMAP.md Queue A, item 7 "MoE / EP across ranks"'

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x w be nb out ws pads group n P H nl block_m E kind lanes silent ...
    "tdt_ag_moe": [_P] * 8 + [_I] * 9 + shd.LAUNCH_SIG,
    # the same with the relay in place of the group
    "tdt_ag_moe_2d": [_P] * 8 + [_I] * 9 + shd.LAUNCH_SIG,
    # x w be nb out ws pads group kgroup no n P N kl block_m E kind lanes
    # silent ...
    "tdt_moe_rs": [_P] * 9 + [_I] * 10 + shd.LAUNCH_SIG}
# the kernels' type codes
_KINDS = {torch.bfloat16: 0, torch.float32: 1}
# lanes a launch asks for; it is cut to what the card keeps resident over
# the n ranks (a few hundred at most), so the pad is sized for these
MAX_LANES = 512
# columns of a rank's block go to the kernel 8 at a time (16 bytes of bf16)
COL_ALIGN = 8


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _moe_axis(ctx, axis) -> tuple:
    """(the axis: a name, or a tuple of axes outer first; its ranks): the
    context's first axis by default."""
    axis = norm_axis(ctx, axis)
    return axis, ctx.axis_size(axis)


def _gather_ids(ctx, ids, axis, t_local: int, plain: bool = False):
    """All-gather the routing ids over ``axis`` as int32: the [n, t_local]
    gathered ids (rank 0's replica; every rank's is the same). The gather
    is ``all_gather``'s push (B9) over one axis, B11 (``push_2d``) over a
    tuple, or with ``plain`` its plain version."""
    n = ctx.axis_size(axis)
    wire = ids.to(torch.int32).contiguous()
    if wire.data_ptr() % 16:            # the gather kernel's alignment
        wire = wire.clone()
    if plain:
        g = all_gather_plain(wire, 1 if n == 1 else ctx.num_ranks)
    else:
        g = all_gather(ctx, wire, axis=axis, method="push_2d"
                       if isinstance(axis, tuple) else "push")
    return (g if n == 1 else g[0]).reshape(n, t_local)


def _segment_alignment(gids, num_experts: int, block_m: int):
    """Each segment's sender-side alignment from the gathered ids [n, t]:
    ``(gather_idx [n, P], row_valid [n, P], block_expert [n, P / block_m],
    n_blocks_used [n], dest_row [n, t])``, ``expert_alignment`` (the layout
    of ``align_tokens_by_expert`` with its used-block count and inverse)
    per segment."""
    parts = [expert_alignment(g, num_experts, block_m) for g in gids]
    return tuple(torch.stack(t) for t in zip(*parts))


def _aligned_rows(tokens, gi, rv, seg_rows: int):
    """Every segment's aligned rows [n, P, ...]: segment s's row j is
    ``tokens[s * seg_rows + gi[s, j]]`` where ``rv[s, j]``, else zeros."""
    n = gi.shape[0]
    base = torch.arange(n, device=tokens.device)[:, None] * seg_rows
    rows = (base + gi.long()).clamp(0, tokens.shape[0] - 1)
    return torch.where(rv[..., None], tokens[rows],
                       torch.zeros((), dtype=tokens.dtype,
                                   device=tokens.device))


def _unscramble(y, dest):
    """Aligned rows back to their rows' order: y [n, P, N], dest [n, t] ->
    [n * t, N] with ``out[s * t + i] = y[s, dest[s, i]]``, zeros where
    ``dest`` is past the aligned rows (an id of -1)."""
    n, P, N = y.shape
    dest = dest.long()
    flat = (torch.arange(n, device=y.device)[:, None] * P
            + dest.clamp(max=P - 1)).reshape(-1)
    return torch.where((dest < P).reshape(-1, 1), y.reshape(n * P, N)[flat],
                       torch.zeros((), dtype=y.dtype, device=y.device))


def _kernel_call(ctx, entry: str, family: str, axis, x, weights, be, nb,
                 outs, ws, plans: tuple, dims: tuple, block_m: int,
                 silent_rank):
    """One launch of ``csrc/moe_tp.cu``'s ``entry`` over every rank of the
    mesh, its workspace ``ws`` [N, ...] symmetric, ``outs`` every rank's
    output (a table), ``plans`` its groups or relay, its pad the family's
    over ``axis``."""
    R = ctx.num_ranks
    be, nb = be.contiguous(), nb.contiguous()
    shd.cuda_checks(entry, x, weights, be, nb, ws)
    pad = family_pad(ctx, family, axis, MAX_LANES + R + 1)
    slots, pads = shd.tables(ctx, ws, pad)
    lib = csrc.load("moe_tp", _SIGNATURES)
    args = shd.launch_args(ctx)
    with csrc.current_on(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), weights.data_ptr(), be.data_ptr(), nb.data_ptr(),
            outs, slots, pads, *(ctypes.byref(p) for p in plans), *dims,
            block_m, weights.shape[0], _KINDS[x.dtype], MAX_LANES,
            -1 if silent_rank is None else int(silent_rank), *args)
    csrc.check(lib, rc, entry)


def _kernel_types(what: str, tokens, weights):
    if tokens.dtype not in _KINDS or weights.dtype != tokens.dtype:
        raise TypeError(f"{what}: tokens and weights share bf16 or f32, got "
                        f"{tokens.dtype} and {weights.dtype}")


# ---------------------------------------------------------------------------
# AG + grouped GEMM (B19)
# ---------------------------------------------------------------------------

def ag_moe_group_gemm(ctx, tokens, ids, weights, axis=None,
                      block_m: int = 128, block_n: int | None = None,
                      silent_rank: int | None = None,
                      replicas: bool = False):
    """tokens [T, H], index r's T / n rows at block r; ids [T] int32, the
    expert of each row (-1 for padding); weights [E, H, N], index r's
    columns at block r; over ``axis`` (a name, or a tuple of axes, outer
    first: the 2-tier path). Returns every rank's rows through their
    experts' weights, [T, N] in the tokens' type with index r's columns at
    block r, rows in token order, padding rows zero (``replicas``: every
    group's, [G, T, N]). ``block_m`` is the aligned row block (a row's
    result does not depend on it); ``block_n``, the TPU's weight-tile
    width, has no counterpart (the kernels tile N by their own 128).
    ``silent_rank`` (n > 1, the card) names a rank that puts but never
    signals: its peers' waits run out and the call raises ``ShmemError``
    (the hang check). Raises ``ValueError`` when T or N does not split over
    the ranks."""
    del block_n
    out = _ag_moe(ctx, tokens, ids, weights, axis, block_m, plain=False,
                  silent_rank=silent_rank, replicas=replicas)
    if tokens.device.type == "cuda":
        ag_moe_group_gemm.launches += 1
    return out if replicas else out[0]


ag_moe_group_gemm.launches = 0
ag_moe_group_gemm.launches_2d = 0


def ag_moe_group_gemm_plain(ctx, tokens, ids, weights, axis=None,
                            block_m: int = 128):
    """The plain PyTorch version of ``ag_moe_group_gemm``: B9's plain gather
    of the ids, each segment's alignment, then per index
    ``grouped_gemm_plain`` of each segment against the index's column
    block, on any device."""
    return _ag_moe(ctx, tokens, ids, weights, axis, block_m, plain=True)[0]


def _ag_moe(ctx, tokens, ids, weights, axis, block_m: int, plain: bool,
            silent_rank=None, replicas: bool = False):
    """``ag_moe_group_gemm``'s result, [1, T, N] (rank 0's group's), or
    with ``replicas`` every group's, [G, T, N]."""
    axis, n = _moe_axis(ctx, axis)
    T, H = tokens.shape
    E, _, N = weights.shape
    if T % n or N % n:
        raise ValueError(f"ag_moe_group_gemm: T={T} rows and N={N} columns "
                         f"must split over {n} ranks")
    t_local, nl = T // n, N // n
    gids = _gather_ids(ctx, ids, axis, t_local, plain)
    gi, rv, be, nb, dest = _segment_alignment(gids, E, block_m)
    x = _aligned_rows(tokens, gi, rv, t_local)               # [n, P, H]
    P = x.shape[1]
    if plain or tokens.device.type == "cpu":
        y = torch.empty(n, P, N, dtype=tokens.dtype, device=tokens.device)
        for r in range(n):
            cols = slice(r * nl, (r + 1) * nl)
            for s in range(n):
                y[s, :, cols] = grouped_gemm_plain(x[s], weights[:, :, cols],
                                                   be[s], block_m, nb[s])
        out = _unscramble(y, dest)[None]
        if replicas and n > 1:
            out = out.expand((ctx.num_ranks // n,) + tuple(out.shape[1:]))
        return out
    if n == 1:
        y = grouped_gemm(x[0], weights, be[0], block_m=block_m,
                         n_blocks_used=nb[0], masked=False)[None]
        return _unscramble(y, dest)[None]
    _kernel_types("ag_moe_group_gemm", tokens, weights)
    if block_m % MIN_BLOCK_M or H % TILE_K or nl % COL_ALIGN:
        raise ValueError(
            f"ag_moe_group_gemm: the kernel takes block_m % "
            f"{MIN_BLOCK_M} == 0, H % {TILE_K} == 0 and a column block "
            f"of a multiple of {COL_ALIGN}; got block_m {block_m}, H "
            f"{H}, N / n = {nl}")
    G = ctx.num_ranks // n
    y = torch.empty(G, n, P, N, dtype=tokens.dtype, device=tokens.device)
    ws = torch.empty(ctx.num_ranks, n, P, H, dtype=tokens.dtype,
                     device=tokens.device)
    if isinstance(axis, tuple):
        entry, plans = "tdt_ag_moe_2d", (shd.relay_plan(ctx, axis),)
    else:
        entry, plans = "tdt_ag_moe", (shd.group_plan(ctx, axis)[1],)
    _kernel_call(ctx, entry, "ag_moe", axis, x, weights.contiguous(), be, nb,
                 shd.group_rows(ctx, y, axis), ws, plans,
                 (ctx.num_ranks, P, H, nl), block_m, silent_rank)
    ag_moe_group_gemm.launches_2d += int(isinstance(axis, tuple))
    return torch.stack([_unscramble(y[g], dest)
                        for g in range(G if replicas else 1)])


# ---------------------------------------------------------------------------
# grouped GEMM + top-k reduce + RS (B20)
# ---------------------------------------------------------------------------

def moe_reduce_rs(ctx, tokens, ids, topk_weights, weights, axis=None,
                  block_m: int = 128, silent_rank: int | None = None,
                  replicas: bool = False):
    """tokens [T * topk, K] (the up-projection's activations, one row per
    (token, k) pair), index r's K columns at block r; ids [T * topk] int32,
    each row's expert (-1 for padding; replicated); topk_weights [T, topk];
    weights [E, K, N], index r's K rows at block r; over ``axis`` (a name,
    or a tuple of axes, outer first: the 2-tier path). Returns [T, N] in
    the tokens' type, index r's T / n rows at block r (``replicas``: every
    group's, [G, T, N]): the grouped down-projection of each row, summed
    over the K shards in slot order in f32 (over a tuple, the inner slots
    in order, then B13's ring over the outer axis), folded over k with the
    top-k weights in f32 in k order and cast once. The aligned row block
    is ``block_m``, cut to the rows of one segment rounded up to the
    kernels' 16. ``silent_rank`` as in ``ag_moe_group_gemm``. Raises
    ``ValueError`` when T does not split over the n ranks, or, at n > 1, K
    over 32 n (the kernel's K stage)."""
    out = _moe_rs(ctx, tokens, ids, topk_weights, weights, axis, block_m,
                  plain=False, silent_rank=silent_rank, replicas=replicas)
    if tokens.device.type == "cuda":
        moe_reduce_rs.launches += 1
    return out if replicas else out[0]


moe_reduce_rs.launches = 0
moe_reduce_rs.launches_2d = 0


def moe_reduce_rs_plain(ctx, tokens, ids, topk_weights, weights, axis=None,
                        block_m: int = 128):
    """The plain PyTorch version of ``moe_reduce_rs``: each segment's
    alignment; per K block, ``grouped_gemm_plain`` of every segment into
    f32 (the partials); per segment ``slot_reduce_plain`` of the n partials
    in slot order (over a tuple, of each strided chunk's inner partials,
    then B13's plain ring over the outer groups); the unscramble and the
    fold; on any device."""
    return _moe_rs(ctx, tokens, ids, topk_weights, weights, axis, block_m,
                   plain=True)[0]


def _moe_rs_2d_plain(ctx, axis, x, weights, be, nb, bm: int, kl: int):
    """The plain version of B20's two stages over the tuple ``axis``:
    every rank's stage-1 chunk [R, no * P, N] (each block r the inner
    slot sum of segment (r, mi)'s partials over its inner peers' K blocks)
    and the aligned rows of every index after B13's plain ring over the
    outer groups, [n, P, N] (rank 0's group's)."""
    outer, inner, no, ni = _tiers(ctx, axis)
    n, P = x.shape[0], x.shape[1]
    N = weights.shape[2]
    f32 = torch.float32
    g_all = shd.group_plan(ctx, axis)[2]
    g_in = shd.group_plan(ctx, inner)[2]
    part = {}
    for g in range(n):
        ks = slice(g * kl, (g + 1) * kl)
        for s in range(n):
            part[g, s] = grouped_gemm_plain(x[s, :, ks], weights[:, ks],
                                            be[s], bm, nb[s], out_dtype=f32)
    R = ctx.num_ranks
    red = torch.empty(R, no * P, N, dtype=f32, device=x.device)
    for q in range(R):
        peers = [g_all[p] for p in ctx.group_members(q, inner)]
        red[q] = torch.cat([slot_reduce_plain(torch.stack(
            [part[g, r * ni + g_in[q]] for g in peers]), f32)
            for r in range(no)])
    out = _rs._groups_plain(ctx, red.view(R, -1), outer) if no > 1 \
        else red.view(R, -1)
    members = list(shd.group_plan(ctx, axis)[3])
    return red, out[members].view(n, P, N)


def _moe_rs(ctx, tokens, ids, topk_weights, weights, axis, block_m: int,
            plain: bool, silent_rank=None, replicas: bool = False):
    """``moe_reduce_rs``'s result, [1, T, N] (rank 0's group's), or with
    ``replicas`` every group's, [G, T, N]."""
    axis, n = _moe_axis(ctx, axis)
    Tk, K = tokens.shape
    T, topk = topk_weights.shape
    if Tk != T * topk:
        raise ValueError(f"moe_reduce_rs: {Tk} rows for {T} tokens x top-"
                         f"{topk}")
    if T % n or (n > 1 and K % (TILE_K * n)):
        raise ValueError(f"moe_reduce_rs: T={T} tokens must split over {n} "
                         f"ranks, and K={K} over {TILE_K} x {n} (the "
                         f"kernel's K stage of each rank)")
    E, _, N = weights.shape
    seg_rows = T // n * topk
    kl = K // n
    bm = min(block_m, _round_up(seg_rows, MIN_BLOCK_M))
    gi, rv, be, nb, dest = _segment_alignment(ids.reshape(n, seg_rows), E,
                                              bm)
    x = _aligned_rows(tokens, gi, rv, seg_rows)              # [n, P, K]
    P = x.shape[1]
    f32 = torch.float32
    if (plain or tokens.device.type == "cpu") and isinstance(axis, tuple):
        ys = _moe_rs_2d_plain(ctx, axis, x, weights, be, nb, bm, kl)[1][None]
    elif plain or tokens.device.type == "cpu":
        # index r's f32 partial of every segment over its K block, then
        # each segment's n partials reduced in slot order
        parts = [[grouped_gemm_plain(x[s, :, r * kl:(r + 1) * kl],
                                     weights[:, r * kl:(r + 1) * kl], be[s],
                                     bm, nb[s], out_dtype=f32)
                  for s in range(n)] for r in range(n)]
        ys = torch.stack([slot_reduce_plain(
            torch.stack([parts[r][s] for r in range(n)]), f32)
            for s in range(n)])[None]
    elif n == 1:
        slots = grouped_gemm(x[0], weights, be[0], block_m=bm,
                             n_blocks_used=nb[0], masked=False, out_dtype=f32)
        ys = slot_reduce(slots[None], f32)[None, None]
    else:
        _kernel_types("moe_reduce_rs", tokens, weights)
        if N % COL_ALIGN:
            raise ValueError(f"moe_reduce_rs: the kernel takes N % "
                             f"{COL_ALIGN} == 0, got {N}")
        ys = _moe_rs_kernel(ctx, axis, n, x.reshape(n * P, K),
                            weights.contiguous(), be, nb, P, N, kl, bm,
                            silent_rank)
    w = topk_weights.float()
    out = []
    for y in ys if replicas else ys[:1]:
        rows = _unscramble(y, dest).view(T, topk, N)
        folded = rows[:, 0] * w[:, 0:1]
        for j in range(1, topk):
            folded = folded + rows[:, j] * w[:, j:j + 1]
        out.append(folded.to(tokens.dtype))
    out = torch.stack(out)
    if replicas and n > 1 and len(ys) == 1:     # the plain version
        out = out.expand((ctx.num_ranks // n,) + tuple(out.shape[1:]))
    return out


def _moe_rs_kernel(ctx, axis, n: int, x, weights, be, nb, P: int, N: int,
                   kl: int, bm: int, silent_rank) -> torch.Tensor:
    """B20's launches at n > 1 ranks: every group's aligned rows after the
    reduce-scatter, [G, n, P, N] f32 (over a tuple, the inner stage and
    then B13's ring over the outer groups)."""
    R = ctx.num_ranks
    G = R // n
    f32 = torch.float32
    dev = x.device
    if not isinstance(axis, tuple):
        y = torch.empty(G, n, P, N, dtype=f32, device=dev)
        index = shd.group_plan(ctx, axis)[2]
        outs = shd.group_rows(ctx, y, axis, [i * P * N * 4 for i in index])
        group = shd.group_plan(ctx, axis)[1]
        ws = torch.empty(R, n, P, N, dtype=f32, device=dev)
        _kernel_call(ctx, "tdt_moe_rs", "moe_rs", axis, x, weights, be, nb,
                     outs, ws, (group, group), (1, R, P, N, kl), bm,
                     silent_rank)
        return y
    outer, inner, no, ni = _tiers(ctx, axis)
    red = torch.empty(R, no * P, N, dtype=f32, device=dev)
    ws = torch.empty(R, ni, no * P, N, dtype=f32, device=dev)
    (outs,) = shd.tables(ctx, red)
    _kernel_call(ctx, "tdt_moe_rs", "moe_rs", axis, x, weights, be, nb, outs,
                 ws, (shd.group_plan(ctx, inner)[1],
                      shd.group_plan(ctx, axis)[1]), (no, R, P, N, kl), bm,
                 silent_rank)
    moe_reduce_rs.launches_2d += 1
    if no > 1:
        (ins,) = shd.tables(ctx, red)
        red = _rs._ring(ctx, ins, P * N, red, outer, silent_rank)
    order = list(shd.group_order(ctx, axis))
    return red.view(R, P, N)[order].view(G, n, P, N)


__all__ = ["MOE_EP", "ag_moe_group_gemm", "ag_moe_group_gemm_plain",
           "moe_reduce_rs", "moe_reduce_rs_plain"]
