"""The EP all-to-all of the MoE serving path: the wire across ranks (TPU
kernels B21 and B22), the EP context and its dispatch and combine.

Counterpart of ``triton_dist_tpu/ops/all_to_all.py``'s 1-D path:

- ``all_to_all_push`` (B21): every rank holds wire arrays ``[n, ...]``,
  slot p bound for peer p along ``axis``; slot p of the result holds what
  peer p sent. ``quant_from`` quantises array 0 per destination slot in
  the kernel, just before its put (fp8 or int8, an f32 scale per row on
  its own wire, padded with ones); ``dequant_to`` dequantises array 0 per
  arrived slot (in the kernel with ``fuse_dequant``, else one pass after).
- ``all_to_all_push_seg`` (B22): the plain wire in counted row segments,
  bitwise B21's output.
- ``create_all_to_all_context`` / ``EpAllToAllContext``, ``route_tokens``,
  ``dispatch`` and ``combine`` with ``quant_edge`` in {fused, pre, kernel}
  and ``dequant_edge`` in {post, kernel, expert} (``QuantTokens`` for the
  grouped GEMMs' ``row_scale``), on rank-major or ``expert_major`` slots;
  ``a2a_wire_bytes``, ``pick_wire_dtype`` (over this card's measured
  ``WIRE_FIT``) and ``expected_capacity``; the slot helpers
  (``_cap_round``, ``_id_cols``, ``_slot_assign``, ``_slot_src_map``,
  ``_slot_gather``, ``_quant``, ``_dequant`` and the quantising gathers),
  plain PyTorch, bitwise JAX's.
- the 2-tier ``Ep2dAllToAllContext`` (``create_all_to_all_context_2d``,
  ``route_tokens_2d``, ``dispatch_2d``, ``combine_2d``): B21 over the major
  axis, then over the minor one, each rank's data its own (the wire's
  ``over``), a quantised row quantised once at its source.

Inputs and outputs are the JAX package's global views: a wire array is
``[n * n, ...]`` (source-major: row ``src * n + dst`` is what src sends
dst), ``dispatch`` takes the tokens ``[n * T, H]`` and ids ``[n * T, k]``
of every rank, rank-major. Inside a multi-axis mesh every group along
``axis`` runs the same exchange (the other axes hold replicas): one
launch covers every rank of the mesh, each rank reading the shard of its
own group index and writing its own output; the result is rank 0's
group's (``replicas=True`` returns every rank's, ``[N, n, ...]``). With
``over`` every rank holds its own arrays instead, one block an index over
those axes.

On a CUDA tensor the wire is one cooperative launch of
``csrc/all_to_all.cu`` over every rank of the mesh on the card, and the
slot gather and the combine's fold run the one-rank kernels of the same
source (``ep_dispatch`` with ``topk=1``, ``ep_combine``; the fold also
takes the expert edge's one-byte rows with their scales). On a CPU tensor
each runs its plain PyTorch version: the exchange is ``transpose(0, 1)``
of the ``[src, dst, ...]`` stack. The router, the slot arithmetic and
the fused and pre-quantised edges are XLA in the reference and plain
PyTorch here.

Not ported (ROADMAP.md Queue A, item 7 "MoE / EP across ranks"): the host
routing twin ``csrc/a2a_route.cc`` (a numpy routing table is taken as a
CPU tensor). The port's slot gather copies rows: a -0.0 stays -0.0 where
the reference's one-hot product makes it +0.0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import typing

import numpy as np
import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.shmem import device as shd
from triton_dist_tpu_torch.shmem.context import MAX_RANKS
from triton_dist_tpu_torch.shmem.device import group_plan

_P = ctypes.c_void_p
_I = ctypes.c_int
# tokens, src, valid, out, P, T, row_bytes, topk, stream
_DISPATCH = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
# y, pos, w, out, P, T, D, topk, stream
_COMBINE = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
# args pads n group lanes + the layer's launch arguments
_WIRE = [_P, _P, _I, _P, _I] + shd.LAUNCH_SIG
# y, scale, pos, w, out, P, T, D, topk, wire, out type, stream
_COMBINE_SCALED = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"tdt_ep_dispatch": _DISPATCH,
               "tdt_ep_combine_bf16": _COMBINE,
               "tdt_ep_combine_f32": _COMBINE,
               "tdt_ep_combine_scaled": _COMBINE_SCALED,
               "tdt_a2a_push": _WIRE, "tdt_a2a_push_seg": _WIRE}
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


def ep_combine_plain(y, pos, weights, scale=None, out_dtype=None):
    """The plain PyTorch version of ``ep_combine``."""
    T, k = weights.shape
    P = y.shape[0]
    p = pos.long().view(T, k)
    ok = (p >= 0) & (p < P)
    pc = p.clamp(0, P - 1)
    rows = torch.where(ok[..., None], y[pc].float(),
                       torch.zeros((), device=y.device))
    if scale is not None:
        rows = rows * torch.where(ok, scale.float()[pc],
                                  torch.ones((), device=y.device))[..., None]
    acc = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    for j in range(k):
        acc = acc + rows[:, j] * weights[:, j:j + 1]
    return acc.to(out_dtype or y.dtype)


def ep_combine(y, pos, weights, scale=None, out_dtype=None):
    """Each token's k processed rows, weighted and summed: ``out[t] =
    sum_j weights[t, j] * (y[p] * scale[p])`` with ``p = pos[t * k + j]``
    (no scale: ``y[p]``), the products and the sum over j (in order, from
    0) in f32, cast once to ``out_dtype`` (y's type by default).

    y [P, D] (expert-aligned output rows), bf16 or f32, or fp8 e4m3fn /
    int8 with ``scale`` [P] f32 (a quantised wire's rows, dequantised in
    the fold: the expert edge's return trip) into ``out_dtype`` bf16 or
    f32; pos [T * k] int32, the aligned row of each (token, k) pair
    (outside ``[0, P)``: the pair adds 0); weights [T, k] f32. Rows of y
    that no pair names are never read. Out [T, D].

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (rows a multiple of 16 bytes) or raises; each launch adds one to
    ``ep_combine.launches`` and to its form's count in
    ``ep_combine.launches_by_form`` (the rows' type, "scaled" with a
    scale)."""
    out_dtype = out_dtype or y.dtype
    if y.device.type == "cpu":
        return ep_combine_plain(y, pos, weights, scale, out_dtype)
    P, D = y.shape
    T, k = weights.shape
    if scale is None:
        if y.dtype not in _COMBINE_ENTRIES or out_dtype != y.dtype:
            raise TypeError(f"ep_combine: y must be bf16 or f32 (out in its "
                            f"type), got {y.dtype} -> {out_dtype}")
        _check("ep_combine", (y, pos, weights),
               (None, torch.int32, torch.float32))
    else:
        if y.dtype not in WIRE_TYPES or out_dtype not in _X_TYPES:
            raise TypeError(f"ep_combine: scaled rows are fp8 e4m3fn or "
                            f"int8 into bf16 or f32, got {y.dtype} -> "
                            f"{out_dtype}")
        _check("ep_combine", (y, pos, weights, scale),
               (None, torch.int32, torch.float32, torch.float32))
    if (pos.numel() != T * k or (D * y.element_size()) % 16 or T < 1
            or P < 1 or (scale is not None and scale.shape != (P,))):
        raise ValueError(f"ep_combine: unsupported shapes y {tuple(y.shape)}, "
                         f"pos {tuple(pos.shape)}, weights "
                         f"{tuple(weights.shape)}")
    out = torch.empty(T, D, dtype=out_dtype, device=y.device)
    lib = _lib()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with csrc.current_on(y.device):
        if scale is None:
            rc = getattr(lib, _COMBINE_ENTRIES[y.dtype])(
                y.data_ptr(), pos.data_ptr(), weights.data_ptr(),
                out.data_ptr(), P, T, D, k, stream)
        else:
            rc = lib.tdt_ep_combine_scaled(
                y.data_ptr(), scale.data_ptr(), pos.data_ptr(),
                weights.data_ptr(), out.data_ptr(), P, T, D, k,
                WIRE_TYPES[y.dtype], _X_TYPES[out_dtype], stream)
    csrc.check(lib, rc, "ep_combine")
    ep_combine.launches += 1
    form = str(y.dtype).split(".")[-1] + (" scaled" if scale is not None
                                          else "")
    ep_combine.launches_by_form[form] = \
        ep_combine.launches_by_form.get(form, 0) + 1
    return out


ep_combine.launches = 0
ep_combine.launches_by_form = {}

# ---------------------------------------------------------------------------
# slot arithmetic and the quantiser (plain PyTorch, bitwise the reference's)
# ---------------------------------------------------------------------------

# the wire types of a quantised wire, by the kernel's code (csrc WireType)
WIRE_TYPES = {torch.float8_e4m3fn: 1, torch.int8: 2}
_X_TYPES = {torch.bfloat16: 0, torch.float32: 1}


def _cap_round(cap: int, wire_itemsize: int = 2) -> int:
    """A slot capacity rounded up to the wire type's row tile (32 bytes of
    rows: 8 for f32, 16 for bf16, 32 for fp8/int8). The rule is the TPU's
    (Mosaic's sublane tile); the port keeps it so that slot layouts and
    wire bytes equal the reference's."""
    mult = 32 // wire_itemsize
    return (cap + mult - 1) // mult * mult


def _id_cols(cap: int) -> int:
    """Columns of an int32 id or scale wire of ``cap`` slots: ``cap``
    rounded up to 128, at least 128."""
    return max((cap + 127) // 128 * 128, 128)


def _slot_assign(dest_flat, n: int, cap: int, valid=None):
    """Exclusive-cumsum slot allocation per destination over the last dim
    of ``dest_flat`` [..., R]: (slot, ok), ``ok`` False past ``cap`` or for
    an invalid row."""
    d = dest_flat.long().clamp(0, n - 1)
    one_hot = torch.nn.functional.one_hot(d, n).to(torch.int32)
    if valid is not None:
        one_hot = one_hot * valid[..., None].to(torch.int32)
    slots = one_hot.cumsum(-2) - one_hot
    slot = slots.gather(-1, d[..., None])[..., 0].to(torch.int32)
    ok = slot < cap
    if valid is not None:
        ok = ok & valid
    return slot, ok


def _slot_src_map(dest_flat, slot_drop, src_rows, n_dst: int, cap: int,
                  n_rows: int):
    """The slot -> source-row map [..., n_dst, cap]: row ``src_rows[i]`` at
    (``dest_flat[i]``, ``slot_drop[i]``), ``n_rows`` in an unfilled slot (a
    slot of ``cap`` is dropped)."""
    lead = dest_flat.shape[:-1]
    out = torch.full(lead + (n_dst * (cap + 1),), n_rows, dtype=torch.int32,
                     device=dest_flat.device)
    idx = dest_flat.long() * (cap + 1) + slot_drop.long()
    out.scatter_(-1, idx, src_rows.to(torch.int32).expand(idx.shape))
    return out.view(lead + (n_dst, cap + 1))[..., :cap]


def _sanitize_rows(rows):
    """NaN to 0 and +-inf to the type's finite range before a slot gather,
    as the reference does (one bad row cannot poison a slot). Wire rows of
    one byte come from ``_quant`` of rows already clamped, finite."""
    if rows.is_floating_point() and rows.element_size() > 1:
        return torch.nan_to_num(rows)
    return rows


def _slot_gather(rows, src, out_dtype):
    """The send buffer [..., n_dst, cap, H] of ``rows`` [R, H] through the
    slot map ``src`` (R = unfilled: zeros), non-finite rows clamped first:
    ``ep_dispatch`` with ``topk=1`` (its kernel on a CUDA tensor)."""
    R = rows.shape[0]
    flat = src.reshape(-1)
    g = ep_dispatch(_sanitize_rows(rows),
                    flat.clamp(max=R - 1).to(torch.int32).contiguous(),
                    (flat < R).contiguous(), 1)
    return g.to(out_dtype).view(tuple(src.shape) + tuple(rows.shape[1:]))


def _qmax(wire_dtype) -> float:
    if wire_dtype.is_floating_point:
        return float(torch.finfo(wire_dtype).max)
    return float(torch.iinfo(wire_dtype).max)


def _quant(x, wire_dtype):
    """Per-row symmetric quantisation: (q rows in ``wire_dtype``, the f32
    scale of each row). A zero row gets scale 1 (and zeros).

    The scale is ``amax`` times the f32 reciprocal of ``qmax``: the
    reference writes ``amax / qmax``, and XLA, which compiles it, rewrites
    a division by a constant into that product (eager JAX divides; the two
    differ by an ulp in some rows). The port follows the compiled
    reference, so its wire bits are JAX's. The quotients ``x / scale`` are
    IEEE divisions."""
    qmax = _qmax(wire_dtype)
    xf = x.float()
    amax = xf.abs().amax(-1)
    inv = torch.ones((), dtype=torch.float32, device=x.device) / qmax
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    q = xf / scale[..., None]
    if not wire_dtype.is_floating_point:
        q = torch.round(q)
    return q.to(wire_dtype), scale


def _dequant(q, scale, out_dtype):
    return (q.float() * scale[..., None].float()).to(out_dtype)


def _slot_gather_quant(rows, src, wire_dtype):
    """The slot gather and ``_quant`` in one logical pass: (q [..., n_dst,
    cap, H], scale [..., n_dst, cap]); an unfilled slot quantises to zeros
    with scale 1."""
    take = _slot_gather(rows, src, rows.dtype)
    H = take.shape[-1]
    q, scale = _quant(take.reshape(-1, H), wire_dtype)
    return q.view(take.shape), scale.view(src.shape)


def _scale_wire(scale, cap: int):
    """Scales [..., cap] on their wire [..., cols // 128, 128], padded with
    ones."""
    cols = _id_cols(cap)
    sc = torch.ones(tuple(scale.shape[:-1]) + (cols,), dtype=torch.float32,
                    device=scale.device)
    sc[..., :cap] = scale
    return sc.view(tuple(scale.shape[:-1]) + (cols // 128, 128))


def _slot_gather_prequant(rows, src, wire_dtype, cap: int):
    """``quant_edge="pre"``: the source rows quantised once, then their wire
    rows and scales gathered through the slot map (1.0 in an unfilled
    slot). Returns (send [..., n_dst, cap, H], scale wire)."""
    rows = _sanitize_rows(rows)
    R = rows.shape[0]
    q, s = _quant(rows, wire_dtype)
    send = _slot_gather(q, src, wire_dtype)
    flat = src.reshape(-1).long()
    sc = torch.where(flat < R, s[flat.clamp(max=R - 1)],
                     torch.ones((), device=s.device)).view(src.shape)
    return send, _scale_wire(sc, cap)


# ---------------------------------------------------------------------------
# the wire: B21 and B22
# ---------------------------------------------------------------------------

class _A2aArgs(ctypes.Structure):
    """``csrc/all_to_all.cu``'s A2aArgs, field for field."""

    _table = ctypes.c_void_p * MAX_RANKS
    _fields_ = [("in_", _table * 3), ("out", _table * 3),
                ("in_slot", ctypes.c_longlong * 3),
                ("slot", ctypes.c_longlong * 3),
                ("arrays", ctypes.c_int), ("quant", ctypes.c_int),
                ("dequant", ctypes.c_int), ("wire", ctypes.c_int),
                ("x_type", ctypes.c_int), ("cap", ctypes.c_int),
                ("H", ctypes.c_int), ("cols", ctypes.c_int),
                ("silent", ctypes.c_int), ("segments", ctypes.c_int),
                ("scale_array", ctypes.c_int),
                ("qscale", _table), ("dscale", _table), ("deq", _table),
                ("seg_off", (ctypes.c_longlong * 4) * 3),
                ("seg_len", (ctypes.c_longlong * 4) * 3)]


# bytes of a slot one block moves at least; under quantisation one row a
# block (the launch cuts the lanes to what the card keeps resident)
WIRE_LANE_BYTES = 32 * 1024
MAX_WIRE_LANES = 32
MAX_ROW_LANES = 128


def _wire_lanes(slot_bytes: int, rows: int | None) -> int:
    if rows:
        return max(1, min(MAX_ROW_LANES, rows))
    return max(1, min(MAX_WIRE_LANES, -(-slot_bytes // WIRE_LANE_BYTES)))


_Table = ctypes.c_void_p * MAX_RANKS


def _rank_table(t):
    """The kernel's PeerTable of an all-ranks tensor [N, ...]: rank r's row."""
    step = t.numel() // t.shape[0] * t.element_size()
    base = t.data_ptr()
    return _Table(*(base + r * step for r in range(t.shape[0])))


def _group0(ctx, axis, out):
    """Rank 0's group's outputs of an all-ranks [N, n, ...] result, as the
    global view [n * n, ...] (a view when the group is contiguous)."""
    members = list(group_plan(ctx, axis)[3])
    n = len(members)
    if members == list(range(members[0], members[0] + n)):
        g = out[members[0]:members[0] + n]
    else:
        g = out[torch.tensor(members, device=out.device)]
    return g.reshape((n * n,) + tuple(out.shape[2:]))


def _replicas(ctx, axis, glob):
    """Every rank's [n, ...] of a global view [n * n, ...]: rank r's is
    its group index's (the plain version of the all-ranks result)."""
    n, _, idx, _ = group_plan(ctx, axis)
    per = glob.view((n, n) + tuple(glob.shape[1:]))
    return per[torch.tensor(idx, device=glob.device)]


def _exchange_plain(x, n: int, over=None, ctx=None, axis=None):
    """The plain exchange of a global view [n * n, ...]: ``transpose(0, 1)``
    of the [src, dst, ...] stack; with ``over``, of every block of ``x``
    [n_over * n, ...] through ``_over_plan``'s source map."""
    if over is not None:
        return x[torch.tensor(_over_plan(ctx, axis, over)[1],
                              device=x.device)].contiguous()
    return x.view((n, n) + tuple(x.shape[1:])).transpose(0, 1) \
        .reshape(x.shape).contiguous()


_over_plans: dict = {}


def _over_plan(ctx, axis, over) -> tuple:
    """The wire over ``axis`` when every rank holds its own data, indexed by
    its flattened coordinate over the axes ``over`` (major to minor; the
    JAX package's inputs sharded ``P(over)``): (the indices over ``over``,
    the source block ``e' * n + me`` of each output block ``e * n + s`` --
    what member s of e's group sends it --, the flat rank whose outputs
    hold each index, the lowest). Made once per mesh shape and axes."""
    over = tuple(over)
    key = (tuple(ctx.axis_names), tuple(ctx.mesh_shape), axis, over)
    plan = _over_plans.get(key)
    if plan is None:
        n_over = ctx.axis_size(over)
        n = ctx.axis_size(axis)
        rep = [min(r for r in range(ctx.num_ranks)
                   if ctx.my_pe(r, over) == e) for e in range(n_over)]
        src = []
        for e in range(n_over):
            me = ctx.my_pe(rep[e], axis)
            src += [ctx.my_pe(m, over) * n + me
                    for m in ctx.group_members(rep[e], axis)]
        plan = _over_plans[key] = (n_over, tuple(src), tuple(rep))
    return plan


def _pick_over(ctx, axis, over, out):
    """The outputs of the indices over ``over`` ([n_over * n, ...]) from an
    all-ranks result [N, n, ...] (a view when they are ranks 0, 1, ...)."""
    n_over, _, rep = _over_plan(ctx, axis, over)
    if list(rep) == list(range(n_over)):
        g = out[:n_over]
    else:
        g = out[torch.tensor(rep, device=out.device)]
    return g.reshape((n_over * out.shape[1],) + tuple(out.shape[2:]))


def _launch_wire(ctx, axis, entry: str, args, family: str, words: int,
                 lanes: int):
    group = group_plan(ctx, axis)[1]
    pad = family_pad(ctx, family, axis, words)
    (pads,) = shd.tables(ctx, pad)
    lib = _lib()
    largs = shd.launch_args(ctx)
    with csrc.current_on(ctx.device):
        rc = getattr(lib, entry)(ctypes.byref(args), pads, ctx.num_ranks,
                                 ctypes.byref(group), lanes, *largs)
    csrc.check(lib, rc, entry)


def _wire_args(ctx, axis, arrays, outs, over=None) -> _A2aArgs:
    """The kernel's arguments for wire arrays (global views [n * n, ...],
    or with ``over`` one block a coordinate over it, [n_over * n, ...])
    into every rank's outputs ([N, n, ...])."""
    n = ctx.axis_size(axis)
    A = _A2aArgs()
    A.arrays = len(arrays)
    for a, (x, o) in enumerate(zip(arrays, outs)):
        A.in_[a] = _Table(*(shd.group_table(ctx, x.view(n, -1), axis)
                            if over is None else shd.group_table(
                                ctx, x.view(ctx.axis_size(over), -1),
                                tuple(over))))
        A.out[a] = _rank_table(o)
        A.in_slot[a] = x.numel() // x.shape[0] * x.element_size()
        A.slot[a] = o.numel() // (o.shape[0] * o.shape[1]) * o.element_size()
    A.silent = -1
    A.segments = 1
    A.scale_array = -1
    return A


def _check_wire(name: str, ctx, axis, arrays, over=None) -> int:
    n = ctx.axis_size(axis)
    rows = n * (n if over is None else ctx.axis_size(tuple(over)))
    if over is not None and axis not in tuple(over):
        raise ValueError(f"{name}: axis {axis!r} is not one of {over}")
    if not 1 <= len(arrays) <= 3:
        raise ValueError(f"{name}: one to three wire arrays, got "
                         f"{len(arrays)}")
    for x in arrays:
        if x.shape[0] != rows or not x.is_contiguous():
            raise ValueError(f"{name}: a wire array is contiguous [{rows}, "
                             f"...], got {tuple(x.shape)}")
        if x.device.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"{name}: wire arrays must be 16-byte aligned")
    return n


def _empty_outs(ctx, n, arrays, dtype0=None):
    N = ctx.num_ranks
    outs = []
    for a, x in enumerate(arrays):
        dt = dtype0 if (a == 0 and dtype0 is not None) else x.dtype
        outs.append(torch.empty((N, n) + tuple(x.shape[1:]), dtype=dt,
                                device=x.device))
    return outs


def all_to_all_push_plain(ctx, *arrays, axis=None, dequant_to=None,
                          quant_from=None, replicas: bool = False,
                          over=None):
    """The plain PyTorch version of ``all_to_all_push``."""
    axis = axis or ctx.axis_names[0]
    n = ctx.axis_size(axis)
    rows = arrays[0].shape[0]
    arrays = list(arrays)
    if quant_from is not None:
        x = arrays[0]
        cap, H = x.shape[-2:]
        q, s = _quant(x.reshape(-1, H), quant_from)
        arrays = [q.view(x.shape)] + arrays[1:] \
            + [_scale_wire(s.view(rows, cap), cap)]
    out = [_exchange_plain(x, n, over, ctx, axis) for x in arrays]
    if dequant_to is not None:
        cap = out[0].shape[-2]
        scale = out[-1].reshape(rows, -1)[:, :cap]
        out[0] = _dequant(out[0], scale, dequant_to)
    if replicas:
        if over is not None:
            raise ValueError("all_to_all_push: replicas=True with over")
        out = [_replicas(ctx, axis, o) for o in out]
    return tuple(out)


def all_to_all_push(ctx, *arrays, axis=None, dequant_to=None,
                    fuse_dequant: bool = True, quant_from=None,
                    fuse_quant: bool = True, replicas: bool = False,
                    silent_rank: int | None = None, over=None):
    """The EP wire (B21): each array is the global view [n * n, ...] (row
    ``src * n + dst`` is src's payload for dst); returns same-shaped arrays
    where row ``dst * n + src`` holds what src sent dst.

    ``quant_from=<wire dtype>`` (``torch.float8_e4m3fn`` or ``torch.int8``):
    array 0 is [n * n, cap, H] in the compute type (bf16 or f32), quantised
    per destination slot in the kernel before its put (``fuse_quant=False``
    quantises in one plain pass first, with the same bits); the f32 scale
    wire [n * n, cols / 128, 128] comes back last. ``dequant_to=<dtype>``:
    array 0 arrives quantised and its scales on the last array (or from
    ``quant_from``); it comes back dequantised, per arrived slot in the
    kernel with ``fuse_dequant``, else in one pass after. Returns (payload,
    the other arrays..., the scale wire under ``quant_from``).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (one cooperative launch over every rank of the mesh; adds one to
    ``all_to_all_push.launches``) or raises. ``replicas=True`` returns
    every rank's [N, n, ...] instead of rank 0's group's. ``silent_rank``
    (a flat rank that puts but never signals) makes its peers' waits run
    out: the call raises ``ShmemError`` (the hang check).

    ``over`` (a tuple of axes holding ``axis``, major to minor): every rank
    holds its own arrays, not its group index's, as the JAX package's
    inputs sharded ``P(over)`` (the 2-tier EP exchange): each array is
    [n_over * n, ...], block e (e the rank's flattened coordinate over
    ``over``) that rank's [n, ...], and the result the same, block e what
    the members of its group along ``axis`` sent it."""
    axis = axis or ctx.axis_names[0]
    n = _check_wire("all_to_all_push", ctx, axis, arrays, over)
    x0 = arrays[0]
    if quant_from is not None and quant_from not in WIRE_TYPES:
        raise TypeError(f"all_to_all_push: wire type {quant_from} (fp8 "
                        f"e4m3fn or int8)")
    if x0.device.type == "cpu":
        return all_to_all_push_plain(ctx, *arrays, axis=axis,
                                     dequant_to=dequant_to,
                                     quant_from=quant_from,
                                     replicas=replicas, over=over)
    if quant_from is not None and not fuse_quant:
        cap, H = x0.shape[-2:]
        q, s = _quant(x0.reshape(-1, H), quant_from)
        return all_to_all_push(ctx, q.view(x0.shape), *arrays[1:],
                               _scale_wire(s.view(x0.shape[0], cap), cap),
                               axis=axis, dequant_to=dequant_to,
                               fuse_dequant=fuse_dequant, replicas=replicas,
                               silent_rank=silent_rank, over=over)
    quant = quant_from is not None
    wire = quant_from if quant else (x0.dtype if dequant_to is not None
                                     else None)
    if wire is not None and wire not in WIRE_TYPES:
        raise TypeError(f"all_to_all_push: a quantised wire is fp8 e4m3fn or "
                        f"int8, got {wire}")
    kdeq = dequant_to is not None and fuse_dequant
    x_type = dequant_to if dequant_to is not None else (
        x0.dtype if quant else None)
    if (quant or kdeq) and x_type not in _X_TYPES:
        raise TypeError(f"all_to_all_push: the compute type is bf16 or f32, "
                        f"got {x_type}")
    if quant and x0.dtype not in _X_TYPES:
        raise TypeError(f"all_to_all_push: quantises bf16 or f32 rows, got "
                        f"{x0.dtype}")
    outs = _empty_outs(ctx, n, arrays, dtype0=quant_from)
    A = _wire_args(ctx, axis, arrays, outs, over)
    cap = H = cols = 0
    if quant or dequant_to is not None:
        cap, H = x0.shape[-2:]
        cols = _id_cols(cap)
        A.cap, A.H, A.cols = cap, H, cols
        A.wire = WIRE_TYPES[wire]
        A.x_type = _X_TYPES[x_type] if (quant or kdeq) else 0
    N = ctx.num_ranks
    qscale = None
    if quant:
        qscale = torch.empty(N, n, cols, dtype=torch.float32,
                             device=x0.device)
        A.quant = WIRE_TYPES[quant_from]
        A.qscale = _rank_table(qscale)
    deq = None
    if kdeq:
        deq = torch.empty((N, n) + tuple(x0.shape[1:]), dtype=dequant_to,
                          device=x0.device)
        A.dequant = 1
        A.deq = _rank_table(deq)
        if quant:
            A.dscale = A.qscale
        else:
            A.scale_array = len(arrays) - 1
            A.dscale = A.out[len(arrays) - 1]
    if silent_rank is not None:
        A.silent = silent_rank
    rows = cap if (quant or kdeq) else None
    lanes = _wire_lanes(int(A.slot[0]), rows)
    _launch_wire(ctx, axis, "tdt_a2a_push", A, "a2a", (n + 1) * lanes, lanes)
    all_to_all_push.launches += 1
    res = list(outs)
    if quant:
        res.append(qscale.view(N, n, cols // 128, 128))
    if kdeq:
        res[0] = deq
    if not replicas:
        res = [_group0(ctx, axis, o) if over is None
               else _pick_over(ctx, axis, over, o) for o in res]
    if dequant_to is not None and not kdeq:
        cap_ = x0.shape[-2]
        sc = res[-1].reshape(res[-1].shape[:-2] + (-1,))[..., :cap_]
        res[0] = _dequant(res[0], sc, dequant_to)
    return tuple(res)


all_to_all_push.launches = 0


def _seg_chunks(shape: tuple, segments: int, itemsize: int):
    """The static per-segment (row offset, rows) split of one wire array's
    slot rows (dim 1 of the local [n, rows, ...] view), each boundary
    rounded down to the type's 32-byte row tile; an array too small or of
    rank below 3 rides whole in segment 0 (``"full"``); an empty chunk is
    None. The reference's split, kept for the same segments."""
    if len(shape) < 3:
        return ("full",) + (None,) * (segments - 1)
    rows = shape[1]
    align = max(1, 32 // max(1, itemsize))
    bounds = [0]
    for s in range(1, segments):
        b = (rows * s // segments) // align * align
        bounds.append(max(bounds[-1], min(b, rows)))
    bounds.append(rows)
    if bounds[1] == 0 and segments > 1:
        return ("full",) + (None,) * (segments - 1)
    return tuple((bounds[s], bounds[s + 1] - bounds[s])
                 if bounds[s + 1] > bounds[s] else None
                 for s in range(segments))


def all_to_all_push_seg(ctx, *arrays, axis=None, segments: int = 2,
                        dequant_to=None, fuse_dequant: bool = False,
                        quant_from=None, fuse_quant: bool = False,
                        replicas: bool = False,
                        silent_rank: int | None = None):
    """The segmented wire (B22): ``all_to_all_push``'s plain exchange with
    each slot cut into ``segments`` row chunks (``_seg_chunks`` of the
    local [n, rows, ...] view); each (peer, segment) is announced by one
    counted signal after its puts, and a rank drains the segments in fixed
    order. The outputs are bitwise B21's. ``quant_from`` / ``dequant_to``
    run as one plain pass before / after, as the reference's segmented
    wire does (``fuse_*`` are accepted and ignored). A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (adds one to
    ``all_to_all_push_seg.launches``) or raises. ``silent_rank`` (a flat
    rank that puts but never signals) starves its peers' segment counts:
    the call raises ``ShmemError`` (the hang check)."""
    del fuse_dequant, fuse_quant
    axis = axis or ctx.axis_names[0]
    segments = max(1, int(segments))
    n = _check_wire("all_to_all_push_seg", ctx, axis, arrays)
    if segments > 4:
        raise ValueError("all_to_all_push_seg: at most 4 segments")
    if quant_from is not None:
        x0 = arrays[0]
        cap, H = x0.shape[-2:]
        q, s = _quant(x0.reshape(-1, H), quant_from)
        return all_to_all_push_seg(ctx, q.view(x0.shape), *arrays[1:],
                                   _scale_wire(s.view(n * n, cap), cap),
                                   axis=axis, segments=segments,
                                   dequant_to=dequant_to, replicas=replicas,
                                   silent_rank=silent_rank)
    if arrays[0].device.type == "cpu":
        return all_to_all_push_plain(ctx, *arrays, axis=axis,
                                     dequant_to=dequant_to,
                                     replicas=replicas)
    outs = _empty_outs(ctx, n, arrays)
    A = _wire_args(ctx, axis, arrays, outs)
    A.segments = segments
    if silent_rank is not None:
        A.silent = silent_rank
    for a, x in enumerate(arrays):
        local = (n,) + tuple(x.shape[1:])
        row = x.numel() // x.shape[0] // max(1, local[1]) * x.element_size() \
            if len(local) >= 3 else 0
        for s, ch in enumerate(_seg_chunks(local, segments,
                                           x.element_size())):
            if ch == "full":
                A.seg_off[a][s], A.seg_len[a][s] = 0, A.slot[a]
            elif ch is not None:
                A.seg_off[a][s], A.seg_len[a][s] = ch[0] * row, ch[1] * row
    lanes = _wire_lanes(int(A.slot[0]), None)
    _launch_wire(ctx, axis, "tdt_a2a_push_seg", A, "a2a_seg",
                 (segments + 1) * lanes, lanes)
    all_to_all_push_seg.launches += 1
    res = list(outs)
    if not replicas:
        res = [_group0(ctx, axis, o) for o in res]
    if dequant_to is not None:
        cap = arrays[0].shape[-2]
        sc = res[-1].reshape(res[-1].shape[:-2] + (-1,))[..., :cap]
        res[0] = _dequant(res[0], sc, dequant_to)
    return tuple(res)


all_to_all_push_seg.launches = 0


# ---------------------------------------------------------------------------
# the EP context, dispatch and combine
# ---------------------------------------------------------------------------

# The wire fit t = t0 + bytes / rate of each wire, that ``wire_dtype="auto"``
# and the sharded engine's modelled comm split use: chip_smoke.py phase 16d's
# least-squares fit of B21's kernel-alone times (the plain bf16 wire; the
# fp8 wire quantised and dequantised in the kernel) at 2, 4 and 8 ranks and
# the engine's decode and chunk rows, bytes a rank's one-way wire bytes. On
# one NVIDIA H100 80GB HBM3 at a 700 W power limit, every rank on the one
# card (emulated ranks, not NVLink). The fp8 wire's in-kernel quantise
# makes it the slower one here at every size.
WIRE_FIT = {
    "bf16": {"t0_us": 19.53, "gb_per_s": 222.1},
    "fp8": {"t0_us": 30.34, "gb_per_s": 28.08},
}


class QuantTokens(typing.NamedTuple):
    """Quantised-wire tokens as ``dispatch`` hands them to the experts
    under ``dequant_edge="expert"``: ``q`` [..., cap, H] in the wire's type
    and the f32 ``scale`` [..., cap] of each slot, meant for the grouped
    GEMMs' ``row_scale`` (no dequantise pass anywhere)."""
    q: torch.Tensor
    scale: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EpAllToAllContext:
    """The EP all-to-all's static shapes and mesh (the reference's context
    of the same name): ``capacity`` slots per (src, dst) pair, rows routed
    past it dropped. ``wire_dtype`` (fp8 e4m3fn or int8) quantises the
    wire per row with an f32 scale wire; ``quant_edge`` "fused" gathers and
    quantises in one pass, "pre" quantises the source rows first, "kernel"
    quantises in B21 per destination slot; ``dequant_edge`` "post"
    dequantises in one pass after the wire, "kernel" in B21 per arrival,
    "expert" nowhere: ``dispatch`` returns ``QuantTokens`` for the expert
    GEMMs' ``row_scale``, and the return trip stays quantised until the
    combine's fold. ``seg_push >= 2`` runs the wire as B22 in that many
    segments.

    ``expert_major``: each (src, dst) block of ``capacity`` slots is laid
    out per local expert, ``capacity_per_expert`` slots each (rows ``[e *
    cap_e, (e + 1) * cap_e)`` of a block are local expert e's), so the
    receiver's row blocks belong to known experts without an alignment
    pass; a row past its expert's budget drops at the source (drops are
    per (src, dst, expert))."""
    ctx: object
    axis: str
    max_tokens: int
    hidden: int
    topk: int
    num_experts: int
    capacity: int
    dtype: torch.dtype = torch.bfloat16
    wire_dtype: torch.dtype | None = None
    quant_edge: str = "fused"
    dequant_edge: str = "post"
    expert_major: bool = False
    seg_push: int = 0

    def _dequant_in_kernel(self) -> bool:
        return self.dequant_edge == "kernel"

    @property
    def n_ranks(self) -> int:
        return self.ctx.axis_size(self.axis)

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.n_ranks

    @property
    def capacity_per_expert(self) -> int:
        if not self.expert_major:
            raise ValueError("capacity is per rank unless expert_major")
        return self.capacity // self.experts_per_rank


def a2a_wire_bytes(n_ranks: int, max_tokens: int, hidden: int, topk: int,
                   wire_dtype=None) -> int:
    """Dispatch and combine wire bytes of one rank at the drop-proof
    capacity: the payload at the wire's size, the int32 id columns, and the
    f32 scale wire when quantised (the reference's formula)."""
    itemsize = (wire_dtype or torch.bfloat16).itemsize
    cap = _cap_round(max_tokens * topk, itemsize)
    idc = _id_cols(cap)
    b = n_ranks * (cap * hidden * itemsize + idc * 4)
    if wire_dtype is not None:
        b += n_ranks * idc * 4
    return 2 * b


def pick_wire_dtype(n_ranks: int, max_tokens: int, hidden: int, topk: int,
                    wire_fit: dict | None = None,
                    fp8_dtype=torch.float8_e4m3fn):
    """``wire_dtype="auto"``: None (the bf16 wire) or ``fp8_dtype``,
    whichever the fit (``WIRE_FIT`` by default) predicts faster at this
    size; a tie keeps bf16."""
    fit = wire_fit or WIRE_FIT

    def t_us(dt, seg):
        b = a2a_wire_bytes(n_ranks, max_tokens, hidden, topk, dt)
        return fit[seg]["t0_us"] + b / (fit[seg]["gb_per_s"] * 1e3)

    return None if t_us(None, "bf16") <= t_us(fp8_dtype, "fp8") else fp8_dtype


def expected_capacity(n_ranks: int, max_tokens: int, topk: int,
                      headroom: float = 2.0, wire_dtype=None) -> int:
    """A slot budget for the expected load (``max_tokens * topk / n`` a
    peer, times ``headroom``), rounded to the wire's row tile and never
    above the drop-proof capacity."""
    cap = max(1, int(max_tokens * topk * headroom / max(n_ranks, 1)))
    itemsize = wire_dtype.itemsize if wire_dtype is not None else 2
    return min(_cap_round(cap, itemsize),
               _cap_round(max_tokens * topk, itemsize))


def create_all_to_all_context(ctx, max_tokens: int, hidden: int, topk: int,
                              num_experts: int, capacity: int | None = None,
                              axis: str | None = None, dtype=torch.bfloat16,
                              wire_dtype=None, wire_fit: dict | None = None,
                              quant_edge: str = "fused",
                              dequant_edge: str = "post",
                              expert_major: bool = False,
                              seg_push: int = 0) -> EpAllToAllContext:
    """The reference's ``create_all_to_all_context`` over one axis (the
    2-tier context over two is ``create_all_to_all_context_2d``).
    ``wire_dtype="auto"`` resolves through ``pick_wire_dtype``. Under
    ``expert_major`` the capacity is split evenly over the rank's local
    experts, each budget rounded to the wire's row tile, and ``capacity``
    becomes their sum."""
    axis = axis or ctx.axis_names[0]
    if not isinstance(axis, str):
        raise ValueError(f"create_all_to_all_context takes one axis; the "
                         f"2-tier context over {tuple(axis)} is "
                         f"create_all_to_all_context_2d")
    n = ctx.axis_size(axis)
    if isinstance(wire_dtype, str):
        if wire_dtype != "auto":
            raise ValueError(f"wire_dtype {wire_dtype!r}: None, 'auto' or "
                             f"a dtype")
        wire_dtype = pick_wire_dtype(n, max_tokens, hidden, topk,
                                     wire_fit=wire_fit)
    if num_experts % n:
        raise ValueError(f"{num_experts} experts do not split over {n} "
                         f"ranks")
    if quant_edge not in ("pre", "fused", "kernel"):
        raise ValueError(f"quant_edge {quant_edge!r}")
    if dequant_edge not in ("kernel", "post", "expert"):
        raise ValueError(f"dequant_edge {dequant_edge!r}")
    if wire_dtype is not None and wire_dtype not in WIRE_TYPES:
        raise TypeError(f"wire_dtype {wire_dtype}: fp8 e4m3fn or int8")
    if capacity is None:
        capacity = max_tokens * topk
    itemsize = (wire_dtype or dtype).itemsize
    capacity = _cap_round(capacity, itemsize)
    if expert_major:
        epr = num_experts // n
        capacity = _cap_round(-(-capacity // epr), itemsize) * epr
    if hidden % 128:
        raise ValueError(f"hidden={hidden} must be a multiple of 128")
    return EpAllToAllContext(ctx=ctx, axis=axis, max_tokens=max_tokens,
                             hidden=hidden, topk=topk,
                             num_experts=num_experts, capacity=capacity,
                             dtype=dtype, wire_dtype=wire_dtype,
                             quant_edge=quant_edge,
                             dequant_edge=dequant_edge,
                             expert_major=bool(expert_major),
                             seg_push=int(seg_push))


def route_tokens(a2a: EpAllToAllContext, topk_ids):
    """The static-shape routing of ``topk_ids`` [..., T, k] (one rank's, or
    every rank's stacked on a leading dim): (dest, slot, valid), each
    [..., T, k]; ``slot`` is the row's place in the capacity-padded slot
    run to rank ``dest``, counted per source rank. Under ``expert_major``
    the slots are counted per global expert, ``capacity_per_expert`` of
    them each, and a row's slot is ``local_expert * cap_e +
    rank_in_group``. A numpy array is taken as a CPU tensor (the host twin
    ``csrc/a2a_route.cc`` is not ported)."""
    if isinstance(topk_ids, np.ndarray):
        topk_ids = torch.from_numpy(np.ascontiguousarray(topk_ids))
    T, k = topk_ids.shape[-2:]
    lead = tuple(topk_ids.shape[:-2])
    epr = a2a.experts_per_rank
    dest = (topk_ids // epr).to(torch.int32)
    flat = topk_ids.reshape(lead + (T * k,))
    if a2a.expert_major:
        cap_e = a2a.capacity_per_expert
        r, valid = _slot_assign(flat, a2a.num_experts, cap_e)
        slot = ((flat % epr) * cap_e + r).to(torch.int32)
    else:
        slot, valid = _slot_assign(dest.reshape(lead + (T * k,)),
                                   a2a.n_ranks, a2a.capacity)
    return dest, slot.view(lead + (T, k)), valid.view(lead + (T, k))


def _a2a_push_fn(a2a: EpAllToAllContext):
    """The wire of this context: B21, or with ``seg_push >= 2`` B22 in that
    many segments (bitwise the same outputs)."""
    if a2a.seg_push >= 2:
        return functools.partial(all_to_all_push_seg, segments=a2a.seg_push)
    return all_to_all_push


def dispatch(a2a: EpAllToAllContext, tokens, topk_ids):
    """EP dispatch: ``tokens`` [n * T, H] and ``topk_ids`` [n * T, k] of
    every rank (rank-major). Returns (recv_tokens [n * n, cap, H] in the
    context's type, recv_ids [n * n, cap] int32, layout): row ``d * n + s``
    holds the slots rank d received from rank s, ``recv_ids`` their local
    expert (-1 in an empty slot); ``layout`` goes to ``combine``. Under
    ``dequant_edge="expert"`` recv_tokens is ``QuantTokens`` (the wire's
    rows and their scales [n * n, cap])."""
    ctx, axis = a2a.ctx, a2a.axis
    n, cap, H, k = a2a.n_ranks, a2a.capacity, a2a.hidden, a2a.topk
    T = a2a.max_tokens
    if tuple(tokens.shape) != (n * T, H) or tuple(topk_ids.shape) != (n * T, k):
        raise ValueError(f"dispatch: tokens {tuple(tokens.shape)} and ids "
                         f"{tuple(topk_ids.shape)} against ({n}*{T}, {H}) "
                         f"and ({n}*{T}, {k})")
    dev = tokens.device
    cols = _id_cols(cap)
    wire = a2a.wire_dtype
    kq = wire is not None and a2a.quant_edge == "kernel"
    ids = topk_ids.view(n, T, k)
    dest, slot, valid = route_tokens(a2a, ids)
    d_f, s_f, v_f = (x.reshape(n, T * k) for x in (dest, slot, valid))
    s_drop = torch.where(v_f, s_f, torch.full_like(s_f, cap))
    local_eid = (ids % a2a.experts_per_rank).reshape(n, T * k)
    src = _slot_src_map(d_f, s_drop, torch.arange(T * k, device=dev) // k,
                        n, cap, T)                            # [n, n, cap]
    # every rank's source rows are its block of the global tokens
    src_g = torch.where(src < T, src + (torch.arange(n, device=dev) * T)
                        .view(n, 1, 1).to(torch.int32),
                        torch.full_like(src, n * T))
    if wire is not None and a2a.quant_edge == "pre":
        send_buf, send_sc = _slot_gather_prequant(tokens, src_g, wire, cap)
    elif wire is not None and not kq:
        send_buf, sc = _slot_gather_quant(tokens, src_g, wire)
        send_sc = _scale_wire(sc, cap)
    else:
        send_buf = _slot_gather(tokens, src_g, a2a.dtype)
    send_ids = torch.full((n, n * (cols + 1)), -1, dtype=torch.int32,
                          device=dev)
    send_ids.scatter_(1, d_f.long() * (cols + 1) + s_drop.long(),
                      local_eid.to(torch.int32))
    send_ids = send_ids.view(n, n, cols + 1)[..., :cols].reshape(
        n * n, cols // 128, 128).contiguous()
    send_buf = send_buf.reshape(n * n, cap, H)
    push = _a2a_push_fn(a2a)
    if wire is not None and a2a.dequant_edge == "expert":
        # no dequantise: the rows stay in the wire's type and their scales
        # ride beside them to the expert GEMMs' row_scale
        sc_arg = () if kq else (
            send_sc.reshape(n * n, cols // 128, 128).contiguous(),)
        recv_q, recv_ids_wire, recv_sc = push(
            ctx, send_buf, send_ids, *sc_arg, axis=axis,
            quant_from=wire if kq else None)
        recv_tokens = QuantTokens(
            recv_q, recv_sc.reshape(n * n, -1)[:, :cap].contiguous())
    elif wire is not None:
        if kq:
            recv_tokens, recv_ids_wire, _ = push(
                ctx, send_buf, send_ids, axis=axis, quant_from=wire,
                dequant_to=a2a.dtype, fuse_dequant=a2a._dequant_in_kernel())
        else:
            recv_tokens, recv_ids_wire, _ = push(
                ctx, send_buf, send_ids,
                send_sc.reshape(n * n, cols // 128, 128).contiguous(),
                axis=axis, dequant_to=a2a.dtype,
                fuse_dequant=a2a._dequant_in_kernel())
    else:
        recv_tokens, recv_ids_wire = push(ctx, send_buf, send_ids, axis=axis)
    recv_ids = recv_ids_wire.reshape(n * n, cols)[:, :cap]
    layout = (dest.reshape(n * T, k), slot.reshape(n * T, k),
              valid.reshape(n * T, k))
    return recv_tokens, recv_ids, layout


def combine(a2a: EpAllToAllContext, processed, layout, topk_weights):
    """EP combine: ``processed`` [n * n, cap, H] (row ``d * n + s``: rank
    d's results for rank s's slots) goes back to the source ranks, quantised
    on the way when the wire is (in B21, per departure slot), and each
    token's k rows are weighted by ``topk_weights`` [n * T, k] (f32) and
    summed in k order in f32, cast once to the context's type: [n * T, H].
    Under ``dequant_edge="expert"`` the rows arrive quantised and the fold
    multiplies each by its scale first."""
    ctx, axis = a2a.ctx, a2a.axis
    n, cap, H, k = a2a.n_ranks, a2a.capacity, a2a.hidden, a2a.topk
    wire = a2a.wire_dtype
    push = _a2a_push_fn(a2a)
    scale = None
    if wire is not None and a2a.dequant_edge == "expert":
        # the return trip stays quantised: each row's scale is gathered
        # with it in the fold and multiplies it in f32 there
        back, back_sc = push(ctx, processed, axis=axis, quant_from=wire)
        scale = back_sc.reshape(n * n, -1)[:, :cap].reshape(-1).contiguous()
    elif wire is not None:
        back, _ = push(ctx, processed, axis=axis, quant_from=wire,
                       dequant_to=a2a.dtype,
                       fuse_dequant=a2a._dequant_in_kernel())
    else:
        (back,) = push(ctx, processed, axis=axis)
    dest, slot, valid = layout
    T = dest.shape[0] // n
    dev = processed.device
    # the fold of every rank's tokens: row src * n * cap + d * cap + slot
    base = (torch.arange(n, device=dev) * (n * cap)).repeat_interleave(T)
    pos = torch.where(valid, base[:, None] + dest.long() * cap + slot.long(),
                      torch.full_like(slot, -1, dtype=torch.long))
    return ep_combine(back.reshape(n * n * cap, H).contiguous(),
                      pos.reshape(-1).to(torch.int32).contiguous(),
                      topk_weights.float().contiguous(), scale=scale,
                      out_dtype=a2a.dtype)


# ---------------------------------------------------------------------------
# the 2-tier EP all-to-all over a (major, minor) pair of axes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ep2dAllToAllContext:
    """The 2-tier EP all-to-all over the axes (major, minor) (the
    reference's context of the same name): tier 1 carries each row over
    the major axis to the rank of its expert's major coordinate (``cap1``
    slots per (src, dst) pair), tier 2 re-slots what arrived over the minor
    axis to the expert's rank (``cap2`` slots). Experts are sharded over
    the ranks in the order of the flattened (major, minor) coordinate. A
    quantised wire (``wire_dtype``) quantises each row once at its source;
    its scale rides both tiers with the same slot maps and nothing is
    requantised at the hop. ``quant_edge`` "pre" or "fused";
    ``dequant_edge`` "post", "kernel" (tier 2's arrivals) or "expert"
    (``QuantTokens`` out)."""
    ctx: object
    axes: tuple
    max_tokens: int
    hidden: int
    topk: int
    num_experts: int
    cap1: int
    cap2: int
    dtype: torch.dtype = torch.bfloat16
    wire_dtype: torch.dtype | None = None
    quant_edge: str = "fused"
    dequant_edge: str = "post"

    def _dequant_in_kernel(self) -> bool:
        return self.dequant_edge == "kernel"

    @property
    def n_major(self) -> int:
        return self.ctx.axis_size(self.axes[0])

    @property
    def n_minor(self) -> int:
        return self.ctx.axis_size(self.axes[1])

    @property
    def n_ranks(self) -> int:
        return self.n_major * self.n_minor

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.n_ranks


def create_all_to_all_context_2d(ctx, max_tokens: int, hidden: int,
                                 topk: int, num_experts: int, axes=None,
                                 cap1: int | None = None,
                                 cap2: int | None = None,
                                 dtype=torch.bfloat16, wire_dtype=None,
                                 quant_edge: str = "fused",
                                 dequant_edge: str = "post"
                                 ) -> Ep2dAllToAllContext:
    """The reference's ``create_all_to_all_context_2d``: ``cap1`` defaults
    to the drop-proof ``max_tokens * topk`` and ``cap2`` to ``n_major *
    cap1``, each rounded to the wire's row tile."""
    axes = tuple(axes or ctx.axis_names[:2])
    if len(axes) != 2:
        raise ValueError(f"the 2-tier EP all-to-all takes (major, minor), "
                         f"got {axes}")
    n = ctx.axis_size(axes)
    if num_experts % n:
        raise ValueError(f"{num_experts} experts do not split over {n} "
                         f"ranks")
    if quant_edge not in ("pre", "fused"):
        raise ValueError(f"quant_edge {quant_edge!r}: the 2-tier wire "
                         f"quantises at the source (pre or fused)")
    if dequant_edge not in ("kernel", "post", "expert"):
        raise ValueError(f"dequant_edge {dequant_edge!r}")
    if wire_dtype is not None and wire_dtype not in WIRE_TYPES:
        raise TypeError(f"wire_dtype {wire_dtype}: fp8 e4m3fn or int8")
    if hidden % 128:
        raise ValueError(f"hidden={hidden} must be a multiple of 128")
    itemsize = (wire_dtype or dtype).itemsize
    cap1 = _cap_round(max_tokens * topk if cap1 is None else cap1, itemsize)
    cap2 = _cap_round(ctx.axis_size(axes[0]) * cap1 if cap2 is None
                      else cap2, itemsize)
    return Ep2dAllToAllContext(ctx=ctx, axes=axes, max_tokens=max_tokens,
                               hidden=hidden, topk=topk,
                               num_experts=num_experts, cap1=cap1, cap2=cap2,
                               dtype=dtype, wire_dtype=wire_dtype,
                               quant_edge=quant_edge,
                               dequant_edge=dequant_edge)


def route_tokens_2d(a2a: Ep2dAllToAllContext, topk_ids):
    """Tier 1's routing plan of ``topk_ids`` [..., T, k] (global expert
    ids; one rank's or every rank's stacked): (major destination, slot,
    valid), each [..., T, k], slots counted per source rank. Tier 2's plan
    re-slots what arrives, so only ``dispatch_2d`` makes it."""
    if isinstance(topk_ids, np.ndarray):
        topk_ids = torch.from_numpy(np.ascontiguousarray(topk_ids))
    T, k = topk_ids.shape[-2:]
    lead = tuple(topk_ids.shape[:-2])
    a_dst = (topk_ids // a2a.experts_per_rank // a2a.n_minor).to(torch.int32)
    slot, ok = _slot_assign(a_dst.reshape(lead + (T * k,)), a2a.n_major,
                            a2a.cap1)
    return a_dst, slot.view(lead + (T, k)), ok.view(lead + (T, k))


def _meta(dst, slot_drop, values, n_dst: int, cols: int):
    """An int32 id wire [..., n_dst, cols // 128, 128]: ``values`` at
    (``dst``, ``slot_drop``), -1 elsewhere (a dropped row's slot, ``cols``
    or less, lands in a column cut off)."""
    lead = tuple(dst.shape[:-1])
    out = torch.full(lead + (n_dst * (cols + 1),), -1, dtype=torch.int32,
                     device=dst.device)
    out.scatter_(-1, dst.long() * (cols + 1) + slot_drop.long(),
                 values.to(torch.int32))
    return out.view(lead + (n_dst, cols + 1))[..., :cols].reshape(
        lead + (n_dst, cols // 128, 128)).contiguous()


def _offsets(n: int, rows: int, device):
    """Each rank's first global row, [n, 1] int32, for per-rank indices."""
    return (torch.arange(n, device=device) * rows).view(n, 1).to(torch.int32)


def dispatch_2d(a2a: Ep2dAllToAllContext, tokens, topk_ids):
    """2-tier EP dispatch: ``tokens`` [n * T, H] and ``topk_ids`` [n * T,
    k] (global expert ids) of every rank, in the order of the flattened
    (major, minor) coordinate. Tier 1 is B21 over the major axis, tier 2
    B21 over the minor axis, every rank's data its own (``over=axes``).
    Returns (recv_tokens [n * n_minor, cap2, H] (``QuantTokens`` under
    ``dequant_edge="expert"``), recv_ids [n * n_minor, cap2] (local expert,
    -1 in an empty slot), layouts for ``combine_2d``: tier 1's (a_dst,
    slot, ok) [n * T * k] and tier 2's (b_dst, slot, ok) [n * n_major *
    cap1])."""
    ctx = a2a.ctx
    major, minor = a2a.axes
    nM, nm, n = a2a.n_major, a2a.n_minor, a2a.n_ranks
    epr = a2a.experts_per_rank
    T, H, k = a2a.max_tokens, a2a.hidden, a2a.topk
    cap1, cap2 = a2a.cap1, a2a.cap2
    c1, c2 = _id_cols(cap1), _id_cols(cap2)
    wire = a2a.wire_dtype
    if tuple(tokens.shape) != (n * T, H) or tuple(topk_ids.shape) != (n * T, k):
        raise ValueError(f"dispatch_2d: tokens {tuple(tokens.shape)} and "
                         f"ids {tuple(topk_ids.shape)} against ({n}*{T}, "
                         f"{H}) and ({n}*{T}, {k})")
    dev = tokens.device
    over = tuple(a2a.axes)
    # tier 1: every row to the rank of its expert's major coordinate
    eid = topk_ids.view(n, T * k).to(torch.int32)
    a_dst = eid // epr // nm
    slot1, ok1 = _slot_assign(a_dst, nM, cap1)
    s1_drop = torch.where(ok1, slot1, torch.full_like(slot1, cap1))
    src = _slot_src_map(a_dst, s1_drop, torch.arange(T * k, device=dev) // k,
                        nM, cap1, T)
    src_g = torch.where(src < T, src + _offsets(n, T, dev).view(n, 1, 1),
                        torch.full_like(src, n * T))
    if wire is not None and a2a.quant_edge == "pre":
        send, send_sc = _slot_gather_prequant(tokens, src_g, wire, cap1)
        scs = (send_sc.reshape(n * nM, c1 // 128, 128).contiguous(),)
    elif wire is not None:
        send, sc = _slot_gather_quant(tokens, src_g, wire)
        scs = (_scale_wire(sc, cap1).reshape(n * nM, c1 // 128, 128)
               .contiguous(),)
    else:
        send = _slot_gather(tokens, src_g, a2a.dtype)
        scs = ()
    meta1 = _meta(a_dst, s1_drop, eid, nM, c1).reshape(n * nM, c1 // 128,
                                                       128)
    recv1, meta1r, *sc1r = all_to_all_push(
        ctx, send.reshape(n * nM, cap1, H), meta1, *scs, axis=major,
        over=over)
    # tier 2: the arrivals re-slotted to their expert's minor coordinate
    R = nM * cap1
    meta = meta1r.view(n, nM, c1)[..., :cap1].reshape(n, R)
    valid = meta >= 0
    b_dst = (torch.where(valid, meta, torch.zeros_like(meta)) // epr) % nm
    slot2, ok2 = _slot_assign(b_dst, nm, cap2, valid)
    s2_drop = torch.where(ok2, slot2, torch.full_like(slot2, cap2))
    src2 = _slot_src_map(b_dst, s2_drop, torch.arange(R, device=dev), nm,
                         cap2, R)
    src2_g = torch.where(src2 < R, src2 + _offsets(n, R, dev).view(n, 1, 1),
                         torch.full_like(src2, n * R))
    send2 = _slot_gather(recv1.reshape(n * R, H), src2_g,
                         wire if wire is not None else a2a.dtype)
    meta2 = _meta(b_dst, s2_drop, meta, nm, c2).reshape(n * nm, c2 // 128,
                                                        128)
    scs2 = ()
    if wire is not None:
        s1 = sc1r[0].view(n, nM, c1)[..., :cap1].reshape(n * R)
        flat = src2_g.reshape(-1).long()
        sc2 = torch.where(flat < n * R, s1[flat.clamp(max=n * R - 1)],
                          torch.ones((), device=dev)).view(n, nm, cap2)
        scs2 = (_scale_wire(sc2, cap2).reshape(n * nm, c2 // 128, 128)
                .contiguous(),)
    if wire is not None and a2a.dequant_edge == "expert":
        recv2, meta2r, sc2w = all_to_all_push(
            ctx, send2.reshape(n * nm, cap2, H), meta2, *scs2, axis=minor,
            over=over)
        recv2 = QuantTokens(recv2, sc2w.reshape(n * nm, -1)[:, :cap2]
                            .contiguous())
    else:
        recv2, meta2r, *_ = all_to_all_push(
            ctx, send2.reshape(n * nm, cap2, H), meta2, *scs2, axis=minor,
            over=over, dequant_to=a2a.dtype if wire is not None else None,
            fuse_dequant=a2a._dequant_in_kernel())
    m2 = meta2r.reshape(n * nm, c2)[:, :cap2]
    recv_ids = torch.where(m2 >= 0, m2 % epr, torch.full_like(m2, -1))
    layouts = ((a_dst.reshape(-1), slot1.reshape(-1), ok1.reshape(-1)),
               (b_dst.reshape(-1), slot2.reshape(-1), ok2.reshape(-1)))
    return recv2, recv_ids, layouts


def combine_2d(a2a: Ep2dAllToAllContext, processed, layouts, topk_weights):
    """The way back of ``dispatch_2d``: ``processed`` [n * n_minor, cap2,
    H] over the minor axis (quantised once, in B21 per departure slot, on a
    quantised wire), re-gathered into tier 1's slots, over the major axis,
    then each token's k rows weighted by ``topk_weights`` [n * T, k] and
    summed in k order in f32 (a quantised row times its scale first), cast
    once to the context's type: [n * T, H]."""
    ctx = a2a.ctx
    major, minor = a2a.axes
    nM, nm, n = a2a.n_major, a2a.n_minor, a2a.n_ranks
    T, H, k = a2a.max_tokens, a2a.hidden, a2a.topk
    cap1, cap2 = a2a.cap1, a2a.cap2
    c1 = _id_cols(cap1)
    (a_dst, slot1, ok1), (b_dst, slot2, ok2) = layouts
    wire = a2a.wire_dtype
    over = tuple(a2a.axes)
    dev = processed.device
    R = nM * cap1
    if wire is not None:
        back2, b2sc = all_to_all_push(ctx, processed, axis=minor,
                                      quant_from=wire, over=over)
    else:
        (back2,) = all_to_all_push(ctx, processed, axis=minor, over=over)
    # each tier-1 slot's row back from its tier-2 slot
    pos2 = (_offsets(n, nm * cap2, dev) + (b_dst.view(n, R) * cap2
                                           + slot2.view(n, R))).reshape(-1)
    ok2 = ok2.reshape(-1)
    mid = ep_dispatch(back2.reshape(n * nm * cap2, H),
                      torch.where(ok2, pos2, torch.zeros_like(pos2))
                      .contiguous(), ok2.contiguous(), 1)
    scs = ()
    if wire is not None:
        s2 = b2sc.reshape(n * nm, -1)[:, :cap2].reshape(-1)
        sv = torch.where(ok2, s2[torch.where(ok2, pos2, 0).long()],
                         torch.ones((), device=dev)).view(n, nM, cap1)
        scs = (_scale_wire(sv, cap1).reshape(n * nM, c1 // 128, 128)
               .contiguous(),)
    back1, *b1sc = all_to_all_push(ctx, mid.view(n * nM, cap1, H), *scs,
                                   axis=major, over=over)
    ok1 = ok1.view(n, T * k)
    pos1 = _offsets(n, R, dev) + a_dst.view(n, T * k) * cap1 \
        + slot1.view(n, T * k)
    pos1 = torch.where(ok1, pos1, torch.full_like(pos1, -1))
    scale = None
    if wire is not None:
        scale = b1sc[0].reshape(n * nM, c1)[:, :cap1].reshape(-1) \
            .contiguous()
    return ep_combine(back1.reshape(n * R, H).contiguous(),
                      pos1.reshape(-1).to(torch.int32).contiguous(),
                      topk_weights.float().contiguous(), scale=scale,
                      out_dtype=a2a.dtype)


__all__ = ["Ep2dAllToAllContext", "EpAllToAllContext",
           "QuantTokens", "WIRE_FIT", "WIRE_TYPES", "a2a_wire_bytes",
           "all_to_all_push", "all_to_all_push_plain",
           "all_to_all_push_seg", "combine", "combine_2d",
           "create_all_to_all_context", "create_all_to_all_context_2d",
           "dispatch", "dispatch_2d", "ep_combine", "ep_combine_plain",
           "ep_dispatch", "ep_dispatch_plain", "expected_capacity",
           "pick_wire_dtype", "route_tokens", "route_tokens_2d"]
