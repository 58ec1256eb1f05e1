"""Ring attention: causal GQA flash attention over a sequence sharded on a
ring of ranks (context parallelism), forward and backward.

Counterpart of ``triton_dist_tpu/ops/ring_attention.py``: the TPU kernels
``_ring_fwd_kernel`` (``ring_attention_fwd``) and ``_ring_bwd_kernel``
(``ring_attention_bwd``). On a CUDA tensor the wrappers launch the
hand-written Hopper kernels of ``csrc/ring_attention.cu``: with no context
(``ctx=None``) or a ring of one rank, the one-rank kernels over the whole
sequence; across ranks, one cooperative launch a call that covers every rank
of the mesh on the card, the K||V blocks travelling the ring through the
shmem layer's puts and counted signals, and in the backward each block's
f32 dk||dv accumulator travelling home with it. On a CPU tensor they run
``ring_attention_fwd_plain`` and ``ring_attention_bwd_plain``: the same
function on the global sequence in dense masked-matrix form, with the same
prescale and rounding points.

The global view, as the port's other collectives take it: q ``[B, Hq, S,
D]``, k/v ``[B, Hkv, S, D]``, lse ``[B, Hq, S]`` f32 in the natural-log
domain, S the global sequence, sharded rank-major on S over the ring's
``axis`` (rank r of the ring holds rows ``[r S/n, (r+1) S/n)``), and in
zigzag order when ``layout="zigzag"`` (rank r holds chunks r and 2n-1-r of
S/(2n) rows; ``zigzag_indices`` gives the permutation). ``batch_axis`` and
``head_axis`` shard B and the heads over other axes of the mesh, so each
(batch, head) shard has a ring of its own, as ``parallel/train.py`` asks.
The softmax runs in base 2: q is prescaled by ``sm_scale * log2(e)`` in f32
and rounded to its type, as the JAX wrapper does outside its
``pallas_call``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.shmem import device as shd

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
HEAD_DIM = 128                     # a head dim is a multiple of it (a lane)
KERNEL_HEAD_DIMS = (128, 256)      # the head dims the kernels are built for
TILE = 64                          # the kernels' rows of a query or key tile
LAYOUTS = ("contiguous", "zigzag")

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = {torch.float32: "tdt_ring_attention_fwd_f32",
        torch.bfloat16: "tdt_ring_attention_fwd_bf16"}
_BWD = {torch.float32: "tdt_ring_attention_bwd_f32",
        torch.bfloat16: "tdt_ring_attention_bwd_bf16"}
_FWD_RANKS = {torch.float32: "tdt_ring_fwd_ranks_f32",
              torch.bfloat16: "tdt_ring_fwd_ranks_bf16"}
_BWD_RANKS = {torch.float32: "tdt_ring_bwd_ranks_f32",
              torch.bfloat16: "tdt_ring_bwd_ranks_bf16"}
_RING_HEAD = [_P, _I, _P, _P]           # tables n shape strides
_SIGNATURES = {
    # q k v out lse | B Hq Hkv S D causal | stream
    **{n: [_P] * 5 + [_I] * 6 + [_P] for n in _FWD.values()},
    # q k v o lse do delta dq dk dv | B Hq Hkv S D causal | scale stream
    **{n: [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P] for n in _BWD.values()},
    # ... D lanes group silent | claim report budget stream
    **{n: _RING_HEAD + [_I, _I, _P, _I] + shd.LAUNCH_SIG
       for n in _FWD_RANKS.values()},
    # ... D scale o do delta rows lanes group silent | launch
    **{n: _RING_HEAD + [_I, ctypes.c_float, _P, _P, _P, _I, _I, _P, _I]
       + shd.LAUNCH_SIG for n in _BWD_RANKS.values()},
}


def _lib():
    return csrc.load("ring_attention", _SIGNATURES)


def _scale(sm_scale, D: int) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)


def _prescale(q, scale: float):
    """q * (sm_scale * log2 e) in f32, rounded to q's type."""
    return (q.float() * (scale * LOG2E)).to(q.dtype)


def _axis_size(ctx, axis) -> int:
    if axis is None:
        return 1
    if not isinstance(axis, str) or axis not in ctx.axis_names:
        raise ValueError(f"ring attention: {axis!r} is not an axis of the "
                         f"mesh {tuple(ctx.axis_names)}")
    return ctx.axis_size(axis)


def _ring_size(ctx, q, k, v, axis=None, batch_axis=None, head_axis=None,
              layout: str = "contiguous") -> int:
    """The ring's rank count n after the reference's shape checks: one
    axis; S divisible by n (by 2n for zigzag); the batch axis dividing B;
    the head axis dividing Hq and Hkv; Hq a multiple of Hkv in each shard.
    ``ctx=None`` is one rank. Raises ``ValueError``."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    B, Hq, S, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    if (S, D) != (Sk, Dk) or v.shape != k.shape or k.shape[0] != B:
        raise ValueError(f"ring attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if ctx is None:
        n, nb, nh = 1, 1, 1
    else:
        if axis is None:
            axis = ctx.axis_names[0]
        if not isinstance(axis, str):
            raise ValueError(f"ring attention rings one axis, got {axis!r}")
        n = _axis_size(ctx, axis)
        nb, nh = _axis_size(ctx, batch_axis), _axis_size(ctx, head_axis)
        named = [a for a in (axis, batch_axis, head_axis) if a]
        if len(set(named)) != len(named):
            raise ValueError(f"ring attention: axis {axis!r}, batch_axis "
                             f"{batch_axis!r} and head_axis {head_axis!r} "
                             f"must differ")
    if D % HEAD_DIM:
        raise ValueError(f"ring attention: head dim {D} must be a multiple "
                         f"of {HEAD_DIM}")
    if S % n:
        raise ValueError(f"ring attention needs S divisible by ranks: S={S}, "
                         f"ranks={n}")
    if layout == "zigzag" and S % (2 * n):
        raise ValueError(f"zigzag ring attention needs S divisible by "
                         f"2*ranks: S={S}, ranks={n}")
    if B % nb:
        raise ValueError(f"batch axis of {nb} ranks does not divide B={B}")
    if Hq % nh or Hkv % nh:
        raise ValueError(f"head axis of {nh} ranks must divide Hq={Hq} and "
                         f"Hkv={Hkv}")
    if (Hq // nh) % (Hkv // nh):
        raise ValueError(f"per-shard GQA needs Hq % Hkv == 0, got "
                         f"{Hq // nh}/{Hkv // nh}")
    return n


def _natural(x, S: int, n: int, layout: str):
    """x [..., S, ...] on dim 2 from the layout's order to the natural one."""
    if layout != "zigzag" or n == 1:
        return x
    _, inv = zigzag_indices(S, n)
    return x[:, :, torch.as_tensor(inv, device=x.device)]


def _laid_out(x, S: int, n: int, layout: str):
    """The inverse of ``_natural``."""
    if layout != "zigzag" or n == 1:
        return x
    idx, _ = zigzag_indices(S, n)
    return x[:, :, torch.as_tensor(idx, device=x.device)]


def _keep(S: int, causal: bool, device):
    """[S, S] bool mask of the (query, key) pairs that count, or None."""
    if not causal:
        return None
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def ring_attention_fwd_plain(q, k, v, causal: bool = True,
                             sm_scale: float | None = None,
                             layout: str = "contiguous", n: int = 1):
    """The plain PyTorch version of ``ring_attention_fwd`` over a ring of
    ``n`` ranks: the global sequence taken out of the layout's order,
    base-2 softmax over the whole masked score matrix, p cast to v's type
    before P.V, ``lse = (m + log2 l) * ln2`` (a row with no valid key gives
    zeros and ``lse = NEG_INF``), and the results put back in the layout's
    order."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    q, k, v = (_natural(x, S, n, layout) for x in (q, k, v))
    qp = _prescale(q, _scale(sm_scale, D)).float().view(B, Hkv, G, S, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qp, k.float())
    keep = _keep(S, causal, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = (acc / safe).to(q.dtype).reshape(B, Hq, S, D)
    lse = torch.where(l > 0, LN2 * (m + torch.log2(safe)),
                      torch.full_like(l, NEG_INF)).reshape(B, Hq, S)
    return (_laid_out(out, S, n, layout),
            _laid_out(lse[..., None], S, n, layout)[..., 0])


def ring_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                             sm_scale: float | None = None,
                             layout: str = "contiguous", n: int = 1):
    """The plain PyTorch version of ``ring_attention_bwd`` over a ring of
    ``n`` ranks, on the global sequence in its natural order: p recomputed
    as ``exp2(s - lse * log2 e)``, ``delta = rowsum(do * o)`` and ``dS = p *
    (dp - delta)`` in f32; dS and p rounded to the input type before their
    products; ``dq = dS.k * scale``, ``dk = dS^T.q_pre * ln2`` (ln2 cancels
    the prescale's log2 e), ``dv = p^T.do``."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    q, k, v, o, do = (_natural(x, S, n, layout) for x in (q, k, v, o, do))
    lse = _natural(lse[..., None], S, n, layout)[..., 0]
    scale = _scale(sm_scale, D)
    qp = _prescale(q, scale).float().view(B, Hkv, G, S, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qp, k.float())
    p = torch.exp2(s - lse.view(B, Hkv, G, S, 1) * LOG2E)
    keep = _keep(S, causal, q.device)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dof = do.float().view(B, Hkv, G, S, D)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    delta = (dof * o.float().view(B, Hkv, G, S, D)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds.to(q.dtype).float(), qp) * LN2
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(do.dtype).float(), dof)
    return tuple(_laid_out(x, S, n, layout)
                 for x in (dq.to(q.dtype).reshape(B, Hq, S, D),
                           dk.to(k.dtype), dv.to(v.dtype)))


def _check_kernel_args(name: str, q, k, v, *rest) -> None:
    """What the kernels take: one CUDA device, bf16 or f32 throughout (lse
    f32), contiguous, D in KERNEL_HEAD_DIMS, Hq a multiple of Hkv, 16-byte
    aligned."""
    tensors = (q, k, v, *rest)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device")
    B, Hq, S, D = q.shape
    if q.dtype not in _FWD or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share a type in {list(_FWD)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if (k.dim() != 4 or k.shape[0] != B or k.shape[2:] != (S, D)
            or v.shape != k.shape or Hq % k.shape[1] or S < 1):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (the "
                         f"kernels take Hq % Hkv == 0)")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernels are built for head dims "
                         f"{KERNEL_HEAD_DIMS}, got {D} (the plain version "
                         f"takes any multiple of {HEAD_DIM})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _check_grad_args(q, o, lse, do) -> None:
    B, Hq, S, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, Hq, S) \
            or o.dtype != q.dtype or do.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise ValueError("ring_attention_bwd: o and do must match q, lse "
                         "must be [B, Hq, S] f32")


class _Ring:
    """One call's ring over every rank of ``ctx``: each rank's shard
    offsets (elements) into the global tensors, the kernels' shape and
    strides, and the ring's Group."""

    def __init__(self, ctx, q, k, axis, batch_axis, head_axis, layout):
        B, Hq, S, D = q.shape
        Hkv = k.shape[1]
        self.axis = axis
        self.n = ctx.axis_size(axis)
        nb = _axis_size(ctx, batch_axis)
        nh = _axis_size(ctx, head_axis)
        Bl, Hql, Hkvl, Sl = B // nb, Hq // nh, Hkv // nh, S // self.n
        zigzag = layout == "zigzag"
        if zigzag and (Sl // 2) % TILE:
            raise ValueError(f"zigzag ring attention on the card needs a "
                             f"chunk of S/(2n) = {Sl // 2} rows to be a "
                             f"multiple of the {TILE}-row tile")
        self.rows = Bl * Hql, Bl * Hkvl, Sl
        self.dims = (Bl * Hql, Bl * Hkvl, Hql, Hkvl, Sl,
                     Sl // 2 if zigzag else Sl, int(zigzag))
        self.strides = (ctypes.c_longlong * 6)(
            Hq * S * D, S * D, Hkv * S * D, S * D, Hq * S, S)
        self.q_off, self.kv_off, self.r_off = [], [], []
        for r in range(ctx.num_ranks):
            bi = ctx.my_pe(r, batch_axis) * Bl if batch_axis else 0
            hi = ctx.my_pe(r, head_axis) if head_axis else 0
            si = ctx.my_pe(r, axis) * Sl
            self.q_off.append(((bi * Hq + hi * Hql) * S + si) * D)
            self.kv_off.append(((bi * Hkv + hi * Hkvl) * S + si) * D)
            self.r_off.append((bi * Hq + hi * Hql) * S + si)
        self.group = shd.group_plan(ctx, axis)[1]

    def shards(self, t, offsets) -> list[int]:
        """Every rank's address of its shard of the global tensor ``t``."""
        return [t.data_ptr() + o * t.element_size() for o in offsets]

    def shape(self, causal: bool) -> ctypes.Array:
        """The kernels' shape array (``RingShape``'s ints)."""
        return (ctypes.c_int * 8)(*self.dims, int(causal))

    @staticmethod
    def tables(*columns) -> ctypes.Array:
        """The flat pointer array of the kernels' tables, n a table."""
        flat = [p for col in columns for p in col]
        return (ctypes.c_void_p * len(flat))(*flat)


def _fwd_ranks(ctx, ring, qp, k, v, causal, silent_rank):
    """One cooperative launch of the forward ring over every rank."""
    BH, BHkv, Sl = ring.rows
    N = ctx.num_ranks
    out = torch.empty_like(qp)
    lse = torch.empty(qp.shape[:3], dtype=torch.float32, device=qp.device)
    D = qp.shape[3]
    slots = torch.empty(N, 2 * 2 * BHkv * Sl * D, dtype=qp.dtype,
                        device=qp.device)
    state = torch.empty(N, BH * Sl * (D + 2), dtype=torch.float32,
                        device=qp.device)
    lanes = BH * -(-Sl // TILE)
    pad = family_pad(ctx, "ring_attn_fwd", ring.axis, lanes + 3 * ring.n + 1)
    tables = ring.tables(
        ring.shards(qp, ring.q_off), ring.shards(k, ring.kv_off),
        ring.shards(v, ring.kv_off), ring.shards(out, ring.q_off),
        ring.shards(lse, ring.r_off), ctx.peer_table(slots),
        ctx.peer_table(state), ctx.peer_table(pad))
    lib = _lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(qp.device):
        rc = getattr(lib, _FWD_RANKS[qp.dtype])(
            tables, N, ring.shape(causal), ring.strides, D, lanes,
            ctypes.byref(ring.group),
            -1 if silent_rank is None else int(silent_rank), *args)
    csrc.check(lib, rc, "ring_attention_fwd")
    return out, lse


def ring_attention_fwd(ctx, q, k, v, axis=None, causal: bool = True,
                       sm_scale: float | None = None, batch_axis=None,
                       head_axis=None, layout: str = "contiguous",
                       silent_rank: int | None = None):
    """Forward ring attention. ``q`` [B, Hq, S, D], ``k``/``v`` [B, Hkv, S,
    D] in the global view (see the module's doc), the ring over ``axis`` of
    ``ctx`` (None: the mesh's first axis; ``ctx=None``: one rank). Returns
    ``(out [B, Hq, S, D] in q's type, lse [B, Hq, S] f32)`` in the same
    layout.

    A CPU tensor runs the plain version. A CUDA tensor (bf16 or f32, D in
    ``KERNEL_HEAD_DIMS``) launches a kernel or raises: the one-rank kernel on the whole
    sequence when the ring has one rank, else the ring across every rank
    of the mesh. Each launch adds one to ``ring_attention_fwd.launches``,
    each ring launch also to ``ring_attention_fwd.launches_ring``.
    ``silent_rank`` (the ring, on the card) names a rank that never signals
    its puts: the call then raises ``ShmemError`` once the spin budget has
    passed."""
    n = _ring_size(ctx, q, k, v, axis, batch_axis, head_axis, layout)
    if q.device.type == "cpu":
        return ring_attention_fwd_plain(q, k, v, causal, sm_scale, layout, n)
    _check_kernel_args("ring_attention_fwd", q, k, v)
    B, Hq, S, D = q.shape
    qp = _prescale(q, _scale(sm_scale, D))
    if n > 1:
        ring = _Ring(ctx, q, k, axis or ctx.axis_names[0], batch_axis,
                     head_axis, layout)
        out, lse = _fwd_ranks(ctx, ring, qp, k, v, causal, silent_rank)
        ring_attention_fwd.launches_ring += 1
        ring_attention_fwd.launches += 1
        return out, lse
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, S, dtype=torch.float32, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with csrc.current_on(q.device):
        rc = getattr(lib, _FWD[q.dtype])(
            qp.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, k.shape[1], S, D, int(causal), stream)
    csrc.check(lib, rc, "ring_attention_fwd")
    ring_attention_fwd.launches += 1
    return out, lse


ring_attention_fwd.launches = 0
ring_attention_fwd.launches_ring = 0


def _bwd_ranks(ctx, ring, qp, k, v, o, lse, do, causal, scale, silent_rank):
    """The delta pass, then one cooperative launch of the backward ring
    over every rank."""
    BH, BHkv, Sl = ring.rows
    N = ctx.num_ranks
    dev = qp.device
    delta = torch.empty(lse.shape, dtype=torch.float32, device=dev)
    dq, dk, dv = torch.empty_like(qp), torch.empty_like(k), torch.empty_like(v)
    D = qp.shape[3]
    slot = 2 * 2 * BHkv * Sl * D
    slots = torch.empty(N, slot, dtype=qp.dtype, device=dev)
    gslots = torch.empty(N, slot, dtype=torch.float32, device=dev)
    dq_acc = torch.empty(N, BH * Sl * D, dtype=torch.float32,
                         device=dev)
    nt = -(-Sl // TILE)
    lanes = max(BH, BHkv) * nt
    pad = family_pad(ctx, "ring_attn_bwd", ring.axis, lanes + 3 * ring.n + 1)
    tables = ring.tables(
        ring.shards(qp, ring.q_off), ring.shards(k, ring.kv_off),
        ring.shards(v, ring.kv_off), ring.shards(lse, ring.r_off),
        ring.shards(do, ring.q_off), ring.shards(delta, ring.r_off),
        ring.shards(dq, ring.q_off), ring.shards(dk, ring.kv_off),
        ring.shards(dv, ring.kv_off), ctx.peer_table(slots),
        ctx.peer_table(gslots), ctx.peer_table(dq_acc), ctx.peer_table(pad))
    lib = _lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(dev):
        rc = getattr(lib, _BWD_RANKS[qp.dtype])(
            tables, N, ring.shape(causal), ring.strides, D, scale, o.data_ptr(),
            do.data_ptr(), delta.data_ptr(), delta.numel(), lanes,
            ctypes.byref(ring.group),
            -1 if silent_rank is None else int(silent_rank), *args)
    csrc.check(lib, rc, "ring_attention_bwd")
    return dq, dk, dv


def ring_attention_bwd(ctx, q, k, v, o, lse, do, axis=None,
                       causal: bool = True, sm_scale: float | None = None,
                       batch_axis=None, head_axis=None,
                       layout: str = "contiguous",
                       silent_rank: int | None = None):
    """Backward ring attention: ``(dq, dk, dv)`` in the types of q, k, v,
    from the forward's ``o`` and ``lse`` and the output gradient ``do``,
    all in the global view of ``ring_attention_fwd``. On one rank the
    kernel runs three launches (delta, dq, dk||dv); across ranks the delta
    pass and one cooperative launch of the second ring, in which each K||V
    block travels with its f32 dk||dv accumulator and arrives home after a
    full circle. Each output tile is summed in a fixed order, so two calls
    on the same inputs give the same bits.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    or raises; each call adds one to ``ring_attention_bwd.launches``, a
    ring call also to ``ring_attention_bwd.launches_ring``."""
    n = _ring_size(ctx, q, k, v, axis, batch_axis, head_axis, layout)
    if q.device.type == "cpu":
        return ring_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                        sm_scale, layout, n)
    _check_kernel_args("ring_attention_bwd", q, k, v, o, lse, do)
    _check_grad_args(q, o, lse, do)
    B, Hq, S, D = q.shape
    scale = _scale(sm_scale, D)
    qp = _prescale(q, scale)
    if n > 1:
        ring = _Ring(ctx, q, k, axis or ctx.axis_names[0], batch_axis,
                     head_axis, layout)
        grads = _bwd_ranks(ctx, ring, qp, k, v, o, lse, do, causal, scale,
                           silent_rank)
        ring_attention_bwd.launches_ring += 1
        ring_attention_bwd.launches += 1
        return grads
    delta = torch.empty(B, Hq, S, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with csrc.current_on(q.device):
        rc = getattr(lib, _BWD[q.dtype])(
            qp.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, k.shape[1], S, D,
            int(causal), scale, stream)
    csrc.check(lib, rc, "ring_attention_bwd")
    ring_attention_bwd.launches += 1
    return dq, dk, dv


ring_attention_bwd.launches = 0
ring_attention_bwd.launches_ring = 0


class _RingAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves (q, k, v, out, lse), the
    backward is ``ring_attention_bwd``."""

    @staticmethod
    def forward(fctx, q, k, v, ctx, kw):
        out, lse = ring_attention_fwd(ctx, q, k, v, **kw)
        fctx.save_for_backward(q, k, v, out, lse)
        fctx.ring = (ctx, kw)
        return out

    @staticmethod
    def backward(fctx, do):
        q, k, v, out, lse = fctx.saved_tensors
        ctx, kw = fctx.ring
        dq, dk, dv = ring_attention_bwd(ctx, q, k, v, out, lse,
                                        do.contiguous(), **kw)
        return dq, dk, dv, None, None


def ring_attention(ctx, q, k, v, axis=None, causal: bool = True,
                   sm_scale: float | None = None, batch_axis=None,
                   head_axis=None, layout: str = "contiguous"):
    """Differentiable ring attention (the reference's public entry):
    ``out [B, Hq, S, D]`` in the global view, its backward the backward
    ring. ``ctx=None`` is one rank."""
    kw = dict(axis=axis, causal=causal, sm_scale=sm_scale,
              batch_axis=batch_axis, head_axis=head_axis, layout=layout)
    return _RingAttention.apply(q, k, v, ctx, kw)


def zigzag_indices(S: int, n: int):
    """Global row permutation of the zigzag layout: rank r holds chunks
    (r, 2n-1-r) of S/(2n) rows each, concatenated. Returns ``idx`` with
    ``x_zigzag = x[idx]`` and ``inv`` with ``x = x_zigzag[inv]``. At
    ``n = 1`` both are the identity."""
    assert S % (2 * n) == 0, (S, n)
    c = S // (2 * n)
    idx = np.concatenate([
        np.concatenate([np.arange(r * c, (r + 1) * c),
                        np.arange((2 * n - 1 - r) * c, (2 * n - r) * c)])
        for r in range(n)])
    inv = np.argsort(idx)
    return idx, inv


__all__ = ["HEAD_DIM", "KERNEL_HEAD_DIMS", "LAYOUTS", "LN2", "LOG2E", "NEG_INF", "TILE",
           "ring_attention", "ring_attention_bwd", "ring_attention_bwd_plain",
           "ring_attention_fwd", "ring_attention_fwd_plain",
           "zigzag_indices"]
