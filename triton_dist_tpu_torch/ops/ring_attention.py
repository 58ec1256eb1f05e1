"""Ring attention on one rank: causal GQA flash attention, forward and
backward.

Counterpart of ``triton_dist_tpu/ops/ring_attention.py``. The TPU kernels
``_ring_fwd_kernel`` (``ring_attention_fwd``) and ``_ring_bwd_kernel``
(``ring_attention_bwd``) walk a ring of ranks; on a ring of one rank they
carry all of their arithmetic and none of their transport. That is what the
port runs: on a CUDA tensor ``ring_attention_fwd`` and ``ring_attention_bwd``
launch the hand-written Hopper kernels in ``csrc/ring_attention.cu``; on a
CPU tensor they run ``ring_attention_fwd_plain`` and
``ring_attention_bwd_plain``, the PyTorch versions in dense masked-matrix
form, with the same prescale and rounding points. A ring of more than one
rank raises: the ring transport over the port's shmem layer is ROADMAP.md
Queue A, item 9 "training and CP across ranks".

Layouts are the JAX package's: q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]``,
lse ``[B, Hq, S]`` f32 in the natural-log domain. The softmax runs in base
2: q is prescaled by ``sm_scale * log2(e)`` in f32 and rounded to its type,
as the JAX wrapper does outside its ``pallas_call``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from triton_dist_tpu_torch import csrc

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
HEAD_DIM = 128                     # the kernels' head dim

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = {torch.float32: "tdt_ring_attention_fwd_f32",
        torch.bfloat16: "tdt_ring_attention_fwd_bf16"}
_BWD = {torch.float32: "tdt_ring_attention_bwd_f32",
        torch.bfloat16: "tdt_ring_attention_bwd_bf16"}
_SIGNATURES = {
    # q k v out lse | B Hq Hkv S D causal | stream
    **{n: [_P] * 5 + [_I] * 6 + [_P] for n in _FWD.values()},
    # q k v o lse do delta dq dk dv | B Hq Hkv S D causal | scale stream
    **{n: [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P] for n in _BWD.values()},
}


def _check_ring(group, layout: str, S: int) -> None:
    """One rank only; both layouts are the identity order there."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be 'contiguous' or 'zigzag', got "
                         f"{layout!r}")
    if layout == "zigzag" and S % 2:
        raise ValueError(f"zigzag needs an even row count, got S={S}")
    n = 1 if group is None else group.size()
    if n > 1:
        raise NotImplementedError(
            f"ring attention over {n} ranks: the ring transport is not "
            "ported yet (ROADMAP.md Queue A, item 9 \"training and CP across "
            "ranks\"); one rank is supported")


def _scale(sm_scale, D: int) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)


def _prescale(q, scale: float):
    """q * (sm_scale * log2 e) in f32, rounded to q's type."""
    return (q.float() * (scale * LOG2E)).to(q.dtype)


def _keep(S: int, causal: bool, device):
    """[S, S] bool mask of the (query, key) pairs that count, or None."""
    if not causal:
        return None
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def ring_attention_fwd_plain(q, k, v, causal: bool = True,
                             sm_scale: float | None = None):
    """The plain PyTorch version of ``ring_attention_fwd``: base-2 softmax
    over the whole masked score matrix, p cast to v's type before P.V,
    ``lse = (m + log2 l) * ln2``; a row with no valid key gives zeros and
    ``lse = NEG_INF``."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
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
                      torch.full_like(l, NEG_INF))
    return out, lse.reshape(B, Hq, S)


def ring_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                             sm_scale: float | None = None):
    """The plain PyTorch version of ``ring_attention_bwd``: p recomputed as
    ``exp2(s - lse * log2 e)``, ``delta = rowsum(do * o)`` and
    ``dS = p * (dp - delta)`` in f32; dS and p rounded to the input type
    before their products; ``dq = dS.k * scale``, ``dk = dS^T.q_pre * ln2``
    (ln2 cancels the prescale's log2 e), ``dv = p^T.do``."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
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
    return (dq.to(q.dtype).reshape(B, Hq, S, D), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_kernel_args(name: str, q, k, v, *rest) -> None:
    """What the kernels take: one CUDA device, bf16 or f32 throughout (lse
    f32), contiguous, D = 128, Hq a multiple of Hkv, 16-byte aligned."""
    tensors = (q, k, v, *rest)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device")
    B, Hq, S, D = q.shape
    if q.dtype not in _FWD or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share a type in {list(_FWD)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if (k.dim() != 4 or k.shape[0] != B or k.shape[2:] != (S, D)
            or v.shape != k.shape or Hq % k.shape[1] or D != HEAD_DIM
            or S < 1):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (the "
                         f"kernels take D = {HEAD_DIM} and Hq % Hkv == 0)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def ring_attention_fwd(q, k, v, causal: bool = True,
                       sm_scale: float | None = None,
                       layout: str = "contiguous", group=None):
    """Forward ring attention on one rank. q ``[B, Hq, S, D]``, k/v
    ``[B, Hkv, S, D]``. Returns ``(out [B, Hq, S, D] in q's type,
    lse [B, Hq, S] f32)``. ``group`` is the ring's process group (None: one
    rank); ``layout`` is accepted for parity, both orders being the
    identity on one rank.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (bf16 or f32, D = 128) or raises; each launch adds one to
    ``ring_attention_fwd.launches``."""
    B, Hq, S, D = q.shape
    _check_ring(group, layout, S)
    if q.device.type == "cpu":
        return ring_attention_fwd_plain(q, k, v, causal, sm_scale)
    _check_kernel_args("ring_attention_fwd", q, k, v)
    qp = _prescale(q, _scale(sm_scale, D))
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, S, dtype=torch.float32, device=q.device)
    lib = csrc.load("ring_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with csrc.current_on(q.device):
        rc = getattr(lib, _FWD[q.dtype])(
            qp.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, k.shape[1], S, D, int(causal), stream)
    csrc.check(lib, rc, "ring_attention_fwd")
    ring_attention_fwd.launches += 1
    return out, lse


ring_attention_fwd.launches = 0


def ring_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                       sm_scale: float | None = None,
                       layout: str = "contiguous", group=None):
    """Backward ring attention on one rank: ``(dq, dk, dv)`` in the types
    of q, k, v, from the forward's ``o`` and ``lse`` and the output
    gradient ``do``. The kernel runs three launches (delta, dq, dk||dv);
    each dk/dv tile is summed by one block in a fixed order, so two calls
    on the same inputs give the same bits.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    or raises; each call adds one to ``ring_attention_bwd.launches``."""
    B, Hq, S, D = q.shape
    _check_ring(group, layout, S)
    if q.device.type == "cpu":
        return ring_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                        sm_scale)
    _check_kernel_args("ring_attention_bwd", q, k, v, o, lse, do)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, Hq, S) \
            or o.dtype != q.dtype or do.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise ValueError("ring_attention_bwd: o and do must match q, lse "
                         "must be [B, Hq, S] f32")
    scale = _scale(sm_scale, D)
    qp = _prescale(q, scale)
    delta = torch.empty(B, Hq, S, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = csrc.load("ring_attention", _SIGNATURES)
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


class _RingAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves (q, k, v, out, lse), the
    backward is ``ring_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, layout, group):
        out, lse = ring_attention_fwd(q, k, v, causal, sm_scale, layout,
                                      group)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, layout, group)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                        *ctx.args)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, causal: bool = True,
                   sm_scale: float | None = None,
                   layout: str = "contiguous", group=None):
    """Differentiable ring attention (one rank): ``out [B, Hq, S, D]``."""
    return _RingAttention.apply(q, k, v, causal, sm_scale, layout, group)


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


__all__ = ["HEAD_DIM", "LN2", "LOG2E", "NEG_INF", "ring_attention",
           "ring_attention_bwd", "ring_attention_bwd_plain",
           "ring_attention_fwd", "ring_attention_fwd_plain",
           "zigzag_indices"]
