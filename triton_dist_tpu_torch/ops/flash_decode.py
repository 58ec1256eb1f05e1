"""Paged GQA decode attention and the paged KV write.

Counterpart of ``triton_dist_tpu/ops/flash_decode.py``: ``gqa_decode_paged``
(the TPU kernel ``_decode_paged_kernel`` + ``_online_softmax_body``) and
``paged_kv_write``. On a CUDA tensor ``gqa_decode_paged`` launches the
hand-written Hopper kernel in ``csrc/flash_decode_paged.cu``; on a CPU
tensor it runs ``gqa_decode_paged_plain``, the PyTorch version that repeats
the kernel's arithmetic page by page.

The TPU kernel returns lse lane-broadcast as ``[B, Hq, 128]``, a tiling
artifact of the TPU (every DMA slice stays 128 lanes wide). The port returns
lse as ``[B, Hq]``; it equals the TPU's ``lse[..., 0]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from triton_dist_tpu_torch import csrc

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _P, _P, _P,          # q k v bt kv_len out lse
              _I, _I, _I, _I, _I, _I, _I,          # B Hq Hkv D ps P pps
              ctypes.c_float, _P]                  # sm_scale stream
_ENTRIES = {torch.float32: "tdt_gqa_decode_paged_f32",
            torch.bfloat16: "tdt_gqa_decode_paged_bf16"}


def gqa_decode_paged_plain(q, k_pages, v_pages, block_table, kv_len,
                           sm_scale: float | None = None):
    """The plain PyTorch version of ``gqa_decode_paged``: the kernel's online
    softmax, vectorised over rows and heads, one Python step per block-table
    column. A row's state is updated only while the column is one of its
    live pages, so entries past them are never used; a live entry is
    clamped into the pool as the TPU index map clamps it."""
    B, Hq, D = q.shape
    P, Hkv, ps, _ = k_pages.shape
    G = Hq // Hkv
    pps = block_table.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    kv_len = kv_len.to(torch.int64)
    qf = q.reshape(B, Hkv, G, D).float()
    acc = torch.zeros(B, Hkv, G, D, dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(B, Hkv, G, 1, dtype=torch.float32, device=dev)
    offs = torch.arange(ps, device=dev)
    for s in range(pps):
        live = (s * ps < kv_len).view(B, 1, 1, 1)
        page = block_table[:, s].long().clamp(0, P - 1)
        k = k_pages[page].float()                            # [B, Hkv, ps, D]
        v = v_pages[page]
        scores = torch.einsum("bhgd,bhjd->bhgj", qf, k) * scale
        valid = (s * ps + offs)[None, :] < kv_len[:, None]   # [B, ps]
        scores = torch.where(valid[:, None, None, :], scores,
                             torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhgj,bhjd->bhgd", p.to(v.dtype).float(), v.float())
        acc = torch.where(live, acc * alpha + pv, acc)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    out = (acc / l_safe).to(q.dtype).reshape(B, Hq, D)
    lse = torch.where(l > 0, m + torch.log(l_safe),
                      torch.full_like(l, NEG_INF)).reshape(B, Hq)
    return out, lse


def gqa_decode_paged(q, k_pages, v_pages, block_table, kv_len,
                     sm_scale: float | None = None):
    """Paged-attention decode over a shared KV page pool.

    q [B, Hq, D]; k_pages / v_pages [P, Hkv, page_size, D]; block_table
    [B, pages_per_seq] int32 page ids, whose entries past
    ``ceil(kv_len / page_size)`` may hold any value (they are never read);
    kv_len [B] int32, 0 allowed (the row gives zeros and lse = NEG_INF).
    Rows may walk the same pages at staggered ``kv_len`` (the chunked-
    prefill rows). Returns ``(out [B, Hq, D] in q's type, lse [B, Hq] f32)``.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (bf16 or f32, ``Hq % Hkv == 0``, ``page_size % 8 == 0``) or raises; each
    launch adds one to ``gqa_decode_paged.launches``.
    """
    if q.device.type == "cpu":
        return gqa_decode_paged_plain(q, k_pages, v_pages, block_table,
                                      kv_len, sm_scale)
    B, Hq, D = q.shape
    P, Hkv, ps, Dk = k_pages.shape
    pps = block_table.shape[1]
    tensors = (q, k_pages, v_pages, block_table, kv_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("gqa_decode_paged: all inputs must be on one device")
    if q.dtype not in _ENTRIES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"gqa_decode_paged: q/k/v must share a type in "
                        f"{list(_ENTRIES)}, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if block_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("gqa_decode_paged: block_table and kv_len must be "
                        "int32")
    if (Dk != D or v_pages.shape != k_pages.shape or Hq % Hkv
            or block_table.shape[0] != B or kv_len.shape != (B,)
            or ps % 8 or (Hq // Hkv) * D > 1024 or B < 1):
        raise ValueError(
            f"gqa_decode_paged: unsupported shapes q {tuple(q.shape)}, "
            f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
            f"block_table {tuple(block_table.shape)}, kv_len "
            f"{tuple(kv_len.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gqa_decode_paged: inputs must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("gqa_decode_paged: page pools must be 16-byte "
                         "aligned")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, dtype=torch.float32, device=q.device)
    lib = csrc.load("flash_decode_paged",
                    {name: _SIGNATURE for name in _ENTRIES.values()})
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with csrc.current_on(q.device):
        rc = getattr(lib, _ENTRIES[q.dtype])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, D, ps, P, pps, scale, stream)
    csrc.check(lib, rc, "gqa_decode_paged")
    gqa_decode_paged.launches += 1
    return out, lse


gqa_decode_paged.launches = 0


def paged_kv_write(k_pages, v_pages, k_new, v_new, block_table, pos,
                   active=None):
    """Write one new (k, v) row per batch row into the page pool, in place:
    page ``block_table[b, pos_b // page_size]``, slot ``pos_b % page_size``.

    k/v_pages [P, Hkv, page_size, D]; k/v_new [B, Hkv, D]; pos [B] int.
    ``active`` [B] bool (optional) sends the writes of masked-off rows to the
    scratch page 0, so a frozen row never lands on a live sequence's page.
    Rows that collide on page 0 may land in any order; page 0 is scratch.
    The JAX version returns new pools; this one updates the given ones and
    returns them. The column index is clamped into the block table, as the
    JAX gather clamps it: a row frozen one past its last page still looks up
    a valid entry (and writes to the scratch page)."""
    B = pos.shape[0]
    page_size = k_pages.shape[2]
    rows = torch.arange(B, device=pos.device)
    col = (pos // page_size).long().clamp(max=block_table.shape[1] - 1)
    page = block_table[rows, col].long()
    if active is not None:
        page = torch.where(active, page, torch.zeros_like(page))
    slot = (pos % page_size).long()
    # the two index tensors around the head slice put the batch dim in
    # front, so the indexed view is [B, Hkv, D]
    k_pages[page, :, slot] = k_new
    v_pages[page, :, slot] = v_new
    return k_pages, v_pages


__all__ = ["NEG_INF", "gqa_decode_paged", "gqa_decode_paged_plain",
           "paged_kv_write"]
