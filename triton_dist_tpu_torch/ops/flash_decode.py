"""GQA decode attention: paged and contiguous caches, the partials'
combine, and the sequence-parallel decode across ranks.

Counterpart of ``triton_dist_tpu/ops/flash_decode.py``. Four kernel
wrappers, each with its plain PyTorch version beside it:

- ``gqa_decode_paged`` (TPU kernel ``_decode_paged_kernel``): decode over
  the serving page pool, ``csrc/flash_decode_paged.cu``;
- ``gqa_decode_partial`` (``_decode_kernel``): decode over a contiguous
  head-major cache. On the card it is split-KV: the keys are cut into splits
  of ``SPLIT_KEYS``, one block per (split, kv head, row), and the partials
  are merged by the combine kernel; where one split covers the cache the
  partial kernel writes the result itself. ``csrc/flash_decode.cu``;
- ``decode_combine`` (``_combine_kernel``): the lse-weighted merge of R
  partials, ``csrc/flash_decode.cu``;
- ``ll_merge``: the merge half of ``ll_ag_merge`` (``_ll_ag_merge_kernel``),
  the canonical-order running merge of gathered partials, and
  ``ll_ag_merge`` across ranks, the partials' all-gather fused with that
  merge, ``csrc/flash_decode.cu``;
- ``fd_page_partials`` (``_fd_page_partials`` / ``_fd_partial_kernel``): one
  independent softmax partial per block-table page, and ``fd_partials_fold``,
  the n = 1 route of ``flash_decode_dist``: the same per-page partials folded
  in page order (``_fd_fold``) inside the kernel, with no slab in device
  memory; ``fd_fold_dist`` (``_fd_fold_kernel``, B8), the fold of n SP
  ranks' slabs across ranks. ``csrc/flash_decode_dist.cu``;
- ``pool_ag_start_local`` (``_pool_ag_kernel``, B6): the start-local,
  signal-gated gather of the K and V page pools across the SP ranks,
  ``csrc/pool_ag.cu``.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel or raises, and adds one to its ``launches`` count at
each launch. ``ll_ag_merge``, ``sp_gqa_flash_decode``, ``flash_decode_dist``
and ``pool_ag_start_local`` run at any rank count of the mesh (every rank
on one card, see ``shmem/context.py``), and over an axis inside a
multi-axis mesh, in groups (``shmem.device.group_plan``);
``sp_gqa_flash_decode`` also over a tuple of axes, through the 2-D
gathers (``all_gather`` with ``push_2d``/``ring_2d``).
``flash_decode_dist`` at n > 1 runs B7 over each rank's slice of the pool,
then B8, in blocks of rows that bound the slabs' memory.
``sp_paged_attend_write`` is the sharded serving engine's SP attention:
the pool sharded on its page dim, gathered in page order through B9
(``all_gather``), or with ``overlap=True`` through B6, and walked by B1 at
any SP size.

The TPU kernels return lse lane-broadcast as ``[B, Hq, 128]``, a tiling
artifact of the TPU (every DMA slice stays 128 lanes wide), and the SP wire
packs ``(out || lse)`` into ``D + 128`` f32 lanes. The port keeps lse as
``[B, Hq]``, the TPU's ``lse[..., 0]``, partials as ``(outs, lses)`` pairs,
and the ``push``/``ring`` wire as ``D + 1`` f32 values.
"""

from __future__ import annotations

import ctypes
import math

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.allgather import all_gather, lanes_for
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.shmem import device as shd

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


def sp_paged_attend_write(ctx, q, k_new, v_new, k_pages, v_pages,
                          block_table, pos, kv_len, axis: str = "sp",
                          active=None, overlap: bool = False):
    """The sequence-parallel paged write and attention of the sharded
    serving engine (the JAX ``sp_paged_attend_write``): the pool
    ``k/v_pages`` [P, Hkv, page_size, D] is the global view of a pool
    sharded over ``axis`` on its page dim (rank r owns pages
    ``[r * P / n, (r + 1) * P / n)``).

    Each rank writes the rows whose page it owns (``paged_kv_write``'s
    rows, inactive ones parked on the scratch page 0, rank 0's); the shards
    are disjoint slices of the one global pool, so every rank's masked
    write together is one scatter of every row, which is how it runs here.
    Then the shards are gathered in page order through ``all_gather`` (B9;
    every rank's replica, the concatenation of the shards bit for bit) and
    ``gqa_decode_paged`` (B1) walks the gathered pool, the same walk on
    every rank; it runs once, on rank 0's replica. The attention is
    therefore bitwise the one-rank write and walk at any SP size. At one
    rank it is that write and walk. Returns (attn [B, Hq, D], k_pages,
    v_pages), the pools updated in place.

    ``overlap=True`` gathers the pools with the start-local kernel
    (``pool_ag_start_local``, B6) instead of B9: each rank's own slice lands
    with no gate, the remote slices behind counted signals. The gathered
    pools are the same page-order concatenation, so the attention is
    bitwise ``overlap=False``'s."""
    n = ctx.axis_size(axis)
    paged_kv_write(k_pages, v_pages, k_new, v_new, block_table, pos,
                   active=active)
    if n == 1:
        return gqa_decode_paged(q, k_pages, v_pages, block_table,
                                kv_len)[0], k_pages, v_pages
    _check_pool_split(k_pages, n, axis)
    if overlap:
        kf, vf = pool_ag_start_local(ctx, k_pages, v_pages, axis=axis)
    else:
        kf = all_gather(ctx, k_pages, axis=axis)
        vf = all_gather(ctx, v_pages, axis=axis)
    out = gqa_decode_paged(q, kf[0], vf[0], block_table, kv_len)[0]
    return out, k_pages, v_pages


def _check_pool_split(k_pages, n: int, axis) -> None:
    if k_pages.shape[0] % n:
        raise ValueError(f"pool pages {k_pages.shape[0]} do not split over "
                         f"|{axis}| = {n}: pad the pool (shard_pool_arrays)")


_POOL_AG_SIG = [_P, _P, _P, _P, ctypes.c_longlong, _I, _P, _I, _P] \
    + shd.LAUNCH_SIG              # kin vin kout vout nbytes lanes pads n group


def pool_ag_start_local_plain(k_pages, v_pages, ranks: int = 1):
    """The plain version of ``pool_ag_start_local``: every rank's replica
    of the full pools, ``[ranks, P, ...]`` each (the pools themselves at
    one rank)."""
    if ranks == 1:
        return k_pages, v_pages
    rep = (ranks,) + tuple(k_pages.shape)
    return (k_pages.unsqueeze(0).expand(rep).clone(),
            v_pages.unsqueeze(0).expand(rep).clone())


def pool_ag_start_local(ctx, k_pages, v_pages, axis: str = "sp"):
    """The start-local gather of the K and V page pools over ``axis`` (TPU
    kernel B6, ``_pool_ag_kernel``). ``k_pages`` / ``v_pages`` [P, Hkv,
    page_size, D] are the global views of pools sharded on the page dim
    (index r of a group holds pages ``[r * P / n, (r + 1) * P / n)``) and
    replicated over the mesh's other axes. At one rank along ``axis`` it
    returns the pools and launches nothing. At n it returns every rank of
    the mesh's replicas of the full pools, ``([N, P, ...], [N, P, ...])``,
    each the page-order concatenation of its group's slices bit for bit
    (B9's gather's bits).

    A CUDA tensor launches ``csrc/pool_ag.cu`` once for both pools (one
    cooperative launch over every rank; each rank's own slice first, with
    no gate, then its puts and one counted signal per peer), adding one to
    ``pool_ag_start_local.launches``; a CPU tensor runs the plain
    version."""
    n, group, _, _ = shd.group_plan(ctx, axis)
    if n == 1:
        return k_pages, v_pages
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pool_ag_start_local: the pools differ: "
                         f"{tuple(k_pages.shape)} {k_pages.dtype} against "
                         f"{tuple(v_pages.shape)} {v_pages.dtype}")
    _check_pool_split(k_pages, n, axis)
    N = ctx.num_ranks
    if k_pages.device.type == "cpu":
        return pool_ag_start_local_plain(k_pages, v_pages, N)
    shd.cuda_checks("pool_ag_start_local", k_pages, v_pages)
    nbytes = k_pages.numel() // n * k_pages.element_size()
    if nbytes % 16 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("pool_ag_start_local: a slice must be a 16-byte "
                         "multiple on a 16-byte boundary")
    kf = torch.empty((N,) + tuple(k_pages.shape), dtype=k_pages.dtype,
                     device=k_pages.device)
    vf = torch.empty_like(kf)
    lanes = lanes_for(nbytes)
    pad = family_pad(ctx, "pool_ag", axis, 2 * lanes)
    kin = shd.group_table(ctx, k_pages.view(n, -1), axis)
    vin = shd.group_table(ctx, v_pages.view(n, -1), axis)
    kout, vout, pads = shd.tables(ctx, kf, vf, pad)
    lib = csrc.load("pool_ag", {"tdt_pool_ag": _POOL_AG_SIG})
    args = shd.launch_args(ctx)
    with csrc.current_on(kf.device):
        rc = lib.tdt_pool_ag(kin, vin, kout, vout, nbytes, lanes, pads, N,
                             ctypes.byref(group), *args)
    csrc.check(lib, rc, "pool_ag_start_local")
    pool_ag_start_local.launches += 1
    return kf, vf


pool_ag_start_local.launches = 0


# ---------------------------------------------------------------------------
# contiguous cache: split-KV partials, their combine, the SP merge
# ---------------------------------------------------------------------------

# keys per split of the contiguous decode. A constant, so the split count
# depends on the cache length S alone, never on the batch, kv_len or the
# device: a row's bits do not depend on which rows share the launch
SPLIT_KEYS = 256
# keys per shared-memory tile of the partial kernel (16 KB of K a tile), by
# type; the plain version walks the same tiles, so both rescale the running
# softmax at the same keys
_TILE = {torch.bfloat16: 64, torch.float32: 32}

_PARTIAL_SIG = [_P, _P, _P, _P, _P, _P, _P, _P,    # q k v kv_len out lse po pl
                _I, _I, _I, _I, _I, _I, _I,        # B Hq Hkv S D split n_split
                ctypes.c_float, _P]                # sm_scale stream
_COMBINE_SIG = [_P, _P, _P, _P, _P,                # outs lses out lse kv_len
                _I, _I, _I, _I, _I, _I, _P]        # R rows D Hq S split stream
_MERGE_SIG = [_P, _P, _P, _I, _I, _I, _P]          # outs lses out n rows D
_PARTIAL_ENTRIES = {torch.float32: "tdt_gqa_decode_partial_f32",
                    torch.bfloat16: "tdt_gqa_decode_partial_bf16"}
# (partials' type, output type)
_COMBINE_ENTRIES = {(torch.float32, torch.float32): "tdt_decode_combine_f32",
                    (torch.bfloat16, torch.bfloat16):
                        "tdt_decode_combine_bf16",
                    (torch.float32, torch.bfloat16):
                        "tdt_decode_combine_f32_bf16"}
_MERGE_ENTRIES = {torch.float32: "tdt_ll_merge_f32",
                  torch.bfloat16: "tdt_ll_merge_bf16"}
# outs lses ws res rows D pads n group silent, then the shmem layer's
# launch arguments
_LL_AG_SIG = [_P, _P, _P, _P, _I, _I, _P, _I, _P, _I] + shd.LAUNCH_SIG
_LL_AG_ENTRIES = {torch.float32: "tdt_ll_ag_merge_f32",
                  torch.bfloat16: "tdt_ll_ag_merge_bf16"}
# rows of the (B, Hq) partials one block of the fused merge takes (its warps)
_LL_AG_ROWS = 4


_FD_SIGNATURES = {**{n: _PARTIAL_SIG for n in _PARTIAL_ENTRIES.values()},
                  **{n: _COMBINE_SIG for n in _COMBINE_ENTRIES.values()},
                  **{n: _MERGE_SIG for n in _MERGE_ENTRIES.values()},
                  **{n: _LL_AG_SIG for n in _LL_AG_ENTRIES.values()}}


def _fd_lib():
    return csrc.load("flash_decode", _FD_SIGNATURES)


def split_count(S: int, split: int = SPLIT_KEYS) -> int:
    """Splits of a cache of S keys (1 when one split covers it)."""
    return max(1, -(-S // split))


def _partials_plain(q, k_cache, v_cache, kv_len, scale: float, split: int):
    """Each split's online softmax over its key tiles, vectorised over
    splits, rows and heads: f32 ``(outs [n, B, Hq, D], lses [n, B, Hq])``.
    A tile's state is updated only when it holds a key below kv_len (the
    kernel reads no other), so a split past kv_len keeps zeros and
    NEG_INF."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    G = Hq // Hkv
    n = split_count(S, split)
    tile = min(_TILE.get(q.dtype, 64), split)
    dev = q.device
    kv = kv_len.to(dev, torch.int64).clamp(0, S)
    pad = n * split - S
    if pad:
        k_cache = torch.nn.functional.pad(k_cache, (0, 0, 0, pad))
        v_cache = torch.nn.functional.pad(v_cache, (0, 0, 0, pad))
    ks = k_cache.reshape(B, Hkv, n, split, D)
    vs = v_cache.reshape(B, Hkv, n, split, D)
    qf = q.reshape(B, Hkv, G, D).float()
    acc = torch.zeros(n, B, Hkv, G, D, dtype=torch.float32, device=dev)
    m = torch.full((n, B, Hkv, G, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros(n, B, Hkv, G, 1, dtype=torch.float32, device=dev)
    starts = torch.arange(n, device=dev) * split                 # [n]
    for t0 in range(0, split, tile):
        kt = ks[:, :, :, t0:t0 + tile].float()             # [B, Hkv, n, j, D]
        vt = vs[:, :, :, t0:t0 + tile]
        width = kt.shape[3]
        scores = torch.einsum("bhgd,bhnjd->nbhgj", qf, kt) * scale
        pos = starts[:, None] + t0 + torch.arange(width, device=dev)
        valid = pos[:, None, :] < kv[None, :, None]              # [n, B, j]
        scores = torch.where(valid[:, :, None, None, :], scores,
                             torch.full_like(scores, NEG_INF))
        live = ((starts + t0)[:, None] < kv[None, :]).view(n, B, 1, 1, 1)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("nbhgj,bhnjd->nbhgd", p.to(vt.dtype).float(),
                          vt.float())
        acc = torch.where(live, acc * alpha + pv, acc)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    outs = (acc / l_safe).reshape(n, B, Hq, D)
    lses = torch.where(l > 0, m + torch.log(l_safe),
                       torch.full_like(l, NEG_INF)).reshape(n, B, Hq)
    return outs, lses


def _combine_plain(partial_outs, partial_lses, out_dtype):
    """The combine's arithmetic: ``(merged in out_dtype, merged lse)``, the
    weighted sum taken over r = 0..R-1 in order, each product and sum
    rounded to f32 on its own."""
    lses = partial_lses.float()
    m = lses.amax(0)
    acc = torch.zeros(partial_outs.shape[1:], dtype=torch.float32,
                      device=partial_outs.device)
    denom = torch.zeros_like(m)
    for r in range(partial_outs.shape[0]):
        w = torch.exp(lses[r] - m)
        denom = denom + w
        acc = acc + partial_outs[r].float() * w[..., None]
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    merged = (acc / safe[..., None]).to(out_dtype)
    lse = torch.where(denom > 0, m + torch.log(safe),
                      torch.full_like(m, NEG_INF))
    return merged, lse


def gqa_decode_partial_plain(q, k_cache, v_cache, kv_len,
                             sm_scale: float | None = None,
                             split: int = SPLIT_KEYS):
    """The plain PyTorch version of ``gqa_decode_partial``: the kernel's
    split-KV walk (``_partials_plain``), then, with more than one split, the
    combine's arithmetic. ``split`` is the kernel's ``SPLIT_KEYS``; a test
    may take a shorter one to walk several splits at a small S."""
    D = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    outs, lses = _partials_plain(q, k_cache, v_cache, kv_len, scale, split)
    if outs.shape[0] == 1:
        return outs[0].to(q.dtype), lses[0]
    return _combine_plain(outs, lses, q.dtype)


def _check_cuda(name: str, tensors) -> None:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def gqa_decode_partial(q, k_cache, v_cache, kv_len, block_s: int = 128,
                       sm_scale: float | None = None):
    """Decode over a contiguous (possibly partial) KV shard.

    q [B, Hq, D]; k_cache / v_cache [B, Hkv, S, D] head-major; kv_len [B]
    int32 valid keys (0 allowed: the row gives zeros and lse = NEG_INF).
    Returns ``(out [B, Hq, D] in q's type, lse [B, Hq] f32)``. ``block_s``
    is the TPU kernel's tile of the S axis; it does not change the result,
    and the port tiles by its own rule.

    A CPU tensor runs the plain version. A CUDA tensor launches the split-KV
    kernel (bf16 or f32, ``Hq % Hkv == 0``, D dividing 256 and a multiple of
    8, ``Hq / Hkv * D <= 1024``), adding one to
    ``gqa_decode_partial.launches``, and with more than one split the
    combine kernel, adding one to ``decode_combine.launches``; or raises.
    """
    del block_s
    if q.device.type == "cpu":
        return gqa_decode_partial_plain(q, k_cache, v_cache, kv_len,
                                        sm_scale)
    B, Hq, D = q.shape
    Bk, Hkv, S, Dk = k_cache.shape
    _check_cuda("gqa_decode_partial", (q, k_cache, v_cache, kv_len))
    if q.dtype not in _PARTIAL_ENTRIES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"gqa_decode_partial: q/k/v must share a type in "
                        f"{list(_PARTIAL_ENTRIES)}, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError("gqa_decode_partial: kv_len must be int32")
    if (Bk != B or Dk != D or v_cache.shape != k_cache.shape or Hq % Hkv
            or 256 % D or D % 8 or (Hq // Hkv) * D > 1024 or B < 1 or S < 1
            or kv_len.shape != (B,)):
        raise ValueError(
            f"gqa_decode_partial: unsupported shapes q {tuple(q.shape)}, "
            f"cache {tuple(k_cache.shape)}/{tuple(v_cache.shape)}, kv_len "
            f"{tuple(kv_len.shape)}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("gqa_decode_partial: caches must be 16-byte aligned")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    n = split_count(S)
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, dtype=torch.float32, device=q.device)
    po = pl = None
    if n > 1:
        po = torch.empty(n, B, Hq, D, dtype=torch.float32, device=q.device)
        pl = torch.empty(n, B, Hq, dtype=torch.float32, device=q.device)
    lib = _fd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with csrc.current_on(q.device):
        rc = getattr(lib, _PARTIAL_ENTRIES[q.dtype])(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), lse.data_ptr(),
            po.data_ptr() if n > 1 else None,
            pl.data_ptr() if n > 1 else None,
            B, Hq, Hkv, S, D, SPLIT_KEYS, n, scale, stream)
    csrc.check(lib, rc, "gqa_decode_partial")
    gqa_decode_partial.launches += 1
    if n > 1:
        _combine_launch(po, pl, out, lse, kv_len, S)
    return out, lse


gqa_decode_partial.launches = 0


def _combine_launch(partial_outs, partial_lses, out, lse=None, kv_len=None,
                    S: int = 0) -> None:
    """Launch the combine kernel into ``out``; adds one to
    ``decode_combine.launches``. B3's use also passes ``lse`` (the merged
    lse is written there) and its ``kv_len`` and S: row b then merges only
    the splits that start below ``kv_len[b]``, the others holding zeros
    and NEG_INF (weight exactly 0)."""
    R, B, Hq, D = partial_outs.shape
    lib = _fd_lib()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with csrc.current_on(out.device):
        rc = getattr(lib, _COMBINE_ENTRIES[(partial_outs.dtype, out.dtype)])(
            partial_outs.data_ptr(), partial_lses.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            kv_len.data_ptr() if kv_len is not None else None,
            R, B * Hq, D, Hq, S, SPLIT_KEYS, stream)
    csrc.check(lib, rc, "decode_combine")
    decode_combine.launches += 1


def decode_combine_plain(partial_outs, partial_lses):
    """The plain PyTorch version of ``decode_combine``."""
    return _combine_plain(partial_outs, partial_lses, partial_outs.dtype)[0]


def decode_combine(partial_outs, partial_lses):
    """The lse-weighted merge of R partial attention outputs:
    ``m = max_r lse``, ``w = exp(lse - m)``, ``merged = sum_r outs * w /
    sum_r w`` (the sum replaced by 1 where it is 0), summed in the order
    r = 0..R-1 in f32. Partials whose lse is NEG_INF everywhere give zeros.

    partial_outs [R, B, Hq, D]; partial_lses [R, B, Hq] f32. Returns
    [B, Hq, D] in the outs' type. A CPU tensor runs the plain version; a
    CUDA tensor (bf16 or f32 outs, D <= 256) launches the kernel, adding one
    to ``decode_combine.launches``, or raises."""
    if partial_outs.device.type == "cpu":
        return decode_combine_plain(partial_outs, partial_lses)
    _check_cuda("decode_combine", (partial_outs, partial_lses))
    if (partial_outs.dtype, partial_outs.dtype) not in _COMBINE_ENTRIES \
            or partial_lses.dtype != torch.float32:
        raise TypeError(f"decode_combine: outs must be bf16 or f32 and lses "
                        f"f32, got {partial_outs.dtype}, "
                        f"{partial_lses.dtype}")
    if (partial_outs.dim() != 4 or partial_lses.shape
            != partial_outs.shape[:3] or partial_outs.shape[0] < 1
            or partial_outs.shape[-1] > 256 or partial_outs[0].numel() == 0):
        raise ValueError(f"decode_combine: unsupported shapes outs "
                         f"{tuple(partial_outs.shape)}, lses "
                         f"{tuple(partial_lses.shape)}")
    out = torch.empty(partial_outs.shape[1:], dtype=partial_outs.dtype,
                      device=partial_outs.device)
    _combine_launch(partial_outs, partial_lses, out)
    return out


decode_combine.launches = 0


def ll_merge_plain(partial_outs, partial_lses, out_dtype=torch.float32):
    """The plain PyTorch version of ``ll_merge``: segment 0 initialises
    ``(acc, m, denom) = (out, lse, 1)``, each later segment rescales
    (``_ll_ag_merge_kernel`` :391-404), each product and sum rounded to f32
    on its own."""
    acc = partial_outs[0].float()
    m = partial_lses[0].float()
    denom = torch.ones_like(m)
    for s in range(1, partial_outs.shape[0]):
        lse = partial_lses[s].float()
        new_m = torch.maximum(m, lse)
        scale = torch.exp(m - new_m)
        w = torch.exp(lse - new_m)
        acc = acc * scale[..., None] + partial_outs[s].float() * w[..., None]
        denom = denom * scale + w
        m = new_m
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return (acc / safe[..., None]).to(out_dtype)


def ll_merge(partial_outs, partial_lses, out_dtype=torch.float32):
    """The merge half of ``ll_ag_merge``: the gathered partials merged in
    canonical rank order 0..n-1 with the running (m, denom, acc) rescaling,
    then ``acc / denom`` in ``out_dtype``. It rounds in another order than
    ``decode_combine`` (running rescale against two passes); over one
    segment it returns the segment's bits.

    partial_outs [n, B, Hq, D] f32; partial_lses [n, B, Hq] f32; any n. A
    CPU tensor runs the plain version; a CUDA tensor (``out_dtype`` bf16 or
    f32, D <= 256) launches the kernel, adding one to ``ll_merge.launches``,
    or raises."""
    if partial_outs.device.type == "cpu":
        return ll_merge_plain(partial_outs, partial_lses, out_dtype)
    _check_cuda("ll_merge", (partial_outs, partial_lses))
    if partial_outs.dtype != torch.float32 \
            or partial_lses.dtype != torch.float32 \
            or out_dtype not in _MERGE_ENTRIES:
        raise TypeError(f"ll_merge: partials must be f32 and the output bf16 "
                        f"or f32, got {partial_outs.dtype}, "
                        f"{partial_lses.dtype} -> {out_dtype}")
    if (partial_outs.dim() != 4 or partial_lses.shape
            != partial_outs.shape[:3] or partial_outs.shape[0] < 1
            or partial_outs.shape[-1] > 256 or partial_outs[0].numel() == 0):
        raise ValueError(f"ll_merge: unsupported shapes outs "
                         f"{tuple(partial_outs.shape)}, lses "
                         f"{tuple(partial_lses.shape)}")
    n, D = partial_outs.shape[0], partial_outs.shape[-1]
    out = torch.empty(partial_outs.shape[1:], dtype=out_dtype,
                      device=partial_outs.device)
    lib = _fd_lib()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with csrc.current_on(out.device):
        rc = getattr(lib, _MERGE_ENTRIES[out_dtype])(
            partial_outs.data_ptr(), partial_lses.data_ptr(), out.data_ptr(),
            n, partial_outs[0].numel() // D, D, stream)
    csrc.check(lib, rc, "ll_merge")
    ll_merge.launches += 1
    return out


ll_merge.launches = 0


def ll_ag_merge_plain(partial_outs, partial_lses, out_dtype=torch.float32,
                     replicas: int | None = None):
    """The plain version of ``ll_ag_merge`` at n ranks: every rank merges
    the same segments in the same order, so each replica is
    ``ll_merge_plain`` of the stacked partials: [replicas, B, Hq, D]
    (``replicas`` n unless the group lies inside a larger mesh)."""
    merged = ll_merge_plain(partial_outs, partial_lses, out_dtype)
    n = replicas or partial_outs.shape[0]
    return merged.unsqueeze(0).expand((n,) + tuple(merged.shape)).clone()


def ll_ag_merge(ctx, partial_outs, partial_lses, out_dtype, axis: str,
                silent_rank: int | None = None):
    """The fused partial all-gather and lse merge (TPU kernel B5) over the
    mesh axis ``axis`` (one name: B5 is a one-axis kernel in the reference,
    so a tuple raises ``ValueError``). The group member at index r holds the
    partial ``(partial_outs[r] [B, Hq, D] f32, partial_lses[r] [B, Hq])``
    (sharded over ``axis``, replicated over the other axes); each rank
    gathers its group's partials and merges them in canonical order with
    ``ll_merge``'s running rescale.

    At one rank along ``axis`` it returns the merge of the one partial ([B,
    Hq, D] in ``out_dtype``, the ``ll_merge`` kernel). At n ranks it returns
    every rank of the mesh's replica, [N, B, Hq, D], each equal to
    ``ll_merge`` of the stacked partials bit for bit: on a CUDA tensor one
    launch covering every rank, every group, puts each partial into every
    group member's workspace and merges as the segments land
    (``csrc/flash_decode.cu``; it adds one to ``ll_ag_merge.launches``); a
    CPU tensor runs the plain version. ``silent_rank`` (the card) names a
    rank that puts but never signals: the call then raises ``ShmemError``
    once the spin budget has passed."""
    if not isinstance(axis, str):
        raise ValueError(f"ll_ag_merge runs over one mesh axis, got "
                         f"{axis!r}: gather over several axes with "
                         f"all_gather (push_2d / ring_2d)")
    n, group, _, _ = shd.group_plan(ctx, axis)
    N = ctx.num_ranks
    if partial_outs.shape[0] != n or partial_lses.shape[0] != n:
        raise ValueError(f"ll_ag_merge: expected {n} partials, got "
                         f"{partial_outs.shape[0]}")
    if n == 1:
        return ll_merge(partial_outs, partial_lses, out_dtype)
    if partial_outs.device.type == "cpu":
        return ll_ag_merge_plain(partial_outs, partial_lses, out_dtype, N)
    _check_cuda("ll_ag_merge", (partial_outs, partial_lses))
    if partial_outs.dtype != torch.float32 \
            or partial_lses.dtype != torch.float32 \
            or out_dtype not in _LL_AG_ENTRIES:
        raise TypeError(f"ll_ag_merge: partials must be f32 and the output "
                        f"bf16 or f32, got {partial_outs.dtype}, "
                        f"{partial_lses.dtype} -> {out_dtype}")
    D = partial_outs.shape[-1]
    if (partial_outs.dim() != 4 or partial_lses.shape
            != partial_outs.shape[:3] or D > 256
            or partial_outs[0].numel() == 0):
        raise ValueError(f"ll_ag_merge: unsupported shapes outs "
                         f"{tuple(partial_outs.shape)}, lses "
                         f"{tuple(partial_lses.shape)}")
    rows = partial_outs[0].numel() // D
    lanes = -(-rows // _LL_AG_ROWS)
    out = torch.empty((N,) + tuple(partial_outs.shape[1:]), dtype=out_dtype,
                      device=partial_outs.device)
    ws = torch.empty(N, n * rows * (D + 1), dtype=torch.float32,
                     device=partial_outs.device)
    pad = family_pad(ctx, "ll_ag_merge", axis, (n + 1) * lanes)
    outs_t = shd.group_table(ctx, partial_outs, axis)
    lses_t = shd.group_table(ctx, partial_lses, axis)
    ws_t, res_t, pads = shd.tables(ctx, ws, out, pad)
    lib = _fd_lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(out.device):
        rc = getattr(lib, _LL_AG_ENTRIES[out_dtype])(
            outs_t, lses_t, ws_t, res_t, rows, D, pads, N,
            ctypes.byref(group), -1 if silent_rank is None else silent_rank,
            *args)
    csrc.check(lib, rc, "ll_ag_merge")
    ll_ag_merge.launches += 1
    return out


ll_ag_merge.launches = 0

# the gathers of the SP decode over one axis (auto: push or ring), and over
# a tuple of axes (auto: push_2d or ring_2d)
AG_METHODS = ("fused", "push", "ring", "auto")
AG_METHODS_2D = ("push_2d", "ring_2d")


def sp_local_lens(global_kv_lens, n: int, s_local: int):
    """Each rank's valid keys of its shard: ``clamp(kv_len - r * S_local, 0,
    S_local)``, [n, B] int32."""
    starts = torch.arange(0, n * s_local, s_local, dtype=torch.int32,
                          device=global_kv_lens.device)
    return (global_kv_lens.to(torch.int32)[None, :]
            - starts[:, None]).clamp_(0, s_local)


def sp_gqa_flash_decode(ctx, q, k_cache, v_cache, global_kv_lens,
                        axis=None, block_s: int = 128,
                        ag_method: str = "fused", replicas: bool = False):
    """Sequence-parallel flash-decode: each rank's split-KV partial over its
    KV shard (``gqa_decode_partial``), the partial all-gather, and the lse
    merge, over ``axis``: a mesh axis (the context's first by default; in a
    multi-axis mesh each group along it apart) or a tuple of axes (one
    group over them, rank-major over the flattened axes).

    q [B, Hq, D]; global_kv_lens [B] int32. At one rank ``k_cache`` /
    ``v_cache`` are the whole cache [B, Hkv, S, D]; at n ranks along
    ``axis`` they are sharded on S, rank-major: [n, B, Hkv, S / n, D]
    (``models.llama``'s ``shard_kv_cache`` makes the layout), group index r
    holding keys ``r * S / n .. (r + 1) * S / n`` with ``clamp(kv_len - r *
    S / n, 0, S / n)`` of them valid; an empty shard's partial is (0,
    NEG_INF), which every merge takes as an exact no-op. One
    ``gqa_decode_partial`` launch covers every shard (the index is a batch
    row).

    ``ag_method="fused"`` merges with ``ll_ag_merge`` (one axis only: a
    tuple raises ``ValueError``); ``"push"``, ``"ring"`` (B9 over the
    group), ``"push_2d"``, ``"ring_2d"`` (over a tuple of axes) and
    ``"auto"`` pack each partial as one f32 wire ``(out || lse)`` [B, Hq, D
    + 1], gather it with ``all_gather`` and let each rank merge its copy
    with ``decode_combine`` over the outs cast to q's type, as the JAX path
    does (every gather gives the same bits). Returns [B, Hq, D] in q's type
    (rank 0's replica), or with ``replicas`` every rank of the mesh's, [N,
    B, Hq, D] (at one rank [1, B, Hq, D]). Other methods raise
    ``ValueError``."""
    axis = axis or ctx.axis_names[0]
    if isinstance(axis, list):
        axis = tuple(axis)
    if ag_method not in AG_METHODS + AG_METHODS_2D:
        raise ValueError(f"sp_gqa_flash_decode: unknown ag_method "
                         f"{ag_method!r}; expected one of "
                         f"{AG_METHODS + AG_METHODS_2D}")
    if ag_method == "fused" and not isinstance(axis, str):
        raise ValueError(f"sp_gqa_flash_decode: the fused gather and merge "
                         f"runs over one axis, got {axis!r}; use push_2d, "
                         f"ring_2d or auto over several")
    n = ctx.axis_size(axis)
    B, Hq, D = q.shape
    if n == 1 and k_cache.dim() == 4:          # one rank's whole cache
        k_cache, v_cache = k_cache[None], v_cache[None]
    if k_cache.dim() != 5 or k_cache.shape[:2] != (n, B) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"sp_gqa_flash_decode: the caches of {n} ranks are [n, B, Hkv, "
            f"S_local, D] = [{n}, {B}, ...], got {tuple(k_cache.shape)} / "
            f"{tuple(v_cache.shape)}")
    lens = sp_local_lens(global_kv_lens, n, k_cache.shape[3]).reshape(n * B)
    out_p, lse_p = gqa_decode_partial(
        q.repeat(n, 1, 1), k_cache.reshape((n * B,) + k_cache.shape[2:]),
        v_cache.reshape((n * B,) + v_cache.shape[2:]), lens,
        block_s=block_s)
    outs = out_p.float().view(n, B, Hq, D)
    lses = lse_p.view(n, B, Hq)
    if ag_method == "fused":
        rep = ll_ag_merge(ctx, outs, lses, q.dtype, axis)
        rep = rep[None] if n == 1 else rep
    else:
        wire = torch.cat([outs, lses[..., None]], -1)      # [n, B, Hq, D+1]
        g = all_gather(ctx, wire, axis=axis, method=ag_method)
        g = g[None] if n == 1 else g             # [R, n, B, Hq, D+1]
        R = g.shape[0]
        # [segment, replica, B, Hq, D+1] -> one combine over every replica,
        # the segments leading
        segs = g.transpose(0, 1)
        rep = decode_combine(
            segs[..., :D].to(q.dtype).reshape(n, R * B, Hq, D).contiguous(),
            segs[..., D].reshape(n, R * B, Hq).contiguous()
        ).view(R, B, Hq, D)
    return rep if replicas else rep[0]


# ---------------------------------------------------------------------------
# distributed flash-decode: per-page partials and their fixed-order fold
# ---------------------------------------------------------------------------

# "no entry" threshold of the page fold: a real lse never gets here
FD_EMPTY = NEG_INF / 2

_FDD_PARTIAL_SIG = [_P, _P, _P, _P, _P, _P, _P,      # q k v bt kv_len out lse
                    _I, _I, _I, _I, _I, _I,          # B Hq Hkv D ps p_local
                    _I, _I, ctypes.c_float, _I, _P]  # S rank sm_scale
                                                     # neutral_out stream
# outs lses res kv_len rows S Hq D ps lanes pads n group, then the shmem
# layer's launch arguments
_FDD_DIST_SIG = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P] \
    + shd.LAUNCH_SIG
_FDD_FOLD_SIG = [_P, _P, _P, _P, _P, _P,             # q k v bt kv_len out
                 _I, _I, _I, _I, _I, _I, _I,         # B Hq Hkv D ps P S
                 ctypes.c_float, _P]                 # sm_scale stream
_FDD_PARTIAL_ENTRIES = {torch.float32: "tdt_fd_page_partials_f32",
                        torch.bfloat16: "tdt_fd_page_partials_bf16"}
_FDD_FOLD_ENTRIES = {torch.float32: "tdt_fd_partials_fold_f32",
                     torch.bfloat16: "tdt_fd_partials_fold_bf16"}
_FDD_DIST_ENTRIES = {torch.float32: "tdt_fd_fold_dist_f32",
                     torch.bfloat16: "tdt_fd_fold_dist_bf16"}
# (row, head) pairs one block of B8 folds at once (csrc kFoldPairs)
_FOLD_PAIRS = 4
# the most bytes of slabs (every rank's partials and lses) one block of
# rows of flash_decode_dist holds at n > 1
FD_SLAB_BYTES = 4 << 30
# block-table columns per step of the plain partials (bounds its memory)
_PLAIN_PAGES = 64
# query heads per kv head and the page size the kernels are instantiated
# for (with head dim 128: the Llama and Mixtral presets)
_FDD_GROUPS = (1, 2, 4, 8)
_FDD_PAGE = 16


def _fdd_lib():
    sigs = {**{n: _FDD_PARTIAL_SIG for n in _FDD_PARTIAL_ENTRIES.values()},
            **{n: _FDD_FOLD_SIG for n in _FDD_FOLD_ENTRIES.values()},
            **{n: _FDD_DIST_SIG for n in _FDD_DIST_ENTRIES.values()}}
    return csrc.load("flash_decode_dist", sigs)


def fd_page_partials_plain(q, k_pages, v_pages, block_table, kv_len,
                           rank: int = 0, sm_scale: float | None = None):
    """The plain PyTorch version of ``fd_page_partials``: the TPU kernel's
    per-page arithmetic, vectorised over rows, pages and heads, a block of
    block-table columns at a time."""
    B, Hq, D = q.shape
    p_local, Hkv, ps, _ = k_pages.shape
    S = block_table.shape[1]
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    kv = kv_len.to(dev, torch.int64)
    qf = q.reshape(B, Hkv, G, D).float()
    out = torch.empty(B, S, Hq, D, dtype=torch.float32, device=dev)
    lse = torch.empty(B, S, Hq, dtype=torch.float32, device=dev)
    offs = torch.arange(ps, device=dev)
    for s0 in range(0, S, _PLAIN_PAGES):
        s1 = min(S, s0 + _PLAIN_PAGES)
        n = s1 - s0
        loc = block_table[:, s0:s1].long() - rank * p_local      # [B, n]
        cols = torch.arange(s0, s1, device=dev)
        live = (loc >= 0) & (loc < p_local) & (cols[None] * ps < kv[:, None])
        # a page that is not this rank's fetches an arbitrary page of the
        # slice (the TPU index map clamps); the select below discards it
        idx = loc.clamp(0, p_local - 1)
        k = k_pages[idx].float()                         # [B, n, Hkv, ps, D]
        v = v_pages[idx]
        scores = torch.einsum("bhgd,bnhjd->bnhgj", qf, k) * scale
        valid = (cols[:, None] * ps + offs)[None] < kv[:, None, None]
        scores = torch.where(valid[:, :, None, None, :], scores,
                             torch.full_like(scores, NEG_INF))
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(-1, keepdim=True)
        pv = torch.einsum("bnhgj,bnhjd->bnhgd", p.to(v.dtype).float(),
                          v.float())
        l_safe = torch.where(l > 0, l, torch.ones_like(l))
        keep = live[:, :, None, None, None] & (l > 0)
        out[:, s0:s1] = torch.where(keep, pv / l_safe,
                                    torch.zeros((), device=dev)) \
            .reshape(B, n, Hq, D)
        lse[:, s0:s1] = torch.where(keep, m + torch.log(l_safe),
                                    torch.full_like(l, NEG_INF)) \
            .reshape(B, n, Hq)
    return out, lse


def _fdd_checks(name: str, q, k_pages, v_pages, block_table, kv_len):
    B, Hq, D = q.shape
    _, Hkv, ps, Dk = k_pages.shape
    _check_cuda(name, (q, k_pages, v_pages, block_table, kv_len))
    if q.dtype not in _FDD_PARTIAL_ENTRIES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share a type in "
                        f"{list(_FDD_PARTIAL_ENTRIES)}, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError(f"{name}: block_table and kv_len must be int32")
    if (Dk != D or v_pages.shape != k_pages.shape or Hq % Hkv
            or Hq // Hkv not in _FDD_GROUPS or D != 128 or ps != _FDD_PAGE
            or block_table.dim() != 2 or block_table.shape[0] != B
            or kv_len.shape != (B,) or B < 1 or block_table.shape[1] < 1
            or B > 65535):
        raise ValueError(
            f"{name}: unsupported shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, block_table "
            f"{tuple(block_table.shape)}, kv_len {tuple(kv_len.shape)} (the "
            f"kernel is built for head dim 128, page size 16 and "
            f"{_FDD_GROUPS} query heads per kv head)")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: page pools must be 16-byte aligned")


def fd_page_partials(q, k_pages, v_pages, block_table, kv_len, rank: int = 0,
                     sm_scale: float | None = None):
    """One independent softmax partial per (row, block-table page): the slab
    the distributed flash-decode folds.

    q [B, Hq, D]; k_pages / v_pages [p_local, Hkv, page_size, D], this
    rank's slice of the pool; block_table [B, S] int32 GLOBAL page ids, rank
    ``rank`` owning ids ``[rank * p_local, (rank + 1) * p_local)``; kv_len
    [B] int32. Returns ``(out [B, S, Hq, D] f32, lse [B, S, Hq] f32)``:
    for a live page of this rank, the partial's ``pv / l`` and
    ``m + log(l)``; for a page that is not this rank's or lies wholly past
    kv_len, the neutral entry (0, NEG_INF). The TPU kernel broadcasts lse
    over 128 lanes (a tiling artifact); one lse per head is its
    ``lse[..., 0]``.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel
    (bf16 or f32, head dim 128, page size 16, 1, 2, 4 or 8 query heads per
    kv head) or raises; each launch adds one to
    ``fd_page_partials.launches``."""
    rank = int(rank)
    if q.device.type == "cpu":
        return fd_page_partials_plain(q, k_pages, v_pages, block_table,
                                      kv_len, rank, sm_scale)
    _fdd_checks("fd_page_partials", q, k_pages, v_pages, block_table, kv_len)
    B, Hq, D = q.shape
    p_local, Hkv, ps, _ = k_pages.shape
    S = block_table.shape[1]
    if S > 65535:
        raise ValueError(f"fd_page_partials: {S} block-table columns; the "
                         "kernel takes at most 65535")
    out = torch.empty(B, S, Hq, D, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, S, Hq, dtype=torch.float32, device=q.device)
    _partials_into(q, k_pages, v_pages, block_table, kv_len, rank, sm_scale,
                   out, lse, neutral_out=True)
    return out, lse


def _partials_into(q, k_pages, v_pages, block_table, kv_len, rank: int,
                   sm_scale, out, lse, neutral_out: bool) -> None:
    """Launch B7 into ``out`` / ``lse`` (checked by the caller). Without
    ``neutral_out`` a neutral entry writes its lse alone: B8 never reads
    the out of an empty entry, so its bytes need not be written."""
    B, Hq, D = q.shape
    p_local, Hkv, ps, _ = k_pages.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    lib = _fdd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with csrc.current_on(q.device):
        rc = getattr(lib, _FDD_PARTIAL_ENTRIES[q.dtype])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, D, ps, p_local,
            block_table.shape[1], rank, scale, int(neutral_out), stream)
    csrc.check(lib, rc, "fd_page_partials")
    fd_page_partials.launches += 1


fd_page_partials.launches = 0


def fd_fold_plain(out, lse, out_dtype):
    """The fixed-order page fold (``_fd_fold``) of a partials slab: out
    [B, S, Hq, D] f32 and lse [B, S, Hq] f32 folded over S in order, each
    product and sum rounded on its own. An entry with ``lse <= FD_EMPTY`` is
    an exact no-op: the carry passes through a select untouched, never
    ``acc * 1 + 0``. Returns ``acc / denom`` (denom 1 where it is 0) in
    ``out_dtype``, [B, Hq, D]."""
    B, S, Hq, D = out.shape
    dev = out.device
    acc = torch.zeros(B, Hq, D, dtype=torch.float32, device=dev)
    m = torch.full((B, Hq, 1), NEG_INF, dtype=torch.float32, device=dev)
    denom = torch.zeros(B, Hq, 1, dtype=torch.float32, device=dev)
    for s in range(S):
        xo = out[:, s].float()
        xl = lse[:, s, :, None].float()
        empty = xl <= FD_EMPTY
        new_m = torch.maximum(m, xl)
        scale = torch.exp(m - new_m)
        w = torch.exp(xl - new_m)
        acc = torch.where(empty, acc, acc * scale + xo * w)
        m = torch.where(empty, m, new_m)
        denom = torch.where(empty, denom, denom * scale + w)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return (acc / safe).to(out_dtype)


def fd_partials_fold_plain(q, k_pages, v_pages, block_table, kv_len,
                           out_dtype=None, sm_scale: float | None = None):
    """The plain PyTorch version of ``fd_partials_fold``: the fold of the
    plain partials."""
    return fd_fold_plain(*fd_page_partials_plain(
        q, k_pages, v_pages, block_table, kv_len, 0, sm_scale),
        out_dtype or q.dtype)


def fd_partials_fold(q, k_pages, v_pages, block_table, kv_len,
                     out_dtype=None, sm_scale: float | None = None):
    """The n = 1 route of the distributed flash-decode: every page's partial
    (``fd_page_partials`` at rank 0 over the whole pool) folded in
    block-table order (``fd_fold_plain``), fused in one kernel that writes
    no slab. Its bits equal ``fd_fold_plain`` of the kernel's slab: each
    page's partial comes from the same device function, the fold rounds each
    product and sum on its own, and the pages past a row's last live page
    are neutral entries, which the kernel skips.

    q [B, Hq, D]; k_pages / v_pages [P, Hkv, page_size, D]; block_table
    [B, S] int32; kv_len [B] int32. Returns [B, Hq, D] in ``out_dtype``
    (q's type by default). A CPU tensor runs the plain version. A CUDA
    tensor launches the kernel (as ``fd_page_partials`` takes, output in
    q's type) or raises; each launch adds one to
    ``fd_partials_fold.launches``."""
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return fd_partials_fold_plain(q, k_pages, v_pages, block_table,
                                      kv_len, out_dtype, sm_scale)
    _fdd_checks("fd_partials_fold", q, k_pages, v_pages, block_table, kv_len)
    if out_dtype != q.dtype:
        raise TypeError(f"fd_partials_fold: the kernel writes q's type "
                        f"{q.dtype}, not {out_dtype}")
    B, Hq, D = q.shape
    P, Hkv, ps, _ = k_pages.shape
    S = block_table.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty(B, Hq, D, dtype=out_dtype, device=q.device)
    lib = _fdd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with csrc.current_on(q.device):
        rc = getattr(lib, _FDD_FOLD_ENTRIES[q.dtype])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, ps, P, S, scale, stream)
    csrc.check(lib, rc, "fd_partials_fold")
    fd_partials_fold.launches += 1
    return out


fd_partials_fold.launches = 0


def fd_fold_dist_plain(outs, lses, out_dtype):
    """The plain version of ``fd_fold_dist``: the slabs of n ranks, outs
    [n, B, S, Hq, D] f32 and lses [n, B, S, Hq] f32, stacked in the one
    fold order (page-major, rank-minor) and folded by ``fd_fold_plain``:
    [B, Hq, D] in ``out_dtype``."""
    n, B, S, Hq, D = outs.shape
    return fd_fold_plain(outs.permute(1, 2, 0, 3, 4).reshape(B, S * n, Hq, D),
                         lses.permute(1, 2, 0, 3).reshape(B, S * n, Hq),
                         out_dtype)


def fd_fold_dist(ctx, outs, lses, kv_len, out_dtype, axis: str = "sp",
                 replicas: bool = False):
    """The fold of n SP ranks' partials slabs across ranks (TPU kernel B8,
    ``_fd_fold_kernel``). ``outs`` [n, B, S, Hq, D] f32 and ``lses`` [n, B,
    S, Hq] f32 hold the slab of each index r of a group along ``axis`` (B7
    over rank r's slice of the pool; the ranks that share an index share
    its slab); ``kv_len`` [B] int32 bounds each row's live pages. Every
    rank folds its group's slabs in the one fixed order, page-major and
    rank-minor, an empty entry (``lse <= FD_EMPTY``) leaving the carry
    untouched, so the result is the n = 1 fold of the same partials bit for
    bit. Returns [B, Hq, D] in ``out_dtype`` (rank 0's), or with
    ``replicas`` every rank of the mesh's, [N, B, Hq, D].

    A CUDA tensor (head dim 128, ``out_dtype`` bf16 or f32) launches
    ``csrc/flash_decode_dist.cu``'s B8 once over every rank of the mesh:
    each rank announces its slab with one counted signal, every rank reads
    its members' slabs in place after n - 1 announcements, and an exit
    barrier keeps each slab until its readers are done. It reads an entry's
    out only where its lse is real. Each launch adds one to
    ``fd_fold_dist.launches``. A CPU tensor runs the plain version."""
    n, group, _, _ = shd.group_plan(ctx, axis)
    N = ctx.num_ranks
    if outs.dim() != 5 or outs.shape[0] != n or lses.shape != outs.shape[:4]:
        raise ValueError(f"fd_fold_dist: the slabs of {n} ranks are [n, B, "
                         f"S, Hq, D] and [n, B, S, Hq], got "
                         f"{tuple(outs.shape)} / {tuple(lses.shape)}")
    if outs.device.type == "cpu":
        res = fd_fold_dist_plain(outs, lses, out_dtype)
        return (res.unsqueeze(0).expand((N,) + tuple(res.shape)).clone()
                if replicas else res)
    _, B, S, Hq, D = outs.shape
    shd.cuda_checks("fd_fold_dist", outs, lses, kv_len)
    if outs.dtype != torch.float32 or lses.dtype != torch.float32 \
            or out_dtype not in _FDD_DIST_ENTRIES \
            or kv_len.dtype != torch.int32:
        raise TypeError(f"fd_fold_dist: the slabs are f32, kv_len int32 and "
                        f"the output bf16 or f32, got {outs.dtype}, "
                        f"{lses.dtype}, {kv_len.dtype} -> {out_dtype}")
    if n < 2 or D != 128 or kv_len.shape != (B,):
        raise ValueError(f"fd_fold_dist: the kernel folds 2..8 ranks at head "
                         f"dim 128, got {n} ranks, D {D}, kv_len "
                         f"{tuple(kv_len.shape)}")
    res = torch.empty(N, B, Hq, D, dtype=out_dtype, device=outs.device)
    lanes = -(-B * Hq // _FOLD_PAIRS)
    pad = family_pad(ctx, "fd_fold", axis, 3 * lanes)
    outs_t = shd.group_table(ctx, outs, axis)
    lses_t = shd.group_table(ctx, lses, axis)
    res_t, pads = shd.tables(ctx, res, pad)
    lib = _fdd_lib()
    args = shd.launch_args(ctx)
    with csrc.current_on(res.device):
        rc = getattr(lib, _FDD_DIST_ENTRIES[out_dtype])(
            outs_t, lses_t, res_t, kv_len.data_ptr(), B, S, Hq, D,
            _FDD_PAGE, lanes, pads, N, ctypes.byref(group), *args)
    csrc.check(lib, rc, "fd_fold_dist")
    fd_fold_dist.launches += 1
    return res if replicas else res[0]


fd_fold_dist.launches = 0


def fd_row_block(n: int, S: int, Hq: int, D: int) -> int:
    """Rows of one block of ``flash_decode_dist`` at n > 1 ranks: the
    largest power of two whose n slabs (S pages x Hq heads x (D + 1) f32 a
    row) fit in ``FD_SLAB_BYTES``, at least 1. A row's fold does not depend
    on the other rows, so the blocks change no bit."""
    per_row = n * S * Hq * (D + 1) * 4
    rows = 1
    while 2 * rows * per_row <= FD_SLAB_BYTES:
        rows *= 2
    return rows


def flash_decode_dist(ctx, q, k_new, v_new, k_pages, v_pages, block_table,
                      pos, kv_len, axis: str = "sp", active=None,
                      replicas: bool = False):
    """Distributed flash-decode over a page pool sharded on ``axis``:
    ``paged_kv_write`` of the new (k, v) rows (``active`` parks frozen rows'
    writes on the scratch page), then the page fold. q [B, Hq, D]; k/v_new
    [B, Hkv, D]; k/v_pages [P, Hkv, page_size, D], the global view of a pool
    sharded on its page dim (index r of a group owns pages ``[r * P / n, (r
    + 1) * P / n)``); block_table [B, S] device rows; pos / kv_len [B]
    int32. Returns ``(attn [B, Hq, D] in q's type, k_pages, v_pages)``, the
    pools updated in place; with ``replicas`` attn is every rank of the
    mesh's, [N, B, Hq, D] (at one rank [1, B, Hq, D]).

    Every rank's masked write together is one scatter of every row (the
    slices are disjoint rows of the one pool), which is how it runs. At one
    rank the fold is ``fd_partials_fold``. At n ranks each index r's slab is
    ``fd_page_partials`` over its slice at ``rank=r`` and ``fd_fold_dist``
    (B8) folds the n slabs page-major, rank-minor: a page's partial is a
    pure function of the row and the page and one rank's entry is real at
    each page, so the result is the n = 1 fold's bit for bit, whatever the
    pool's layout. The rows go through in blocks of ``fd_row_block`` rows
    (B7 n times and B8 once a block), which bounds the slabs to
    ``FD_SLAB_BYTES``. A pool whose pages do not split over the axis
    raises ``ValueError``."""
    n = ctx.axis_size(axis)
    paged_kv_write(k_pages, v_pages, k_new, v_new, block_table, pos,
                   active=active)
    if n == 1:
        attn = fd_partials_fold(q, k_pages, v_pages, block_table, kv_len,
                                q.dtype)
        return (attn[None] if replicas else attn), k_pages, v_pages
    _check_pool_split(k_pages, n, axis)
    B, Hq, D = q.shape
    S = block_table.shape[1]
    p_local = k_pages.shape[0] // n
    slices = [(k_pages[r * p_local:(r + 1) * p_local],
               v_pages[r * p_local:(r + 1) * p_local]) for r in range(n)]
    if q.device.type == "cpu":
        parts = [fd_page_partials_plain(q, kp, vp, block_table, kv_len, r)
                 for r, (kp, vp) in enumerate(slices)]
        attn = fd_fold_dist(ctx, torch.stack([o for o, _ in parts]),
                            torch.stack([l for _, l in parts]), kv_len,
                            q.dtype, axis=axis, replicas=replicas)
        return attn, k_pages, v_pages
    _fdd_checks("flash_decode_dist", q, k_pages, v_pages, block_table, kv_len)
    rb = fd_row_block(n, S, Hq, D)
    blocks = []
    for b0 in range(0, B, rb):
        b1 = min(B, b0 + rb)
        outs = torch.empty(n, b1 - b0, S, Hq, D, dtype=torch.float32,
                           device=q.device)
        lses = torch.empty(n, b1 - b0, S, Hq, dtype=torch.float32,
                           device=q.device)
        for r, (kp, vp) in enumerate(slices):
            _partials_into(q[b0:b1], kp, vp, block_table[b0:b1],
                           kv_len[b0:b1], r, None, outs[r], lses[r],
                           neutral_out=False)
        blocks.append(fd_fold_dist(ctx, outs, lses, kv_len[b0:b1], q.dtype,
                                   axis=axis, replicas=replicas))
        del outs, lses
    attn = blocks[0] if len(blocks) == 1 else torch.cat(
        blocks, dim=1 if replicas else 0)
    return attn, k_pages, v_pages


__all__ = ["AG_METHODS", "AG_METHODS_2D", "FD_EMPTY", "FD_SLAB_BYTES", "NEG_INF",
           "SPLIT_KEYS", "decode_combine", "decode_combine_plain",
           "fd_fold_dist", "fd_fold_dist_plain", "fd_fold_plain",
           "fd_page_partials", "fd_page_partials_plain", "fd_partials_fold",
           "fd_partials_fold_plain", "fd_row_block", "flash_decode_dist",
           "gqa_decode_paged",
           "gqa_decode_paged_plain", "gqa_decode_partial",
           "gqa_decode_partial_plain", "ll_ag_merge", "ll_ag_merge_plain",
           "ll_merge", "ll_merge_plain", "paged_kv_write",
           "pool_ag_start_local", "pool_ag_start_local_plain",
           "sp_gqa_flash_decode", "sp_local_lens", "sp_paged_attend_write",
           "split_count"]
