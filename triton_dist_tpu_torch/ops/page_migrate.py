"""KV page migration between two roles of a mesh axis (TPU kernel B23).

Counterpart of ``triton_dist_tpu/ops/page_migrate.py``: the disaggregated
engine's producer/consumer transport. The producer role pushes a chunk's
finished KV pages into the consumer role's pool at reserved destination
ids, one put per (layer, page) of K and of V, and signals the count; the
consumer waits for exactly those signals and only then reports the pages
landed. The report ``(count, tag)`` is the host ledger's one source of
truth for signal-gated admission (``serving/disagg.py``); the tag is the
send's attempt number, echoed so a late report of a superseded attempt can
be told apart.

The pools are symmetric tensors, ``[N, L, P + 1, Hkv, page_size, D]``
(``ctx.create_symm_tensor``), rank r's own pool at row r and page 0 of each
its scratch page. On a CUDA tensor one cooperative launch covers every
rank of the mesh (``csrc/page_migrate.cu``); the page ids, the count and
the tag are read from device memory, so one build serves every chunk. On a
CPU tensor the plain version copies the same pages. Both update the pools
in place.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.common import family_pad
from triton_dist_tpu_torch.shmem import device as shd

_P = ctypes.c_void_p
_I = ctypes.c_int
# kpool vpool src dst nt landed L pages page_bytes producer consumer silent
# lanes pads n group, then the shmem layer's launch arguments
_SIGNATURE = [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _I, _I,
              _I, _P, _I, _P] + shd.LAUNCH_SIG


def _ids(x) -> list[int]:
    return [int(v) for v in (x.tolist() if torch.is_tensor(x) else x)]


def paged_transport_plain(ctx, pool_k, pool_v, src_ids, dst_ids, n_pages: int,
                          axis, producer: int, consumer: int, tag: int):
    """The plain version of ``paged_transport``: in every group along
    ``axis``, the producer's pages ``src_ids[:n_pages]`` of every layer
    copied to the consumer's ``dst_ids[:n_pages]``, in place. Returns
    (pool_k, pool_v, landed [N, 2] int32)."""
    axes = ctx.group_axes(axis)
    landed = torch.zeros(ctx.num_ranks, 2, dtype=torch.int32)
    landed[:, 1] = tag
    src = torch.tensor(src_ids[:n_pages], dtype=torch.long)
    dst = torch.tensor(dst_ids[:n_pages], dtype=torch.long)
    for r in range(ctx.num_ranks):
        me = ctx.my_pe(r, axes)
        if me not in (producer, consumer):
            continue
        landed[r, 0] = n_pages
        if me == producer and n_pages:
            peer = ctx.pe_at_group(r, axes, consumer)
            pool_k[peer][:, dst] = pool_k[r][:, src]
            pool_v[peer][:, dst] = pool_v[r][:, src]
    return pool_k, pool_v, landed.to(pool_k.device)


def paged_transport(ctx, pool_k, pool_v, src_ids, dst_ids, n_pages,
                    axis: str | None = None, producer: int = 0,
                    consumer: int = 1, tag: int = 0,
                    name: str = "page_migrate", silent: bool = False):
    """Move ``n_pages`` pages of every layer from the ``producer`` role to
    the ``consumer`` role of each group along ``axis`` (the context's first
    axis by default): the shared core of ``migrate_pages`` and
    ``lend_pages``, each of which keys its own signal pad by ``name``.

    ``pool_k`` / ``pool_v``: symmetric pools [N, L, P + 1, Hkv, page_size,
    D], page 0 of each rank's pool its scratch page. ``src_ids`` /
    ``dst_ids``: [pmax] page ids (producer-local sources, consumer-side
    destinations), valid up to ``n_pages``; entries past it are never read.
    ``tag`` is the send's attempt number, echoed in the report. Returns
    ``(pool_k, pool_v, landed [N, 2] int32)``, the pools updated in place:
    ``landed[r] == (n_pages, tag)`` at the producer and, once every covered
    page has landed, at the consumer; ``(0, tag)`` at ranks outside the
    pair, which take part in the entry barrier only.

    A CUDA tensor launches ``csrc/page_migrate.cu``, adding one to
    ``paged_transport.launches``; ``silent`` makes the producer put without
    signalling, so the consumer's wait runs out and the next collective
    call (or ``shmem.check_errors``) raises ``ShmemError`` (the starvation
    check). A CPU tensor runs the plain version."""
    axis = axis or ctx.axis_names[0]
    n_roles, group, _, _ = shd.group_plan(ctx, axis)
    n_pages = int(n_pages.reshape(-1)[0]) if torch.is_tensor(n_pages) \
        else int(n_pages)
    tag = int(tag.reshape(-1)[0]) if torch.is_tensor(tag) else int(tag)
    src, dst = _ids(src_ids), _ids(dst_ids)
    N = ctx.num_ranks
    if n_roles < 2 or producer == consumer or not (
            0 <= producer < n_roles and 0 <= consumer < n_roles):
        raise ValueError(f"paged_transport: roles {producer} -> {consumer} "
                         f"on an axis of {n_roles}")
    if pool_k.shape != pool_v.shape or pool_k.dim() != 6 \
            or pool_k.shape[0] != N:
        raise ValueError(f"paged_transport: the pools are symmetric [{N}, L, "
                         f"P + 1, Hkv, page_size, D], got "
                         f"{tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    pages = pool_k.shape[2]
    if len(src) != len(dst) or not 0 <= n_pages <= len(src) or any(
            not 0 <= p < pages for p in src[:n_pages] + dst[:n_pages]):
        raise ValueError(f"paged_transport: {n_pages} pages of id lists "
                         f"{len(src)} / {len(dst)} long, ids in [0, {pages})")
    if pool_k.device.type == "cpu":
        return paged_transport_plain(ctx, pool_k, pool_v, src, dst, n_pages,
                                     axis, producer, consumer, tag)
    shd.cuda_checks("paged_transport", pool_k, pool_v)
    L = pool_k.shape[1]
    page_bytes = pool_k[0, 0, 0].numel() * pool_k.element_size()
    dev = pool_k.device
    pmax = len(src)
    # [src | dst | n_pages, tag]: one upload
    ids = torch.tensor(src + dst + [n_pages, tag], dtype=torch.int32).to(dev)
    base, step = ids.data_ptr(), 4 * pmax
    landed = torch.empty(N, 2, dtype=torch.int32, device=dev)
    lanes = max(pmax, 1) * L
    pad = family_pad(ctx, name, axis, lanes + 1)
    kt, vt, pads = shd.tables(ctx, pool_k, pool_v, pad)
    lib = csrc.load("page_migrate", {"tdt_paged_transport": _SIGNATURE})
    args = shd.launch_args(ctx)
    with csrc.current_on(dev):
        rc = lib.tdt_paged_transport(
            kt, vt, base, base + step, base + 2 * step, landed.data_ptr(), L,
            pages, page_bytes, producer, consumer, int(silent), lanes, pads,
            N, ctypes.byref(group), *args)
    csrc.check(lib, rc, "paged_transport")
    paged_transport.launches += 1
    return pool_k, pool_v, landed


paged_transport.launches = 0


def migrate_pages(ctx, pool_k, pool_v, src_ids, dst_ids, n_pages,
                  axis: str | None = None, producer: int = 0,
                  consumer: int = 1, tag: int = 0):
    """The disaggregated prefill-to-decode handoff over the role axis: a
    front over ``paged_transport`` (its contracts) with its own signal
    pad."""
    return paged_transport(ctx, pool_k, pool_v, src_ids, dst_ids, n_pages,
                           axis=axis, producer=producer, consumer=consumer,
                           tag=tag, name="page_migrate")


__all__ = ["migrate_pages", "paged_transport", "paged_transport_plain"]
