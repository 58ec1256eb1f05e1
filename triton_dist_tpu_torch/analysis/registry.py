"""The op registry sigcheck iterates: every public name in
``triton_dist_tpu_torch.ops`` (its ``__all__``) is either protocol-checked
here (a ``run`` callable that drives the op end to end on a port
``ShmemContext`` at tiny shapes the op and its kernel accept) or carries a
documented skip reason (pure host math and plain versions, config
classes, eager stateful wrappers whose kernel path is checked through their
functional twin, and the single-device kernels, which signal nobody).

Counterpart of ``triton_dist_tpu/analysis/registry.py``: the same meshes
(n in {2, 3, 4}, ``MESH_2D``, ``MESH_PAIR``, ``MESH_LEND``). The tests hold
the registry and the ``ops`` surface in lockstep. Shapes are chosen per
rank count inside ``run`` and follow the kernels' own limits (head dim
128, 16-row pages, B20's K a multiple of 32 n).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from triton_dist_tpu_torch.analysis.api import DEFAULT_MESHES

MESH_2D: Tuple[Dict[str, int], ...] = ({"x": 2, "y": 2},)
MESH_PAIR: Tuple[Dict[str, int], ...] = ({"role": 2},)
# lend_pages' role-gated protocol must balance at any axis size (ranks
# outside the {lender, borrower} pair only take the entry barrier)
MESH_LEND: Tuple[Dict[str, int], ...] = ({"role": 2}, {"role": 3},
                                         {"role": 4})
MESH_1D_AND_2D = DEFAULT_MESHES + MESH_2D


@dataclasses.dataclass
class RegistryEntry:
    name: str
    run: Optional[Callable[[Any], Any]] = None
    meshes: Sequence[Dict[str, int]] = DEFAULT_MESHES
    skip: Optional[str] = None


def _zeros(ctx, *shape, dtype=None):
    import torch

    return torch.zeros(shape, dtype=dtype or torch.float32,
                       device=ctx.device)


def _ints(ctx, values):
    import torch

    return torch.tensor(values, dtype=torch.int32, device=ctx.device)


# -- collectives -------------------------------------------------------------

def _run_barrier_all_op(ctx):
    from triton_dist_tpu_torch.ops import barrier_all_op
    barrier_all_op(ctx)()


def _run_all_gather(ctx):
    from triton_dist_tpu_torch.ops import all_gather
    x = _zeros(ctx, 4 * ctx.num_ranks, 128)
    methods = ("push_2d", "ring_2d") if len(ctx.axis_names) > 1 \
        else ("push", "ring")
    for method in methods:
        all_gather(ctx, x, method=method)


def _run_all_gather_ll(ctx):
    import torch

    from triton_dist_tpu_torch.ops import all_gather_ll, create_ag_ll_workspace
    ws = create_ag_ll_workspace(ctx, 4, (128,), torch.float32)
    all_gather_ll(ctx, _zeros(ctx, 4 * ctx.num_ranks, 128), ws, 0)


def _run_broadcast(ctx):
    from triton_dist_tpu_torch.ops import broadcast
    n = ctx.num_ranks
    broadcast(ctx, _zeros(ctx, n, 8, 128), root=n - 1)


def _run_reduce_scatter(ctx):
    from triton_dist_tpu_torch.ops import reduce_scatter
    n = ctx.num_ranks
    x = _zeros(ctx, 4 * n * n, 128)
    if len(ctx.axis_names) > 1:
        reduce_scatter(ctx, x, axis=None, method="ring_2d")
    else:
        reduce_scatter(ctx, x, method="ring")


# -- GEMM overlaps (B15, B16) ------------------------------------------------

def _ag_operands(ctx):
    n = ctx.num_ranks
    return _zeros(ctx, 16 * n, 128), _zeros(ctx, 128, 128 * n)


def _rs_operands(ctx):
    n = ctx.num_ranks
    return _zeros(ctx, 16 * n, 128 * n), _zeros(ctx, 128 * n, 128)


def _run_ag_gemm(ctx):
    from triton_dist_tpu_torch.ops import ag_gemm
    ag_gemm(ctx, *_ag_operands(ctx))


def _run_ag_gemm_ws(ctx):
    import torch

    from triton_dist_tpu_torch.ops import ag_gemm_ws, create_ag_gemm_workspace
    ws = create_ag_gemm_workspace(ctx, 16, 128, torch.float32)
    ag_gemm_ws(ctx, *_ag_operands(ctx), ws)


def _run_ag_gemm_diff(ctx):
    from triton_dist_tpu_torch.ops import ag_gemm_diff
    ag_gemm_diff(ctx, ctx.axis_names[0], None, *_ag_operands(ctx))


def _run_tp_column_linear(ctx):
    from triton_dist_tpu_torch.ops import tp_column_linear
    n = ctx.num_ranks
    w = _zeros(ctx, 128, 128 * n)
    tp_column_linear(ctx, _zeros(ctx, 16, 128), w, axis="x", impl="xla")
    tp_column_linear(ctx, _zeros(ctx, 16 * n, 128), w, axis="x",
                     impl="ag_gemm")


def _run_gemm_rs(ctx):
    from triton_dist_tpu_torch.ops import gemm_rs
    gemm_rs(ctx, *_rs_operands(ctx))


def _run_gemm_rs_ws(ctx):
    import torch

    from triton_dist_tpu_torch.ops import (create_gemm_rs_workspace,
                                           gemm_rs_ws)
    ws, stage = create_gemm_rs_workspace(ctx, 16, 128, torch.float32)
    gemm_rs_ws(ctx, *_rs_operands(ctx), ws, stage)


def _run_gemm_rs_diff(ctx):
    from triton_dist_tpu_torch.ops import gemm_rs_diff
    gemm_rs_diff(ctx, ctx.axis_names[0], None, *_rs_operands(ctx))


# -- ring attention (B24, B25) -----------------------------------------------

def _ra_inputs(ctx):
    n = ctx.num_ranks
    q = _zeros(ctx, 1, 2, 128 * n, 128)
    kv = _zeros(ctx, 1, 2, 128 * n, 128)
    return q, kv


def _run_ring_attention(ctx):
    from triton_dist_tpu_torch.ops import ring_attention
    q, kv = _ra_inputs(ctx)
    ring_attention(ctx, q, kv, kv, axis="x")


def _run_ring_attention_fwd(ctx):
    from triton_dist_tpu_torch.ops import ring_attention_fwd
    q, kv = _ra_inputs(ctx)
    for layout in ("contiguous", "zigzag"):
        ring_attention_fwd(ctx, q, kv, kv, axis="x", layout=layout)


def _run_ring_attention_bwd(ctx):
    from triton_dist_tpu_torch.ops import ring_attention_bwd, ring_attention_fwd
    q, kv = _ra_inputs(ctx)
    o, lse = ring_attention_fwd(ctx, q, kv, kv, axis="x")
    ring_attention_bwd(ctx, q, kv, kv, o, lse, o, axis="x")


# -- serving: page migration and lending -------------------------------------

def _pools(ctx):
    n = ctx.num_ranks
    return (_zeros(ctx, n, 2, 9, 2, 16, 128), _zeros(ctx, n, 2, 9, 2, 16, 128))


def _run_migrate_pages(ctx):
    from triton_dist_tpu_torch.ops import migrate_pages
    migrate_pages(ctx, *_pools(ctx), [1, 2, 0, 0], [3, 4, 0, 0], 2,
                  axis="role")


def _run_lend_pages(ctx):
    from triton_dist_tpu_torch.ops import lend_pages
    # lender 0 -> borrower (last rank): at n > 2 the middle ranks only take
    # the entry barrier, and their books must still balance
    lend_pages(ctx, *_pools(ctx), [1, 2, 0, 0], [3, 4, 0, 0], 2, axis="role",
               lender=0, borrower=ctx.num_ranks - 1)


# -- EP all-to-all (B21) -----------------------------------------------------

def _run_ep_dispatch_combine(ctx):
    import torch

    from triton_dist_tpu_torch.ops import (combine, create_all_to_all_context,
                                           dispatch, route_tokens)
    n = ctx.num_ranks
    T, H, topk = 4, 128, 2
    a2a = create_all_to_all_context(ctx, max_tokens=T, hidden=H, topk=topk,
                                    num_experts=2 * n, dtype=torch.float32)
    ids = _zeros(ctx, n * T, topk, dtype=torch.int32)
    route_tokens(a2a, ids)
    recv, _, layout = dispatch(a2a, _zeros(ctx, n * T, H), ids)
    combine(a2a, _zeros(ctx, *recv.shape), layout, _zeros(ctx, n * T, topk))


def _run_ep_dispatch_combine_2d(ctx):
    import torch

    from triton_dist_tpu_torch.ops import (combine_2d,
                                           create_all_to_all_context_2d,
                                           dispatch_2d, route_tokens_2d)
    n = ctx.num_ranks
    T, H, topk = 4, 128, 2
    a2a = create_all_to_all_context_2d(ctx, max_tokens=T, hidden=H,
                                       topk=topk, num_experts=n,
                                       dtype=torch.float32)
    ids = _zeros(ctx, n * T, topk, dtype=torch.int32)
    route_tokens_2d(a2a, ids)
    recv, _, layouts = dispatch_2d(a2a, _zeros(ctx, n * T, H), ids)
    combine_2d(a2a, _zeros(ctx, *recv.shape), layouts,
               _zeros(ctx, n * T, topk))


# -- flash decode (B5, B6, B7's fold) ----------------------------------------

def _run_ll_ag_merge(ctx):
    import torch

    from triton_dist_tpu_torch.ops import ll_ag_merge
    n = ctx.num_ranks
    ll_ag_merge(ctx, _zeros(ctx, n, 1, 4, 128), _zeros(ctx, n, 1, 4),
                torch.float32, "x")


def _run_sp_gqa_flash_decode(ctx):
    from triton_dist_tpu_torch.ops import sp_gqa_flash_decode
    n = ctx.num_ranks
    kv = _zeros(ctx, n, 1, 2, 128, 128)
    sp_gqa_flash_decode(ctx, _zeros(ctx, 1, 4, 128), kv, kv,
                        _ints(ctx, [100]), axis="x")


def _sp_pools(ctx):
    n = ctx.num_ranks
    return (_zeros(ctx, 4 * n, 2, 16, 128), _zeros(ctx, 4 * n, 2, 16, 128))


def _run_pool_ag_start_local(ctx):
    from triton_dist_tpu_torch.ops import pool_ag_start_local
    pool_ag_start_local(ctx, *_sp_pools(ctx), axis="x")


def _run_flash_decode_dist(ctx):
    from triton_dist_tpu_torch.ops import flash_decode_dist
    new = _zeros(ctx, 1, 2, 128)
    flash_decode_dist(ctx, _zeros(ctx, 1, 4, 128), new, new, *_sp_pools(ctx),
                      _ints(ctx, [[1, 2, 0, 0]]), _ints(ctx, [20]),
                      _ints(ctx, [21]), axis="x")


# -- MoE overlaps (B19, B20) -------------------------------------------------

def _run_ag_moe_group_gemm(ctx):
    import torch

    from triton_dist_tpu_torch.ops import ag_moe_group_gemm
    n = ctx.num_ranks
    ag_moe_group_gemm(ctx, _zeros(ctx, 8 * n, 128),
                      _zeros(ctx, 8 * n, dtype=torch.int32),
                      _zeros(ctx, 2, 128, 64 * n), block_m=16)


def _run_moe_reduce_rs(ctx):
    import torch

    from triton_dist_tpu_torch.ops import moe_reduce_rs
    n = ctx.num_ranks
    T, topk = 4 * n, 2
    moe_reduce_rs(ctx, _zeros(ctx, T * topk, 64 * n),
                  _zeros(ctx, T * topk, dtype=torch.int32),
                  _zeros(ctx, T, topk), _zeros(ctx, 2, 64 * n, 128),
                  block_m=16)


# -- the registry ------------------------------------------------------------

_SKIP_PURE = "pure host-side math, no DMA/semaphore protocol"
_SKIP_CLASS = "config/context dataclass, not an op"
_SKIP_PLAIN = "plain PyTorch version of a kernel; " + _SKIP_PURE
_SKIP_LOCAL = "single-device kernel, no signal protocol"
_SKIP_CONST = "constant, not an op"


def _eager(op: str) -> str:
    return f"eager stateful wrapper; kernel path checked via {op}"


_ENTRIES = [
    # common (B14)
    RegistryEntry("barrier_all_op", _run_barrier_all_op,
                  meshes=MESH_1D_AND_2D),
    RegistryEntry("barrier_all_plain", skip=_SKIP_PLAIN),
    # allgather (B9-B12)
    RegistryEntry("all_gather", _run_all_gather, meshes=MESH_1D_AND_2D),
    RegistryEntry("all_gather_plain", skip=_SKIP_PLAIN),
    RegistryEntry("all_gather_ll", _run_all_gather_ll),
    RegistryEntry("create_ag_ll_workspace", _run_all_gather_ll),
    RegistryEntry("AgLLContext", skip=_eager("all_gather_ll")),
    RegistryEntry("broadcast", _run_broadcast),
    # reduce_scatter (B13)
    RegistryEntry("reduce_scatter", _run_reduce_scatter,
                  meshes=MESH_1D_AND_2D),
    RegistryEntry("reduce_scatter_plain", skip=_SKIP_PLAIN),
    # AG-GEMM (B15)
    RegistryEntry("GemmConfig", skip=_SKIP_CLASS),
    RegistryEntry("ag_gemm", _run_ag_gemm),
    RegistryEntry("ag_gemm_plain", skip=_SKIP_PLAIN),
    RegistryEntry("ag_gemm_ws", _run_ag_gemm_ws),
    RegistryEntry("create_ag_gemm_workspace", _run_ag_gemm_ws),
    RegistryEntry("create_ag_gemm_context", skip=_eager("ag_gemm_ws")),
    RegistryEntry("AgGemmContext", skip=_eager("ag_gemm_ws")),
    RegistryEntry("tp_column_linear", _run_tp_column_linear),
    RegistryEntry("ag_gemm_diff", _run_ag_gemm_diff),
    # GEMM-RS (B16)
    RegistryEntry("gemm_rs", _run_gemm_rs),
    RegistryEntry("gemm_rs_plain", skip=_SKIP_PLAIN),
    RegistryEntry("gemm_rs_ws", _run_gemm_rs_ws),
    RegistryEntry("create_gemm_rs_workspace", _run_gemm_rs_ws),
    RegistryEntry("create_gemm_rs_context", skip=_eager("gemm_rs_ws")),
    RegistryEntry("GemmRsContext", skip=_eager("gemm_rs_ws")),
    RegistryEntry("gemm_rs_diff", _run_gemm_rs_diff),
    # the dense GEMM (B2) and GEMM-RS's slot reduction
    RegistryEntry("matmul", skip=_SKIP_LOCAL),
    RegistryEntry("matmul_plain", skip=_SKIP_PLAIN),
    RegistryEntry("slot_reduce", skip=_SKIP_LOCAL),
    RegistryEntry("slot_reduce_plain", skip=_SKIP_PLAIN),
    # ring attention (B24, B25)
    RegistryEntry("ring_attention", _run_ring_attention),
    RegistryEntry("ring_attention_fwd", _run_ring_attention_fwd),
    RegistryEntry("ring_attention_bwd", _run_ring_attention_bwd),
    RegistryEntry("ring_attention_fwd_plain", skip=_SKIP_PLAIN),
    RegistryEntry("ring_attention_bwd_plain", skip=_SKIP_PLAIN),
    RegistryEntry("zigzag_indices", skip=_SKIP_PURE),
    # page migration and lending (B22, B23: one pairwise protocol)
    RegistryEntry("migrate_pages", _run_migrate_pages, meshes=MESH_PAIR),
    RegistryEntry("paged_transport",
                  skip="shared transport host wrapper; protocol checked "
                       "via migrate_pages and lend_pages"),
    RegistryEntry("paged_transport_plain", skip=_SKIP_PLAIN),
    RegistryEntry("lend_pages", _run_lend_pages, meshes=MESH_LEND),
    # EP all-to-all (B21)
    RegistryEntry("create_all_to_all_context", _run_ep_dispatch_combine),
    RegistryEntry("dispatch", _run_ep_dispatch_combine),
    RegistryEntry("combine", _run_ep_dispatch_combine),
    RegistryEntry("route_tokens", _run_ep_dispatch_combine),
    RegistryEntry("create_all_to_all_context_2d", _run_ep_dispatch_combine_2d,
                  meshes=MESH_2D),
    RegistryEntry("dispatch_2d", _run_ep_dispatch_combine_2d, meshes=MESH_2D),
    RegistryEntry("combine_2d", _run_ep_dispatch_combine_2d, meshes=MESH_2D),
    RegistryEntry("route_tokens_2d", _run_ep_dispatch_combine_2d,
                  meshes=MESH_2D),
    RegistryEntry("EpAllToAllContext", skip=_SKIP_CLASS),
    RegistryEntry("Ep2dAllToAllContext", skip=_SKIP_CLASS),
    RegistryEntry("QuantTokens", skip=_SKIP_CLASS),
    RegistryEntry("ep_dispatch", skip=_SKIP_LOCAL),
    RegistryEntry("ep_dispatch_plain", skip=_SKIP_PLAIN),
    RegistryEntry("ep_combine", skip=_SKIP_LOCAL),
    RegistryEntry("ep_combine_plain", skip=_SKIP_PLAIN),
    # flash decode (B1, B3, B4, B5, B6, B7)
    RegistryEntry("FD_EMPTY", skip=_SKIP_CONST),
    RegistryEntry("NEG_INF", skip=_SKIP_CONST),
    RegistryEntry("SPLIT_KEYS", skip=_SKIP_CONST),
    RegistryEntry("gqa_decode_paged", skip=_SKIP_LOCAL),
    RegistryEntry("gqa_decode_paged_plain", skip=_SKIP_PLAIN),
    RegistryEntry("paged_kv_write", skip=_SKIP_LOCAL),
    RegistryEntry("gqa_decode_partial", skip=_SKIP_LOCAL),
    RegistryEntry("gqa_decode_partial_plain", skip=_SKIP_PLAIN),
    RegistryEntry("decode_combine", skip=_SKIP_LOCAL),
    RegistryEntry("decode_combine_plain", skip=_SKIP_PLAIN),
    RegistryEntry("ll_merge", skip=_SKIP_LOCAL),
    RegistryEntry("ll_merge_plain", skip=_SKIP_PLAIN),
    RegistryEntry("ll_ag_merge", _run_ll_ag_merge),
    RegistryEntry("ll_ag_merge_plain", skip=_SKIP_PLAIN),
    RegistryEntry("sp_gqa_flash_decode", _run_sp_gqa_flash_decode),
    RegistryEntry("pool_ag_start_local", _run_pool_ag_start_local),
    RegistryEntry("pool_ag_start_local_plain", skip=_SKIP_PLAIN),
    RegistryEntry("fd_page_partials", skip=_SKIP_LOCAL),
    RegistryEntry("fd_page_partials_plain", skip=_SKIP_PLAIN),
    RegistryEntry("fd_partials_fold", skip=_SKIP_LOCAL),
    RegistryEntry("fd_partials_fold_plain", skip=_SKIP_PLAIN),
    RegistryEntry("fd_fold_plain", skip=_SKIP_PLAIN),
    RegistryEntry("flash_decode_dist", _run_flash_decode_dist),
    # grouped GEMM (B17, B18)
    RegistryEntry("grouped_gemm", skip=_SKIP_LOCAL),
    RegistryEntry("grouped_gemm_plain", skip=_SKIP_PLAIN),
    RegistryEntry("grouped_gemm_gated", skip=_SKIP_LOCAL),
    RegistryEntry("grouped_gemm_gated_plain", skip=_SKIP_PLAIN),
    RegistryEntry("apply_grouped",
                  skip=_SKIP_LOCAL + "; runs grouped_gemm"),
    RegistryEntry("moe_ffn_local",
                  skip=_SKIP_LOCAL + "; runs grouped_gemm_gated"),
    RegistryEntry("PackedGatedWeights", skip=_SKIP_CLASS),
    RegistryEntry("pack_gated_weights",
                  skip="pure weight relayout; " + _SKIP_PURE),
    RegistryEntry("unpack_gated_weights",
                  skip="pure weight relayout; " + _SKIP_PURE),
    RegistryEntry("align_tokens_by_expert",
                  skip=_SKIP_PURE + "; exercised inside apply_grouped"),
    RegistryEntry("used_block_count",
                  skip=_SKIP_PURE + "; exercised inside apply_grouped"),
    RegistryEntry("expert_alignment", skip=_SKIP_PURE),
    # MoE overlaps (B19, B20)
    RegistryEntry("ag_moe_group_gemm", _run_ag_moe_group_gemm),
    RegistryEntry("moe_reduce_rs", _run_moe_reduce_rs),
]

REGISTRY: Dict[str, RegistryEntry] = {e.name: e for e in _ENTRIES}


def surface_names() -> set:
    """The public names of ``triton_dist_tpu_torch.ops`` (its ``__all__``):
    the set the registry must cover exactly."""
    from triton_dist_tpu_torch import ops
    return set(ops.__all__)


__all__ = ["MESH_1D_AND_2D", "MESH_2D", "MESH_LEND", "MESH_PAIR", "REGISTRY",
           "RegistryEntry", "surface_names"]
