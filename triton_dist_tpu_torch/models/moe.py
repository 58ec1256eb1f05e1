"""MoE model family (Mixtral/DeepSeek-style): configs, parameters and the
MoE FFNs of the serving path.

Counterpart of ``triton_dist_tpu/models/moe.py``. Its inference block
``moe_mlp_ep_overlap`` routes rows through the EP all-to-all
(``layers.EPAll2AllLayer`` over ``ops.all_to_all``: B21, or B22 for the
microbatched schedule; B21 over both tiers of a 2-tier layer) to the ranks
that hold their experts, runs each rank's local experts (``ops.group_gemm``:
B18 then B17) and combines the rows back, at any EP size, one rank
included, in every form the reference deploys (expert-major slots, the
expert edge of a quantised wire, the packed gate‖up stream). The
tensor-parallel block ``moe_mlp_tp_overlap`` runs over the MoE-TP ops of
``ops.moe`` (B19, B20) at any TP size, and ``moe_decode_step_sp`` is the
serving decode step that puts sequence-parallel attention and this EP FFN on
one axis. The GShard training path (``moe_mlp_gshard``, ``moe_forward``)
waits for ROADMAP.md Queue A, item 7 "MoE / EP across ranks".
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.models.llama import (LlamaConfig, decode_step_sp,
                                                init_params)
from triton_dist_tpu_torch.ops.all_to_all import QuantTokens, _cap_round
from triton_dist_tpu_torch.ops.allgather import all_gather
from triton_dist_tpu_torch.ops.allgather_gemm import norm_axis
from triton_dist_tpu_torch.ops.group_gemm import (PackedGatedWeights,
                                                  apply_grouped, grouped_gemm,
                                                  grouped_gemm_gated)
from triton_dist_tpu_torch.ops.moe import ag_moe_group_gemm, moe_reduce_rs
from triton_dist_tpu_torch.utils.env import default_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    base: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    num_experts: int = 8
    topk: int = 2
    moe_d_ff: int = 2048           # per-expert FFN width

    @classmethod
    def tiny(cls, n_layers: int = 2, num_experts: int = 4):
        return cls(base=LlamaConfig.tiny(n_layers), num_experts=num_experts,
                   topk=2, moe_d_ff=128)

    @classmethod
    def mixtral_8x7b(cls):
        """The reference preset, kept as it is: it leaves ``rope_theta`` at
        ``LlamaConfig``'s 1e4, where Mixtral-8x7B's published config has
        1e6 (ROADMAP Queue C)."""
        return cls(base=LlamaConfig(vocab_size=32000, d_model=4096,
                                    n_layers=32, n_heads=32, n_kv_heads=8,
                                    d_ff=14336),
                   num_experts=8, topk=2, moe_d_ff=14336)

    @classmethod
    def deepseek_infer(cls):
        """The reference's A2A benchmark shape: hidden 7168, topk 8."""
        return cls(base=LlamaConfig(vocab_size=129280, d_model=7168,
                                    n_layers=4, n_heads=56, n_kv_heads=8,
                                    d_ff=18432),
                   num_experts=64, topk=8, moe_d_ff=2048)


def _normal(shape, gen, dev, dtype, std: float = 0.02):
    """Scaled normals drawn in f32 one trailing matrix at a time into a
    preallocated tensor, so no f32 copy of the whole tensor exists (a
    Mixtral-width ``we_gate`` of 16 layers is 47 GB in f32)."""
    out = torch.empty(shape, dtype=dtype, device=dev)
    for mat in out.view(-1, *shape[-2:]):
        mat.copy_(torch.randn(shape[-2:], generator=gen, device=dev,
                              dtype=torch.float32).mul_(std))
    return out


def init_moe_params(cfg: MoEConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from seeded ``torch.Generator``s: the attention
    weights as ``llama.init_params`` makes them, plus per layer the f32
    router ``w_router`` [L, D, E] and the stacked experts ``we_gate`` /
    ``we_up`` [L, E, D, F] and ``we_down`` [L, E, F, D] in ``cfg.base.dtype``.
    The same keys and shapes as the JAX ``init_moe_params``; the numbers
    differ (another generator)."""
    dev = default_device(device)
    b = cfg.base
    L, D, F, E = b.n_layers, b.d_model, cfg.moe_d_ff, cfg.num_experts
    # the experts replace the dense FFN: d_ff=0 leaves its tensors empty
    params = init_params(dataclasses.replace(b, d_ff=0), seed=seed,
                         device=dev)
    blocks = params["blocks"]
    for k in ("w_gate", "w_up", "w_down"):
        del blocks[k]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    blocks["w_router"] = _normal((L, D, E), gen, dev, torch.float32)
    blocks["we_gate"] = _normal((L, E, D, F), gen, dev, b.dtype)
    blocks["we_up"] = _normal((L, E, D, F), gen, dev, b.dtype)
    blocks["we_down"] = _normal((L, E, F, D), gen, dev, b.dtype)
    return params


def router_topk(x2d, router_w, topk: int):
    """The router in f32 (``x2d.float() @ router_w``), softmax, top-k and
    the renormalised top-k weights: (weights [T, k] f32, ids [T, k])."""
    probs = torch.softmax(x2d.float() @ router_w, -1)
    gate_vals, gate_ids = probs.topk(topk, -1)
    return gate_vals / gate_vals.sum(-1, keepdim=True), gate_ids


def _expert_major_table(n: int, cap: int, cap_e: int, el: int, block_m: int,
                        rows: int, device):
    """The static block -> expert table of expert-major receive rows: row
    block b of rank d's ``n * cap`` rows lies at offset ``(b * block_m) %
    cap`` of a (src, dst) block, whose local expert is that offset //
    ``cap_e``; its global expert is ``d * el`` more."""
    b = torch.arange(rows // block_m, device=device) * block_m
    return ((b // (n * cap)) * el + (b % cap) // cap_e).to(torch.int32)


def moe_mlp_ep_overlap(ctx, a2a_layer, x2d, router_w, we_gate, we_up,
                       we_down, axis: str | None = None, block_m: int = 64,
                       block_n: int = 128, block_k: int | None = None,
                       down_block_n: int | None = None,
                       we_gate_up_packed=None, microbatches: int = 1):
    """The EP MoE inference block (the JAX ``moe_mlp_ep_overlap``): router,
    the EP dispatch, each rank's local experts, the EP combine.

    ``x2d`` [n * T, D] holds every EP rank's T token rows, rank-major (the
    global view of rows sharded over ``a2a_layer``'s axis, or its pair of
    axes on two tiers, in the order of their flattened coordinate);
    router_w [D, E]; we_gate / we_up [E, D, F], we_down [E, F, D]. Rank r's
    local experts are the slice ``we_*[r * El:(r + 1) * El]``, views of the
    same tensors. Returns [n * T, D] in the context's type.

    The router runs over every rank's rows in one product (``router_topk``;
    a row's result is its rank's), then ``a2a_layer.dispatch``. The expert
    FFN runs over every rank's received rows in one launch of each grouped
    GEMM (B18, then B17), rank r's local expert e as global expert r * El +
    e (a row's result does not depend on the rows beside it), then
    ``a2a_layer.combine``. The rows are aligned by expert as
    ``apply_grouped`` does, except on an ``expert_major`` context whose
    per-expert budget is a multiple of ``block_m``: the received rows are
    then expert-aligned already, and every row block runs against a static
    block -> expert table, with no alignment pass (unfilled slots are zero
    rows and give zeros).

    On a quantised wire with ``dequant_edge="expert"`` the received rows
    stay fp8 or int8 and their scales go to both grouped GEMMs'
    ``row_scale`` (the gated kernel reads the one-byte rows; its output is
    in the context's type). ``we_gate_up_packed`` (``pack_gated_weights(
    we_gate, we_up, block_n)``; its width must be ``block_n``) runs B18
    over the packed stream; ``block_k`` is B18's K split. ``block_n`` is
    only the pack width (unread without a packed stream), and
    ``down_block_n`` (the reference's down-GEMM column tile) is accepted
    for the JAX function's signature only and unread: the column tile is
    the kernels' own.

    ``microbatches=M > 1`` (one axis, rank-major slots) splits each rank's
    rows into M contiguous blocks, each through an M-times-smaller
    drop-proof context (same wire type, edges and segmented wire), issuing
    block i + 1's dispatch before block i's FFN; the outputs are
    concatenated back per rank in order, so the result is bitwise
    ``microbatches=1``'s."""
    del axis, down_block_n
    a2a = a2a_layer.a2a
    is_2d = a2a_layer.is_2d
    n, E, k = a2a.n_ranks, a2a.num_experts, a2a.topk
    el = a2a.experts_per_rank
    T, D = a2a.max_tokens, x2d.shape[1]
    packed = we_gate_up_packed is not None
    if isinstance(we_gate_up_packed, PackedGatedWeights) \
            and we_gate_up_packed.block_n != block_n:
        raise ValueError(
            f"we_gate_up_packed was packed with block_n="
            f"{we_gate_up_packed.block_n} but the layer runs block_n="
            f"{block_n}: repack with pack_gated_weights(..., block_n="
            f"{block_n})")
    expert_major = not is_2d and a2a.expert_major
    cap_e = a2a.capacity_per_expert if expert_major else None
    em_fast = expert_major and cap_e % block_m == 0
    gate_vals, gate_ids = router_topk(x2d, router_w, k)
    mbs = int(microbatches)
    if mbs > 1:
        if is_2d or expert_major:
            raise ValueError(
                "microbatches > 1 run the one-axis, rank-major schedule: an "
                "expert-major budget is not drop-proof per microbatch, and "
                "the 2-tier path has no microbatched form")
        if T % mbs:
            raise ValueError(f"{T} rows a rank do not split into {mbs} "
                             f"microbatches")
        itemsize = (a2a.wire_dtype or a2a.dtype).itemsize
        if a2a.capacity < _cap_round(T * k, itemsize):
            raise ValueError("microbatches need a drop-proof capacity: a "
                             "smaller one drops other rows per microbatch")
        mbT = T // mbs
        mb_layer = dataclasses.replace(a2a_layer, a2a=dataclasses.replace(
            a2a, max_tokens=mbT, capacity=_cap_round(mbT * k, itemsize)))

        def part(t, i):
            return t.view((n, T) + tuple(t.shape[1:]))[:, i * mbT:(i + 1) * mbT] \
                .reshape((n * mbT,) + tuple(t.shape[1:])).contiguous()

        parts = [tuple(part(t, i) for t in (x2d, gate_vals, gate_ids))
                 for i in range(mbs)]
    else:
        mb_layer = a2a_layer
        parts = [(x2d, gate_vals, gate_ids)]

    def ffn(xs, be, nb, *ss):
        kw = dict(block_m=block_m, n_blocks_used=nb, masked=False)
        if ss:
            kw.update(row_scale=ss[0], out_dtype=a2a.dtype)
        if packed:
            h = grouped_gemm_gated(xs, we_gate_up_packed, None, be,
                                   block_k=block_k, packed=True,
                                   block_n=block_n, **kw)
        else:
            h = grouped_gemm_gated(xs, we_gate, we_up, be, block_k=block_k,
                                   **kw)
        return grouped_gemm(h, we_down, be, block_m=block_m,
                            n_blocks_used=nb, masked=False)

    def expert_ffn(recv_tok, recv_ids):
        quant = isinstance(recv_tok, QuantTokens)
        q = recv_tok.q if quant else recv_tok
        slots, cap = q.shape[:2]
        rows = slots * cap
        per_rank = rows // n
        xs = q.reshape(rows, -1)
        sc = recv_tok.scale.reshape(rows) if quant else None
        if em_fast:
            be = _expert_major_table(n, cap, cap_e, el, block_m, rows,
                                     xs.device)
            nb = torch.full((1,), rows // block_m, dtype=torch.int32,
                            device=xs.device)
            out = ffn(xs, be, nb, *((sc,) if quant else ()))
        else:
            # rank d's received rows are rows [d * per_rank, (d + 1) *
            # per_rank)
            rank = torch.arange(n, device=recv_ids.device) \
                .repeat_interleave(per_rank).view(slots, cap)
            ids = torch.where(recv_ids >= 0, rank * el + recv_ids,
                              torch.full_like(recv_ids, -1))
            out = apply_grouped(xs, ids.reshape(-1), E, ffn,
                                block_m=block_m, row_scale=sc)
        return out.view(slots, cap, -1)

    disp = [mb_layer.dispatch(parts[0][0], parts[0][2])]
    outs = []
    for i in range(len(parts)):
        if i + 1 < len(parts):
            disp.append(mb_layer.dispatch(parts[i + 1][0], parts[i + 1][2]))
        recv_tok, recv_ids, layout = disp[i]
        outs.append(mb_layer.combine(expert_ffn(recv_tok, recv_ids), layout,
                                     parts[i][1]))
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o.view(n, -1, D) for o in outs], 1).reshape(n * T, D)


def moe_mlp_tp_overlap(ctx, x2d, router_w, we_up, we_down, topk: int,
                       axis=None, block_m: int = 128):
    """The MoE tensor-parallel inference block (the JAX
    ``moe_mlp_tp_overlap``) over the TP axis ``axis`` of n ranks (a name:
    the whole mesh or a group inside it; or a tuple of axes, outer first:
    the 2-tier forms): x2d [T, D], index r's T / n rows at block r -> [T,
    D] in x2d's type, the same layout.

    The router in f32 (``x2d.float() @ router_w``), softmax, top-k and the
    renormalised top-k weights; one row per (token, k) pair, the rows of a
    token adjacent; ``ag_moe_group_gemm`` (the token all-gather with the
    grouped up-projection, we_up [E, D, F] column-sharded: rank r's columns
    at block r); ``silu`` in f32, cast to x2d's type; then ``moe_reduce_rs``
    (the grouped down-projection, we_down [E, F, D] row-sharded, into the
    f32 slots, their reduce-scatter and the top-k fold). The second stage
    takes the replicated row-to-expert map: at n ranks B9's push (B11's
    ``push_2d`` over a tuple) gathers the ranks' ids over ``axis`` (the JAX
    block gathers them with XLA); at one rank it is the rows' own ids. This
    block has no gate projection, unlike ``moe_mlp_ep_overlap``.
    ``block_m`` is the aligned row block of both grouped GEMMs."""
    axis = norm_axis(ctx, axis)
    gate_vals, gate_ids = router_topk(x2d, router_w, topk)
    rep = x2d.repeat_interleave(topk, 0)
    ids = gate_ids.reshape(-1).to(torch.int32).contiguous()
    h = ag_moe_group_gemm(ctx, rep, ids, we_up, axis=axis, block_m=block_m)
    h = torch.nn.functional.silu(h.float()).to(x2d.dtype)
    if ctx.axis_size(axis) > 1:
        ids = all_gather(ctx, ids, axis=axis, method="push_2d"
                         if isinstance(axis, tuple) else "push")[0]
    return moe_reduce_rs(ctx, h, ids, gate_vals, we_down, axis=axis,
                         block_m=block_m)


def moe_decode_step_sp(ctx, a2a_layer, params: dict, token, pos,
                       cfg: MoEConfig, cache: dict,
                       sp_axis: str | None = None, ag_method: str = "fused",
                       replica_checks: list | None = None):
    """The DeepSeek-style serving decode step (the JAX
    ``moe_decode_step_sp``): sequence-parallel attention over the KV cache
    sharded on ``sp_axis`` and the expert-parallel MoE FFN through the EP
    dispatch and combine, on one axis (the SP decode ranks are the EP
    ranks). A composition over ``llama.decode_step_sp``'s ``ffn`` hook with
    ``moe_mlp_ep_overlap`` as the FFN; it adds no kernel.

    ``token`` [B] int32 with B = n * ``a2a_layer.a2a.max_tokens``; ``pos``
    an int; ``cache`` from ``init_kv_cache(cfg.base, B, S)``, at n > 1
    sharded on S with ``shard_kv_cache``, updated in place. Returns
    (logits [B, V] f32, cache). ``replica_checks`` as in
    ``decode_step_sp``."""
    a2a = a2a_layer.a2a
    if a2a.num_experts != cfg.num_experts:
        raise AssertionError(
            f"a2a layer built for {a2a.num_experts} experts but cfg routes "
            f"over {cfg.num_experts}: gate ids would address nonexistent "
            "ranks/slots")
    if a2a.topk != cfg.topk:
        raise AssertionError((a2a.topk, cfg.topk))

    def moe_ffn(h, p):
        return moe_mlp_ep_overlap(ctx, a2a_layer, h, p["w_router"],
                                  p["we_gate"], p["we_up"], p["we_down"])

    return decode_step_sp(ctx, params, token, pos, cfg.base, cache,
                          axis=sp_axis, ag_method=ag_method, ffn=moe_ffn,
                          replica_checks=replica_checks)


__all__ = ["MoEConfig", "init_moe_params", "moe_decode_step_sp",
           "moe_mlp_ep_overlap", "moe_mlp_tp_overlap", "router_topk"]
