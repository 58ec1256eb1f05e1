"""MoE model family (Mixtral/DeepSeek-style): configs, parameters and the
one-rank MoE FFN of the serving path.

Counterpart of ``triton_dist_tpu/models/moe.py``. Its inference block
``moe_mlp_ep_overlap`` routes rows through an EP all-to-all to the ranks
that hold their experts; at one rank the dispatch keeps every row (its
capacity is drop-proof) and the block reduces to what ``moe_mlp_ep_overlap``
here computes: router, top-k, the dispatch into expert-aligned rows and the
combine back (``ops.all_to_all``, B21's one-rank form), and the grouped
expert FFN over all experts between them (``ops.group_gemm``: B18 then
B17). Its tensor-parallel block ``moe_mlp_tp_overlap`` runs at one rank
over the MoE-TP ops of ``ops.moe`` (B19, B20). The wire across ranks
(B21/B22 at n > 1), the TP block over more ranks and the GShard training
path (``moe_mlp_gshard``, ``moe_forward``) wait for ROADMAP.md Queue A,
item 7 "MoE / EP across ranks".
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.models.llama import LlamaConfig, init_params
from triton_dist_tpu_torch.ops.all_to_all import ep_combine, ep_dispatch
from triton_dist_tpu_torch.ops.group_gemm import (expert_alignment,
                                                  grouped_gemm,
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


def moe_mlp_ep_overlap(x2d, router_w, we_gate, we_up, we_down, topk: int,
                       block_m: int = 64):
    """The one-rank form of the JAX ``moe_mlp_ep_overlap``: x2d [T, D] ->
    [T, D] in x2d's type.

    The router runs in f32 (``x2d.float() @ router_w``, router_w [D, E]),
    then softmax, top-k and the renormalised top-k weights. Each (token, k)
    pair is one row, aligned by expert over all E experts
    (``expert_alignment``); ``ep_dispatch`` moves the rows into place,
    ``grouped_gemm_gated`` (we_gate, we_up [E, D, F]; the gated output in
    the model's type) and ``grouped_gemm`` (we_down [E, F, D]) run them
    unmasked, and ``ep_combine`` sums ``weight * row`` over k in k order in
    f32 and casts once, as the JAX combine does. Nothing syncs with the
    host.

    ``block_m`` is the aligned row block; a row's result does not depend on
    it."""
    T = x2d.shape[0]
    E = router_w.shape[1]
    probs = torch.softmax(x2d.float() @ router_w, -1)
    gate_vals, gate_ids = probs.topk(topk, -1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    src, valid, be, nb, pos = expert_alignment(gate_ids.reshape(-1), E,
                                               block_m)
    xs = ep_dispatch(x2d, src, valid, topk)
    h = grouped_gemm_gated(xs, we_gate, we_up, be, block_m=block_m,
                           n_blocks_used=nb, masked=False)
    y = grouped_gemm(h, we_down, be, block_m=block_m, n_blocks_used=nb,
                     masked=False)
    return ep_combine(y, pos, gate_vals)


def moe_mlp_tp_overlap(ctx, x2d, router_w, we_up, we_down, topk: int,
                       axis: str | None = None, block_m: int = 128):
    """The MoE tensor-parallel inference block (the JAX
    ``moe_mlp_tp_overlap``) at one rank: x2d [T, D] -> [T, D] in x2d's
    type.

    The router in f32 (``x2d.float() @ router_w``), softmax, top-k and the
    renormalised top-k weights; one row per (token, k) pair, the rows of a
    token adjacent; ``ag_moe_group_gemm`` (the token all-gather with the
    grouped up-projection, we_up [E, D, F]); ``silu`` in f32, cast to x2d's
    type; then ``moe_reduce_rs`` (the grouped down-projection, we_down
    [E, F, D], into the f32 slot, its reduction and the top-k fold). The
    second stage takes the replicated row-to-expert map, which the JAX
    block all-gathers with XLA; at one rank it is the rows' own ids. This
    block has no gate projection, unlike ``moe_mlp_ep_overlap``.
    ``block_m`` is the aligned row block of both grouped GEMMs."""
    probs = torch.softmax(x2d.float() @ router_w, -1)
    gate_vals, gate_ids = probs.topk(topk, -1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    rep = x2d.repeat_interleave(topk, 0)
    ids = gate_ids.reshape(-1).to(torch.int32)
    h = ag_moe_group_gemm(ctx, rep, ids, we_up, axis=axis, block_m=block_m)
    h = torch.nn.functional.silu(h.float()).to(x2d.dtype)
    return moe_reduce_rs(ctx, h, ids, gate_vals, we_down, axis=axis,
                         block_m=block_m)


__all__ = ["MoEConfig", "init_moe_params", "moe_mlp_ep_overlap",
           "moe_mlp_tp_overlap"]
