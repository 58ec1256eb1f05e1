"""Single-card train step: the counterpart of
``triton_dist_tpu/parallel/train.py::make_train_step`` on one rank.

The JAX step composes dp / tp / sp / pp / ep / cp over a mesh. On one card
every axis has size 1, so what remains is the dense model's forward, the
next-token cross-entropy, its gradient and one optimizer step. With
``ParallelPlan(cp=...)`` every layer's attention runs through
``ops.ring_attention.ring_attention`` (on a CUDA tensor the hand-written
forward and backward kernels), as ``train.py:159-177`` does; without it,
through the dense ``models.llama._attention``. Plans that need more than one
rank raise ``NotImplementedError`` naming the ROADMAP item that brings them.

JAX's step is pure and returns new params and optimizer state. Here the
optimizer updates the parameters and its moments in place, which keeps a
second copy of them off the card, and ``step_fn`` returns a ``TrainState``
holding the same tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from triton_dist_tpu_torch.models.llama import (LlamaConfig, forward,
                                                init_params)
from triton_dist_tpu_torch.ops.ring_attention import HEAD_DIM, ring_attention
from triton_dist_tpu_torch.utils.env import default_device


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    dp: str | None = "dp"
    tp: str | None = "tp"
    pp: str | None = None
    ep: str | None = None
    cp: str | None = None    # context parallelism: ring attention over cp
    sp: bool = True          # sequence-shard the residual over the tp axis
    n_micro: int = 2         # pipeline microbatches (pp only)
    remat: bool = False


class TrainState(NamedTuple):
    params: dict
    opt_state: Any           # the torch optimizer, which holds its state
    step: int


def adamw(params, lr: float = 3e-4) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` set to ``optax.adamw(lr)``'s defaults: betas
    (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (torch's default is 1e-2)
    on every parameter, norm gains included; the moments are kept in each
    parameter's type, as optax keeps them."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _xent(logits, tokens):
    """Mean next-token cross-entropy. logits [B, S, V] f32, tokens [B, S]."""
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    tgt = tokens[:, 1:].long()
    return -lp.gather(-1, tgt[..., None])[..., 0].mean()


def _check_plan(cfg, plan: ParallelPlan, mesh: dict | None) -> None:
    if not isinstance(cfg, LlamaConfig):
        raise NotImplementedError(
            f"training a {type(cfg).__name__}: the port trains the dense "
            "LlamaConfig; MoE training (moe_forward) is the MoE slice "
            "(ROADMAP.md Queue A, item 7 \"MoE / EP across ranks\")")
    if plan.pp is not None:
        raise NotImplementedError(
            "pipeline parallelism needs more than one rank "
            "(parallel/pipeline.py, ROADMAP.md Queue A, item 9 \"training "
            "and CP across ranks\")")
    wide = {a: n for a, n in (mesh or {}).items() if n > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} need more than one rank: parallel/mesh.py and "
            "the training plans across ranks are not ported yet (ROADMAP.md "
            "Queue A, item 9 \"training and CP across ranks\")")
    if plan.cp is not None and plan.sp:
        raise ValueError("cp shards the sequence dim; disable sp")
    if plan.cp is not None and cfg.head_dim != HEAD_DIM:
        raise ValueError(f"ring attention needs head_dim {HEAD_DIM}, got "
                         f"{cfg.head_dim}")


def _ring_attn(q, k, v, sm_scale):
    """Llama layout [B, S, H, Dh] to the ring layout [B, H, S, Dh] and back.
    The kernels take contiguous tensors, so q, k and v are copied once each
    here, the output once by the ``reshape`` after it, and the output's
    gradient once in the backward."""
    o = ring_attention(q.transpose(1, 2).contiguous(),
                       k.transpose(1, 2).contiguous(),
                       v.transpose(1, 2).contiguous(), causal=True,
                       sm_scale=sm_scale)
    return o.transpose(1, 2)


def make_loss_fn(cfg: LlamaConfig, plan: ParallelPlan | None = None,
                 mesh: dict | None = None) -> Callable:
    """``loss_fn(params, tokens) -> loss``: the step's differentiable loss
    (the JAX step's inner ``loss_fn``), for callers that want gradients
    without an optimizer step."""
    plan = plan or ParallelPlan()
    _check_plan(cfg, plan, mesh)
    attn_fn = _ring_attn if plan.cp is not None else None

    def loss_fn(params, tokens):
        logits = forward(params, tokens, cfg, remat=plan.remat,
                         attn_fn=attn_fn)
        return _xent(logits, tokens)

    return loss_fn


def _leaves(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def make_train_step(cfg: LlamaConfig, plan: ParallelPlan | None = None,
                    optimizer: Callable | None = None, device=None,
                    mesh: dict | None = None) -> tuple[Callable, Callable]:
    """Returns ``(init_fn, step_fn)`` on one card:

    - ``init_fn(seed_or_params=0) -> TrainState``: parameters from
      ``models.llama.init_params(cfg, seed)``, or a parameter dict (e.g.
      from ``models.convert.params_from_jax``), which is then trained in
      place;
    - ``step_fn(state, tokens [B, S]) -> (TrainState, loss)``: forward,
      loss, backward and one optimizer step, with no host sync.

    ``optimizer`` maps the list of parameter tensors to a
    ``torch.optim.Optimizer`` (default ``adamw``). ``mesh`` is the JAX
    mesh's ``{axis: size}``; the default is one device. Runs on CUDA unless
    ``device="cpu"``; without a card it raises."""
    plan = plan or ParallelPlan()
    loss_fn = make_loss_fn(cfg, plan, mesh)
    dev = default_device(device)
    optimizer = optimizer or adamw

    def init_fn(seed_or_params=0) -> TrainState:
        if isinstance(seed_or_params, dict):
            params = seed_or_params
            if any(t.device.type != dev.type for t in _leaves(params)):
                raise ValueError(f"init_fn: the parameters must lie on {dev}")
        else:
            params = init_params(cfg, seed=int(seed_or_params), device=dev)
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return TrainState(params, optimizer(leaves), 0)

    def step_fn(state: TrainState, tokens):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, tokens.to(dev))
        loss.backward()
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss.detach()

    return init_fn, step_fn


__all__ = ["ParallelPlan", "TrainState", "adamw", "make_loss_fn",
           "make_train_step"]
