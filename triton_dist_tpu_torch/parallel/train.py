"""The train step: the counterpart of
``triton_dist_tpu/parallel/train.py::make_train_step``, over a mesh of
ranks that all run on one device.

The JAX step composes dp / tp / sp / pp / ep / cp over a mesh, and XLA
inserts the collectives that its shardings imply. The port computes in the
global view (the whole batch, every head, the whole sequence), so what
remains of dp and tp are the sums that autograd already makes over one copy
of the parameters. What is distributed is what the JAX package wrote as
kernels and loops:

- **cp**: every layer's attention is ``ops.ring_attention.ring_attention``
  over ``plan.cp`` (on a CUDA tensor the hand-written kernels: the ring
  across the cp ranks, or the one-rank kernels when cp has one rank), with
  ``batch_axis=plan.dp`` and ``head_axis=plan.tp``, so each (dp, tp) shard
  is a ring of its own, in the contiguous layout, as ``train.py:159-177``
  does. Without cp, attention is the dense ``models.llama._attention``.
- **pp**: the dense stack as a GPipe wavefront (``parallel.pipeline``) of
  ``n_micro`` microbatches over the pp axis's stages.

A plan axis that the mesh lacks counts as one rank. cp with sp or with pp
raises ``ValueError``, as the reference's asserts do; MoE training raises
``NotImplementedError`` naming ROADMAP item 7.

JAX's step is pure and returns new params and optimizer state. Here the
optimizer updates the parameters and its moments in place, which keeps a
second copy of them off the card, and ``step_fn`` returns a ``TrainState``
holding the same tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from triton_dist_tpu_torch.models.llama import (LlamaConfig, block_apply,
                                                forward, init_params,
                                                rmsnorm)
from triton_dist_tpu_torch.ops.ring_attention import HEAD_DIM, ring_attention
from triton_dist_tpu_torch.parallel.mesh import make_mesh
from triton_dist_tpu_torch.parallel.pipeline import pipeline_apply
from triton_dist_tpu_torch.shmem.context import ShmemContext
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

    def act_spec(self) -> tuple:
        """The residual's sharding (batch, sequence, model) by axis name."""
        if self.cp is not None:
            # the residual's sequence dim belongs to the cp ring; sp's
            # tp-sharding of the same dim would conflict
            return (self.dp, self.cp, None)
        return (self.dp, self.tp if self.sp else None, None)


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


def _context(mesh, device) -> ShmemContext | None:
    """The mesh as a ``ShmemContext`` (a dict ``{axis: size}`` is built on
    ``device``), or None for none."""
    if mesh is None or isinstance(mesh, ShmemContext):
        return mesh
    return make_mesh(dict(mesh), device)


def _axis(ctx, name):
    """``name`` if the mesh has it, else None (one rank)."""
    return name if ctx is not None and name in ctx.axis_names else None


def _size(ctx, name) -> int:
    return ctx.axis_size(name) if _axis(ctx, name) else 1


def _check_plan(cfg, plan: ParallelPlan, ctx) -> None:
    if not isinstance(cfg, LlamaConfig):
        raise NotImplementedError(
            f"training a {type(cfg).__name__}: the port trains the dense "
            "LlamaConfig; MoE training (moe_forward) is the MoE slice "
            "(ROADMAP.md Queue A, item 7 \"MoE / EP across ranks\")")
    if plan.cp is not None and plan.pp is not None:
        raise ValueError("cp (ring attention) composes with dp/tp only; "
                         "disable pp")
    if plan.cp is not None and plan.sp:
        raise ValueError("cp shards the sequence dim; disable sp")
    if plan.cp is not None and cfg.head_dim % HEAD_DIM:
        raise ValueError(f"ring attention needs a head_dim that is a "
                         f"multiple of {HEAD_DIM}, got {cfg.head_dim}")
    if plan.pp is not None and cfg.n_layers % _size(ctx, plan.pp):
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{_size(ctx, plan.pp)} pipeline stages")


def _ring_attn_fn(ctx, plan: ParallelPlan) -> Callable:
    """The cp plan's attention: Llama layout [B, S, H, Dh] to the ring
    layout [B, H, S, Dh] and back. The kernels take contiguous tensors, so
    q, k and v are copied once each here, the output once by the
    ``reshape`` after it, and the output's gradient once in the backward."""
    cp = _axis(ctx, plan.cp)
    ring_ctx = ctx if cp else None
    kw = dict(axis=cp, causal=True, batch_axis=_axis(ctx, plan.dp),
              head_axis=_axis(ctx, plan.tp))

    def attn(q, k, v, sm_scale):
        o = ring_attention(ring_ctx, q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), sm_scale=sm_scale,
                           **kw)
        return o.transpose(1, 2)

    return attn


def _stage_layers(params: dict, n_stages: int) -> list[list[dict]]:
    """Each stage's layers' weights: the stacked weights unbound once, the
    layers dealt to the stages in order."""
    names = list(params["blocks"])
    layers = [dict(zip(names, ws)) for ws in
              zip(*(params["blocks"][n].unbind(0) for n in names))]
    per = len(layers) // n_stages
    return [layers[p * per:(p + 1) * per] for p in range(n_stages)]


def _pipeline_loss(cfg: LlamaConfig, plan: ParallelPlan, n_stages: int):
    """The dense pp plan's loss (the reference's ``train.py:184-229``):
    the embeddings in f32, microbatched, cast to the model's type at the
    pipeline's edge, the stages' layers as the wavefront, the final norm
    and the head in f32 on the last stage's outputs."""

    def stage_fn(layers, h):
        positions = torch.arange(h.shape[1], device=h.device)[None, :] \
            .expand(h.shape[0], h.shape[1])
        for p in layers:
            if plan.remat:
                h = checkpoint(block_apply, cfg, h, p, positions,
                               use_reentrant=False)
            else:
                h = block_apply(cfg, h, p, positions)
        return h

    def loss_fn(params, tokens):
        B, S = tokens.shape
        if B % plan.n_micro:
            raise ValueError(f"a batch of {B} rows does not split into "
                             f"{plan.n_micro} microbatches")
        x = params["embed"][tokens].float()
        x_micro = x.reshape(plan.n_micro, B // plan.n_micro, S, cfg.d_model)
        outs = pipeline_apply(stage_fn, _stage_layers(params, n_stages),
                              x_micro.to(cfg.dtype)).float()
        x = rmsnorm(outs.reshape(B, S, cfg.d_model), params["final_norm"],
                    cfg.norm_eps)
        return _xent(x @ params["lm_head"].float(), tokens)

    return loss_fn


def make_loss_fn(cfg: LlamaConfig, plan: ParallelPlan | None = None,
                 mesh=None, device=None) -> Callable:
    """``loss_fn(params, tokens) -> loss``: the step's differentiable loss
    (the JAX step's inner ``loss_fn``), for callers that want gradients
    without an optimizer step. ``mesh`` as ``make_train_step`` takes it."""
    plan = plan or ParallelPlan()
    ctx = _context(mesh, device)
    _check_plan(cfg, plan, ctx)
    if plan.pp is not None:
        return _pipeline_loss(cfg, plan, _size(ctx, plan.pp))
    attn_fn = _ring_attn_fn(ctx, plan) if plan.cp is not None else None

    def loss_fn(params, tokens):
        nb = _size(ctx, plan.dp)
        if tokens.shape[0] % nb:
            raise ValueError(f"a batch of {tokens.shape[0]} rows does not "
                             f"split over {nb} dp ranks")
        logits = forward(params, tokens, cfg, remat=plan.remat,
                         attn_fn=attn_fn)
        return _xent(logits, tokens)

    return loss_fn


def _leaves(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def make_train_step(cfg: LlamaConfig, mesh=None,
                    plan: ParallelPlan | None = None,
                    optimizer: Callable | None = None,
                    device=None) -> tuple[Callable, Callable]:
    """Returns ``(init_fn, step_fn)`` over ``mesh``:

    - ``init_fn(seed_or_params=0) -> TrainState``: parameters from
      ``models.llama.init_params(cfg, seed)``, or a parameter dict (e.g.
      from ``models.convert.params_from_jax``), which is then trained in
      place;
    - ``step_fn(state, tokens [B, S]) -> (TrainState, loss)``: forward,
      loss, backward and one optimizer step, with no host sync; ``tokens``
      is the global batch.

    ``mesh`` is a ``ShmemContext`` (``parallel.make_mesh``), whose device
    the step runs on, or the JAX mesh's ``{axis: size}``, built on
    ``device`` (``cuda`` unless the caller names another; without a card
    it raises); None is one rank. ``optimizer`` maps the list of parameter
    tensors to a ``torch.optim.Optimizer`` (default ``adamw``)."""
    plan = plan or ParallelPlan()
    ctx = _context(mesh, device)
    dev = ctx.device if ctx is not None else default_device(device)
    loss_fn = make_loss_fn(cfg, plan, ctx)
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
