"""Pipeline parallelism: the GPipe microbatch wavefront over a ``pp`` axis.

Counterpart of ``triton_dist_tpu/parallel/pipeline.py``, where every stage
runs the same ``T = n_micro + P - 1``-step scan inside ``shard_map`` and the
activations hop stage to stage through ``lax.ppermute``. The port runs every
stage in one process on one device, so the wavefront is a Python loop over
the T steps: at step t stage 0 injects microbatch t, stage p runs on what
stage p - 1 handed it at step t - 1 (microbatch t - p), and the last stage's
output is kept. A step whose stage holds no microbatch (the bubbles, where
the reference computes on activations that never reach the loss) is
skipped, so the result and its gradient are the sequential stack's.
Autograd through the loop gives the GPipe backward schedule.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def pipeline_apply(stage_fn: Callable, stage_params: Sequence,
                   x_micro: torch.Tensor) -> torch.Tensor:
    """``stage_fn(params, h) -> h`` is one stage's chunk of the network;
    ``stage_params[p]`` stage p's parameters; ``x_micro`` [n_micro, mb, ...]
    the microbatched input. Returns the last stage's outputs [n_micro, mb,
    ...]. (The reference's ``with_aux`` serves MoE pipelines, which the port
    does not train yet.)"""
    n_stages = len(stage_params)
    n_micro = x_micro.shape[0]
    held: list = [None] * n_stages      # what each stage received last step
    outs: list = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        handed: list = [None] * n_stages
        for p in range(n_stages):
            if not 0 <= t - p < n_micro:    # a bubble
                continue
            h = x_micro[t] if p == 0 else held[p]
            h = stage_fn(stage_params[p], h)
            if p == n_stages - 1:
                outs[t - p] = h
            else:
                handed[p + 1] = h           # the hop to the next stage
        held = handed
    return torch.stack(outs)


__all__ = ["pipeline_apply"]
