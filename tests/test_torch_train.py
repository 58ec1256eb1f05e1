"""The port's single-card trainer against the JAX package's.

Two links hold the port's cp trainer (ring attention in every layer)
against the reference; a JAX cp step in interpret mode costs minutes here:

- the port's trainer without cp against JAX ``make_train_step`` without cp
  (XLA attention, no Pallas) on a one-device mesh, from the same JAX-made
  weights and numpy tokens, over three AdamW steps;
- within the port, the cp plan (ring attention; its plain version on the
  CPU, itself held against the JAX ring kernels in
  ``test_torch_ring_attention.py``) against no cp.

The config is the JAX cp tests' shape (``tests/test_train.py::_cp_cfg``:
head_dim 128, as ring attention needs), in f32.

Tolerances: losses ``rtol 1e-4`` across frameworks (sums in another order);
parameters after three steps ``atol 1e-3``, because a gradient near zero
may change sign between frameworks, which moves that element by up to
2 * lr (6e-4) a step while Adam normalises it. Within the port, cp against
no cp: loss ``rtol 1e-5``, gradients ``atol 1e-5``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from triton_dist_tpu.models import llama as jl
from triton_dist_tpu.models.moe import MoEConfig
from triton_dist_tpu.parallel import ParallelPlan as JPlan
from triton_dist_tpu.parallel import make_mesh
from triton_dist_tpu.parallel import make_train_step as j_make_train_step
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models.convert import params_from_jax
from triton_dist_tpu_torch.parallel import (ParallelPlan, make_loss_fn,
                                            make_train_step)

pytestmark = pytest.mark.port

B, S, STEPS = 2, 32, 3
NO_CP = ParallelPlan(dp=None, tp=None, sp=False)
CP = ParallelPlan(dp=None, tp=None, cp="cp", sp=False)


def _cfgs():
    shape = dict(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=256, max_seq_len=64)
    return (jl.LlamaConfig(dtype=jax.numpy.float32, **shape),
            tl.LlamaConfig(dtype=torch.float32, **shape))


def _tokens(vocab, seed=7):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps without cp: the initial params (numpy), the losses
    and the params after the last step."""
    jcfg, _ = _cfgs()
    mesh = make_mesh({"dp": 1})
    init_fn, step_fn = j_make_train_step(
        jcfg, mesh, JPlan(dp=None, tp=None, sp=False))
    tokens = _tokens(jcfg.vocab_size)
    with jax.set_mesh(mesh):
        state = init_fn(jax.random.key(0))
        init = jax.tree.map(np.asarray, state.params)
        losses = []
        for _ in range(STEPS):
            state, loss = step_fn(state, jax.numpy.asarray(tokens))
            losses.append(float(loss))
        final = jax.tree.map(np.asarray, state.params)
    return init, tokens, losses, final


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_forward_matches_jax(jax_run):
    init, tokens, _, _ = jax_run
    jcfg, tcfg = _cfgs()
    want = np.asarray(jl.forward(jax.tree.map(jax.numpy.asarray, init),
                                 jax.numpy.asarray(tokens), jcfg))
    got = tl.forward(params_from_jax(init, device="cpu"),
                     torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=1e-3)


def test_train_steps_match_jax(jax_run):
    init, tokens, want_losses, want_params = jax_run
    _, tcfg = _cfgs()
    init_fn, step_fn = make_train_step(tcfg, plan=NO_CP, device="cpu")
    state = init_fn(params_from_jax(init, device="cpu"))
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, torch.from_numpy(tokens))
        losses.append(loss.item())
    assert state.step == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    got = dict(_flat(state.params))
    for name, want in _flat(want_params):
        np.testing.assert_allclose(got[name].detach().numpy(), want,
                                   atol=1e-3, err_msg=name)


def _loss_and_grads(plan, init, tokens):
    _, tcfg = _cfgs()
    params = params_from_jax(init, device="cpu")
    leaves = [t.requires_grad_(True) for _, t in _flat(params)]
    loss = make_loss_fn(tcfg, plan)(params, torch.from_numpy(tokens))
    return loss, torch.autograd.grad(loss, leaves)


def test_cp_plan_matches_no_cp(jax_run):
    init, tokens, _, _ = jax_run
    loss_cp, g_cp = _loss_and_grads(CP, init, tokens)
    loss_ref, g_ref = _loss_and_grads(NO_CP, init, tokens)
    np.testing.assert_allclose(loss_cp.item(), loss_ref.item(), rtol=1e-5)
    for a, b in zip(g_cp, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_remat_gives_the_same_gradients(jax_run):
    init, tokens, _, _ = jax_run
    loss, grads = _loss_and_grads(CP, init, tokens)
    loss_r, grads_r = _loss_and_grads(dataclasses.replace(CP, remat=True),
                                      init, tokens)
    assert loss.item() == loss_r.item()
    for a, b in zip(grads, grads_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_cp_loss_falls_on_a_repeated_batch():
    _, tcfg = _cfgs()
    init_fn, step_fn = make_train_step(tcfg, plan=CP, device="cpu")
    state = init_fn(0)
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, seed=3))
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, tokens)
        losses.append(loss.item())
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


def test_plans_needing_more_than_one_rank_raise():
    """The plans across ranks build since the CP slice (cp, dp x cp, dense
    pp; the mesh in the reference's place or by keyword);
    MoE training and the reference's guards still raise."""
    _, tcfg = _cfgs()
    make_train_step(tcfg, {"cp": 2, "dp": 1}, CP, device="cpu")
    make_train_step(tcfg, {"dp": 2, "cp": 2}, dataclasses.replace(CP, dp="dp"),
                    device="cpu")
    make_train_step(tcfg, plan=dataclasses.replace(NO_CP, pp="pp"),
                    device="cpu", mesh={"pp": 2})
    with pytest.raises(ValueError, match="pp"):
        make_train_step(tcfg, {"cp": 2, "pp": 2},
                        dataclasses.replace(CP, pp="pp"), device="cpu")
    with pytest.raises(NotImplementedError,
                       match='item 7 "MoE / EP across ranks"'):
        make_train_step(MoEConfig.tiny(n_layers=2, num_experts=4),
                        plan=NO_CP, device="cpu")
    with pytest.raises(ValueError, match="sp"):
        make_train_step(tcfg, plan=dataclasses.replace(CP, sp=True),
                        device="cpu")
    with pytest.raises(ValueError, match="pipeline stages"):
        make_train_step(tcfg, {"pp": 4}, dataclasses.replace(NO_CP, pp="pp"),
                        device="cpu")
    # the single-device mesh is what the one-rank trainer runs
    make_train_step(tcfg, {"cp": 1, "dp": 1}, CP, device="cpu")


def test_default_device_is_the_card():
    _, tcfg = _cfgs()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(tcfg, plan=CP)
