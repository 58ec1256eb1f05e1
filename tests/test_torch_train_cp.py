"""The port's train plans across ranks, within the port.

The port's trainer without cp is held against JAX ``make_train_step`` in
``test_torch_train.py``, and its ring attention across ranks against the
JAX ring kernels in ``test_torch_ring_ranks.py``; a JAX cp step in
interpret mode does not finish here. So the plans across ranks are held
against the port's own one-rank step on the same seeded weights and numpy
tokens, on ``tests/test_train.py::_cp_cfg``'s shape in f32: cp over 2 and
4 ranks against cp on one rank, dp x cp and tp x cp on a (2, 2) mesh
against the step without cp, and the dense pipeline over 2 stages against
the step without pp. On the CPU the ring runs its plain version over the
ring's ranks; on the card its kernels (``chip_smoke.py`` phase 22).

Tolerances: losses ``rtol 1e-4`` over three AdamW steps (the ring's plain
version sums in base 2, the dense attention in the natural base, and the
microbatched pipeline multiplies smaller blocks); parameters after them
``atol 1e-3``, because a gradient near zero may change sign between two
summation orders, which moves that element by up to 2 * lr (6e-4) a step
while Adam normalises it (as in ``test_torch_train.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from triton_dist_tpu.parallel import ParallelPlan as JPlan
from triton_dist_tpu.parallel.mesh import \
    factorize_devices as j_factorize_devices
from triton_dist_tpu_torch.models.llama import LlamaConfig, init_params
from triton_dist_tpu_torch.ops.ring_attention import ring_attention_fwd
from triton_dist_tpu_torch.parallel import (ParallelPlan, factorize_devices,
                                            make_loss_fn, make_mesh,
                                            make_train_step, pipeline_apply)

pytestmark = pytest.mark.port

B, S, STEPS = 4, 32, 3
NO_CP = ParallelPlan(dp=None, tp=None, sp=False)
CP = ParallelPlan(dp=None, tp=None, cp="cp", sp=False)
CFG = LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=256, max_seq_len=64, dtype=torch.float32)


def _tokens(seed=7):
    return torch.from_numpy(np.random.RandomState(seed)
                            .randint(0, CFG.vocab_size, (B, S)))


def _train(mesh, plan):
    """Losses of three steps from seed 0, and the final parameters."""
    init_fn, step_fn = make_train_step(CFG, mesh, plan, device="cpu")
    state = init_fn(0)
    tokens = _tokens()
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, tokens)
        losses.append(loss.item())
    return losses, state.params


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def reference():
    """The one-rank steps: cp (ring attention, one rank) and without cp."""
    return {"cp": _train(None, CP), "no_cp": _train(None, NO_CP)}


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    params = dict(_flat(want[1]))
    for name, t in _flat(got[1]):
        np.testing.assert_allclose(t.detach().numpy(),
                                   params[name].detach().numpy(), atol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_cp_across_ranks_equals_one_rank(reference, n):
    before = ring_attention_fwd.launches
    _close(_train({"cp": n}, CP), reference["cp"])
    assert ring_attention_fwd.launches == before      # plain on the CPU


@pytest.mark.parametrize("axes,plan", [
    ({"dp": 2, "cp": 2}, dataclasses.replace(CP, dp="dp")),
    ({"tp": 2, "cp": 2}, dataclasses.replace(CP, tp="tp")),
], ids=["dp x cp", "tp x cp"])
def test_2d_cp_plans_equal_the_step_without_cp(reference, axes, plan):
    _close(_train(make_mesh(axes, device="cpu"), plan), reference["no_cp"])


def test_pipeline_equals_the_step_without_pp(reference):
    plan = dataclasses.replace(NO_CP, pp="pp", n_micro=2)
    _close(_train({"pp": 2}, plan), reference["no_cp"])


def test_cp_gradients_across_ranks():
    """The gradient of the cp loss over a ring of 2, batch over dp,
    against one rank's, every parameter."""
    params = init_params(CFG, seed=1, device="cpu")
    leaves = [t.requires_grad_(True) for _, t in _flat(params)]
    tokens = _tokens(seed=3)

    def grads(mesh, plan):
        loss = make_loss_fn(CFG, plan, mesh)(params, tokens)
        return torch.autograd.grad(loss, leaves)

    ctx = make_mesh({"dp": 2, "cp": 2}, device="cpu")
    got = grads(ctx, dataclasses.replace(CP, dp="dp"))
    for g, w in zip(got, grads(None, CP)):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


def test_pipeline_apply_is_the_sequential_stack():
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn(8, 8, generator=gen) for _ in range(3)]
    x = torch.randn(4, 2, 8, generator=gen)
    got = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x)
    want = x
    for w in ws:
        want = torch.tanh(want @ w)
    assert torch.equal(got, want)


def test_plan_guards():
    init_fn, step_fn = make_train_step(
        CFG, {"pp": 2}, dataclasses.replace(NO_CP, pp="pp", n_micro=3),
        device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step_fn(init_fn(0), _tokens())
    init_fn, step_fn = make_train_step(
        CFG, {"dp": 8}, dataclasses.replace(CP, dp="dp"), device="cpu")
    with pytest.raises(ValueError, match="dp ranks"):
        step_fn(init_fn(0), _tokens())


@pytest.mark.parametrize("plan", [
    dict(), dict(cp="cp", sp=False), dict(sp=False), dict(tp=None)])
def test_act_spec_matches_jax(plan):
    assert ParallelPlan(**plan).act_spec() == tuple(JPlan(**plan).act_spec())


@pytest.mark.parametrize("n", [1, 4, 8, 12])
def test_factorize_devices_matches_jax(n):
    assert factorize_devices(n) == j_factorize_devices(n)
    assert factorize_devices(n, ("dp", "cp"), "cp") == \
        j_factorize_devices(n, ("dp", "cp"), "cp")


def test_make_mesh_is_a_context_on_the_device():
    ctx = make_mesh({"dp": 2, "cp": 4}, device="cpu")
    assert ctx.axis_names == ("dp", "cp") and ctx.mesh_shape == (2, 4)
    assert ctx.device.type == "cpu" and ctx.num_ranks == 8
