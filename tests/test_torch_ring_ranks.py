"""The port's ring attention across ranks against the JAX package's.

The same numpy inputs, made from a seed, go through JAX
``ring_attention_fwd`` and ``ring_attention_bwd`` (the backward of the
``ring_attention`` custom_vjp) on a mesh of 2 or 4 virtual devices (the
Pallas kernels in interpret mode, which run the ring's transport) and
through the port's functions on CPU tensors in the same global view, where
the wrappers run their plain versions over the ring. The CUDA kernels of
the ring are held against those plain versions on the card by
``chip_smoke.py`` (phase 22).

Each JAX interpret-mode call costs seconds here (a forward ~5 s and a
backward ~11 s at 2 ranks, a forward ~12 s at 4), so the JAX outputs are
made once per module, and the 4-rank and (2, 2) cases hold the forward
only.

Tolerances: f32 out, lse and gradients ``atol 1e-4, rtol 1e-3`` (the JAX
kernels sum tile by tile and step by step with an online softmax, the
plain version over the whole row); bf16 ``atol 2e-2`` (the same rounding
points, but a p rounded to bf16 after a tiny f32 difference may fall the
other way).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.shmem.context import initialize_distributed as j_init
from triton_dist_tpu_torch.shmem import initialize_distributed

# both ``ops`` packages export a function named like the module
jra = importlib.import_module("triton_dist_tpu.ops.ring_attention")
tra = importlib.import_module("triton_dist_tpu_torch.ops.ring_attention")

pytestmark = pytest.mark.port

HQ, HKV, D = 4, 2, 128
TOL = {"float32": dict(atol=1e-4, rtol=1e-3),
       "bfloat16": dict(atol=2e-2, rtol=0)}
# name: (mesh axes, mesh shape, batch axis, B, S global, dtype, layout,
# causal, with the backward)
CASES = {
    "2 ranks f32 contiguous": (("cp",), (2,), None, 1, 32, "float32",
                               "contiguous", True, True),
    "2 ranks bf16 zigzag": (("cp",), (2,), None, 1, 64, "bfloat16",
                            "zigzag", True, True),
    "4 ranks f32 zigzag": (("cp",), (4,), None, 1, 64, "float32", "zigzag",
                           True, False),
    "dp x cp f32 full": (("dp", "cp"), (2, 2), "dp", 2, 32, "float32",
                         "contiguous", False, False),
}
NAMES = ("out", "lse", "dq", "dk", "dv")


def _inputs(B, S, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, h, S, D).astype(np.float32) * 0.5
                 for h in (HQ, HKV, HKV, HQ))


def _jax(case):
    axes, shape, batch_axis, B, S, dtype, layout, causal, bwd = CASES[case]
    ctx = j_init(axis_names=axes, mesh_shape=shape)
    q, k, v, do = (jnp.asarray(a, getattr(jnp, dtype))
                   for a in _inputs(B, S))
    kw = dict(axis="cp", causal=causal, batch_axis=batch_axis, layout=layout)
    out, lse = jra.ring_attention_fwd(ctx, q, k, v, **kw)
    got = [out, lse]
    if bwd:
        got += list(jra.ring_attention_bwd(ctx, q, k, v, out, lse, do,
                                           sm_scale=None, **kw))
    return [np.asarray(x, np.float32) for x in got]


def _port(case):
    axes, shape, batch_axis, B, S, dtype, layout, causal, bwd = CASES[case]
    ctx = initialize_distributed(axes, shape, device="cpu")
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype))
                   for a in _inputs(B, S))
    kw = dict(axis="cp", causal=causal, batch_axis=batch_axis, layout=layout)
    if not bwd:
        return [t.float().numpy()
                for t in tra.ring_attention_fwd(ctx, q, k, v, **kw)]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tra.ring_attention(ctx, *leaves, **kw)
    out.backward(do)
    _, lse = tra.ring_attention_fwd(ctx, q, k, v, **kw)
    return [t.detach().float().numpy()
            for t in (out, lse, *(x.grad for x in leaves))]


@pytest.fixture(scope="module")
def jax_outputs():
    """Every case's JAX outputs, made once."""
    return {case: _jax(case) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_ring_across_ranks_matches_jax(jax_outputs, case):
    want = jax_outputs[case]
    got = _port(case)
    assert len(got) == len(want)
    tol = TOL[CASES[case][5]]
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=f"{case}: {name}", **tol)


def _grads(ctx, q, k, v, do, **kw):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tra.ring_attention(ctx, *leaves, **kw)
    out.backward(do)
    return [out.detach()] + [x.grad for x in leaves]


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_after_inv_equals_contiguous(n):
    S = 16 * n
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, S, seed=1))
    idx, inv = tra.zigzag_indices(S, n)
    ctx = initialize_distributed(("cp",), (n,), device="cpu")
    want = _grads(ctx, q, k, v, do, axis="cp")
    got = _grads(ctx, *(x[:, :, idx] for x in (q, k, v, do)), axis="cp",
                 layout="zigzag")
    for w, g in zip(want, got):
        torch.testing.assert_close(g[:, :, inv], w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_equal_one_rank_on_the_gathered_sequence(n):
    """The ring over n ranks of a (dp, cp) mesh, each (dp) row a ring of
    its own, against the one-rank plain version on the whole sequence."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 16 * n, seed=2))
    ctx = initialize_distributed(("dp", "cp"), (2, n), device="cpu")
    got = _grads(ctx, q, k, v, do, axis="cp", batch_axis="dp")
    out, lse = tra.ring_attention_fwd_plain(q, k, v)
    want = [out, *tra.ring_attention_bwd_plain(q, k, v, out, lse, do)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_reference_shape_checks():
    ctx = initialize_distributed(("dp", "cp"), (2, 4), device="cpu")
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 24))
    with pytest.raises(ValueError, match="divisible by ranks"):
        tra.ring_attention_fwd(ctx, q[:, :, :18], k[:, :, :18], v[:, :, :18],
                               axis="cp")
    with pytest.raises(ValueError, match="2\\*ranks"):
        tra.ring_attention_fwd(ctx, q[:, :, :20], k[:, :, :20],
                               v[:, :, :20], axis="cp", layout="zigzag")
    with pytest.raises(ValueError, match="batch axis"):
        tra.ring_attention_fwd(ctx, q[:1], k[:1], v[:1], axis="cp",
                               batch_axis="dp")
    with pytest.raises(ValueError, match="head axis"):
        tra.ring_attention_fwd(ctx, q, k[:, :1], v[:, :1], axis="dp",
                               head_axis="cp")
    with pytest.raises(ValueError, match="one axis"):
        tra.ring_attention_fwd(ctx, q, k, v, axis=("dp", "cp"))
    with pytest.raises(ValueError, match="not an axis"):
        tra.ring_attention_fwd(ctx, q, k, v, axis="tp")
    with pytest.raises(ValueError, match="layout"):
        tra.ring_attention_fwd(ctx, q, k, v, axis="cp", layout="striped")
