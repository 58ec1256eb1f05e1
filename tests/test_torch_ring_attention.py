"""The port's ring attention (one rank) against the JAX package's.

The same numpy inputs, made from a seed, go through JAX
``ring_attention_fwd`` and ``ring_attention_bwd`` (the backward of the
``ring_attention`` custom_vjp) on a one-rank mesh (the Pallas kernels in
interpret mode, block 32, so the walk covers 2 x 2 tiles) and through the
port's functions on CPU tensors, where the wrappers run their plain
versions. The CUDA kernels are held against those plain versions on the
card by ``chip_smoke.py``.

Tolerances: f32 out, lse and gradients ``atol 1e-4, rtol 1e-3`` (the JAX
kernels sum tile by tile with an online softmax, the plain version over the
whole row); bf16 ``atol 2e-2`` (the same rounding points, but a p rounded
to bf16 after a tiny f32 difference may fall the other way: one bf16 ulp of
a value near 1 is ~8e-3).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.shmem.context import initialize_distributed

# both ``ops`` packages export a function named like the module
jra = importlib.import_module("triton_dist_tpu.ops.ring_attention")
tra = importlib.import_module("triton_dist_tpu_torch.ops.ring_attention")

pytestmark = pytest.mark.port

B, HQ, HKV, S, D, BLOCK = 1, 4, 2, 64, 128, 32
TOL = {"float32": dict(atol=1e-4, rtol=1e-3),
       "bfloat16": dict(atol=2e-2, rtol=0)}


@pytest.fixture(scope="module")
def ctx():
    return initialize_distributed(axis_names=("x",), mesh_shape=(1,))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, HQ, S, D).astype(np.float32) * 0.5
    k = rng.randn(B, HKV, S, D).astype(np.float32) * 0.5
    v = rng.randn(B, HKV, S, D).astype(np.float32) * 0.5
    do = rng.randn(B, HQ, S, D).astype(np.float32) * 0.5
    return q, k, v, do


def _jax(ctx, arrays, causal, dtype):
    """out and lse of ``ring_attention_fwd``, then the gradients as the
    ``custom_vjp`` of ``ring_attention`` makes them: ``ring_attention_bwd``
    on the forward's residuals (called directly, which spares a second
    interpret-mode forward; each kernel call costs seconds here)."""
    q, k, v, do = (jnp.asarray(a, dtype) for a in arrays)
    kw = dict(axis="x", causal=causal, block_q=BLOCK, block_k=BLOCK)
    out, lse = jra.ring_attention_fwd(ctx, q, k, v, **kw)
    grads = jra.ring_attention_bwd(ctx, q, k, v, out, lse, do,
                                   sm_scale=None, **kw)
    return [np.asarray(x, np.float32) for x in (out, lse, *grads)]


def _port(arrays, causal, dtype, layout="contiguous"):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tra.ring_attention(None, *leaves, causal=causal, layout=layout)
    out.backward(do)
    _, lse = tra.ring_attention_fwd(None, q, k, v, causal=causal,
                                    layout=layout)
    return [t.detach().float().numpy()
            for t in (out, lse, *(x.grad for x in leaves))]


@pytest.mark.parametrize("causal,dtype", [(True, "float32"),
                                          (False, "float32"),
                                          (True, "bfloat16")])
def test_ring_attention_matches_jax(ctx, causal, dtype):
    arrays = _inputs(0)
    want = _jax(ctx, arrays, causal, getattr(jnp, dtype))
    got = _port(arrays, causal, getattr(torch, dtype))
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL[dtype])


def test_zigzag_layout_is_the_identity_on_one_rank():
    arrays = _inputs(1)
    got = _port(arrays, True, torch.float32, layout="zigzag")
    want = _port(arrays, True, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("S_,n", [(8, 1), (16, 2), (24, 3), (64, 4)])
def test_zigzag_indices_match_jax(S_, n):
    idx, inv = tra.zigzag_indices(S_, n)
    j_idx, j_inv = jra.zigzag_indices(S_, n)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(inv, j_inv)
    if n == 1:
        np.testing.assert_array_equal(idx, np.arange(S_))


def test_cpu_tensors_run_the_plain_versions():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2))
    before = (tra.ring_attention_fwd.launches,
              tra.ring_attention_bwd.launches)
    out, lse = tra.ring_attention_fwd(None, q, k, v)
    ref_out, ref_lse = tra.ring_attention_fwd_plain(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    grads = tra.ring_attention_bwd(None, q, k, v, out, lse, do)
    ref = tra.ring_attention_bwd_plain(q, k, v, out, lse, do)
    assert all(torch.equal(g, r) for g, r in zip(grads, ref))
    assert (tra.ring_attention_fwd.launches,
            tra.ring_attention_bwd.launches) == before


def test_more_than_one_rank_raises():
    """A ring of 2 ranks runs (since the ring transport was ported) and
    gives the one-rank function of the whole sequence; a bad layout and S
    not divisible by the ranks still raise."""
    from triton_dist_tpu_torch.shmem import initialize_distributed

    ring = initialize_distributed(("cp",), (2,), device="cpu")
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(3))
    out, lse = tra.ring_attention_fwd(ring, q, k, v, axis="cp")
    want = tra.ring_attention_fwd(None, q, k, v)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    assert torch.equal(tra.ring_attention(ring, q, k, v, axis="cp"),
                       want[0])
    with pytest.raises(ValueError, match="layout"):
        tra.ring_attention_fwd(ring, q, k, v, axis="cp", layout="striped")
    with pytest.raises(ValueError, match="divisible by ranks"):
        tra.ring_attention_fwd(ring, q[:, :, :S - 1], k[:, :, :S - 1],
                               v[:, :, :S - 1], axis="cp")
