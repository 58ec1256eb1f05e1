"""The port's one-rank MoE tensor-parallel block against the JAX package:
``ag_moe_group_gemm`` (B19) and ``moe_reduce_rs`` (B20) against JAX's on a
one-device mesh (interpret mode, as ``tests/test_models.py`` builds it), with
-1 padding rows; ``moe_mlp_tp_overlap`` against JAX's on the weights of JAX
``init_moe_params`` carried through ``models.convert.params_from_jax``; and
``AllGatherLayer`` (push, ring, auto) against JAX's at one rank.

Inputs come from numpy with a seed. Tolerances: f32 at ``atol 1e-5``, bf16
at ``2e-2`` (both sum in f32 in other orders and round once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.layers.allgather_layer import (AllGatherLayer as
                                                    JAllGatherLayer)
from triton_dist_tpu.models import llama as jl
from triton_dist_tpu.models import moe as jm
from triton_dist_tpu.ops import moe as jmoe
from triton_dist_tpu.shmem.context import initialize_distributed as j_init
from triton_dist_tpu_torch.layers import AllGatherLayer
from triton_dist_tpu_torch.models import moe as tm
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.ops import moe as tmoe
from triton_dist_tpu_torch.ops.group_gemm import grouped_gemm_plain
from triton_dist_tpu_torch.shmem.context import initialize_distributed

pytestmark = pytest.mark.port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
T, D, F, E, K = 12, 128, 128, 4, 2
BM = 16
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jctx():
    return j_init(axis_names=("x",), mesh_shape=(1,))


@pytest.fixture(scope="module")
def tctx():
    return initialize_distributed(axis_names=("x",), device="cpu")


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _inputs(dtype, rows: int, width: int, n_out: int, seed: int):
    """Rows, their experts (two rows padded with -1) and the expert
    weights, scaled so bf16 outputs stay near 1."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(rows, width) * 0.5, jnp.float32) \
        .astype(JDT[dtype])
    ids = rng.randint(0, E, rows).astype(np.int32)
    ids[[1, rows - 2]] = -1
    w = jnp.asarray(rng.randn(E, width, n_out) / np.sqrt(width),
                    jnp.float32).astype(JDT[dtype])
    return x, ids, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ag_moe_group_gemm_matches_jax(jctx, tctx, dtype):
    x, ids, w = _inputs(dtype, T, D, F, seed=1)
    want = jax.jit(lambda a, i, b: jmoe.ag_moe_group_gemm(
        jctx, a, i, b, axis="x", block_m=BM))(x, jnp.asarray(ids), w)
    got = tmoe.ag_moe_group_gemm(tctx, _t(x), _t(ids), _t(w), axis="x",
                                 block_m=BM)
    assert got.dtype == _t(x).dtype and got.shape == (T, F)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)
    assert not got[torch.from_numpy(ids < 0)].any()    # padding rows: zero
    # the aligned row block does not change a row's bits
    assert torch.equal(got, tmoe.ag_moe_group_gemm(
        tctx, _t(x), _t(ids), _t(w), block_m=64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_reduce_rs_matches_jax(jctx, tctx, dtype):
    h, ids, w = _inputs(dtype, T * K, F, D, seed=2)
    tw = np.random.RandomState(3).rand(T, K).astype(np.float32) + 0.1
    tw /= tw.sum(-1, keepdims=True)
    want = jax.jit(lambda a, i, g, b: jmoe.moe_reduce_rs(
        jctx, a, i, g, b, axis="x", block_m=BM))(
        h, jnp.asarray(ids), jnp.asarray(tw), w)
    got = tmoe.moe_reduce_rs(tctx, _t(h), _t(ids), _t(tw), _t(w), axis="x",
                             block_m=BM)
    assert got.dtype == _t(h).dtype and got.shape == (T, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


def test_moe_reduce_rs_folds_the_f32_slot():
    """In bf16 the down-projection reaches the top-k fold unrounded: the
    f32 slot, the f32 fold and one cast (a grouped GEMM into bf16 first
    would round twice)."""
    ctx = initialize_distributed(device="cpu")
    h, ids, w = _inputs("bfloat16", T * K, F, D, seed=4)
    h, w, ids = _t(h), _t(w), _t(ids)
    tw = torch.full((T, K), 0.5)
    y = torch.stack([h[r].float() @ w[i].float() if i >= 0
                     else torch.zeros(D) for r, i in enumerate(ids.tolist())])
    want = (y.view(T, K, D)[:, 0] * 0.5 + y.view(T, K, D)[:, 1] * 0.5) \
        .to(torch.bfloat16)
    assert torch.equal(tmoe.moe_reduce_rs(ctx, h, ids, tw, w, block_m=BM),
                       want)
    be = torch.zeros(1, dtype=torch.int32)
    out = grouped_gemm_plain(h[:16], w, be, 16, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert torch.equal(out, h[:16].float() @ w[0].float())


def test_more_ranks_and_tuple_axes_raise(tctx):
    """A 1-tuple is its axis, and a tuple of one-rank axes is the one-rank
    op (the 2-tier forms at n = 1)."""
    x, ids, w = (_t(a) for a in _inputs("float32", T, D, F, seed=1))
    tw = torch.full((T // 2, 2), 0.5)
    assert torch.equal(tmoe.ag_moe_group_gemm(tctx, x, ids, w, axis=("x",)),
                       tmoe.ag_moe_group_gemm(tctx, x, ids, w))
    ctx2 = initialize_distributed(axis_names=("x", "y"), device="cpu")
    assert torch.equal(tmoe.moe_reduce_rs(ctx2, x, ids, tw, w,
                                          axis=("x", "y")),
                       tmoe.moe_reduce_rs(tctx, x, ids, tw, w))


@pytest.fixture(scope="module")
def tiny_moe():
    """A tiny MoE model's weights from JAX ``init_moe_params``, and the same
    weights in the port through ``params_from_jax``."""
    base = jl.LlamaConfig(vocab_size=128, d_model=D, n_layers=1, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=128,
                          dtype=jnp.float32)
    cfg = jm.MoEConfig(base=base, num_experts=E, topk=K, moe_d_ff=F)
    jparams = jm.init_moe_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu", dtype=torch.float32)
    return cfg, jparams, tparams


def test_moe_mlp_tp_overlap_matches_jax(jctx, tctx, tiny_moe):
    cfg, jparams, tparams = tiny_moe
    jb = {k: v[0] for k, v in jparams["blocks"].items()}
    tb = {k: v[0] for k, v in tparams["blocks"].items()}
    for k in ("w_router", "we_up", "we_down"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    x = (np.random.RandomState(5).randn(T, D) * 2).astype(np.float32)
    want = jax.jit(lambda a: jm.moe_mlp_tp_overlap(
        jctx, a, jb["w_router"], jb["we_up"], jb["we_down"], topk=K,
        axis="x", block_m=BM))(jnp.asarray(x))
    got = tm.moe_mlp_tp_overlap(tctx, _t(x), tb["w_router"], tb["we_up"],
                                tb["we_down"], K, axis="x", block_m=BM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=0)
    assert np.abs(np.asarray(want)).max() > 10 * TOL["float32"]


@pytest.mark.parametrize("method", ["push", "ring", "auto"])
def test_allgather_layer_matches_jax(jctx, tctx, method):
    x = np.random.RandomState(6).randn(8, 128).astype(np.float32)
    jlayer, tlayer = JAllGatherLayer(jctx, "x"), AllGatherLayer(tctx, "x")
    jfn = jlayer if method == "auto" else getattr(jlayer, f"forward_{method}")
    tfn = tlayer if method == "auto" else getattr(tlayer, f"forward_{method}")
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    got = tfn(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)
    for two_d in (tlayer.forward_push_2d, tlayer.forward_ring_2d):
        with pytest.raises(ValueError, match="two or more axes"):
            two_d(_t(x))
