"""The port's tensor-parallel overlap ops across ranks against the JAX
package on the same numpy inputs, on (2,) and (4,) meshes of the conftest's
virtual CPU devices: AG-GEMM (``ag_gemm``, ``ag_gemm_ws``) and GEMM-RS
(``gemm_rs``, ``gemm_rs_ws``) with their workspace slots, the persistent
``tp_linear`` layers, the autograd ops ``ag_gemm_diff`` / ``gemm_rs_diff``
(values and gradients against ``jax.value_and_grad``), ``mlp_tp_overlap``
and ``forward_tp_overlap``.

On the CPU every wrapper runs its plain PyTorch version (per rank, B2's
plain product on the gathered A; per rank, B2's plain f32 partials summed in
slot order); the JAX side runs its Pallas kernels in interpret mode, each
jitted once and cached per module. The CUDA kernels are held against the
plain versions on the card by ``chip_smoke.py`` phase 15. Tolerances,
relative to the result's scale: f32 1e-5 for one op; bf16 2e-2 (one bf16
rounding may fall the other way); rtol 1e-4 for values and gradients
through the autograd ops and the MLP (the JAX op's test tolerance in
test_torch_tp_overlap.py); f32 logits 1e-4; bf16 logits 5e-2 (the JAX
model test's). The AG workspace slots are copies, compared bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.models import llama as jl
from triton_dist_tpu.ops import allgather_gemm as jag
from triton_dist_tpu.ops import autodiff as jad
from triton_dist_tpu.ops import gemm_reduce_scatter as jrs
from triton_dist_tpu.shmem.context import \
    initialize_distributed as j_initialize_distributed
from triton_dist_tpu_torch.layers import (ColumnParallelLinear,
                                          RowParallelLinear)
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.ops import allgather_gemm as tag
from triton_dist_tpu_torch.ops import autodiff as tad
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as trs
from triton_dist_tpu_torch.shmem import initialize_distributed

pytestmark = pytest.mark.port

M, K, N = 64, 128, 128
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_RTOL = 1e-4
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
RANKS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch ops run 10-30x slower beside JAX's interpret-mode threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jctx(n: int):
    return j_initialize_distributed(axis_names=("x",), mesh_shape=(n,))


def _tctx(n: int):
    return initialize_distributed(("x",), (n,), device="cpu")


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _arrays(dtype: str, *shapes, seed: int = 0):
    rng = np.random.RandomState(seed)
    out = [(rng.randn(*s) * 0.3).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        out = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in out]
    return out


@functools.lru_cache(maxsize=None)
def _jax_ops(n: int, dtype: str):
    """The JAX workspace forms at n ranks on a [M, K] @ [K, N] case, each
    with its returned buffers; the workspaces start as ones, so a slot the
    kernel leaves unwritten shows."""
    ctx = _jctx(n)
    a, b = _arrays(dtype, (M, K), (K, N), seed=n)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ws = jnp.ones((n, n, M // n, K), ja.dtype)
    ag = jax.jit(lambda x, y, w: jag.ag_gemm_ws(ctx, x, y, w, axis="x"))(
        ja, jb, ws)
    rws = jnp.ones((n, n, M // n, N), jnp.float32)
    stage = jnp.ones((n, 2, M // n, N), jnp.float32)
    rs = jax.jit(lambda x, y, w, s: jrs.gemm_rs_ws(ctx, x, y, w, s,
                                                   axis="x"))(ja, jb, rws,
                                                              stage)
    return a, b, jax.tree.map(np.asarray, {"ag": ag, "rs": rs})


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ag_gemm_and_gemm_rs_match_jax(n, dtype):
    a, b, want = _jax_ops(n, dtype)
    ctx = _tctx(n)
    for name, op in (("ag", tag.ag_gemm), ("rs", trs.gemm_rs)):
        got = op(ctx, _t(a), _t(b))
        assert str(got.dtype).split(".")[-1] == dtype
        assert got.shape == want[name][0].shape
        assert _rel(_np(got), want[name][0]) <= TOL[dtype], name


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_workspace_forms_match_jax_with_their_slots(n, dtype):
    """``ag_gemm_ws`` leaves rank r's slot s holding shard s for s != r and
    its own slot as it was, bit for bit as JAX's; ``gemm_rs_ws`` leaves rank
    r's slot s holding rank s's f32 partial of segment r, as JAX's, and its
    send stage unwritten (the kernel stores each partial straight into its
    owner's slot)."""
    a, b, want = _jax_ops(n, dtype)
    ctx = _tctx(n)
    ws = torch.ones(n, n, M // n, K, dtype=_t(a).dtype)
    c, ws_out = tag.ag_gemm_ws(ctx, _t(a), _t(b), ws)
    j_c, j_ws = want["ag"]
    assert ws_out is ws
    assert np.array_equal(j_ws.astype(np.float32), _np(ws_out))
    assert _rel(_np(c), j_c) <= TOL[dtype]

    rws = torch.ones(n, n, M // n, N)
    stage = torch.ones(n, 2, M // n, N)
    out, rws_out, stage_out = trs.gemm_rs_ws(ctx, _t(a), _t(b), rws, stage)
    j_out, j_rws, _ = want["rs"]
    assert rws_out is rws and stage_out is stage
    assert torch.equal(stage, torch.ones_like(stage))
    assert _rel(_np(rws_out), j_rws) <= TOL["float32"]
    assert _rel(_np(out), j_out) <= TOL[dtype]
    # rank r's rows are the slot reduction of its n partials, in slot order
    m = M // n
    for r in range(n):
        acc = rws_out[r, 0].clone()
        for s in range(1, n):
            acc += rws_out[r, s]
        assert torch.equal(out[r * m:(r + 1) * m], acc.to(out.dtype))


def test_workspace_helpers_and_contexts_at_two_ranks():
    ctx = _tctx(2)
    ws = tag.create_ag_gemm_workspace(ctx, 8, K, torch.bfloat16)
    assert ws.shape == (2, 2, 8, K) and not ws.any()
    rws, stage = trs.create_gemm_rs_workspace(ctx, 8, N, torch.bfloat16)
    assert rws.shape == (2, 2, 8, N) and stage.shape == (2, 2, 8, N)
    assert rws.dtype == stage.dtype == torch.float32
    a, b = (_t(x) for x in _arrays("float32", (16, K), (K, N)))
    agc = tag.create_ag_gemm_context(ctx, 8, K, torch.float32)
    assert torch.equal(agc(a, b), tag.ag_gemm(ctx, a, b))
    with pytest.raises(ValueError, match="does not match"):
        tag.ag_gemm_ws(ctx, a, b, torch.zeros(1, 1, 16, K))
    with pytest.raises(ValueError, match="split"):
        tag.ag_gemm(ctx, a[:15], b)


@pytest.mark.parametrize("persistent", [False, True])
def test_tp_linear_layers_two_calls_in_a_row(persistent):
    a, b, want = _jax_ops(2, "bfloat16")
    ctx = _tctx(2)
    col = ColumnParallelLinear(ctx, persistent=persistent)
    row = RowParallelLinear(ctx, persistent=persistent)
    for _ in range(2):
        assert _rel(_np(col(_t(a), _t(b))), want["ag"][0]) <= TOL["bfloat16"]
        assert _rel(_np(row(_t(a), _t(b))), want["rs"][0]) <= TOL["bfloat16"]
    # one workspace context per shape, reused by the second call
    assert len(col._ag_ctxs) == len(row._rs_ctxs) == int(persistent)


def _loss_weights(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_diff(which: str, n: int = 2):
    """jax.value_and_grad of sum(op(x, w) * g) through the JAX autograd op
    at n ranks."""
    ctx = _jctx(n)
    x, w = _arrays("float32", (M, K), (K, N), seed=3)
    g = _loss_weights((M, N))
    op = jad.ag_gemm_diff if which == "ag" else jad.gemm_rs_diff

    def loss(x, w):
        return jnp.sum(op(ctx, "x", None, x, w) * g)

    val, grads = jax.jit(jax.value_and_grad(loss, (0, 1)))(jnp.asarray(x),
                                                          jnp.asarray(w))
    return x, w, g, float(val), [np.asarray(d) for d in grads]


@pytest.mark.parametrize("which", ["ag", "rs"])
def test_autodiff_value_and_grads_match_jax_at_two_ranks(which):
    x, w, g, val, grads = _jax_diff(which)
    op = tad.ag_gemm_diff if which == "ag" else tad.gemm_rs_diff
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    loss = (op(_tctx(2), "x", None, tx, tw) * _t(g)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), val, rtol=GRAD_RTOL)
    for got, want in zip((tx.grad, tw.grad), grads):
        assert _rel(_np(got), want) <= GRAD_RTOL


def test_gemm_rs_diff_rebuilds_each_ranks_gather():
    """dw = x^T @ AG(dy) at two ranks: each rank rebuilds AG(dy) from its
    own workspace slots with its own segment of dy in its own slot, and its
    row block of dw is its columns of x against that gather. A gather
    rebuilt with rank 0's segment alone (the one-rank rule) gives a wrong
    dw (or no dw at all) at n > 1."""
    x, w = (_t(v) for v in _arrays("float32", (M, K), (K, N), seed=4))
    g = _t(_loss_weights((M, N), seed=5))
    tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
    (tad.gemm_rs_diff(_tctx(2), "x", None, tx, tw) * g).sum().backward()
    assert _rel(_np(tw.grad), _np(x.t() @ g)) <= TOL["float32"]
    assert _rel(_np(tx.grad), _np(g @ w.t())) <= TOL["float32"]


@functools.lru_cache(maxsize=None)
def _jax_mlp(n: int = 2):
    ctx = _jctx(n)
    T, D, Fd = 128, 64, 96
    x, wg, wu, wd = _arrays("float32", (T, D), (D, Fd), (D, Fd), (Fd, D),
                            seed=5)
    g = _loss_weights((T, D))

    def loss(*args):
        return jnp.sum(jl.mlp_tp_overlap(ctx, *args, axis="x") * g)

    val, grads = jax.jit(jax.value_and_grad(loss, (0, 1, 2, 3)))(
        *(jnp.asarray(v) for v in (x, wg, wu, wd)))
    return (x, wg, wu, wd), g, float(val), [np.asarray(d) for d in grads]


def test_mlp_tp_overlap_value_and_grads_match_jax_at_two_ranks():
    args, g, val, grads = _jax_mlp()
    targs = [_t(a).requires_grad_() for a in args]
    out = tl.mlp_tp_overlap(_tctx(2), *targs)
    loss = (out * _t(g)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), val, rtol=GRAD_RTOL)
    for name, t, want in zip(("dx", "dw_gate", "dw_up", "dw_down"), targs,
                             grads):
        assert _rel(_np(t.grad), want) <= GRAD_RTOL, name


def _tiny(dtype: str, n_layers: int = 2):
    return dataclasses.replace(tl.LlamaConfig.tiny(n_layers),
                               dtype=getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _jax_forward(dtype: str, n: int = 2, n_layers: int = 1):
    """JAX's forward_tp_overlap at n ranks on a one-layer tiny model (its
    interpret-mode compile grows with the depth)."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(n_layers),
                               dtype=jnp.dtype(dtype))
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tokens = np.random.RandomState(1).randint(1, jcfg.vocab_size,
                                              (2, 64)).astype(np.int32)
    ctx = _jctx(n)
    logits = jax.jit(lambda p, t: jl.forward_tp_overlap(ctx, p, t, jcfg,
                                                        axis="x"))(
        jparams, jnp.asarray(tokens))
    return jax.tree.map(np.asarray, jparams), tokens, np.asarray(logits)


@pytest.mark.parametrize("dtype", ["bfloat16"])
def test_forward_tp_overlap_matches_jax_at_two_ranks(dtype):
    """bf16, as the JAX model test holds it; f32 at n ranks is held against
    one rank below."""
    np_params, tokens, want = _jax_forward(dtype)
    tdt = getattr(torch, dtype)
    params = params_from_jax(np_params, device="cpu", dtype=tdt)
    got = tl.forward_tp_overlap(_tctx(2), params, _t(tokens),
                                _tiny(dtype, n_layers=1))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= LOGIT_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_tp_overlap_at_four_ranks_matches_one_rank(dtype):
    cfg = _tiny(dtype)
    params = tl.init_params(cfg, seed=2, device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(3))
    one = tl.forward_tp_overlap(_tctx(1), params, tokens, cfg)
    four = tl.forward_tp_overlap(_tctx(4), params, tokens, cfg)
    assert _rel(four.numpy(), one.numpy()) <= LOGIT_TOL[dtype]
