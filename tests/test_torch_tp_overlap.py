"""The port's tensor-parallel overlap slice at one rank against the JAX
package on a one-device mesh: AG-GEMM (``ag_gemm``, ``ag_gemm_ws``), GEMM-RS
(``gemm_rs``, ``gemm_rs_ws``) with their returned workspaces, the autograd
ops ``ag_gemm_diff`` / ``gemm_rs_diff`` (values and gradients against
``jax.value_and_grad``), the ``tp_linear`` layers, ``mlp_tp_overlap`` and
``forward_tp_overlap``.

On the CPU every wrapper runs its plain PyTorch version (f32 sums, one
cast); the JAX side runs its Pallas kernels in interpret mode, jitted once
per case. Tolerances: f32 1e-5 of the result's scale for one GEMM, rtol
1e-4 for values and gradients through the autograd ops and the MLP; bf16
2e-2 of the scale (one bf16 rounding may fall the other way); the model's
logits 1e-4 (f32) and 2e-2 (bf16) of the logits' scale.
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
from triton_dist_tpu_torch.ops import gemm as tg
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as trs
from triton_dist_tpu_torch.shmem import initialize_distributed

pytestmark = pytest.mark.port

M, K, N = 64, 128, 96
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch ops run 10-30x slower beside JAX's interpret-mode threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jctx():
    return j_initialize_distributed(axis_names=("x",), mesh_shape=(1,))


def _tctx():
    return initialize_distributed(("x",), device="cpu")


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
def _jax_ops(dtype: str):
    """The JAX ops at one rank on a [M, K] @ [K, N] case: ag_gemm, gemm_rs,
    and the workspace forms with their returned buffers (the persistent
    workspaces start as ones, so an untouched buffer shows)."""
    ctx = _jctx()
    a, b = _arrays(dtype, (M, K), (K, N))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ag = jax.jit(lambda x, y: jag.ag_gemm(ctx, x, y, axis="x"))(ja, jb)
    rs = jax.jit(lambda x, y: jrs.gemm_rs(ctx, x, y, axis="x"))(ja, jb)
    ws = jnp.ones((1, 1, M, K), ja.dtype)
    ag_ws = jax.jit(lambda x, y, w: jag.ag_gemm_ws(ctx, x, y, w, axis="x"))(
        ja, jb, ws)
    rws, stage = (jnp.ones((1, 1, M, N), jnp.float32),
                  jnp.ones((1, 2, M, N), jnp.float32))
    rs_ws = jax.jit(lambda x, y, w, s: jrs.gemm_rs_ws(ctx, x, y, w, s,
                                                      axis="x"))(
        ja, jb, rws, stage)
    return a, b, jax.tree.map(np.asarray, {"ag": ag, "rs": rs,
                                           "ag_ws": ag_ws, "rs_ws": rs_ws})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ag_gemm_and_gemm_rs_match_jax(dtype):
    a, b, want = _jax_ops(dtype)
    ctx = _tctx()
    for name, op in (("ag", tag.ag_gemm), ("rs", trs.gemm_rs)):
        got = op(ctx, _t(a), _t(b))
        assert str(got.dtype).split(".")[-1] == str(want[name].dtype) == dtype
        assert _rel(_np(got), want[name]) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_workspace_forms_match_jax_with_their_workspaces(dtype):
    """``ag_gemm_ws`` returns its workspace unwritten; ``gemm_rs_ws`` leaves
    the f32 partial in slot 0 and the send stage untouched, as the JAX
    kernels leave them at one rank."""
    a, b, want = _jax_ops(dtype)
    ctx = _tctx()
    ws = torch.ones(1, 1, M, K, dtype=_t(a).dtype)
    c, ws_out = tag.ag_gemm_ws(ctx, _t(a), _t(b), ws)
    assert ws_out is ws and torch.equal(ws, torch.ones_like(ws))
    assert np.array_equal(want["ag_ws"][1].astype(np.float32), _np(ws_out))
    assert _rel(_np(c), want["ag_ws"][0]) <= TOL[dtype]

    rws, stage = torch.ones(1, 1, M, N), torch.ones(1, 2, M, N)
    out, rws_out, stage_out = trs.gemm_rs_ws(ctx, _t(a), _t(b), rws, stage)
    j_out, j_ws, j_stage = want["rs_ws"]
    assert np.array_equal(j_stage, _np(stage_out))
    assert _rel(_np(rws_out), j_ws) <= TOL["float32"]
    assert _rel(_np(out), j_out) <= TOL[dtype]
    # the output is the slot reduction of the f32 partial: a cast
    assert torch.equal(out, rws_out[0, 0].to(out.dtype))


def test_workspace_helpers_and_contexts():
    ctx = _tctx()
    ws = tag.create_ag_gemm_workspace(ctx, M, K, torch.float32)
    assert ws.shape == (1, 1, M, K) and not ws.any()
    rws, stage = trs.create_gemm_rs_workspace(ctx, M, N, torch.bfloat16)
    assert rws.shape == (1, 1, M, N) and stage.shape == (1, 2, M, N)
    assert rws.dtype == stage.dtype == torch.float32
    a, b = (_t(x) for x in _arrays("float32", (M, K), (K, N)))
    agc = tag.create_ag_gemm_context(ctx, M, K, torch.float32)
    rsc = trs.create_gemm_rs_context(ctx, M, N, torch.float32)
    assert torch.equal(agc(a, b), a @ b) and torch.equal(rsc(a, b), a @ b)
    with pytest.raises(ValueError, match="does not match"):
        tag.ag_gemm_ws(ctx, a, b, torch.zeros(1, 1, M, K + 1))
    with pytest.raises(ValueError, match="stage"):
        trs.gemm_rs_ws(ctx, a, b, rsc.ws, torch.zeros(1, 1, M, N))


def test_more_ranks_and_axis_tuples_raise():
    """Tuple axes and groups inside a multi-axis mesh run (the 2-tier and
    group forms): over a tuple of one-rank axes they are the one-rank op,
    a 1-tuple is its axis, and a group of (2, 2) is the 2-rank op."""
    ctx = initialize_distributed(("x", "y"), device="cpu")
    a, b = (_t(x) for x in _arrays("float32", (8, 8), (8, 8), seed=9))
    one = tag.ag_gemm(ctx, a, b)
    assert torch.equal(tag.ag_gemm(ctx, a, b, axis=("x", "y")), one)
    assert torch.equal(trs.gemm_rs(ctx, a, b, axis=("x", "y")),
                       trs.gemm_rs(ctx, a, b))
    ws = tag.create_ag_gemm_workspace(ctx, 8, 8, axis=("x", "y"))
    assert ws.shape == (1, 1, 8, 8) and not ws.any()
    # a 1-tuple is its axis
    assert tag.ag_gemm(ctx, a, b, axis=("y",)).shape == (8, 8)
    # more ranks run over an axis that spans the whole mesh (every rank on
    # the one card), and over a group inside a multi-axis mesh
    two = tag.ag_gemm(initialize_distributed(("x",), (2,), device="cpu"),
                      a, b)
    assert torch.equal(two, a @ b)
    assert torch.equal(tag.ag_gemm(initialize_distributed(
        ("x", "y"), (2, 2), device="cpu"), a, b, axis="y"), two)


def test_tp_column_linear_is_the_product_at_one_rank():
    """At one rank it is the product, summed per element in the fixed K
    order that makes every column split bitwise the whole
    (``column_product``; B2 on the card), within f32 rounding of ``h @
    w``."""
    ctx = initialize_distributed(("tp",), device="cpu")
    h, w = (_t(x) for x in _arrays("float32", (4, K), (K, N)))
    got = tag.tp_column_linear(ctx, h, w)
    assert torch.equal(got, tag.column_product(h, w))
    torch.testing.assert_close(got, h @ w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("persistent", [False, True])
def test_tp_linear_layers_match_jax(persistent):
    a, b, want = _jax_ops("bfloat16")
    ctx = _tctx()
    col = ColumnParallelLinear(ctx, persistent=persistent)
    row = RowParallelLinear(ctx, persistent=persistent)
    for _ in range(2):
        assert _rel(_np(col(_t(a), _t(b))), want["ag"]) <= TOL["bfloat16"]
        assert _rel(_np(row(_t(a), _t(b))), want["rs"]) <= TOL["bfloat16"]
    # one workspace context per shape, reused by the second call
    assert len(col._ag_ctxs) == len(row._rs_ctxs) == int(persistent)


def _loss_weights(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_diff(which: str):
    """jax.value_and_grad of sum(op(x, w) * g) through the JAX autograd op."""
    ctx = _jctx()
    shapes = ((M, K), (K, N))
    x, w = _arrays("float32", *shapes, seed=3)
    g = _loss_weights((M, N))
    op = jad.ag_gemm_diff if which == "ag" else jad.gemm_rs_diff

    def loss(x, w):
        return jnp.sum(op(ctx, "x", None, x, w) * g)

    val, grads = jax.jit(jax.value_and_grad(loss, (0, 1)))(jnp.asarray(x),
                                                          jnp.asarray(w))
    return x, w, g, float(val), [np.asarray(d) for d in grads]


@pytest.mark.parametrize("which", ["ag", "rs"])
def test_autodiff_value_and_grads_match_jax(which):
    x, w, g, val, grads = _jax_diff(which)
    op = tad.ag_gemm_diff if which == "ag" else tad.gemm_rs_diff
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    loss = (op(_tctx(), "x", None, tx, tw) * _t(g)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), val, rtol=GRAD_RTOL)
    for got, want in zip((tx.grad, tw.grad), grads):
        assert _rel(_np(got), want) <= GRAD_RTOL


@functools.lru_cache(maxsize=None)
def _jax_mlp():
    ctx = _jctx()
    T, D, Fd = 128, 64, 96
    x, wg, wu, wd = _arrays("float32", (T, D), (D, Fd), (D, Fd), (Fd, D),
                            seed=5)
    g = _loss_weights((T, D))

    def loss(*args):
        return jnp.sum(jl.mlp_tp_overlap(ctx, *args, axis="x") * g)

    val, grads = jax.jit(jax.value_and_grad(loss, (0, 1, 2, 3)))(
        *(jnp.asarray(v) for v in (x, wg, wu, wd)))
    return (x, wg, wu, wd), g, float(val), [np.asarray(d) for d in grads]


def test_mlp_tp_overlap_value_and_grads_match_jax():
    args, g, val, grads = _jax_mlp()
    targs = [_t(a).requires_grad_() for a in args]
    out = tl.mlp_tp_overlap(_tctx(), *targs)
    loss = (out * _t(g)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), val, rtol=GRAD_RTOL)
    for name, t, want in zip(("dx", "dw_gate", "dw_up", "dw_down"), targs,
                             grads):
        assert _rel(_np(t.grad), want) <= GRAD_RTOL, name
    # the same MLP written densely
    x, wg, wu, wd = (t.detach() for t in targs)
    dense = (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd
    assert _rel(_np(out), _np(dense)) <= TOL["float32"]


@functools.lru_cache(maxsize=None)
def _jax_forward(dtype: str):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.dtype(dtype))
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tokens = np.random.RandomState(1).randint(1, jcfg.vocab_size,
                                              (2, 64)).astype(np.int32)
    ctx = _jctx()
    logits = jax.jit(lambda p, t: jl.forward_tp_overlap(ctx, p, t, jcfg))(
        jparams, jnp.asarray(tokens))
    return jax.tree.map(np.asarray, jparams), tokens, np.asarray(logits)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
def test_forward_tp_overlap_matches_jax_and_dense_forward(dtype, tol):
    np_params, tokens, want = _jax_forward(dtype)
    tdt = getattr(torch, dtype)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=tdt)
    params = params_from_jax(np_params, device="cpu", dtype=tdt)
    before = tg.matmul.launches
    got = tl.forward_tp_overlap(_tctx(), params, _t(tokens), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= tol
    dense = tl.forward(params, _t(tokens).long(), cfg)
    assert _rel(got.numpy(), dense.numpy()) <= tol
    assert tg.matmul.launches == before       # the CPU runs the plain version
