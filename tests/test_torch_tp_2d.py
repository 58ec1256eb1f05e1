"""The port's TP overlap ops and MoE-TP block over a group inside a
multi-axis mesh and over a tuple of axes (the 2-tier forms) against the JAX
package on the same numpy inputs, on the reference's own meshes and shapes:
(2, 3) over ("a", "b") as in ``tests/test_hierarchical.py`` (``block_m=8``
for the MoE ops), (2, 2) over b's groups, ``ag_gemm`` over ("a", "b", "c")
of (2, 2, 2) as in ``tests/test_three_tier.py``, and ``forward_tp_overlap``
on ``LlamaConfig.tiny()`` over ("a", "b") of (2, 2). Within the port: the
2-tier and group forms of B15 and B19 are bitwise their 1-tier forms over
the same ranks; the 2-tier B16 and B20 are bitwise their inner-group stage
on the strided rows followed by B13's ring over the outer axis, and within
f32 rounding of the flat form; ``mlp_tp_overlap``'s gradients over ("a",
"b") agree with the flat 4-rank axis.

On the CPU every wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode, each jitted once and cached per
module. The CUDA kernels are held against their compositions on the card
by ``chip_smoke.py`` phase 20. Tolerances, relative to the result's scale:
f32 1e-5 for the gathers (B15, B19: one f32 sum a row, the same terms),
1e-4 for the reductions (B16, B20: partials summed across ranks in another
order) and for the f32 logits and gradients; bf16 2e-2 (one bf16 rounding
may fall the other way).
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
from triton_dist_tpu.ops import gemm_reduce_scatter as jrs
from triton_dist_tpu.ops import moe as jmoe
from triton_dist_tpu.ops.gemm import GemmConfig as JGemmConfig
from triton_dist_tpu.shmem.context import initialize_distributed as j_init
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.ops import allgather_gemm as tag
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as trs
from triton_dist_tpu_torch.ops import moe as tmoe
from triton_dist_tpu_torch.ops.gemm import matmul_plain, slot_reduce_plain
from triton_dist_tpu_torch.ops.reduce_scatter import reduce_scatter_plain
from triton_dist_tpu_torch.shmem import initialize_distributed

pytestmark = pytest.mark.port

AXES = ("a", "b")
AXES3 = ("a", "b", "c")
GATHER_TOL = 1e-5
REDUCE_TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch ops run 10-30x slower beside JAX's interpret-mode threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jctx(shape: tuple):
    return j_init(axis_names=AXES3[:len(shape)], mesh_shape=shape)


def _tctx(shape: tuple):
    return initialize_distributed(AXES3[:len(shape)], shape, device="cpu")


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _gemm_inputs(n: int, kind: str, seed: int, dtype: str = "float32"):
    """test_hierarchical's shapes at n ranks: AG-GEMM [n 16, 128] @ [128, n
    32]; GEMM-RS [n 16, n 32] @ [n 32, 64]."""
    rng = np.random.RandomState(seed)
    M, K, N = (n * 16, 128, n * 32) if kind == "ag" else (n * 16, n * 32, 64)
    a = rng.randn(M, K).astype(np.float32)
    b = (rng.randn(K, N) * 0.1).astype(np.float32)
    return (_bf16(a), _bf16(b)) if dtype == "bfloat16" else (a, b)


def _moe_inputs(n: int, kind: str, seed: int, dtype: str = "float32"):
    """test_hierarchical's MoE shapes at n ranks (E = 4), with -1 padding
    rows: B19 tokens [n 8, 128], weights [4, 128, n 16]; B20 rows [n 4 x 2,
    n 32], top-2 weights, weights [4, n 32, 64]."""
    rng = np.random.RandomState(seed)
    E = 4
    if kind == "ag":
        T, H, N = n * 8, 128, n * 16
        x = rng.randn(T, H).astype(np.float32)
        w = (rng.randn(E, H, N) * 0.2).astype(np.float32)
        ids = rng.randint(0, E, T).astype(np.int32)
        ids[[1, T - 2]] = -1
        out = (x, ids, w)
    else:
        T, topk, K, N = n * 4, 2, n * 32, 64
        x = (rng.randn(T * topk, K) * 0.3).astype(np.float32)
        ids = rng.randint(0, E, T * topk).astype(np.int32)
        ids[[0, 1, T * topk - 3]] = -1     # token 0 routes nowhere
        tw = rng.rand(T, topk).astype(np.float32) + 0.1
        tw /= tw.sum(-1, keepdims=True)
        w = (rng.randn(E, K, N) * 0.2).astype(np.float32)
        out = (x, ids, tw, w)
    if dtype == "bfloat16":             # the rows and the expert weights
        out = (_bf16(out[0]),) + out[1:-1] + (_bf16(out[-1]),)
    return out


@functools.lru_cache(maxsize=None)
def _jax_ops(shape: tuple, axis, dtype: str):
    """The four JAX ops over ``axis`` of ``shape`` (jitted once): AG-GEMM
    (with its workspace, started as ones, over a tuple), GEMM-RS, B19 and
    B20 (``block_m=8``)."""
    ctx = _jctx(shape)
    n = ctx.axis_size(axis)
    jdt = jnp.dtype(dtype)
    a, b = _gemm_inputs(n, "ag", 0, dtype)
    cfg = JGemmConfig(block_m=16, block_n=32)
    if isinstance(axis, tuple):
        ws = jnp.ones((n, n, a.shape[0] // n, a.shape[1]), jdt)
        ag = jax.jit(lambda x, y, w: jag.ag_gemm_ws(
            ctx, x, y, w, axis=axis, cfg=cfg, out_dtype=jnp.float32))(
            jnp.asarray(a), jnp.asarray(b), ws)
    else:
        ag = (jax.jit(lambda x, y: jag.ag_gemm(
            ctx, x, y, axis=axis, cfg=cfg, out_dtype=jnp.float32))(
            jnp.asarray(a), jnp.asarray(b)),)
    ra, rb = _gemm_inputs(n, "rs", 1, dtype)
    rs = jax.jit(lambda x, y: jrs.gemm_rs(ctx, x, y, axis=axis, cfg=cfg,
                                          out_dtype=jnp.float32))(
        jnp.asarray(ra), jnp.asarray(rb))
    x, ids, w = _moe_inputs(n, "ag", 2, dtype)
    moe_ag = jax.jit(lambda t, w_: jmoe.ag_moe_group_gemm(
        ctx, t, jnp.asarray(ids), w_, axis=axis, block_m=8))(
        jnp.asarray(x), jnp.asarray(w))
    h, rids, tw, rw = _moe_inputs(n, "rs", 3, dtype)
    moe_rs = jax.jit(lambda t, w_: jmoe.moe_reduce_rs(
        ctx, t, jnp.asarray(rids), jnp.asarray(tw), w_, axis=axis,
        block_m=8))(jnp.asarray(h), jnp.asarray(rw))
    return jax.tree.map(np.asarray, {"ag": ag, "rs": rs, "moe_ag": moe_ag,
                                     "moe_rs": moe_rs})


CASES = [((2, 3), AXES, "float32"), ((2, 2), "b", "bfloat16")]


@pytest.mark.parametrize("shape,axis,dtype", CASES, ids=["2x3-ab", "2x2-b"])
def test_tp_ops_match_jax(shape, axis, dtype):
    """B15 and B16 over ("a", "b") of (2, 3) in f32 and over b's groups of
    (2, 2) in bf16, against JAX; over the tuple AG-GEMM's workspace slots
    are JAX's bit for bit (every slot but a rank's own filled)."""
    want = _jax_ops(shape, axis, dtype)
    ctx = _tctx(shape)
    n = ctx.axis_size(axis)
    a, b = (_t(v) for v in _gemm_inputs(n, "ag", 0, dtype))
    if isinstance(axis, tuple):
        ws = torch.ones(n, n, a.shape[0] // n, a.shape[1], dtype=a.dtype)
        c, ws = tag.ag_gemm_ws(ctx, a, b, ws, axis=axis,
                               out_dtype=torch.float32)
        assert np.array_equal(_np(ws), want["ag"][1].astype(np.float32))
    else:
        c = tag.ag_gemm(ctx, a, b, axis=axis, out_dtype=torch.float32)
    tol = GATHER_TOL if dtype == "float32" else BF16_TOL
    assert _rel(_np(c), want["ag"][0]) <= tol
    ra, rb = (_t(v) for v in _gemm_inputs(n, "rs", 1, dtype))
    y = trs.gemm_rs(ctx, ra, rb, axis=axis, out_dtype=torch.float32)
    tol = REDUCE_TOL if dtype == "float32" else BF16_TOL
    assert y.shape == want["rs"].shape and _rel(_np(y), want["rs"]) <= tol


@pytest.mark.parametrize("shape,axis,dtype", CASES, ids=["2x3-ab", "2x2-b"])
def test_moe_tp_ops_match_jax(shape, axis, dtype):
    """B19 and B20 (``block_m=8``) over the same meshes against JAX, padding
    rows and all."""
    want = _jax_ops(shape, axis, dtype)
    ctx = _tctx(shape)
    n = ctx.axis_size(axis)
    x, ids, w = (_t(v) for v in _moe_inputs(n, "ag", 2, dtype))
    y = tmoe.ag_moe_group_gemm(ctx, x, ids, w, axis=axis, block_m=8)
    assert _rel(_np(y), want["moe_ag"]) <= (GATHER_TOL if dtype == "float32"
                                            else BF16_TOL)
    h, rids, tw, rw = (_t(v) for v in _moe_inputs(n, "rs", 3, dtype))
    z = tmoe.moe_reduce_rs(ctx, h, rids, tw, rw, axis=axis, block_m=8)
    assert _rel(_np(z), want["moe_rs"]) <= (REDUCE_TOL if dtype == "float32"
                                            else BF16_TOL)


@functools.lru_cache(maxsize=None)
def _jax_three_tier():
    """test_three_tier's AG-GEMM over ("a", "b", "c") of (2, 2, 2)."""
    ctx = _jctx((2, 2, 2))
    rng = np.random.RandomState(4)
    a = rng.randn(16, 128).astype(np.float32)
    b = rng.randn(128, 128).astype(np.float32)
    c = jax.jit(lambda u, v: jag.ag_gemm(ctx, u, v, axis=AXES3,
                                         cfg=JGemmConfig(2, 16)))(
        jnp.asarray(a), jnp.asarray(b))
    return a, b, np.asarray(c)


def test_ag_gemm_three_tier_matches_jax():
    """Over three axes the inner two flatten into one tier (as B11 does)."""
    a, b, want = _jax_three_tier()
    got = tag.ag_gemm(_tctx((2, 2, 2)), _t(a), _t(b), axis=AXES3)
    assert _rel(_np(got), want) <= GATHER_TOL


FORMS = [("b", (2, 2), 2), (AXES, (2, 2), 4), (AXES, (2, 3), 6),
         (AXES3, (2, 2, 2), 8), (("b", "c"), (2, 2, 2), 4)]


@pytest.mark.parametrize("axis,shape,n", FORMS,
                         ids=["2x2-b", "2x2-ab", "2x3-ab", "2x2x2-abc",
                              "2x2x2-bc"])
def test_gathers_are_bitwise_their_one_axis_forms(axis, shape, n):
    """B15 and B19 over a group or a tuple compute each segment's rows with
    the same sums as the one-axis op over n ranks: bitwise, in every
    group's replica; the AG workspace's slots are filled as the one-axis
    op fills them."""
    ctx, flat = _tctx(shape), _tctx((n,))
    a, b = (_t(v) for v in _gemm_inputs(n, "ag", 5))
    want = tag.ag_gemm(flat, a, b)
    got = tag.ag_gemm(ctx, a, b, axis=axis, replicas=True)
    assert got.shape[0] == ctx.num_ranks // n
    assert all(torch.equal(g, want) for g in got)
    ws = tag.create_ag_gemm_workspace(ctx, a.shape[0] // n, a.shape[1],
                                      torch.float32, axis=axis)
    tag.ag_gemm_ws(ctx, a, b, ws, axis=axis)
    shards = a.view(n, -1, a.shape[1])
    index = [ctx.my_pe(r, ctx.group_axes(axis)) for r in range(ctx.num_ranks)]
    assert all(torch.equal(ws[r, s], shards[s]) == (s != index[r])
               for r in range(ctx.num_ranks) for s in range(n))
    x, ids, w = (_t(v) for v in _moe_inputs(n, "ag", 6))
    want = tmoe.ag_moe_group_gemm(flat, x, ids, w, block_m=8)
    got = tmoe.ag_moe_group_gemm(ctx, x, ids, w, axis=axis, block_m=8,
                                 replicas=True)
    assert all(torch.equal(g, want) for g in got)
    assert not got[:, ids < 0].any()          # padding rows stay zero


def _stage_then_ring(ctx, parts, axis):
    """The 2-tier reduction as its two stages, written out: ``parts[g][s]``
    is index g's f32 partial of segment s (g, s < n, the P(axes) order);
    stage 1 sums, for rank (mo, mi), the partials of its strided chunk
    {(r, mi) : r < no} over its inner peers in inner slot order; stage 2
    is B13's ring (``reduce_scatter_plain``) over the outer axis on those
    chunks. Returns every index's reduced segment, [n, ...]."""
    outer, inner = axis[0], tuple(axis[1:])
    no, ni = ctx.axis_size(outer), ctx.axis_size(inner)
    out = [None] * (no * ni)
    for mi in range(ni):
        chunks = torch.stack([torch.cat([slot_reduce_plain(torch.stack(
            [parts[mo * ni + s][r * ni + mi] for s in range(ni)]),
            torch.float32) for r in range(no)]) for mo in range(no)])
        segs = reduce_scatter_plain(chunks.reshape(no * no, -1), no)
        for mo in range(no):
            out[mo * ni + mi] = segs.view(no, -1)[mo]
    return torch.stack(out)


@pytest.mark.parametrize("axis,shape", [(AXES, (2, 3)), (AXES, (2, 2)),
                                        (("b", "c"), (2, 2, 2))],
                         ids=["2x3-ab", "2x2-ab", "2x2x2-bc"])
def test_gemm_rs_2d_is_its_stage_then_ring_composition(axis, shape):
    """B16 over a tuple is bitwise its inner-group stage on the strided
    rows followed by B13's ring over the outer axis, in every group's
    replica, and within f32 rounding of the flat form."""
    ctx = _tctx(shape)
    n = ctx.axis_size(axis)
    a, b = (_t(v) for v in _gemm_inputs(n, "rs", 7))
    M, K = a.shape
    m, kl = M // n, K // n
    parts = [matmul_plain(a[:, g * kl:(g + 1) * kl], b[g * kl:(g + 1) * kl],
                          torch.float32).view(n, m, -1) for g in range(n)]
    want = _stage_then_ring(ctx, parts, axis).view(M, -1)
    got = trs.gemm_rs(ctx, a, b, axis=axis, replicas=True)
    assert all(torch.equal(g, want) for g in got)
    flat = trs.gemm_rs(_tctx((n,)), a, b)
    assert _rel(_np(got[0]), _np(flat)) <= REDUCE_TOL


def test_moe_reduce_rs_2d_is_its_stage_then_ring_composition():
    """B20 over ("a", "b") of (2, 3): the aligned rows after both stages
    are bitwise the inner-group stage on the strided aligned chunks (every
    unused row zero) followed by B13's ring over a; the op is their
    unscramble and fold, within f32 rounding of the flat form; a token
    whose every row has id -1 comes back zero."""
    ctx = _tctx((2, 3))
    n = 6
    h, rids, tw, rw = (_t(v) for v in _moe_inputs(n, "rs", 8))
    bm = 8
    seg_rows = h.shape[0] // n
    gi, rv, be, nb, _ = tmoe._segment_alignment(rids.view(n, seg_rows), 4,
                                                bm)
    x = tmoe._aligned_rows(h, gi, rv, seg_rows)
    kl = h.shape[1] // n
    parts = [[tmoe.grouped_gemm_plain(
        x[s, :, g * kl:(g + 1) * kl], rw[:, g * kl:(g + 1) * kl], be[s], bm,
        nb[s], out_dtype=torch.float32) for s in range(n)] for g in range(n)]
    want = _stage_then_ring(ctx, parts, AXES).view(n, x.shape[1], -1)
    red, got = tmoe._moe_rs_2d_plain(ctx, AXES, x, rw, be, nb, bm, kl)
    assert torch.equal(got, want)
    out = tmoe.moe_reduce_rs(ctx, h, rids, tw, rw, axis=AXES, block_m=bm)
    assert not out[0].any()
    flat = tmoe.moe_reduce_rs(_tctx((n,)), h, rids, tw, rw, block_m=bm)
    assert _rel(_np(out), _np(flat)) <= REDUCE_TOL


def test_mlp_tp_overlap_grads_over_two_axes_match_the_flat_axis():
    """mlp_tp_overlap's f32 output and its four gradients over ("a", "b")
    of (2, 2) within 1e-4 of the one-axis 4-rank run (the autograd ops'
    backward composes gemm_rs, ag_gemm_ws and the gather over the same
    axes)."""
    rng = np.random.RandomState(9)
    T, D, Fd = 32, 64, 96
    args = [rng.randn(*s).astype(np.float32) * 0.3
            for s in ((T, D), (D, Fd), (D, Fd), (Fd, D))]
    g = _t(rng.randn(T, D).astype(np.float32))

    def run(ctx, axis):
        ts = [_t(v).requires_grad_() for v in args]
        out = tl.mlp_tp_overlap(ctx, *ts, axis=axis)
        (out * g).sum().backward()
        return [out] + [t.grad for t in ts]

    want = run(_tctx((4,)), "a")
    for got_t, want_t in zip(run(_tctx((2, 2)), AXES), want):
        assert _rel(_np(got_t), _np(want_t)) <= REDUCE_TOL


@functools.lru_cache(maxsize=None)
def _jax_forward():
    """JAX's forward_tp_overlap over ("a", "b") of (2, 2) on a one-layer
    f32 tiny model (its interpret-mode compile grows with the depth)."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(1), dtype=jnp.float32)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tokens = np.random.RandomState(1).randint(1, jcfg.vocab_size,
                                              (2, 16)).astype(np.int32)
    ctx = _jctx((2, 2))
    logits = jax.jit(lambda p, t: jl.forward_tp_overlap(ctx, p, t, jcfg,
                                                        axis=AXES))(
        jparams, jnp.asarray(tokens))
    return jax.tree.map(np.asarray, jparams), tokens, np.asarray(logits)


def test_forward_tp_overlap_over_two_axes_matches_jax():
    np_params, tokens, want = _jax_forward()
    params = params_from_jax(np_params, device="cpu", dtype=torch.float32)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(1), dtype=torch.float32)
    got = tl.forward_tp_overlap(_tctx((2, 2)), params, _t(tokens), cfg,
                                axis=AXES)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= REDUCE_TOL
