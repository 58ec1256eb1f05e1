"""The port's collectives across ranks against the JAX package on the same
numpy inputs: the push and ring ``all_gather`` (B9) and the ring
``reduce_scatter`` (B13) at 4 ranks; the ops that once refused more than
one rank, which now run; and the group and 2-D forms of the
collectives, which run (against JAX: ``test_torch_collectives_2d.py``; the
gather and the barrier over a group: ``test_torch_ep_ranks.py``).

On the CPU each wrapper runs its plain PyTorch version (copies; the ring's
sums in its order and rounding); the JAX side runs its Pallas kernels in
interpret mode on a 4-device mesh of the conftest's virtual CPU devices.
The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py``. Tolerances: the gathers are copies, bitwise; the f32
scatter adds the same values in the same order, bitwise; the bf16 scatter
rounds to bf16 at every hop in both, and is bitwise on these inputs (one
bf16 ulp is allowed: XLA and PyTorch may round a bf16 sum through f32 at
other points).
"""

import dataclasses
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.ops import allgather as jag
from triton_dist_tpu.shmem.context import \
    initialize_distributed as j_initialize_distributed
from triton_dist_tpu_torch.layers import AllGatherLayer
from triton_dist_tpu_torch.models.convert import tensor_from_numpy
from triton_dist_tpu_torch.ops import allgather as tag
from triton_dist_tpu_torch.shmem import initialize_distributed

# both ops packages export a function named reduce_scatter, which shadows
# the module of the same name on attribute access
jrs = importlib.import_module("triton_dist_tpu.ops.reduce_scatter")
trs = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")

pytestmark = pytest.mark.port

N, M, W = 4, 16, 128          # ranks, rows a shard, row width


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@functools.lru_cache(maxsize=None)
def _jctx():
    return j_initialize_distributed(axis_names=("x",), mesh_shape=(N,))


def _shards(dtype: str, seed: int, rows: int = N * M):
    x = np.random.RandomState(seed).randn(rows, W).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return x


@functools.lru_cache(maxsize=None)
def _jax_all_gather(method: str, dtype: str):
    """JAX's gather of ``_shards`` at 4 ranks: each device's replica."""
    ctx = _jctx()
    y = jax.jit(lambda v: jag.all_gather(ctx, v, axis="x", method=method))(
        ctx.shard(jnp.asarray(_shards(dtype, 0)), P("x")))
    return [np.asarray(s.data) for s in y.addressable_shards]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["push", "ring"])
def test_all_gather_replicas_match_jax_bitwise(method, dtype):
    replicas = _jax_all_gather(method, dtype)
    assert len(replicas) == N
    ctx = initialize_distributed(("x",), (N,), device="cpu")
    x = _t(_shards(dtype, 0))
    launches = tag.all_gather.launches
    got = tag.all_gather(ctx, x, method=method)
    assert tag.all_gather.launches == launches       # CPU: the plain version
    assert got.shape == (N, N * M, W) and got.dtype == x.dtype
    for r in range(N):
        assert np.array_equal(got[r].float().numpy(),
                              replicas[r].astype(np.float32))


def test_all_gather_repeated_calls_with_fresh_data():
    """Five calls through one context, fresh shards each (the JAX package's
    repeated-call check), and ``auto`` picks push at four ranks."""
    ctx = initialize_distributed(("x",), (N,), device="cpu")
    for it in range(5):
        x = _t(_shards("float32", 10 + it))
        for method in ("push", "ring", "auto"):
            got = tag.all_gather(ctx, x, method=method)
            assert all(torch.equal(got[r], x) for r in range(N))
    assert tag.auto_method(ctx, x, "x") == "push"
    ctx8 = initialize_distributed(("x",), (8,), device="cpu")
    big = torch.zeros(8 * 64 * 1024, dtype=torch.float32)   # 256 KiB a rank
    assert tag.auto_method(ctx8, big, "x") == "push"
    assert tag.auto_method(ctx8, torch.zeros(2 * big.numel()), "x") == "ring"


@pytest.mark.parametrize("method", ["push", "ring", "auto"])
def test_all_gather_layer_across_ranks(method):
    ctx = initialize_distributed(("x",), (N,), device="cpu")
    layer = AllGatherLayer(ctx, "x")
    fn = layer if method == "auto" else getattr(layer, f"forward_{method}")
    x = _t(_shards("float32", 3))
    assert torch.equal(fn(x), tag.all_gather(ctx, x, method=method))


@functools.lru_cache(maxsize=None)
def _jax_reduce_scatter(dtype: str):
    ctx = _jctx()
    y = jax.jit(lambda v: jrs.reduce_scatter(ctx, v, axis="x",
                                             method="ring"))(
        ctx.shard(jnp.asarray(_shards(dtype, 1, rows=N * N * M)), P("x")))
    return np.asarray(y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduce_scatter_ring_matches_jax(dtype):
    """f32: bitwise. bf16: bitwise on these inputs (asserted), and within
    one bf16 ulp of the value in any case."""
    want = _jax_reduce_scatter(dtype).astype(np.float32)
    ctx = initialize_distributed(("x",), (N,), device="cpu")
    x = _t(_shards(dtype, 1, rows=N * N * M))
    got = trs.reduce_scatter(ctx, x, method="ring")
    assert got.shape == (N * M, W) and got.dtype == x.dtype
    got = got.float().numpy()
    if dtype == "bfloat16":
        ulp = np.abs(want) * 2.0 ** -7 + 1e-30
        assert (np.abs(got - want) <= ulp).all()
    np.testing.assert_array_equal(got, want)
    # the order matters in bf16: the plain ring rounds at every hop, unlike
    # a sum in f32 rounded once
    plain = trs.reduce_scatter_plain(x, N)
    assert torch.equal(trs.reduce_scatter(ctx, x), plain)


def test_reduce_scatter_at_one_rank_is_the_contribution():
    ctx = initialize_distributed(("x",), device="cpu")
    x = _t(_shards("float32", 2))
    assert torch.equal(trs.reduce_scatter(ctx, x), x)


def test_all_gather_without_axis_on_a_2d_mesh_raises():
    """With ``axis=None`` on a mesh of two axes the reference's ``auto``
    gathers over every axis (its 2-D gathers: ``push_2d`` for a small
    shard) and an explicit ``push`` or ``ring`` asks for ``axis=``; neither
    gathers over the first axis alone. A one-axis mesh still gathers with no
    axis."""
    ctx2d = initialize_distributed(("a", "b"), (2, 2), device="cpu")
    x = torch.arange(8.).reshape(8, 1)
    assert tag.auto_method(ctx2d, x, None) == "push_2d"
    for got in (tag.all_gather(ctx2d, x), AllGatherLayer(ctx2d)(x)):
        assert got.shape == (4, 8, 1)
        assert all(torch.equal(g, x) for g in got)
    for method in ("push", "ring"):
        with pytest.raises(ValueError, match="axis="):
            tag.all_gather(ctx2d, x, method=method)
    for fn in (AllGatherLayer(ctx2d).forward_push,
               AllGatherLayer(ctx2d).forward_ring):
        with pytest.raises(ValueError, match="axis="):
            fn(x)
    # an explicit axis still gathers in groups
    got = tag.all_gather(ctx2d, x[:4], axis="a")
    assert got.shape == (4, 4, 1) and torch.equal(got[0], x[:4])
    ctx1 = initialize_distributed(("x",), (4,), device="cpu")
    assert torch.equal(tag.all_gather(ctx1, x)[2], x)


def _raising_calls():
    """(name, call, check) of the ops and forms this walk names, on a (2, 2)
    context: the TP and MoE overlap ops over tuple axes and over a group
    inside the multi-axis mesh, which run since the TP-overlap 2-tier slice
    (``check(result)`` holds each against its plain composition over
    flattened or one-axis ranks), and the CP train plan across ranks, which
    runs since the CP slice (one step's loss against the no-cp step's)."""
    from triton_dist_tpu_torch.models import llama as tl
    from triton_dist_tpu_torch.ops import allgather_gemm as tagg
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as tgrs
    from triton_dist_tpu_torch.ops import moe as tmoe
    from triton_dist_tpu_torch.parallel.train import (ParallelPlan,
                                                      make_train_step)

    ctx2d = initialize_distributed(("a", "b"), (2, 2), device="cpu")
    flat = {n: initialize_distributed(("x",), (n,), device="cpu")
            for n in (2, 4)}
    g = torch.Generator().manual_seed(11)
    a = torch.randn(8, 128, generator=g)
    b = torch.randn(128, 8, generator=g)
    w = torch.randn(8, 128, generator=g) * 0.1
    ids = torch.randint(-1, 4, (8,), generator=g, dtype=torch.int32)
    we = torch.randn(4, 128, 8, generator=g) * 0.1
    tw = torch.softmax(torch.randn(4, 2, generator=g), -1)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(n_layers=1),
                              dtype=torch.float32)
    # ring attention takes head_dim 128
    cp_cfg = dataclasses.replace(cfg, d_model=512, n_kv_heads=2)
    cp_plan = ParallelPlan(dp=None, tp=None, cp="cp", sp=False)

    def train_step(cfg, mesh, plan):
        """The loss of one step of ``plan`` over ``mesh`` from seed 0."""
        init_fn, step_fn = make_train_step(cfg, mesh, plan, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(0))
        return step_fn(init_fn(0), tokens)[1].item()


    def same(want):
        return lambda got: torch.equal(got, want)

    def close(want):
        return lambda got: bool(torch.allclose(got, want, rtol=1e-5,
                                               atol=1e-5))

    def mlp(ctx, axis):
        return tl.mlp_tp_overlap(ctx, a[:, :8], w, w, w.t().contiguous(),
                                 axis=axis)

    return [
        ("ag_gemm over two axes", lambda: tagg.ag_gemm(
            ctx2d, a, b, axis=("a", "b")),
         same(tagg.ag_gemm_plain(a, b, 4))),
        ("ag_gemm_ws inside a 2-D mesh", lambda: tagg.create_ag_gemm_workspace(
            ctx2d, 2, 8, axis="b"),
         lambda ws: ws.shape == (4, 2, 2, 8) and not ws.any()),
        ("gemm_rs over two axes", lambda: tgrs.gemm_rs(
            ctx2d, a, b, axis=("a", "b")),
         close(tgrs.gemm_rs_plain(a, b, 4))),
        ("gemm_rs_ws inside a 2-D mesh", lambda: tgrs.create_gemm_rs_workspace(
            ctx2d, 2, 8, axis="a"),
         lambda wss: [tuple(t.shape) for t in wss] == [(4, 2, 2, 8)] * 2),
        ("mlp_tp_overlap inside a 2-D mesh", lambda: mlp(ctx2d, "b"),
         same(mlp(flat[2], "x"))),
        ("ag_moe_group_gemm inside a 2-D mesh", lambda: tmoe.
         ag_moe_group_gemm(ctx2d, a, ids, we, axis="a"),
         same(tmoe.ag_moe_group_gemm(flat[2], a, ids, we))),
        ("moe_reduce_rs inside a 2-D mesh", lambda: tmoe.moe_reduce_rs(
            ctx2d, a, ids, tw, we, axis="b"),
         same(tmoe.moe_reduce_rs(flat[2], a, ids, tw, we))),
        ("ag_moe_group_gemm over two axes", lambda: tmoe.ag_moe_group_gemm(
            ctx2d, a, ids, we, axis=("a", "b")),
         same(tmoe.ag_moe_group_gemm(flat[4], a, ids, we))),
        ("train plan", lambda: train_step(cp_cfg, {"cp": 2}, cp_plan),
         lambda loss: math.isclose(loss, train_step(
             cp_cfg, None, dataclasses.replace(cp_plan, cp=None)),
             rel_tol=1e-5)),
        ("moe_reduce_rs over two axes", lambda: tmoe.moe_reduce_rs(
            ctx2d, a, ids, tw, we, axis=("a", "b")),
         close(tmoe.moe_reduce_rs(flat[4], a, ids, tw, we))),
    ]


@pytest.mark.parametrize("case", range(10))
def test_ops_outside_the_slice_refuse_more_ranks(case):
    """The walk of the ops that once refused more than one rank: the TP and
    MoE overlap ops over tuple axes and over groups inside a multi-axis
    mesh now run and agree with their plain compositions (bitwise where
    the 2-tier or group form keeps the 1-tier sums, within f32 rounding
    where GEMM-RS and B20 sum the inner tier first); the CP train plan
    across ranks runs and one step equals the no-cp step."""
    calls = _raising_calls()
    assert len(calls) == 10
    name, call, check = calls[case]
    assert check(call()), name


def _collective_forms():
    """(name, check) of the forms the walk above named as waiting for the
    collectives: each now runs, or raises the reference's ``ValueError``."""
    from triton_dist_tpu_torch.ops import flash_decode as tfd

    ctx = initialize_distributed(("x",), (N,), device="cpu")
    ctx2d = initialize_distributed(("a", "b"), (2, 2), device="cpu")
    a = _t(_shards("float32", 4, rows=32))
    contrib = torch.round(a * 4)            # integer-valued: exact sums

    def merge_in_groups():
        outs, lses = torch.randn(2, 2, 4, 32), torch.randn(2, 2, 4)
        got = tfd.ll_ag_merge(ctx2d, outs, lses, torch.float32, axis="a")
        assert got.shape == (4, 2, 4, 32)
        assert all(torch.equal(g, tfd.ll_merge(outs, lses)) for g in got)

    def raises(call, match):
        with pytest.raises(ValueError, match=match):
            call()

    def rs_in_groups():
        got = trs.reduce_scatter(ctx2d, contrib[:8], axis="b")
        assert torch.equal(got, contrib[:4] + contrib[4:8])

    def rs_two_axes(**kw):
        got = trs.reduce_scatter(ctx2d, contrib, **kw)
        assert torch.equal(got, contrib.view(4, 8, W).sum(0))

    def sp_in_groups():
        gen = torch.Generator().manual_seed(0)
        q = torch.randn(2, 4, 32, generator=gen)
        k, v = (torch.randn(2, 2, 2, 16, 32, generator=gen)
                for _ in range(2))
        lens = torch.tensor([32, 5], dtype=torch.int32)
        got = tfd.sp_gqa_flash_decode(ctx2d, q, k, v, lens, axis="a")
        one = tfd.sp_gqa_flash_decode(
            initialize_distributed(("x",), (2,), device="cpu"), q, k, v,
            lens)
        assert torch.equal(got, one)

    return [
        ("ll_ag_merge inside a 2-D mesh", merge_in_groups),
        ("all_gather ring_2d on one axis", lambda: raises(
            lambda: tag.all_gather(ctx, a, method="ring_2d"),
            "two or more axes")),
        ("all_gather push_2d on one axis", lambda: raises(
            lambda: AllGatherLayer(ctx).forward_push_2d(a),
            "two or more axes")),
        ("all_gather ll", lambda: raises(
            lambda: tag.all_gather(ctx, a, method="ll"),
            "unknown allgather method")),
        ("all_gather broadcast", lambda: raises(
            lambda: tag.all_gather(ctx, a, method="broadcast"),
            "unknown allgather method")),
        ("reduce_scatter inside a 2-D mesh", rs_in_groups),
        ("reduce_scatter ring_2d", lambda: rs_two_axes(method="ring_2d")),
        ("reduce_scatter xla", lambda: rs_two_axes(method="xla")),
        ("reduce_scatter over two axes", lambda: rs_two_axes(
            axis=("a", "b"))),
        ("sp_gqa_flash_decode inside a 2-D mesh", sp_in_groups),
    ]


@pytest.mark.parametrize("case", range(10))
def test_collective_forms_across_the_mesh_run(case):
    """The ten forms the walk of ``test_ops_outside_the_slice_refuse_more_
    ranks`` dropped: the group and 2-D collectives give their plain
    results, and the forms the reference refuses raise its
    ``ValueError``."""
    forms = _collective_forms()
    assert len(forms) == 10
    forms[case][1]()
