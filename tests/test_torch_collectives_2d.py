"""The port's collectives over several axes and over groups against the JAX
package on the same numpy inputs: the 2-D all-gathers (``push_2d``, B11, and
``ring_2d``) and ``auto`` across axes, the low-latency all-gather (B10) with
its workspace and context, the broadcast (B12), the reduce-scatter (B13) over
a group, as ``ring_2d`` and as ``xla``, the 2-D forms of ``AllGatherLayer``,
and the SP decode over a group and over two axes (B5 over a group).

On the CPU each wrapper runs its plain PyTorch version (copies; the rings'
sums in their order and rounding, stage by stage for ``ring_2d``); the JAX
side runs its Pallas kernels in interpret mode on meshes of the conftest's
virtual CPU devices. The CUDA kernels are held against the plain versions on
the card by ``chip_smoke.py`` (phase 19). Tolerances: the gathers and the
broadcast are copies, bitwise; the scatters bitwise in f32 on integer-valued
data (every sum exact), within 1e-5 of the value's scale on random data
(XLA's ``psum_scatter`` may add in another order); the SP decode within 1e-5
in f32 (the frameworks sum the softmax in other orders).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.models import llama as jl
from triton_dist_tpu.ops import allgather as jag
from triton_dist_tpu.ops import flash_decode as jfd
from triton_dist_tpu.shmem.context import \
    initialize_distributed as j_initialize_distributed
from triton_dist_tpu_torch.layers import AllGatherLayer
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.ops import allgather as tag
from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.shmem import initialize_distributed

jrs = importlib.import_module("triton_dist_tpu.ops.reduce_scatter")
trs = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")

pytestmark = pytest.mark.port

W = 128                       # row width
MESHES = {"2x3": (("a", "b"), (2, 3)), "2x2x2": (("a", "b", "c"), (2, 2, 2)),
          "2x2": (("a", "b"), (2, 2)), "4": (("x",), (4,))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch ops run 10-30x slower beside JAX's interpret-mode threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@functools.lru_cache(maxsize=None)
def _jctx(mesh: str):
    names, shape = MESHES[mesh]
    return j_initialize_distributed(axis_names=names, mesh_shape=shape)


def _tctx(mesh: str):
    names, shape = MESHES[mesh]
    return initialize_distributed(names, shape, device="cpu")


def _rows(n_rows: int, seed: int, integer: bool = False):
    x = np.random.RandomState(seed).randn(n_rows, W).astype(np.float32)
    return np.round(x * 4) if integer else x


@functools.lru_cache(maxsize=None)
def _jax_gather(mesh: str, method: str, rows: int):
    """JAX's gather over every axis of ``mesh`` of ``rows`` rows a rank:
    each device's replica."""
    ctx = _jctx(mesh)
    names = MESHES[mesh][0]
    x = _rows(ctx.num_ranks * rows, 1)
    y = jax.jit(lambda v: jag.all_gather(ctx, v, method=method))(
        ctx.shard(jnp.asarray(x), P(names)))
    return x, [np.asarray(s.data) for s in y.addressable_shards]


# a shard of 16 rows (8 KiB) and one just over the 256 KiB ceiling
SMALL, LARGE = 16, tag.PUSH_BYTES_CEILING // (4 * W) + 1


@pytest.mark.parametrize("mesh,method,rows", [
    ("2x3", "push_2d", SMALL), ("2x3", "ring_2d", SMALL),
    ("2x2x2", "push_2d", SMALL), ("2x2x2", "ring_2d", SMALL),
    ("2x3", "auto", SMALL), ("2x3", "auto", LARGE)])
def test_all_gather_2d_matches_jax_bitwise(mesh, method, rows):
    """Every rank's replica is JAX's bit for bit: the (2, 3) mesh would
    show a swap of the major and minor axes, (2, 2, 2) a relay over two
    inner axes; ``auto`` picks ``push_2d`` below the 256 KiB ceiling and
    ``ring_2d`` above it, on both sides."""
    x, replicas = _jax_gather(mesh, method, rows)
    ctx = _tctx(mesh)
    assert len(replicas) == ctx.num_ranks
    xt = _t(x)
    launches = (tag.all_gather.launches, tag.all_gather_push_2d.launches)
    got = tag.all_gather(ctx, xt, method=method)
    assert (tag.all_gather.launches, tag.all_gather_push_2d.launches) \
        == launches                              # CPU: the plain versions
    assert got.shape == (ctx.num_ranks,) + x.shape
    for r in range(ctx.num_ranks):
        assert np.array_equal(got[r].numpy(), replicas[r])
    if method == "auto":
        want = "push_2d" if rows == SMALL else "ring_2d"
        assert tag.auto_method(ctx, xt, None) == want
        assert tag.auto_method(ctx, xt, MESHES[mesh][0]) == want
    # the same gather through the tuple of every axis
    assert torch.equal(tag.all_gather(ctx, xt, axis=MESHES[mesh][0],
                                      method=method), got)


def test_all_gather_2d_forms_and_their_errors():
    """The 2-D gathers on a one-axis mesh, and unknown methods, raise
    ``ValueError`` as the reference's do; ``xla`` gives every replica;
    ``ring_2d``'s plain version is its composition of per-axis gathers, each
    stage on every rank's own result (a shard changed on one rank shows in
    its group's replicas only at the stage that reads it)."""
    ctx1, ctx = _tctx("4"), _tctx("2x3")
    x = _t(_rows(24, 2))
    for method in ("push_2d", "ring_2d"):
        with pytest.raises(ValueError, match="two or more axes"):
            tag.all_gather(ctx1, x, method=method)
    for method in ("ll", "broadcast"):
        with pytest.raises(ValueError, match="unknown allgather method"):
            tag.all_gather(ctx, x, method=method)
    for axis in (None, ("a", "b"), "b"):
        got = tag.all_gather(ctx, x if axis != "b" else x[:12], axis=axis,
                             method="xla")
        assert got.shape[0] == 6
        assert all(torch.equal(g, x if axis != "b" else x[:12]) for g in got)
    stage1 = tag._gather_groups_plain(ctx, tag._rank_rows(ctx, x, ("a", "b")),
                                      "b")
    assert stage1.shape == (6, 3 * 4 * W)
    assert torch.equal(stage1[4].view(12, W), x[12:])   # rank (1, 1): row 1


@functools.lru_cache(maxsize=None)
def _jax_ll(form: str):
    """JAX's low-latency gather at 4 ranks: the inputs and outputs of 5
    calls through ``AgLLContext`` or 3 through ``all_gather_ll``, threading
    the workspace."""
    ctx = _jctx("4")
    m = 16 if form == "context" else 8
    xs = [_rows(4 * m, 20 + it) for it in range(5 if form == "context"
                                                 else 3)]
    if form == "context":
        ag = jag.AgLLContext(ctx, m_local=m, trailing=(W,),
                             dtype=jnp.float32)
        ys = [np.asarray(ag(ctx.shard(jnp.asarray(x), P("x")))) for x in xs]
    else:
        ws = jag.create_ag_ll_workspace(ctx, m, (W,), jnp.float32)
        f = jax.jit(lambda ph, v, w: jag.all_gather_ll(ctx, v, w, ph,
                                                       axis="x"))
        ys = []
        for it, x in enumerate(xs):
            y, ws = f(jnp.asarray([it % 2], jnp.int32),
                      ctx.shard(jnp.asarray(x), P("x")), ws)
            ys.append(np.asarray(y))
    return m, xs, ys


@pytest.mark.parametrize("form", ["context", "functional"])
def test_all_gather_ll_matches_jax(form):
    """``AgLLContext`` (5 calls) and ``all_gather_ll`` threading ``ws`` (3
    calls) at 4 ranks: every replica JAX's bit for bit; the workspace holds
    each call's foreign shards in the slots of its parity."""
    m, xs, ys = _jax_ll(form)
    ctx = _tctx("4")
    if form == "context":
        ag = tag.AgLLContext(ctx, m, (W,), torch.float32)
        outs = [ag(_t(x)) for x in xs]
        assert ag.calls == 5
        ws = ag.ws
    else:
        ws = tag.create_ag_ll_workspace(ctx, m, (W,), torch.float32)
        outs = []
        for it, x in enumerate(xs):
            out, ws = tag.all_gather_ll(ctx, _t(x), ws, torch.tensor(
                [it % 2], dtype=torch.int32), axis="x")
            outs.append(out)
    assert ws.shape == (4, 2, 4, m, W)
    for x, y, out in zip(xs, ys, outs):
        assert out.shape == (4,) + x.shape
        assert all(np.array_equal(out[r].numpy(), y) for r in range(4))
    last, phase = _t(xs[-1]).view(4, m, W), (len(xs) - 1) % 2
    for r in range(4):
        for s in range(4):
            if s != r:
                assert torch.equal(ws[r, phase, s], last[s])
    with pytest.raises(ValueError, match="workspace"):
        tag.all_gather_ll(ctx, _t(xs[0]), ws[:, :1], 0)


@functools.lru_cache(maxsize=None)
def _jax_broadcast(mesh: str, root: int, axis: str):
    ctx = _jctx(mesh)
    n = ctx.axis_size(axis)
    x = np.stack([np.full((16, W), float(i), np.float32) + _rows(16, 30 + i)
                  for i in range(n)])
    y = jax.jit(lambda v: jag.broadcast(ctx, v, axis=axis, root=root))(
        ctx.shard(jnp.asarray(x), P(axis)))
    return x, np.asarray(y)


@pytest.mark.parametrize("mesh,root,axis", [("4", 0, "x"), ("4", 2, "x"),
                                            ("2x3", 2, "b")])
def test_broadcast_matches_jax(mesh, root, axis):
    """Roots 0 and 2 at 4 ranks, and root 2 in each group along ``b`` of
    the (2, 3) mesh: every rank's copy is JAX's bit for bit; a root out of
    range raises."""
    x, want = _jax_broadcast(mesh, root, axis)
    ctx = _tctx(mesh)
    got = tag.broadcast(ctx, _t(x), axis=axis, root=root)
    assert got.shape == (ctx.num_ranks,) + x.shape[1:]
    assert all(np.array_equal(g.numpy(), want) for g in got)
    with pytest.raises(ValueError, match="root"):
        tag.broadcast(ctx, _t(x), axis=axis, root=x.shape[0])


@functools.lru_cache(maxsize=None)
def _jax_rs(mesh: str, axis, method: str, integer: bool):
    ctx = _jctx(mesh)
    n = ctx.axis_size(axis)
    M = 2 * ctx.num_ranks                        # rows a contribution
    x = _rows(n * M, 40 + integer, integer)
    spec = P(axis) if axis is not None else P(MESHES[mesh][0])
    y = jax.jit(lambda v: jrs.reduce_scatter(ctx, v, axis=axis,
                                             method=method))(
        ctx.shard(jnp.asarray(x), spec))
    return x, np.asarray(y)


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "random"])
@pytest.mark.parametrize("axis,method", [("b", "ring"), (None, "ring_2d"),
                                         (None, "xla")])
def test_reduce_scatter_2x3_matches_jax(axis, method, integer):
    """Over ``b``'s groups of the (2, 3) mesh, as ``ring_2d`` over both
    axes, and as ``xla``: exact in f32 on integer-valued data, within 1e-5
    of the scale on random data. The port's plain ``ring_2d`` is bitwise its
    own composition of one ring per axis, innermost first."""
    x, want = _jax_rs("2x3", axis, method, integer)
    ctx = _tctx("2x3")
    got = trs.reduce_scatter(ctx, _t(x), axis=axis, method=method)
    assert got.shape == want.shape
    if integer:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    if method == "ring_2d":
        # auto and the tuple of every axis take the same path
        assert torch.equal(trs.reduce_scatter(ctx, _t(x)), got)
        assert torch.equal(trs.reduce_scatter(ctx, _t(x), axis=("a", "b")),
                           got)
        # the composition: pre-permute, ring over b's groups, then a's
        N, M = 6, x.shape[0] // 6
        contrib = _t(x).view(N, 2, 3, M // 6, W).permute(0, 2, 1, 3, 4)
        per_rank = contrib.reshape(N, -1)
        for ax in ("b", "a"):
            per_rank = trs._groups_plain(ctx, per_rank, ax)
        assert torch.equal(per_rank.reshape(M, W), got)


def test_reduce_scatter_2d_errors():
    ctx, ctx1 = _tctx("2x3"), _tctx("4")
    x = _t(_rows(72, 5))
    with pytest.raises(ValueError, match="every axis"):
        trs.reduce_scatter(ctx, x, axis=("b", "a"))
    with pytest.raises(ValueError, match="no axis"):
        trs.reduce_scatter(ctx, x, axis="a", method="ring_2d")
    with pytest.raises(ValueError, match="two or more axes"):
        trs.reduce_scatter(ctx1, x[:64], method="ring_2d")
    with pytest.raises(ValueError, match="unknown reduce_scatter method"):
        trs.reduce_scatter(ctx1, x[:64], method="tree")


@pytest.mark.parametrize("mesh", ["2x3", "2x2x2"])
def test_allgather_layer_2d_forms(mesh):
    """``forward_push_2d``/``forward_ring_2d`` and ``auto`` with no axis
    gather over every axis, JAX's bits."""
    x, replicas = _jax_gather(mesh, "push_2d", SMALL)
    layer = AllGatherLayer(_tctx(mesh))
    for fn in (layer.forward_push_2d, layer.forward_ring_2d, layer):
        got = fn(_t(x))
        assert all(np.array_equal(got[r].numpy(), replicas[r])
                   for r in range(len(replicas)))


# the SP decode: q [B, HQ, D] over a cache of S keys, sharded over 4 ranks
# on (2, 2) (both axes) or 2 along b; kv_len (S, 0, 77)
B, HQ, HKV, D, S = 3, 4, 2, 32, 192
KV_LEN = np.array([S, 0, 77], np.int32)


@functools.lru_cache(maxsize=None)
def _decode_inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((B, HQ, D), (B, HKV, S, D), (B, HKV, S, D))]


def _shard_s(a, n):
    """[B, Hkv, S, D] -> the port's rank-major [n, B, Hkv, S / n, D]."""
    b, h, s, d = a.shape
    return a.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous()


@functools.lru_cache(maxsize=None)
def _jax_sp_decode(axis, ag_method: str):
    q, k, v = _decode_inputs()
    ctx = _jctx("2x2")
    return np.asarray(jax.jit(lambda *a: jfd.sp_gqa_flash_decode(
        ctx, *a, axis=axis, ag_method=ag_method))(
        jnp.asarray(q), ctx.shard(jnp.asarray(k), P(None, None, axis)),
        ctx.shard(jnp.asarray(v), P(None, None, axis)),
        jnp.asarray(KV_LEN)))


@pytest.mark.parametrize("axis,ag_method", [
    (("a", "b"), "push_2d"), (("a", "b"), "ring_2d"), ("b", "fused"),
    ("b", "push")])
def test_sp_gqa_flash_decode_2x2_matches_jax(axis, ag_method):
    """Over both axes of (2, 2) (4 shards) and over ``b``'s two groups (2
    shards each): within 1e-5 of JAX's in f32; every replica of the mesh
    bitwise equal; every 2-D gather, and ``auto``, gives the same bits; the
    fused merge over a tuple raises ``ValueError``."""
    want = _jax_sp_decode(axis, ag_method)
    q, k, v = (_t(a) for a in _decode_inputs())
    ctx = _tctx("2x2")
    n = ctx.axis_size(axis)
    kt, vt = _shard_s(k, n), _shard_s(v, n)
    reps = tfd.sp_gqa_flash_decode(ctx, q, kt, vt, _t(KV_LEN), axis=axis,
                                   ag_method=ag_method, replicas=True)
    assert reps.shape == (4, B, HQ, D)
    assert all(torch.equal(reps[r], reps[0]) for r in range(4))
    np.testing.assert_allclose(reps[0].numpy(), want, atol=1e-5, rtol=1e-5)
    others = ("push_2d", "ring_2d", "auto", "push") \
        if isinstance(axis, tuple) else ("ring", "auto")
    for m in others:
        assert torch.equal(tfd.sp_gqa_flash_decode(
            ctx, q, kt, vt, _t(KV_LEN), axis=axis, ag_method=m),
            reps[0] if ag_method != "fused" else tfd.sp_gqa_flash_decode(
                ctx, q, kt, vt, _t(KV_LEN), axis=axis, ag_method="push"))
    if isinstance(axis, tuple):
        with pytest.raises(ValueError, match="one axis"):
            tfd.sp_gqa_flash_decode(ctx, q, kt, vt, _t(KV_LEN), axis=axis,
                                    ag_method="fused")
        with pytest.raises(ValueError, match="one mesh axis"):
            tfd.ll_ag_merge(ctx, torch.zeros(4, B, HQ, D),
                            torch.zeros(4, B, HQ), torch.float32, axis)


def test_ll_ag_merge_over_a_group():
    """B5 over ``b``'s groups of (2, 2): every rank's replica is
    ``ll_merge`` of its group's two partials."""
    rng = np.random.RandomState(7)
    outs = _t(rng.randn(2, B, HQ, D).astype(np.float32))
    lses = _t((rng.randn(2, B, HQ) * 3).astype(np.float32))
    got = tfd.ll_ag_merge(_tctx("2x2"), outs, lses, torch.float32, "b")
    merged = tfd.ll_merge(outs, lses)
    assert got.shape == (4, B, HQ, D)
    assert all(torch.equal(g, merged) for g in got)


# the reference's SP decode test's model (tests/test_decode.py:111-112), in
# f32 here
SP_CFG = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
              n_kv_heads=2, d_ff=256, max_seq_len=4 * 32)
SP_B, SP_STEPS = 4, 3


@functools.lru_cache(maxsize=None)
def _jax_decode_step_sp_2d():
    """JAX ``decode_step_sp`` on (2, 2) over ("a", "b") with ``push_2d``,
    the cache sharded 4 ways on S, 3 steps each fed the argmax of the
    last: (params, tokens fed, logits)."""
    from jax.sharding import NamedSharding

    ctx = _jctx("2x2")
    cfg = dataclasses.replace(jl.LlamaConfig(**SP_CFG), dtype=jnp.float32)
    params = jl.init_params(jax.random.key(0), cfg)
    cache = jl.init_kv_cache(cfg, SP_B, cfg.max_seq_len)
    spec = P(None, None, None, ("a", "b"), None)
    cache = {n: jax.device_put(a, NamedSharding(ctx.mesh, spec))
             for n, a in cache.items()}
    step = jax.jit(lambda p, t, pos, c: jl.decode_step_sp(
        ctx, p, t, pos, cfg, c, axis=("a", "b"), ag_method="push_2d"))
    token = np.random.RandomState(8).randint(
        0, cfg.vocab_size, SP_B).astype(np.int32)
    fed, logits = [], []
    for pos in range(SP_STEPS):
        fed.append(token)
        lg, cache = step(params, jnp.asarray(token), pos, cache)
        logits.append(np.asarray(lg))
        token = logits[-1].argmax(-1).astype(np.int32)
    return jax.tree.map(np.asarray, params), fed, logits


def test_decode_step_sp_2x2_matches_jax_and_the_flat_run():
    """The port's SP step on (2, 2) over ("a", "b") with ``push_2d``: within
    1e-5 of JAX's on the same tokens (f32), every layer's replicas bitwise
    equal, and bitwise the 1-D push over 4 ranks of a one-axis mesh (the
    wire's bits and the merge are the same); over ``b``'s groups (fused,
    push) bitwise the 2-rank run."""
    jparams, fed, want = _jax_decode_step_sp_2d()
    cfg = dataclasses.replace(tl.LlamaConfig(**SP_CFG), dtype=torch.float32)
    params = params_from_jax(jparams, device="cpu", dtype=cfg.dtype)
    ctx2, ctx1 = _tctx("2x2"), _tctx("4")
    ctx_b = initialize_distributed(("x",), (2,), device="cpu")
    runs = {("2x2", ("a", "b"), "push_2d"): ctx2, ("4", "x", "push"): ctx1,
            ("2x2", "b", "fused"): ctx2, ("2x2", "b", "push"): ctx2,
            ("2", "x", "fused"): ctx_b, ("2", "x", "push"): ctx_b}
    caches = {key: tl.shard_kv_cache(tl.init_kv_cache(
        cfg, SP_B, cfg.max_seq_len, device="cpu"), c.axis_size(key[1]))
        for key, c in runs.items()}
    for pos in range(SP_STEPS):
        got = {}
        for key, c in runs.items():
            checks = []
            got[key], caches[key] = tl.decode_step_sp(
                c, params, _t(fed[pos]), pos, cfg, caches[key], axis=key[1],
                ag_method=key[2], replica_checks=checks)
            assert len(checks) == cfg.n_layers and all(bool(x) for x in checks)
        np.testing.assert_allclose(got[("2x2", ("a", "b"), "push_2d")].numpy(),
                                   want[pos], rtol=1e-5, atol=1e-5)
        assert torch.equal(got[("2x2", ("a", "b"), "push_2d")],
                           got[("4", "x", "push")])
        for m in ("fused", "push"):
            assert torch.equal(got[("2x2", "b", m)], got[("2", "x", m)])
