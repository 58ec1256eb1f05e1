"""The sharded engine's SP modes across ranks in the port: the
distributed flash-decode's fold across ranks (``flash_decode_dist`` at
n > 1, TPU kernel B8's plain version) and the start-local pool gather
(``pool_ag_start_local``, B6) against the JAX package on CPU meshes, the
long-context attention split model against JAX's, and the port's
``ShardedServingEngine`` with ``long_context=True`` at sp > 1 and with
``overlap="ep+sp"``, bitwise its own goldens.

Every rank runs in this one process on the CPU, through the wrappers'
plain versions. Tolerances: against JAX, f32 ``atol 1e-5`` and bf16
``2e-2`` (the frameworks sum each page's products in other orders); the
pools and the gathered pools exactly; within the port, bitwise (the fold
visits pages in one order at every rank count)."""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.ops import flash_decode as jfd
from triton_dist_tpu.ops.all_to_all import _DEFAULT_WIRE_FIT
from triton_dist_tpu.serving import serving_mesh as j_serving_mesh
from triton_dist_tpu.serving.sharded import fd_attn_split_us as j_split
from triton_dist_tpu.shmem.context import initialize_distributed as jinit
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models import moe as tm
from triton_dist_tpu_torch.models.convert import tensor_from_numpy
from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.serving import (ShardedServingEngine,
                                           fd_attn_split_us, serving_mesh)
from triton_dist_tpu_torch.shmem import initialize_distributed
from triton_dist_tpu_torch.shmem.context import ShmemContext

pytestmark = pytest.mark.port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, HQ, HKV, D, PS, POOL, S = 4, 4, 2, 16, 8, 12, 6
ENGINE = dict(num_slots=4, page_size=8, num_pages=7, pages_per_seq=4,
              prefill_chunk=8)


@pytest.fixture(autouse=True)
def watchdog():
    """Each test gets 60 s; a hung engine fails instead of stalling."""
    def boom(signum, frame):
        raise TimeoutError("test exceeded its 60 s watchdog")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(60)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _case(dtype: str, seed: int):
    """q, new rows and pools in ``dtype`` (numpy f32 values rounded to it
    by both frameworks), a block table with live pages on every rank's
    slice, positions, lengths and a parked row."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, HQ, D).astype(np.float32)
    kn, vn = (rng.randn(B, HKV, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(POOL, HKV, PS, D).astype(np.float32)
            for _ in range(2))
    bt = np.array([[1, 4, 7, 10, 0, 0], [2, 11, 0, 0, 0, 0],
                   [9, 6, 3, 5, 8, 11], [0] * S], np.int32)
    pos = np.array([30, 9, 44, 0], np.int32)
    active = np.array([True, True, True, False])
    return q, kn, vn, k, v, bt, pos, pos + 1, active


@pytest.mark.parametrize("n,dtype", [(2, "float32"), (4, "bfloat16")],
                         ids=["2-float32", "4-bfloat16"])
def test_flash_decode_dist_across_ranks_matches_jax(n, dtype):
    """At n ranks: the pools exactly JAX's and the attention within TOL of
    JAX's n-rank fold (a parked row writes the scratch page), and the
    attention bitwise the port's one-rank fused route. Each rank count and
    each type runs once: JAX's interpret-mode fold takes 6-11 s a call on
    this CPU."""
    q, kn, vn, k, v, bt, pos, kv, active = _case(dtype, seed=n)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    jctx = jinit(axis_names=("sp",), mesh_shape=(n,))
    jo, jk, jv = jax.jit(lambda *a: jfd.flash_decode_dist(
        jctx, *a, axis="sp", active=jnp.asarray(active)))(
        *(jnp.asarray(a, jdt) for a in (q, kn, vn)),
        jctx.shard(jnp.asarray(k, jdt), P("sp")),
        jctx.shard(jnp.asarray(v, jdt), P("sp")),
        *(jnp.asarray(a) for a in (bt, pos, kv)))
    outs = {}
    for ranks in (1, n):
        ctx = initialize_distributed(("sp",), (ranks,), device="cpu")
        tk, tv = (_t(a).to(tdt) for a in (k, v))
        outs[ranks] = tfd.flash_decode_dist(
            ctx, *(_t(a).to(tdt) for a in (q, kn, vn)), tk, tv,
            *(_t(a) for a in (bt, pos, kv)), axis="sp", active=_t(active))
        assert outs[ranks][1] is tk and outs[ranks][2] is tv
    assert torch.equal(outs[n][0], outs[1][0])
    np.testing.assert_allclose(outs[n][0].float().numpy(),
                               np.asarray(jo, np.float32), atol=TOL[dtype],
                               rtol=0)
    for t, j in ((outs[n][1], jk), (outs[n][2], jv)):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


def test_flash_decode_dist_replicas_and_refusal():
    """Every rank's replica is the one result; a pool whose pages do not
    split over the SP axis is refused, as is a fold of the wrong rank
    count."""
    q, kn, vn, k, v, bt, pos, kv, active = _case("float32", seed=9)
    ctx = serving_mesh(1, 2, 2)
    ctx = ShmemContext(ctx.axis_names, ctx.mesh_shape, torch.device("cpu"))
    rep, _, _ = tfd.flash_decode_dist(
        ctx, _t(q), _t(kn), _t(vn), _t(k), _t(v), _t(bt), _t(pos), _t(kv),
        axis="sp", active=_t(active), replicas=True)
    one, _, _ = tfd.flash_decode_dist(
        initialize_distributed(("sp",), (1,), device="cpu"), _t(q), _t(kn),
        _t(vn), _t(k), _t(v), _t(bt), _t(pos), _t(kv), axis="sp",
        active=_t(active))
    assert rep.shape == (4,) + tuple(one.shape)
    assert all(torch.equal(r, one) for r in rep)
    ctx8 = initialize_distributed(("sp",), (8,), device="cpu")
    with pytest.raises(ValueError, match="split"):
        tfd.flash_decode_dist(ctx8, _t(q), _t(kn), _t(vn), _t(k), _t(v),
                              _t(bt), _t(pos), _t(kv))
    with pytest.raises(ValueError, match="split"):
        tfd.pool_ag_start_local(ctx8, _t(k), _t(v))
    with pytest.raises(ValueError, match="slabs"):
        tfd.fd_fold_dist(initialize_distributed(("sp",), (2,),
                                                device="cpu"),
                         torch.zeros(3, 1, 2, HQ, D), torch.zeros(3, 1, 2, HQ),
                         _t(kv[:1]), torch.float32)


@pytest.mark.parametrize("mesh", [(2,), (4,), (2, 2, 2)],
                         ids=["2", "4", "2x2x2"])
def test_pool_ag_start_local_is_bitwise_jax(mesh):
    """The start-local gather over sp at 2 and 4 ranks and inside a 2x2x2
    mesh's sp groups: every rank's replica bitwise JAX's full pools (and
    the page-order concatenation); one rank returns the pools."""
    rng = np.random.RandomState(len(mesh) + mesh[0])
    k, v = (rng.randn(POOL, HKV, PS, D).astype(np.float32)
            for _ in range(2))
    if len(mesh) == 1:
        jctx = jinit(axis_names=("sp",), mesh_shape=mesh)
        ctx = initialize_distributed(("sp",), mesh, device="cpu")
    else:
        jctx = j_serving_mesh(*mesh)
        grid = serving_mesh(*mesh)
        ctx = ShmemContext(grid.axis_names, grid.mesh_shape,
                           torch.device("cpu"))
    jk, jv = jfd.pool_ag_start_local(jctx, jctx.shard(jnp.asarray(k),
                                                      P("sp")),
                                     jctx.shard(jnp.asarray(v), P("sp")),
                                     axis="sp")
    tk, tv = tfd.pool_ag_start_local(ctx, _t(k), _t(v), axis="sp")
    assert tk.shape == (ctx.num_ranks, POOL, HKV, PS, D)
    for t, j in ((tk, jk), (tv, jv)):
        for r in range(ctx.num_ranks):
            np.testing.assert_array_equal(t[r].numpy(), np.asarray(j))
    one = initialize_distributed(("sp",), (1,), device="cpu")
    pk = _t(k)
    assert tfd.pool_ag_start_local(one, pk, _t(v))[0] is pk


@pytest.mark.parametrize("n_sp", [1, 2, 4])
def test_fd_attn_split_us_matches_jax(n_sp):
    """With JAX's fit passed in, the modelled split is JAX's; the card's
    fit prices a fold wait only across ranks."""
    fit = _DEFAULT_WIRE_FIT["bf16"]
    for args in ((32, 8, 2056, 2 * 8 * 16 * 128 * 2, 32 * 256 * 4),
                 (16, 4, 64, 4096, 1024), (1, 1, 3, 100, 7)):
        assert fd_attn_split_us(n_sp, *args, fit=fit) == j_split(n_sp, *args)
        local, fold = fd_attn_split_us(n_sp, *args)
        assert local > 0 and (fold > 0) == (n_sp > 1)


@pytest.fixture(scope="module")
def micro():
    """``test_sharded_serving.py``'s micro MoE model's shapes (f32, one
    layer, four experts, top-2), the port's weights from a seed."""
    cfg = tm.MoEConfig(base=tl.LlamaConfig(
        vocab_size=128, d_model=128, n_layers=1, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, dtype=torch.float32),
        num_experts=4, topk=2, moe_d_ff=64)
    return cfg, tm.init_moe_params(cfg, seed=0, device="cpu")


def _trace(n: int, seed: int = 77):
    """Bursty arrivals (two per step) against the 7-page pool: it
    preempts."""
    rng = np.random.RandomState(seed)
    return [(i // 2, rng.randint(1, 128, size=int(rng.randint(3, 17)))
             .tolist(), int(rng.randint(4, 12))) for i in range(n)]


def _serve(micro, mesh, **kw):
    cfg, params = micro
    eng = ShardedServingEngine(params, cfg, serving_mesh(*mesh),
                               device="cpu", **dict(ENGINE, **kw))
    return eng.run(max_steps=10_000, arrivals=_trace(6)), eng


@pytest.fixture(scope="module")
def goldens(micro):
    """The 1x1x1 engine's streams, long-context and plain."""
    long, eng = _serve(micro, (1, 1, 1), long_context=True)
    assert eng.metrics.counters["preemptions"] >= 1 and len(long) == 6
    plain, _ = _serve(micro, (1, 1, 1))
    return {"long": long, "plain": plain}


@pytest.mark.parametrize("mesh", [(1, 2, 1), (1, 4, 1), (1, 2, 2)],
                         ids=["1x2x1", "1x4x1", "1x2x2"])
def test_long_context_across_sp_is_bitwise_one_rank(micro, goldens, mesh):
    """``long_context`` at sp > 1 serves the preempting trace bitwise as
    the 1x1x1 long-context engine, over the interleaved pool, with the
    modelled attention split observed every step."""
    res, eng = _serve(micro, mesh, long_context=True)
    assert res == goldens["long"]
    assert eng.alloc.layout == "interleaved"
    assert eng.metrics.counters["preemptions"] >= 1
    h = eng.metrics.hist
    assert h["attn_local_us"].mean > 0 and h["attn_fold_wait_us"].mean > 0
    eng.alloc.check()
    assert eng.alloc.used_pages == 0


@pytest.mark.parametrize("mesh", [(1, 2, 2), (2, 2, 2)],
                         ids=["1x2x2", "2x2x2"])
def test_overlap_ep_sp_is_bitwise_off(micro, goldens, mesh):
    """``overlap="ep+sp"`` (B22's microbatches and B6's start-local pool
    gather) serves the trace bitwise as ``overlap="off"`` on the same
    mesh, which is the 1x1x1 golden."""
    off, _ = _serve(micro, mesh)
    res, eng = _serve(micro, mesh, overlap="ep+sp")
    assert res == off == goldens["plain"]
    assert eng.overlap == "ep+sp" and eng.overlap_microbatches == 2
    assert eng.metrics.counters["preemptions"] >= 1
    assert eng.metrics.hist["attn_fold_wait_us"].max == 0
