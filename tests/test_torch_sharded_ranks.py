"""The port's sharded MoE serving engine across ranks: the TP projection
(``tp_column_linear``) and the SP attention (``sp_paged_attend_write``) at
2 and 4 ranks, bitwise the port's one-rank form and close to JAX's; the
engine on ``test_sharded_serving.py``'s micro MoE model (f32, fp8 wire
pinned) at 1x1x2, 1x1x4, 2x1x2, 1x2x2, 2x2x2 and with ``overlap="ep"``,
bitwise its own 1x1x1 golden on a trace that preempts; its 1x1x1 fp8
streams equal to JAX's engine's; the replicated-decision guard; the pool
padding; and the modes that still raise.

Every rank runs in this one process on the CPU, through the wrappers'
plain versions; the JAX engine runs its interpret-mode kernels once, on a
one-device mesh (cached in a module fixture). Tolerances: bitwise within
the port (each output element is summed in one order at every mesh
size); against JAX in f32, ``atol 1e-5`` (the frameworks' products sum in
other orders), and token streams equal.
"""

import dataclasses
import functools
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.models import llama as jl
from triton_dist_tpu.models import moe as jm
from triton_dist_tpu.ops import allgather_gemm as jagg
from triton_dist_tpu.ops import flash_decode as jfd
from triton_dist_tpu.serving import ShardedServingEngine as JEngine
from triton_dist_tpu.serving import serving_mesh as j_serving_mesh
from triton_dist_tpu.serving.kv_pool import page_pool_pspec as j_pspec
from triton_dist_tpu.shmem.context import initialize_distributed as jinit
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models import moe as tm
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.ops import allgather_gemm as tagg
from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.serving import (ReplicatedDecisionError,
                                           ShardedServingEngine,
                                           page_pool_pspec, serving_mesh,
                                           shard_pool_arrays)
from triton_dist_tpu_torch.shmem import initialize_distributed

pytestmark = pytest.mark.port

FP8 = torch.float8_e4m3fn
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
    """The port's CPU ops are tiny; after the JAX engine has run, torch's
    worker threads and JAX's contend and the port's engines slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@functools.lru_cache(maxsize=None)
def _jctx(n: int, name: str):
    return jinit(axis_names=(name,), mesh_shape=(n,))


@pytest.mark.parametrize("impl", ["xla", "ag_gemm"])
@pytest.mark.parametrize("n", [2, 4])
def test_tp_column_linear_across_ranks(n, impl):
    """``xla``: bitwise the one-rank product; ``ag_gemm`` (B15): close to
    it. Both close to JAX's ``tp_column_linear`` at n ranks."""
    rs = np.random.RandomState(n)
    h = rs.randn(8, 64).astype(np.float32)
    w = (rs.randn(64, 96) * 0.1).astype(np.float32)
    one = tagg.tp_column_linear(initialize_distributed(("tp",), (1,),
                                                       device="cpu"),
                                _t(h), _t(w), axis="tp")
    ctx = initialize_distributed(("tp",), (n,), device="cpu")
    got = tagg.tp_column_linear(ctx, _t(h), _t(w), axis="tp", impl=impl)
    if impl == "xla":
        assert torch.equal(got, one)
    jctx = _jctx(n, "tp")
    want = jax.jit(lambda a, b: jagg.tp_column_linear(
        jctx, a, b, axis="tp", impl="xla"))(jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="gemm_rs"):
        tagg.tp_column_linear(ctx, _t(h), _t(w), axis="tp", impl="gemm_rs")


@pytest.mark.parametrize("n", [2, 4])
def test_sp_paged_attend_write_across_ranks(n):
    """The pool sharded over n SP ranks: the same pools and bitwise the
    same attention as one rank (with B9's gather or B6's), close to JAX's
    at n ranks."""
    B, Hq, Hkv, D, ps, pages = 3, 4, 2, 32, 8, 8
    rs = np.random.RandomState(11)
    q = rs.randn(B, Hq, D).astype(np.float32)
    kn, vn = (rs.randn(B, Hkv, D).astype(np.float32) for _ in range(2))
    kp, vp = (rs.randn(pages, Hkv, ps, D).astype(np.float32)
              for _ in range(2))
    bt = np.array([[1, 2], [3, 5], [0, 0]], np.int32)
    pos = np.array([9, 4, 0], np.int32)
    kv = pos + 1
    active = np.array([True, True, False])
    outs = {}
    for ranks in (1, n):
        ctx = initialize_distributed(("sp",), (ranks,), device="cpu")
        tk, tv = _t(kp), _t(vp)
        outs[ranks] = tfd.sp_paged_attend_write(
            ctx, _t(q), _t(kn), _t(vn), tk, tv, _t(bt), _t(pos), _t(kv),
            axis="sp", active=_t(active))
        assert outs[ranks][1] is tk and outs[ranks][2] is tv
    assert torch.equal(outs[n][0], outs[1][0])
    assert torch.equal(outs[n][1], outs[1][1])
    jctx = _jctx(n, "sp")
    jo, jk, _ = jax.jit(lambda *a: jfd.sp_paged_attend_write(
        jctx, *a, axis="sp", active=jnp.asarray(active)))(
        *(jnp.asarray(a) for a in (q, kn, vn)),
        jctx.shard(jnp.asarray(kp), P("sp")),
        jctx.shard(jnp.asarray(vp), P("sp")),
        *(jnp.asarray(a) for a in (bt, pos, kv)))
    np.testing.assert_allclose(outs[n][0].numpy(), np.asarray(jo),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(outs[n][1].numpy(), np.asarray(jk))
    # the start-local gather (B6) gives the same pools and attention
    tk, tv = _t(kp), _t(vp)
    over = tfd.sp_paged_attend_write(ctx, _t(q), _t(kn), _t(vn), tk, tv,
                                     _t(bt), _t(pos), _t(kv), axis="sp",
                                     active=_t(active), overlap=True)
    assert all(torch.equal(a, b) for a, b in zip(over, outs[n]))


@pytest.fixture(scope="module")
def micro():
    """``test_sharded_serving.py``'s micro MoE model (f32, one layer, four
    experts, top-2), in both frameworks."""
    base = jl.LlamaConfig(vocab_size=128, d_model=128, n_layers=1, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=128,
                          dtype=jnp.float32)
    jcfg = jm.MoEConfig(base=base, num_experts=4, topk=2, moe_d_ff=64)
    jparams = jm.init_moe_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tm.MoEConfig(base=tl.LlamaConfig(
        vocab_size=128, d_model=128, n_layers=1, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, dtype=torch.float32),
        num_experts=4, topk=2, moe_d_ff=64)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu", dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def _trace(n: int, seed: int = 77):
    """Bursty arrivals (two per step) against the 7-page pool: it
    preempts."""
    rng = np.random.RandomState(seed)
    return [(i // 2, rng.randint(1, 128, size=int(rng.randint(3, 17)))
             .tolist(), int(rng.randint(4, 12))) for i in range(n)]


def _serve(tcfg, tparams, mesh, wire=FP8, **kw):
    eng = ShardedServingEngine(tparams, tcfg, serving_mesh(*mesh),
                               device="cpu", wire_dtype=wire,
                               **dict(ENGINE, **kw))
    return eng.run(max_steps=10_000, arrivals=_trace(6)), eng


@pytest.fixture(scope="module")
def golden(micro):
    _, _, tcfg, tparams = micro
    res, eng = _serve(tcfg, tparams, (1, 1, 1))
    assert eng.metrics.counters["preemptions"] >= 1 and len(res) == 6
    return res


MESHES = [((1, 1, 2), {}), ((1, 1, 4), {}), ((2, 1, 2), {}),
          ((1, 2, 2), {}), ((2, 2, 2), {}),
          ((1, 1, 2), {"overlap": "ep"}), ((2, 1, 2), {"tp_impl": "ag_gemm"})]


@pytest.mark.parametrize("mesh,kw", MESHES,
                         ids=["1x1x2", "1x1x4", "2x1x2", "1x2x2", "2x2x2",
                              "1x1x2-overlap", "2x1x2-ag-gemm"])
def test_engine_on_a_mesh_equals_the_one_rank_golden(micro, golden, mesh,
                                                     kw):
    """Every mesh serves the preempting trace bitwise as the 1x1x1 engine
    with the same fp8 wire, preemptions and all. ``tp_impl="ag_gemm"``
    (B15 over the TP axis, a group inside the 2-D mesh) sums its tiles in
    another order than the column products, so it is held against the
    2x1x1 ``ag_gemm`` engine on the same trace instead, bitwise."""
    _, _, tcfg, tparams = micro
    if kw.get("tp_impl") == "ag_gemm":
        res, eng = _serve(tcfg, tparams, mesh, **kw)
        ref, _ = _serve(tcfg, tparams, (2, 1, 1), **kw)
        assert len(res) == 6 and res == ref
        assert eng.mesh_desc == "x".join(map(str, mesh))
        eng.alloc.check()
        return
    res, eng = _serve(tcfg, tparams, mesh, **kw)
    assert res == golden
    c = eng.metrics.counters
    assert c["preemptions"] >= 1 and c["digest_checks"] >= 1
    assert eng.mesh_desc == "x".join(map(str, mesh))
    assert eng.metrics.hist["exposed_comm_us"].count > 0
    eng.alloc.check()
    assert eng.alloc.used_pages == 0


def test_plain_wire_on_a_mesh_equals_its_golden(micro):
    _, _, tcfg, tparams = micro
    one, _ = _serve(tcfg, tparams, (1, 1, 1), wire=None)
    four, _ = _serve(tcfg, tparams, (1, 1, 4), wire=None)
    assert one == four


@pytest.fixture(scope="module")
def jax_fp8_streams(micro):
    """JAX's 1x1x1 engine with the fp8 wire pinned, on four requests."""
    jcfg, jparams, _, _ = micro
    eng = JEngine(jparams, jcfg, j_serving_mesh(1, 1, 1),
                  wire_dtype=jnp.float8_e4m3fn, **ENGINE)
    return eng.run(max_steps=10_000, arrivals=_trace(4, seed=5))


def test_one_rank_fp8_streams_match_jax(micro, jax_fp8_streams):
    _, _, tcfg, tparams = micro
    eng = ShardedServingEngine(tparams, tcfg, serving_mesh(1, 1, 1),
                               device="cpu", wire_dtype=FP8, **ENGINE)
    assert eng.wire_dtype == "float8_e4m3fn"
    assert eng.run(max_steps=10_000,
                   arrivals=_trace(4, seed=5)) == jax_fp8_streams


def test_digest_guard_trips_under_skew(micro):
    _, _, tcfg, tparams = micro
    eng = ShardedServingEngine(tparams, tcfg, serving_mesh(1, 1, 2),
                               device="cpu", wire_dtype=FP8, **ENGINE)
    eng.check_replicated_decisions()
    eng._digest_skew[1] = 1
    with pytest.raises(ReplicatedDecisionError, match=r"ranks \[1\]"):
        eng.run(max_steps=10_000, arrivals=_trace(2))
    assert eng.metrics.counters["digest_checks"] >= 2


def test_pool_is_padded_and_the_padding_never_handed_out(micro):
    """At sp = 2 a 7-page pool (8 with the scratch page) stays 8; at sp = 3
    it pads to 9 device pages, and no block table ever names page 8."""
    _, _, tcfg, tparams = micro
    assert page_pool_pspec("sp") == tuple(j_pspec("sp"))
    pool = {"k": torch.ones(1, 5, 2, 8, 4), "v": torch.ones(1, 5, 2, 8, 4)}
    padded = shard_pool_arrays(pool, 3)
    assert padded["k"].shape[1] == 6 and not padded["k"][:, 5].any()
    assert shard_pool_arrays(pool, 5) is pool
    ctx = initialize_distributed(("tp", "sp", "ep"), (1, 3, 1), device="cpu")
    eng = ShardedServingEngine(tparams, tcfg, ctx, device="cpu",
                               wire_dtype=FP8, **ENGINE)
    assert eng.pool["k"].shape[1] == 9 and eng.alloc.device_pages == 9
    seen = set()
    orig = eng._bt_row

    def spy(rid):
        row = orig(rid)
        seen.update(int(p) for p in row)
        return row

    eng._bt_row = spy
    eng.run(max_steps=10_000, arrivals=_trace(6))
    assert seen and max(seen) < 8


@pytest.mark.parametrize("kw,item", [
    ({"speculate": 4}, "item 10"),
    ({"journal": object()}, "item 10")],
    ids=["speculate", "journal"])
def test_modes_outside_the_slice_raise(micro, kw, item):
    _, _, tcfg, tparams = micro
    with pytest.raises(NotImplementedError, match=item):
        ShardedServingEngine(tparams, tcfg, device="cpu",
                             **dict(ENGINE, **kw))


def test_engine_preconditions(micro):
    _, _, tcfg, tparams = micro
    with pytest.raises(ValueError, match="split over ep"):
        ShardedServingEngine(tparams, tcfg, serving_mesh(ep=4), device="cpu",
                             **dict(ENGINE, num_slots=6))
    with pytest.raises(ValueError, match="microbatches"):
        ShardedServingEngine(tparams, tcfg, serving_mesh(ep=4), device="cpu",
                             overlap="ep", **ENGINE)
    with pytest.raises(ValueError, match="gemm_rs"):
        ShardedServingEngine(tparams, tcfg, device="cpu", tp_impl="gemm_rs",
                             **ENGINE)
    small = dataclasses.replace(tcfg, base=dataclasses.replace(
        tcfg.base, d_model=96, n_heads=3))
    with pytest.raises(ValueError, match="multiple of 128"):
        ShardedServingEngine(tm.init_moe_params(small, device="cpu"), small,
                             device="cpu", **ENGINE)
