"""The port's one-rank long-context serving path against the JAX package:
the per-page flash-decode partials (B7's plain version) against JAX
``_fd_page_partials`` in interpret mode, the page fold against JAX
``_fd_fold``, ``flash_decode_dist`` at one rank against JAX's on a one-device
mesh and against the port's ``gqa_decode_paged``, the ledger's device layout
(``device_row``, ``page_shard``, ``digest``) against JAX ``KVPagePool``, and
the port's ``ShardedServingEngine(long_context=True)`` at mesh 1x1x1 on
``test_long_context.py``'s micro MoE model: its token streams equal the
port's plain engine (the within-port form of
``test_longctx_n1_equals_replicated``) and JAX's long-context engine at
1x1x1 (no quantised wire).

Tolerances: f32 at ``atol 1e-5``; bf16 at ``2e-2`` (the frameworks round
the bf16 products' sums in other orders). The neutral entries (pages that
are dead, past kv_len or not this rank's) are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.models import llama as jl
from triton_dist_tpu.models import moe as jm
from triton_dist_tpu.ops import flash_decode as jfd
from triton_dist_tpu.serving import ShardedServingEngine as JEngine
from triton_dist_tpu.serving import serving_mesh as j_serving_mesh
from triton_dist_tpu.serving.kv_pool import KVPagePool as JPool
from triton_dist_tpu.shmem.context import initialize_distributed
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models import moe as tm
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.serving import (ServingEngine,
                                           ShardedServingEngine,
                                           serving_mesh)
from triton_dist_tpu_torch.serving.kv_pool import KVPagePool

pytestmark = pytest.mark.port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, HQ, HKV, D, PS, POOL, S = 4, 4, 2, 16, 8, 12, 6
ENGINE = dict(num_slots=4, page_size=8, num_pages=9, pages_per_seq=4,
              prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in ``test_torch_moe.py``: one torch thread, so the port's tiny CPU
    ops do not contend with the JAX runtime's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _case(dtype, seed: int = 0):
    """Rows with kv_len 0, inside a page, on a page edge and full; block-
    table entries past each row's live pages are garbage ids (dead pages,
    some outside the pool)."""
    rng = np.random.RandomState(seed)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q = jnp.asarray(rng.randn(B, HQ, D), jnp.float32).astype(jdt)
    k = jnp.asarray(rng.randn(POOL, HKV, PS, D), jnp.float32).astype(jdt)
    v = jnp.asarray(rng.randn(POOL, HKV, PS, D), jnp.float32).astype(jdt)
    kv_len = np.array([0, 5, 2 * PS, S * PS], np.int32)
    bt = rng.randint(1, POOL, (B, S)).astype(np.int32)
    for b in range(B):
        live = -(-int(kv_len[b]) // PS)
        bt[b, live:] = rng.randint(-50, 50, S - live)
    return q, k, v, bt, kv_len


@pytest.fixture(scope="module")
def jax_partials():
    """JAX ``_fd_page_partials`` (interpret mode) per (dtype, rank), each
    computed once: rank 1 owns the second half of the pool."""
    cache = {}

    def get(dtype, rank):
        if (dtype, rank) not in cache:
            q, k, v, bt, kv = _case(dtype)
            half = POOL // 2
            ks, vs = (k, v) if rank == 0 else (k[half:], v[half:])
            packed = jfd._fd_page_partials(
                q, ks, vs, jnp.asarray(bt), jnp.asarray(kv),
                jnp.full((1,), rank, jnp.int32))
            cache[(dtype, rank)] = np.asarray(packed)
        return cache[(dtype, rank)]
    return get


@pytest.mark.parametrize("dtype,rank", [("float32", 0), ("bfloat16", 0),
                                        ("float32", 1)])
def test_page_partials_match_jax(jax_partials, dtype, rank):
    q, k, v, bt, kv = _case(dtype)
    half = POOL // 2
    ks, vs = (k, v) if rank == 0 else (k[half:], v[half:])
    want = jax_partials(dtype, rank)
    out, lse = tfd.fd_page_partials(_t(q), _t(ks), _t(vs), _t(bt), _t(kv),
                                    rank=rank)
    assert out.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want[..., :D], atol=TOL[dtype],
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want[..., D], atol=TOL[dtype],
                               rtol=TOL[dtype])
    # the neutral entries, exactly: dead pages, pages past kv_len, the
    # empty row, and at rank 1 the pages of rank 0's slice
    p_local = ks.shape[0]
    mine = (bt >= rank * p_local) & (bt < (rank + 1) * p_local)
    live = mine & (np.arange(S)[None] * PS < kv[:, None])
    assert (~live).any() and live.any()
    assert (out.numpy()[~live] == 0).all()
    assert (lse.numpy()[~live] == tfd.NEG_INF).all()
    assert (want[..., D][~live] == tfd.NEG_INF).all()


def test_page_fold_matches_jax(jax_partials):
    """The fold of JAX's own slab, in both frameworks, to f32 and bf16."""
    packed = jax_partials("float32", 0)
    stacked = packed.transpose(1, 0, 2, 3).reshape(S, B * HQ, D + 128)
    out, lse = _t(packed[..., :D]), _t(packed[..., D])
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jfd._fd_fold(jnp.asarray(stacked), D, jdt)
                          .astype(jnp.float32)).reshape(B, HQ, D)
        got = tfd.fd_fold_plain(out, lse, tdt)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=1e-6 if tdt == torch.float32
                                   else 1e-2, rtol=0)
    # the empty row folds to zeros; a neutral entry leaves the carry alone
    got = tfd.fd_fold_plain(out, lse, torch.float32)
    assert (got[0] == 0).all()
    again = tfd.fd_fold_plain(torch.cat([out, torch.zeros_like(out[:, :1])],
                                        1),
                              torch.cat([lse, torch.full_like(
                                  lse[:, :1], tfd.NEG_INF)], 1),
                              torch.float32)
    assert torch.equal(got, again)


@pytest.fixture(scope="module")
def one_device_mesh():
    return initialize_distributed(axis_names=("sp",), mesh_shape=(1,))


@pytest.mark.parametrize("parked", [False, True], ids=["live", "parked"])
def test_flash_decode_dist_one_rank_matches_jax(one_device_mesh, parked):
    """The KV write and the fused fold at one rank, against JAX's n = 1
    route on a one-device mesh (f32 1e-5, the pools exactly), and against
    the port's ``gqa_decode_paged`` on the same pools."""
    rng = np.random.RandomState(4)
    q, k, v, _, _ = _case("float32", seed=4)
    bt = np.array([[1, 2, 3, 0, 0, 0], [4, 5, 0, 0, 0, 0],
                   [6, 7, 8, 9, 10, 11], [0] * S], np.int32)
    pos = np.array([20, 9, 40, 0], np.int32)
    kv = pos + 1
    active = np.array([True, True, True, not parked])
    kn = rng.randn(B, HKV, D).astype(np.float32)
    vn = rng.randn(B, HKV, D).astype(np.float32)
    j_out, j_kp, j_vp = jfd.flash_decode_dist(
        one_device_mesh, q, jnp.asarray(kn), jnp.asarray(vn), k, v,
        jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(kv), axis="sp",
        active=jnp.asarray(active))
    kp, vp = _t(k), _t(v)
    ctx = serving_mesh(1, 1, 1)
    out, kp2, vp2 = tfd.flash_decode_dist(
        ctx, _t(q), _t(kn), _t(vn), kp, vp, _t(bt), _t(pos), _t(kv),
        axis="sp", active=_t(active))
    assert kp2 is kp and vp2 is vp                 # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(j_kp))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(j_vp))
    paged, _ = tfd.gqa_decode_paged(_t(q), kp, vp, _t(bt), _t(kv))
    np.testing.assert_allclose(out.numpy(), paged.numpy(), atol=1e-5,
                               rtol=0)
    # the plain route is the fold of the plain partials
    assert torch.equal(out, tfd.fd_fold_plain(
        *tfd.fd_page_partials_plain(_t(q), kp, vp, _t(bt), _t(kv)),
        torch.float32))


@pytest.mark.parametrize("sp", [1, 2, 4])
@pytest.mark.parametrize("layout", ["blocked", "interleaved"])
def test_device_layout_matches_jax(sp, layout):
    j, t = JPool(13, 8, reserved=1, sp_ranks=sp, layout=layout), \
        KVPagePool(13, 8, reserved=1, sp_ranks=sp, layout=layout)
    assert t.device_pages == j.device_pages
    rows = [t.device_row(p) for p in range(t.device_pages)]
    assert rows == [j.device_row(p) for p in range(j.device_pages)]
    assert sorted(rows) == list(range(t.device_pages))     # a bijection
    assert rows[0] == 0                                    # row 0 fixed
    assert [t.page_shard(p) for p in range(t.device_pages)] == \
        [j.page_shard(p) for p in range(j.device_pages)]
    with pytest.raises(AssertionError):
        t.device_row(t.device_pages)


def test_digest_ignores_layout_and_matches_jax():
    digests = set()
    for sp, layout in ((1, "blocked"), (2, "interleaved"), (4, "blocked")):
        pools = (KVPagePool(13, 8, reserved=1, sp_ranks=sp, layout=layout),
                 JPool(13, 8, reserved=1, sp_ranks=sp, layout=layout))
        for pool in pools:
            pool.alloc(5, 3)
            pool.alloc(7, 2)
            pool.free_seq(5)
            pool.alloc(9, 4)
        digests.update(p.digest() for p in pools)
    assert len(digests) == 1
    with pytest.raises(AssertionError):
        KVPagePool(13, 8, layout="striped")


# ------------------------------------------------------------- the engines

@pytest.fixture(scope="module")
def micro():
    """``test_long_context.py``'s micro MoE model (f32, one layer, four
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


def _trace(n: int):
    """``test_long_context.py``'s trace generator: bursty arrivals (two per
    step) against a 9-page pool."""
    rng = np.random.RandomState(77)
    out = []
    for i in range(n):
        plen = int(rng.randint(3, 17))
        mnt = int(rng.randint(2, 6))
        out.append((i // 2, rng.randint(1, 128, size=plen).tolist(), mnt))
    return out


def _serve(tcfg, tparams, n: int, **kw):
    eng = ShardedServingEngine(tparams, tcfg, device="cpu",
                               **dict(ENGINE, **kw))
    return eng.run(max_steps=10_000, arrivals=_trace(n)), eng


def test_longctx_n1_equals_replicated(micro):
    """Within the port: 24 requests (preempting) through the long-context
    engine and the plain one give the same token streams; the layout is
    interleaved and, at one SP rank, the identity."""
    _, _, tcfg, tparams = micro
    long_res, long_eng = _serve(tcfg, tparams, 24, long_context=True)
    plain_res, plain_eng = _serve(tcfg, tparams, 24)
    assert long_eng.metrics.counters["preemptions"] >= 1
    assert len(long_res) == 24 and long_res == plain_res
    assert long_eng.alloc.layout == "interleaved"
    assert plain_eng.alloc.layout == "blocked"
    assert all(long_eng.alloc.device_row(p) == p
               for p in range(long_eng.alloc.device_pages))
    long_eng.alloc.check()
    assert long_eng.alloc.used_pages == 0


def test_longctx_engine_matches_jax(micro):
    """Six requests through the port's and JAX's long-context engines at
    mesh 1x1x1: the same token streams and the same control story."""
    jcfg, jparams, tcfg, tparams = micro
    trace = _trace(6)
    j_eng = JEngine(jparams, jcfg, j_serving_mesh(1, 1, 1), wire_dtype=None,
                    long_context=True, **ENGINE)
    j_res = j_eng.run(max_steps=10_000, arrivals=trace)
    t_res, t_eng = _serve(tcfg, tparams, 6, long_context=True)
    assert j_eng.alloc.layout == t_eng.alloc.layout == "interleaved"
    assert len(t_res) == 6 and t_res == j_res
    for key in ("requests_finished", "tokens_generated", "preemptions",
                "prefill_chunks", "dispatches"):
        assert t_eng.metrics.counters[key] == j_eng.metrics.counters[key], key


def test_engine_hooks_keep_the_plain_bits():
    """A plain Llama engine with no hooks, and with hooks that compute the
    default pair and products, serve the same streams bit for bit; a hook
    without ``prefill_chunk`` is refused."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, seed=0, device="cpu")
    calls = {"attn_io": 0, "linear": 0}

    def attn_io(q, k, v, kp, vp, bt, pos, kv_len, active):
        calls["attn_io"] += 1
        tfd.paged_kv_write(kp, vp, k, v, bt, pos, active=active)
        return tfd.gqa_decode_paged(q, kp, vp, bt, kv_len)[0], kp, vp

    def linear(h, w, name):
        calls["linear"] += 1
        return h @ w

    trace = [(i, list(range(1 + i, 12 + 3 * i)), 4) for i in range(4)]
    kw = dict(num_slots=2, page_size=8, num_pages=12, pages_per_seq=4,
              prefill_chunk=8, decode_horizon=2)
    plain = ServingEngine(params, cfg, device="cpu", **kw) \
        .run(arrivals=trace)
    hooked = ServingEngine(params, cfg, device="cpu", attn_io=attn_io,
                           linear=linear, **kw).run(arrivals=trace)
    assert hooked == plain and len(plain) == 4
    assert calls["attn_io"] > 0 and calls["linear"] > 0
    for hook in ({"attn_io": attn_io}, {"linear": linear}):
        with pytest.raises(ValueError, match="prefill_chunk"):
            ServingEngine(params, cfg, device="cpu", **hook)

    def copies(q, k, v, kp, vp, bt, pos, kv_len, active):
        return attn_io(q, k, v, kp.clone(), vp.clone(), bt, pos, kv_len,
                       active)

    pages = tl.init_page_pool(cfg, 4, 8, device="cpu")
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="in place"):
        tl.decode_step_paged(params, one, one, cfg, pages,
                             torch.ones(1, 2, dtype=torch.int32),
                             attn_io=copies)
