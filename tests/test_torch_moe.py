"""The port's one-rank MoE serving path against the JAX package: the MoE
block (``moe_mlp_ep_overlap`` over a one-rank ``EPAll2AllLayer``) against
JAX ``moe_mlp_ep_overlap`` on a one-device mesh, the paged
decode step and prefill chunk with the MoE ``ffn`` against JAX's, and the
port's ``ShardedServingEngine`` against JAX ``ShardedServingEngine`` at mesh
1x1x1 (no quantised wire) on ``test_sharded_serving.py``'s micro model (f32)
and a cut of its trace: the token streams are equal. Within the port, the
contended, preempting trace equals the uncontended one at K in {1, 4}.

Weights come from the JAX ``init_moe_params`` through numpy. Tolerances:
f32 at ``atol 1e-5`` for the block's outputs, ``atol 1e-4, rtol 1e-3`` for
logits (the frameworks sum in other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.layers.ep_a2a_layer import EPAll2AllLayer
from triton_dist_tpu.models import llama as jl
from triton_dist_tpu.models import moe as jm
from triton_dist_tpu.serving import ShardedServingEngine as JEngine
from triton_dist_tpu.serving import serving_mesh as j_serving_mesh
from triton_dist_tpu.shmem.context import initialize_distributed
from triton_dist_tpu_torch.layers import EPAll2AllLayer as TLayer
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models import moe as tm
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.serving import (ServingEngine,
                                           ShardedServingEngine,
                                           serving_mesh)
from triton_dist_tpu_torch.shmem import \
    initialize_distributed as t_initialize_distributed

pytestmark = pytest.mark.port

ATOL, RTOL = 1e-4, 1e-3
PS, PPS, P = 8, 4, 12
ENGINE = dict(num_slots=4, page_size=8, num_pages=9, pages_per_seq=4,
              prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops here are tiny; with several threads each, torch's
    worker threads and the JAX runtime's (after the interpret-mode engine
    has run) contend for the cores and the port's engine runs slow down
    tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.fixture(scope="module")
def ctx():
    return initialize_distributed(axis_names=("x",), mesh_shape=(1,))


def _j_ffn(ctx, cfg, rows):
    layer = EPAll2AllLayer.create(ctx, max_tokens=rows,
                                  hidden=cfg.base.d_model, topk=cfg.topk,
                                  num_experts=cfg.num_experts, axis="x",
                                  dtype=cfg.base.dtype, wire_dtype=None)

    def ffn(h, p):
        return jm.moe_mlp_ep_overlap(ctx, layer, h, p["w_router"],
                                     p["we_gate"], p["we_up"], p["we_down"])
    return ffn


def _t_ffn(cfg, rows, block_m):
    """The port's block as the one-rank engine runs it: the plain wire over
    a one-rank EP layer of ``rows`` rows."""
    ctx = t_initialize_distributed(("x",), (1,), device="cpu")
    layer = TLayer.create(ctx, max_tokens=rows, hidden=cfg.base.d_model,
                          topk=cfg.topk, num_experts=cfg.num_experts,
                          axis="x", dtype=cfg.base.dtype)

    def ffn(h, p):
        return tm.moe_mlp_ep_overlap(ctx, layer, h, p["w_router"],
                                     p["we_gate"], p["we_up"], p["we_down"],
                                     block_m=block_m)
    return ffn


def _layer0(params):
    return {k: v[0] for k, v in params["blocks"].items()}


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def test_moe_block_matches_jax(micro, ctx):
    """Sixteen rows through the one-rank block: router, top-2, grouped FFN
    and combine agree with the EP block on one rank; within the port the
    aligned row block does not change a bit."""
    jcfg, jparams, tcfg, tparams = micro
    x = np.random.RandomState(3).randn(16, 128).astype(np.float32)
    want = jax.jit(lambda h, p: _j_ffn(ctx, jcfg, 16)(h, p))(
        jnp.asarray(x), _layer0(jparams))
    outs = [_t_ffn(tcfg, 16, bm)(_t(x), _layer0(tparams))
            for bm in (16, 64)]
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert torch.equal(outs[0], outs[1])


def _pool(cfg, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, P, cfg.n_kv_heads, PS, cfg.head_dim)
    return {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}


def test_decode_step_paged_with_moe_ffn_matches_jax(micro, ctx):
    """Four rows at their own depths, the last parked (active=False)."""
    jcfg, jparams, tcfg, tparams = micro
    pool = _pool(jcfg.base, 1)
    token = np.array([5, 77, 100, 3], np.int32)
    pos = np.array([9, 30, 3, 0], np.int32)
    bt = np.array([[1, 2, 0, 0], [3, 4, 5, 6], [7, 0, 0, 0], [0, 0, 0, 0]],
                  np.int32)
    active = np.array([True, True, True, False])
    jffn = _j_ffn(ctx, jcfg, 4)
    j_logits, j_pages = jax.jit(
        lambda p, tk, ps, pg, b, a: jl.decode_step_paged(
            p, tk, ps, jcfg.base, pg, b, ffn=jffn, active=a))(
        jparams, jnp.asarray(token), jnp.asarray(pos),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(bt),
        jnp.asarray(active))
    t_logits, t_pages = tl.decode_step_paged(
        tparams, _t(token), _t(pos), tcfg.base,
        {k: _t(v) for k, v in pool.items()}, _t(bt), active=_t(active),
        ffn=_t_ffn(tcfg, 4, 16))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=ATOL, rtol=RTOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(t_pages[k].numpy(),
                                   np.asarray(j_pages[k]), atol=ATOL,
                                   rtol=RTOL)


def test_prefill_chunk_paged_with_moe_ffn_matches_jax(micro, ctx):
    """A 13-token prompt in two chunks of 8 (the second padded): the same
    first token and the same KV in the pages."""
    jcfg, jparams, tcfg, tparams = micro
    base = jcfg.base
    prompt = np.random.RandomState(2).randint(1, 128, 13).astype(np.int32)
    row = np.array([3, 8, 0, 0], np.int32)
    zeros = {k: np.zeros((1, P, base.n_kv_heads, PS, base.head_dim),
                         np.float32) for k in ("k", "v")}
    j_pages = {k: jnp.asarray(v) for k, v in zeros.items()}
    t_pages = {k: _t(v) for k, v in zeros.items()}
    jffn = _j_ffn(ctx, jcfg, 8)
    chunk = jax.jit(lambda p, t, s, n, pg, b: jl.prefill_chunk_paged(
        p, t, s, n, base, pg, b, ffn=jffn))
    for start in (0, 8):
        toks = np.zeros(8, np.int32)
        part = prompt[start:start + 8]
        toks[:len(part)] = part
        j_tok, j_pages = chunk(jparams, jnp.asarray(toks), jnp.int32(start),
                               jnp.int32(13), j_pages, jnp.asarray(row))
        t_tok, t_pages = tl.prefill_chunk_paged(
            tparams, _t(toks), start, 13, tcfg.base, t_pages, _t(row),
            ffn=_t_ffn(tcfg, 8, 64))
    assert int(t_tok) == int(j_tok)
    for k in ("k", "v"):
        np.testing.assert_allclose(t_pages[k][:, row[:2]].numpy(),
                                   np.asarray(j_pages[k])[:, row[:2]],
                                   atol=ATOL, rtol=RTOL)


def _trace(n: int):
    """``test_sharded_serving.py``'s trace generator: bursty arrivals (two
    per step) against a 9-page pool."""
    rng = np.random.RandomState(77)
    out = []
    for i in range(n):
        plen = int(rng.randint(3, 17))
        mnt = int(rng.randint(2, 6))
        out.append((i // 2, rng.randint(1, 128, size=plen).tolist(), mnt))
    return out


COUNTERS = ("requests_finished", "tokens_generated", "preemptions",
            "prefill_chunks", "dispatches", "decode_steps")


def test_engine_streams_match_jax_sharded_engine(micro):
    """Eight requests (one preemption) through both engines at mesh 1x1x1:
    the same token streams and the same control story. (Each JAX engine
    compiles its two programs with the interpret-mode kernels inside, about
    15 s on the CPU, and each request adds about 1 s.)"""
    jcfg, jparams, tcfg, tparams = micro
    trace = _trace(8)
    j_eng = JEngine(jparams, jcfg, j_serving_mesh(1, 1, 1), wire_dtype=None,
                    **ENGINE)
    j_res = j_eng.run(max_steps=10_000, arrivals=trace)
    t_eng = ShardedServingEngine(tparams, tcfg, serving_mesh(1, 1, 1),
                                 device="cpu", **ENGINE)
    t_res = t_eng.run(max_steps=10_000, arrivals=trace)
    assert len(t_res) == 8 and t_res == j_res
    assert j_eng.metrics.counters["preemptions"] >= 1
    for key in COUNTERS:
        assert t_eng.metrics.counters[key] == j_eng.metrics.counters[key], key


@pytest.fixture(scope="module")
def golden(micro):
    """Each of 50 requests served alone: one slot, an ample pool."""
    _, _, tcfg, tparams = micro
    eng = ShardedServingEngine(tparams, tcfg, device="cpu",
                               **dict(ENGINE, num_slots=1, num_pages=8))
    res = eng.run(max_steps=10_000, arrivals=_trace(50))
    assert eng.metrics.counters["preemptions"] == 0 and len(res) == 50
    return res


@pytest.mark.parametrize("horizon", [1, 4])
def test_contended_trace_equals_uncontended(micro, golden, horizon):
    _, _, tcfg, tparams = micro
    # a 7-page pool preempts at both horizons (9 pages do only at K=1)
    eng = ShardedServingEngine(tparams, tcfg, device="cpu",
                               decode_horizon=horizon,
                               **dict(ENGINE, num_pages=7))
    res = eng.run(max_steps=10_000, arrivals=_trace(50))
    assert eng.metrics.counters["preemptions"] >= 1
    assert res == golden
    eng.alloc.check()
    assert eng.alloc.used_pages == 0


def test_ffn_hook_needs_prefill_chunk(micro):
    _, _, tcfg, tparams = micro
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(tparams, tcfg.base, ffn=_t_ffn(tcfg, 4, 16),
                      device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        ShardedServingEngine(tparams, tcfg, device="cpu")


@pytest.mark.parametrize("kw,built", [
    ({"ctx": serving_mesh(tp=2)}, {"mesh_desc": "2x1x1"}),
    ({"ctx": serving_mesh(sp=2)}, {"mesh_desc": "1x2x1"}),
    ({"ctx": serving_mesh(ep=2)}, {"mesh_desc": "1x1x2"}),
    ({"wire_dtype": "auto"}, {"mesh_desc": "1x1x1"}),
    ({"wire_dtype": torch.float8_e4m3fn}, {"wire_dtype": "float8_e4m3fn"}),
    ({"overlap": "ep+sp"}, {"overlap": "ep+sp", "overlap_microbatches": 2}),
    ({"long_context": True, "ctx": serving_mesh(sp=2)},
     {"mesh_desc": "1x2x1", "long_context": True}),
    ({"speculate": 4}, None),
    ({"tp_impl": "ag_gemm"}, {"mesh_desc": "1x1x1"})],
    ids=["tp2", "sp2", "ep2", "wire-auto", "wire-fp8", "overlap",
         "long-context", "speculate", "tp-ag-gemm"])
def test_multi_rank_options_raise(micro, kw, built):
    """The options across ranks: the meshes, the wires, ``tp_impl``,
    ``overlap="ep+sp"`` (B6) and ``long_context`` at sp > 1 (B8) build the
    engine now (``test_torch_sharded_ranks.py`` and
    ``test_torch_sp_modes.py`` serve them); ``speculate`` still raises,
    naming its ROADMAP item."""
    _, _, tcfg, tparams = micro
    if built is None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ShardedServingEngine(tparams, tcfg, device="cpu",
                                 **dict(ENGINE, **kw))
        return
    eng = ShardedServingEngine(tparams, tcfg, device="cpu",
                               **dict(ENGINE, **kw))
    for attr, want in built.items():
        assert getattr(eng, attr) == want


@pytest.mark.parametrize("preset", ["tiny", "mixtral_8x7b",
                                    "deepseek_infer"])
def test_presets_match_jax(preset):
    """The presets carry the reference's widths (Mixtral's rope_theta 1e4
    included: ROADMAP Queue C)."""
    j, t = getattr(jm.MoEConfig, preset)(), getattr(tm.MoEConfig, preset)()
    for f in ("num_experts", "topk", "moe_d_ff"):
        assert getattr(t, f) == getattr(j, f), f
    for f in dataclasses.fields(t.base):
        if f.name != "dtype":
            assert getattr(t.base, f.name) == getattr(j.base, f.name), f.name


def test_init_moe_params_shapes_match_jax():
    cfg = tm.MoEConfig.tiny()
    got = tm.init_moe_params(cfg, seed=0, device="cpu")
    want = jax.eval_shape(lambda: jm.init_moe_params(
        jax.random.PRNGKey(0), jm.MoEConfig.tiny()))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_got.items():
        assert tuple(v.shape) == flat_want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(flat_want[k].dtype), k
    assert got["blocks"]["we_gate"].std().item() == pytest.approx(0.02,
                                                                  rel=0.05)


def test_engine_runs_on_the_card_by_default(micro):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, tparams = micro
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedServingEngine(tparams, tcfg, **ENGINE)
