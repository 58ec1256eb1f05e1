"""The port's MoE tensor-parallel ops and blocks across ranks against the
JAX package on the same numpy inputs, on (2,) and (4,) meshes of the
conftest's virtual CPU devices: ``ag_moe_group_gemm`` (B19) and
``moe_reduce_rs`` (B20) with -1 padding rows, ``moe_mlp_tp_overlap`` and
``moe_decode_step_sp``; and, within the port, each op at 2, 4 and 8 ranks
against its composition from one-rank pieces.

On the CPU every wrapper runs its plain PyTorch version (per rank, the
plain grouped GEMM of each gathered segment against the rank's columns; per
rank, the f32 partial of every segment over its K block, reduced in slot
order); the JAX side runs its Pallas kernels in interpret mode, each jitted
once and cached per module. The CUDA kernels are held against the plain
versions on the card by ``chip_smoke.py`` phases 13 and 18. Tolerances: f32
1e-5 and bf16 2e-2 for one op (both sum in f32 in other orders and round
once); the blocks and the decode step's logits 1e-5 of the result's scale
in f32 (the SP merge and the rank-split sums change the order only)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.layers.ep_a2a_layer import EPAll2AllLayer as JLayer
from triton_dist_tpu.models import llama as jl
from triton_dist_tpu.models import moe as jm
from triton_dist_tpu.ops import moe as jmoe
from triton_dist_tpu.shmem.context import initialize_distributed as j_init
from triton_dist_tpu_torch.layers import EPAll2AllLayer
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models import moe as tm
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.ops import moe as tmoe
from triton_dist_tpu_torch.ops.gemm import slot_reduce_plain
from triton_dist_tpu_torch.ops.group_gemm import (expert_alignment,
                                                  grouped_gemm_plain)
from triton_dist_tpu_torch.shmem import initialize_distributed

pytestmark = pytest.mark.port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# B19: T rows of width H through E experts of [H, N]; B20: TK tokens x top-K
# rows of width F (the K that is sharded) down to D
T, H, N, E = 16, 128, 256, 2
TK, K, F, D = 8, 2, 256, 128
BM = 16
RAGGED_N = 192


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch ops run 10-30x slower beside JAX's interpret-mode threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jctx(n: int):
    return j_init(axis_names=("x",), mesh_shape=(n,))


def _tctx(n: int):
    return initialize_distributed(("x",), (n,), device="cpu")


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _ag_inputs(dtype: str, cols: int, seed: int):
    """B19's rows, their experts (three padded with -1) and the expert
    weights, in numpy (bf16 as bf16 values)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(T, H) * 0.5).astype(np.float32)
    ids = rng.randint(0, E, T).astype(np.int32)
    ids[[1, T // 2, T - 2]] = -1
    w = (rng.randn(E, H, cols) / np.sqrt(H)).astype(np.float32)
    if dtype == "bfloat16":
        x, w = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, w))
    return x, ids, w


def _rs_inputs(dtype: str, cols: int, seed: int):
    """B20's rows (one per token and k), their experts (two padded with
    -1), the top-k weights and the expert weights."""
    rng = np.random.RandomState(seed)
    h = (rng.randn(TK * K, F) * 0.5).astype(np.float32)
    ids = rng.randint(0, E, TK * K).astype(np.int32)
    ids[[0, TK * K - 3]] = -1
    tw = rng.rand(TK, K).astype(np.float32) + 0.1
    tw /= tw.sum(-1, keepdims=True)
    w = (rng.randn(E, F, cols) / np.sqrt(F)).astype(np.float32)
    if dtype == "bfloat16":
        h, w = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (h, w))
    return h, ids, tw, w


@functools.lru_cache(maxsize=None)
def _jax_ops(n: int, dtype: str):
    """JAX's B19 and B20 at n ranks on the cases' inputs, jitted once."""
    ctx = _jctx(n)
    x, ids, w = _ag_inputs(dtype, N, seed=n)
    ag = jax.jit(lambda a, i, b: jmoe.ag_moe_group_gemm(
        ctx, a, i, b, axis="x", block_m=BM))(jnp.asarray(x), jnp.asarray(ids),
                                             jnp.asarray(w))
    h, rids, tw, rw = _rs_inputs(dtype, D, seed=10 + n)
    rs = jax.jit(lambda a, i, g, b: jmoe.moe_reduce_rs(
        ctx, a, i, g, b, axis="x", block_m=BM))(
        jnp.asarray(h), jnp.asarray(rids), jnp.asarray(tw), jnp.asarray(rw))
    return ((x, ids, w), np.asarray(ag.astype(jnp.float32)),
            (h, rids, tw, rw), np.asarray(rs.astype(jnp.float32)))


@pytest.mark.parametrize("n,dtype", [(2, "float32"), (4, "bfloat16")])
def test_ag_moe_and_moe_reduce_rs_match_jax(n, dtype):
    (x, ids, w), ag_want, (h, rids, tw, rw), rs_want = _jax_ops(n, dtype)
    ctx = _tctx(n)
    got = tmoe.ag_moe_group_gemm(ctx, _t(x), _t(ids), _t(w), axis="x",
                                 block_m=BM)
    assert got.shape == (T, N) and got.dtype == _t(x).dtype
    np.testing.assert_allclose(got.float().numpy(), ag_want,
                               atol=TOL[dtype], rtol=0)
    assert not got[torch.from_numpy(ids < 0)].any()      # padding rows: zero
    got = tmoe.moe_reduce_rs(ctx, _t(h), _t(rids), _t(tw), _t(rw), axis="x",
                             block_m=BM)
    assert got.shape == (TK, D) and got.dtype == _t(h).dtype
    np.testing.assert_allclose(got.float().numpy(), rs_want,
                               atol=TOL[dtype], rtol=0)


def _ag_composition(x, ids, w, n: int):
    """B19 at n ranks from the one-rank op: each rank's column block is the
    one-rank ``ag_moe_group_gemm`` of all rows against its columns."""
    one = _tctx(1)
    nl = w.shape[2] // n
    return torch.cat([tmoe.ag_moe_group_gemm(one, x, ids,
                                             w[:, :, r * nl:(r + 1) * nl],
                                             block_m=BM)
                      for r in range(n)], dim=1)


def _rs_composition(h, ids, tw, w, n: int):
    """B20 at n ranks from one-rank pieces: rank r's f32 partial of every
    row over its K block (the one-rank grouped GEMM of the rows aligned as
    one segment), the n partials reduced in slot order
    (``slot_reduce_plain``), unscrambled, folded over k in f32 in k order
    and cast once."""
    rows, kl = h.shape[0], h.shape[1] // n
    gi, rv, be, nb, dest = expert_alignment(ids, E, BM)
    xs = torch.where(rv[:, None], h[gi.long()], torch.zeros((), dtype=h.dtype))
    parts = torch.stack([grouped_gemm_plain(
        xs[:, r * kl:(r + 1) * kl], w[:, r * kl:(r + 1) * kl], be, BM, nb,
        out_dtype=torch.float32) for r in range(n)])
    y = slot_reduce_plain(parts, torch.float32)
    dest = dest.long()
    y = torch.where((dest < y.shape[0])[:, None],
                    y[dest.clamp(max=y.shape[0] - 1)], torch.zeros(()))
    y = y.view(rows // K, K, -1)
    folded = y[:, 0] * tw[:, 0:1]
    for j in range(1, K):
        folded = folded + y[:, j] * tw[:, j:j + 1]
    return folded.to(h.dtype)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ops_at_n_ranks_are_their_one_rank_composition(n):
    """Bitwise, in bf16, at N = 256 and a ragged N = 192 (rank blocks of
    96, 48 and 24 columns): B19 is its per-column-block one-rank
    composition, with zero padding rows; B20 is the slot reduction of the
    n one-rank partials, unscrambled and folded."""
    ctx = _tctx(n)
    for cols in (N, RAGGED_N):
        x, ids, w = (_t(a) for a in _ag_inputs("bfloat16", cols, seed=20))
        got = tmoe.ag_moe_group_gemm(ctx, x, ids, w, block_m=BM)
        assert torch.equal(got, _ag_composition(x, ids, w, n)), cols
        assert torch.equal(got, tmoe.ag_moe_group_gemm_plain(ctx, x, ids, w,
                                                             block_m=BM))
        assert not got[ids < 0].any()
        h, rids, tw, rw = (_t(a) for a in _rs_inputs("bfloat16", cols,
                                                     seed=21))
        got = tmoe.moe_reduce_rs(ctx, h, rids, tw, rw, block_m=BM)
        assert got.shape == (TK, cols)
        assert torch.equal(got, _rs_composition(h, rids, tw, rw, n)), cols


def test_splits_that_do_not_divide_raise():
    ctx = _tctx(4)
    x, ids, w = (_t(a) for a in _ag_inputs("float32", N, seed=1))
    with pytest.raises(ValueError, match="split over 4"):
        tmoe.ag_moe_group_gemm(ctx, x[:14], ids[:14], w)
    h, rids, tw, rw = (_t(a) for a in _rs_inputs("float32", D, seed=2))
    with pytest.raises(ValueError, match="split over 4"):
        tmoe.moe_reduce_rs(ctx, h[:12], rids[:12], tw[:6], rw)
    with pytest.raises(ValueError, match="the kernel's K stage"):
        tmoe.moe_reduce_rs(ctx, h[:, :192], rids, tw, rw[:, :192])


def test_tuple_axes_and_groups_inside_a_mesh_raise():
    """Over ("a", "b") of (2, 2) both ops are their one-axis forms at 4 ranks
    (B19 bitwise; B20 within f32 rounding: the inner slots are summed
    first, then the outer ring), and over a or b their 2-rank forms,
    bitwise, in every group's replica."""
    ctx2d = initialize_distributed(("a", "b"), (2, 2), device="cpu")
    x, ids, w = (_t(a) for a in _ag_inputs("float32", N, seed=1))
    h, rids, tw, rw = (_t(a) for a in _rs_inputs("float32", D, seed=2))
    flat = {n: _tctx(n) for n in (2, 4)}
    assert torch.equal(tmoe.ag_moe_group_gemm(ctx2d, x, ids, w,
                                              axis=("a", "b"), block_m=BM),
                       tmoe.ag_moe_group_gemm(flat[4], x, ids, w,
                                              block_m=BM))
    torch.testing.assert_close(
        tmoe.moe_reduce_rs(ctx2d, h, rids, tw, rw, axis=("a", "b"),
                           block_m=BM),
        tmoe.moe_reduce_rs(flat[4], h, rids, tw, rw, block_m=BM),
        rtol=TOL["float32"], atol=TOL["float32"])
    for axis in ("a", "b"):
        want = tmoe.ag_moe_group_gemm(flat[2], x, ids, w, block_m=BM)
        got = tmoe.ag_moe_group_gemm(ctx2d, x, ids, w, axis=axis,
                                     block_m=BM, replicas=True)
        assert got.shape[0] == 2 and all(torch.equal(g, want) for g in got)
        want = tmoe.moe_reduce_rs(flat[2], h, rids, tw, rw, block_m=BM)
        got = tmoe.moe_reduce_rs(ctx2d, h, rids, tw, rw, axis=axis,
                                 block_m=BM, replicas=True)
        assert got.shape[0] == 2 and all(torch.equal(g, want) for g in got)


@pytest.fixture(scope="module")
def tiny_moe():
    """``tests/test_torch_moe_tp.py``'s tiny MoE weights from JAX
    ``init_moe_params``, and the same weights in the port."""
    base = jl.LlamaConfig(vocab_size=128, d_model=128, n_layers=1, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=128,
                          dtype=jnp.float32)
    cfg = jm.MoEConfig(base=base, num_experts=4, topk=K, moe_d_ff=128)
    jparams = jm.init_moe_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu", dtype=torch.float32)
    return ({k: v[0] for k, v in jparams["blocks"].items()},
            {k: v[0] for k, v in tparams["blocks"].items()})


def test_moe_mlp_tp_overlap_across_ranks(tiny_moe):
    """At 2 ranks within 1e-5 of JAX's block; at 4 ranks within 1e-5 of
    the port's one-rank block (f32)."""
    jb, tb = tiny_moe
    x = (np.random.RandomState(5).randn(12, 128) * 2).astype(np.float32)
    args = [tb[k] for k in ("w_router", "we_up", "we_down")]
    want = jax.jit(lambda a: jm.moe_mlp_tp_overlap(
        _jctx(2), a, jb["w_router"], jb["we_up"], jb["we_down"], topk=K,
        axis="x", block_m=BM))(jnp.asarray(x))
    got2 = tm.moe_mlp_tp_overlap(_tctx(2), _t(x), *args, K, axis="x",
                                 block_m=BM)
    assert _rel(got2.numpy(), want) <= TOL["float32"]
    one = tm.moe_mlp_tp_overlap(_tctx(1), _t(x), *args, K, block_m=BM)
    got4 = tm.moe_mlp_tp_overlap(_tctx(4), _t(x), *args, K, block_m=BM)
    assert _rel(got4.numpy(), one.numpy()) <= TOL["float32"]
    assert _rel(got2.numpy(), one.numpy()) <= TOL["float32"]


def _micro_cfg(n_experts: int):
    """``tests/test_decode.py``'s micro MoE model (d_model 128, 2 layers,
    2 heads of 64, experts of width 128), in f32."""
    base = jl.LlamaConfig(vocab_size=256, d_model=128, n_layers=2,
                          n_heads=2, n_kv_heads=2, d_ff=128,
                          max_seq_len=4 * 32, dtype=jnp.float32)
    return jm.MoEConfig(base=base, num_experts=n_experts, topk=2,
                        moe_d_ff=128)


def _port_cfg(jcfg):
    b = jcfg.base
    base = tl.LlamaConfig(vocab_size=b.vocab_size, d_model=b.d_model,
                          n_layers=b.n_layers, n_heads=b.n_heads,
                          n_kv_heads=b.n_kv_heads, d_ff=b.d_ff,
                          max_seq_len=b.max_seq_len, dtype=torch.float32)
    return tm.MoEConfig(base=base, num_experts=jcfg.num_experts,
                        topk=jcfg.topk, moe_d_ff=jcfg.moe_d_ff)


B, STEPS = 4, 2


def _tokens(vocab: int):
    return np.random.RandomState(7).randint(0, vocab, (STEPS, B)) \
        .astype(np.int32)


def _port_steps(cfg, params, n: int, checks=None):
    """The port's ``moe_decode_step_sp`` at n ranks over the teacher-forced
    tokens: the logits of each step."""
    ctx = _tctx(n)
    layer = EPAll2AllLayer.create(ctx, B // n, cfg.base.d_model, cfg.topk,
                                  cfg.num_experts, axis="x",
                                  dtype=torch.float32)
    cache = tl.init_kv_cache(cfg.base, B, cfg.base.max_seq_len,
                             device="cpu")
    if n > 1:
        cache = tl.shard_kv_cache(cache, n)
    out = []
    for pos, tok in enumerate(_tokens(cfg.base.vocab_size)):
        logits, cache = tm.moe_decode_step_sp(
            ctx, layer, params, _t(tok), pos, cfg, cache, sp_axis="x",
            replica_checks=checks)
        out.append(logits.numpy())
    return out


def _micro_params(jcfg, seed: int):
    """Parameters of ``init_moe_params``'s tree for ``jcfg`` (its shapes,
    traced without running it) as numpy normals from ``seed``: the norm
    gains near 1, the rest at scale 0.05."""
    shapes = jax.eval_shape(lambda: jm.init_moe_params(jax.random.key(0),
                                                       jcfg))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        x = rng.randn(*s.shape).astype(np.float32)
        norm = "norm" in jax.tree_util.keystr(path)
        return 1.0 + 0.1 * x if norm else 0.05 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_moe_decode_step_sp_at_two_ranks_matches_jax():
    """The logits at 2 ranks within 1e-5 of JAX's logit scale over two
    steps (the second reads the first's cache entries)."""
    jcfg, n = _micro_cfg(4), 2
    jparams = jax.tree.map(jnp.asarray, _micro_params(jcfg, 3))
    jctx = _jctx(n)
    jlayer = JLayer.create(jctx, max_tokens=B // n, hidden=128, topk=2,
                           num_experts=jcfg.num_experts, axis="x",
                           dtype=jnp.float32)
    spec = NamedSharding(jctx.mesh, P(None, None, None, "x", None))
    cache = {k: jax.device_put(v, spec) for k, v in jl.init_kv_cache(
        jcfg.base, B, jcfg.base.max_seq_len).items()}
    step = jax.jit(lambda p, t, pos, c: jm.moe_decode_step_sp(
        jctx, jlayer, p, t, pos, jcfg, c, sp_axis="x"))
    want = []
    for pos, tok in enumerate(_tokens(jcfg.base.vocab_size)):
        logits, cache = step(jparams, jnp.asarray(tok), pos, cache)
        want.append(np.asarray(logits))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu", dtype=torch.float32)
    got = _port_steps(_port_cfg(jcfg), params, n)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL["float32"]


def test_moe_decode_step_sp_at_four_ranks_matches_one_rank():
    """At 4 ranks within 1e-5 of the port's one-rank step (f32), every
    layer's replicas bitwise; a layer built for another expert count or
    top-k is refused."""
    jcfg = _micro_cfg(8)
    params = params_from_jax(_micro_params(jcfg, 4), device="cpu",
                             dtype=torch.float32)
    cfg = _port_cfg(jcfg)
    checks = []
    got = _port_steps(cfg, params, 4, checks)
    want = _port_steps(cfg, params, 1)
    assert len(checks) == STEPS * cfg.base.n_layers
    assert all(bool(c) for c in checks)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL["float32"]
    ctx = _tctx(1)
    for other in (dataclasses.replace(cfg, num_experts=4),
                  dataclasses.replace(cfg, topk=1)):
        layer = EPAll2AllLayer.create(ctx, B, 128, other.topk,
                                      other.num_experts, axis="x",
                                      dtype=torch.float32)
        with pytest.raises(AssertionError):
            tm.moe_decode_step_sp(ctx, layer, params, torch.zeros(
                B, dtype=torch.int32), 0, cfg, {}, sp_axis="x")
