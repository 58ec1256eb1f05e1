"""The port's contiguous-cache decode family against the JAX package on the
same numpy inputs: ``gqa_decode_partial`` (split-KV partials and their
combine), ``decode_combine``, the merge half of ``ll_ag_merge``, the one-rank
push/ring ``all_gather`` and ``sp_gqa_flash_decode``, the model's
``decode_step``, ``generate`` and the one-rank ``decode_step_sp``, and the
decode attention layers.

On the CPU every wrapper runs its plain PyTorch version, the arithmetic the
Hopper kernels repeat; the JAX side runs its Pallas kernels in interpret
mode, as the JAX package's own tests run them. The kernels themselves are
held against the plain versions on the card by ``chip_smoke.py``.

Tolerances: f32 1e-5 for the attention (the frameworks sum in other orders
and the port rescales its softmax at other keys), 1e-6 for the merges (one
exp and a few products per element); bf16 2e-2 (p is rounded to bf16 at
other running maxima, and one bf16 ulp near 1 is 8e-3); model logits
``atol 1e-4, rtol 1e-3`` as in ``test_torch_llama.py``.
"""

import dataclasses
import functools

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
from triton_dist_tpu_torch.layers import (PagedGQADecodeAttention,
                                          SpGQAFlashDecodeAttention)
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.ops import allgather as tag
from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.shmem import ShmemContext, initialize_distributed

pytestmark = pytest.mark.port

B, HQ, HKV, D = 3, 4, 2, 32
# S = 192 takes the JAX kernel's gcd fallback (block_s 128 -> 64); the rows
# are a full one, an empty one and a ragged one
S = 192
KV_LEN = np.array([S, 0, 77], np.int32)
ATOL, RTOL = 1e-4, 1e-3


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
def _decode_case(dtype: str):
    """(q, k, v) as numpy arrays in ``dtype`` (bf16 as ml_dtypes) and the
    JAX kernel's (out, lse[..., 0]) on them."""
    rng = np.random.RandomState(0)
    arrays = [rng.randn(*shape).astype(np.float32)
              for shape in ((B, HQ, D), (B, HKV, S, D), (B, HKV, S, D))]
    if dtype == "bfloat16":
        arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrays]
    out, lse = jfd.gqa_decode_partial(*(jnp.asarray(a) for a in arrays),
                                      jnp.asarray(KV_LEN))
    return arrays, np.asarray(out, np.float32), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("split", [tfd.SPLIT_KEYS, 64, 96])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_gqa_decode_partial_matches_jax(dtype, atol, split):
    """One split (the wrapper's rule at S=192) and several: the split-KV
    walk and its combine give JAX's single-pass result."""
    (q, k, v), j_out, j_lse = _decode_case(dtype)
    args = _t(q), _t(k), _t(v), _t(KV_LEN)
    if split == tfd.SPLIT_KEYS:
        launches = (tfd.gqa_decode_partial.launches,
                    tfd.decode_combine.launches)
        out, lse = tfd.gqa_decode_partial(*args)
        # CPU tensors: the plain version, no kernel
        assert launches == (tfd.gqa_decode_partial.launches,
                            tfd.decode_combine.launches)
    else:
        assert tfd.split_count(S, split) > 1
        out, lse = tfd.gqa_decode_partial_plain(*args, split=split)
    assert out.dtype == args[0].dtype and lse.shape == (B, HQ)
    np.testing.assert_allclose(out.float().numpy(), j_out, atol=atol,
                               rtol=0 if dtype == "bfloat16" else 1e-5)
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=1e-5, rtol=1e-5)
    assert not out[1].float().any() and (lse[1] == tfd.NEG_INF).all()


def test_decode_combine_matches_jax_with_an_empty_partial():
    R = 4
    rng = np.random.RandomState(1)
    outs = rng.randn(R, B, HQ, D).astype(np.float32)
    lses = (rng.randn(R, B, HQ) * 3).astype(np.float32)
    outs[2] = 0.0                      # an empty shard's partial
    lses[2] = tfd.NEG_INF
    lses[:, 1, 0] = tfd.NEG_INF        # one (row, head) empty everywhere
    outs[:, 1, 0] = 0.0
    want = np.asarray(jfd.decode_combine(
        jnp.asarray(outs),
        jnp.asarray(np.broadcast_to(lses[..., None], lses.shape + (128,)))))
    got = tfd.decode_combine(_t(outs), _t(lses))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    assert np.isfinite(got.numpy()).all() and not got[1, 0].any()


@functools.lru_cache(maxsize=None)
def _jax_ctx4():
    return j_initialize_distributed(axis_names=("x",), mesh_shape=(4,))


def test_ll_merge_matches_jax_ll_ag_merge_on_four_ranks():
    """The port's merge over 4 gathered partials against the JAX fused
    all-gather + merge on a 4-device mesh, fed the same stacked partials
    (the JAX wire packs each as out || lse broadcast over 128 lanes)."""
    n = 4
    rng = np.random.RandomState(2)
    outs = rng.randn(n, B, HQ, D).astype(np.float32)
    lses = (rng.randn(n, B, HQ) * 3).astype(np.float32)
    outs[0, 2] = 0.0                   # segment 0 empty for one row
    lses[0, 2] = tfd.NEG_INF
    ctx = _jax_ctx4()
    packed = np.concatenate(
        [outs, np.broadcast_to(lses[..., None], lses.shape + (128,))], -1)
    want = jax.jit(lambda pk: jfd.ll_ag_merge(ctx, pk, D, jnp.float32, "x"))(
        ctx.shard(jnp.asarray(packed), P("x")))
    got = tfd.ll_merge(_t(outs), _t(lses))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    # over one segment the merge keeps the segment's bits
    one = tfd.ll_merge(_t(outs[:1]), _t(lses[:1]), torch.float32)
    assert torch.equal(one, _t(outs[0]))


@functools.lru_cache(maxsize=None)
def _jax_ctx1():
    return j_initialize_distributed(axis_names=("x",), mesh_shape=(1,))


@pytest.mark.parametrize("method", ["push", "ring"])
def test_all_gather_one_rank_matches_jax(method):
    """The SP wire (out || lse, f32) gathered at one rank: JAX's push/ring
    kernel and the port's give the shard's bits in slot 0."""
    x = np.random.RandomState(6).randn(1, B, HQ, D + 1).astype(np.float32)
    ctx = _jax_ctx1()
    want = jax.jit(lambda a: jag.all_gather(ctx, a, axis="x", method=method))(
        ctx.shard(jnp.asarray(x), P("x")))
    launches = tag.all_gather.launches
    got = tag.all_gather(initialize_distributed(("x",), device="cpu"), _t(x),
                         method=method)
    assert tag.all_gather.launches == launches     # CPU: the plain version
    assert got.shape == want.shape and np.array_equal(got.numpy(),
                                                      np.asarray(want))
    with pytest.raises(ValueError, match="two or more axes"):
        tag.all_gather(initialize_distributed(("x",), device="cpu"), _t(x),
                       method="push_2d")


@pytest.mark.parametrize("ag_method", ["fused", "push", "ring"])
def test_sp_gqa_flash_decode_one_rank_matches_jax(ag_method):
    (q, k, v), _, _ = _decode_case("float32")
    ctx = _jax_ctx1()
    want = jax.jit(lambda *a: jfd.sp_gqa_flash_decode(
        ctx, *a, ag_method=ag_method))(
        jnp.asarray(q), ctx.shard(jnp.asarray(k), P(None, None, "x")),
        ctx.shard(jnp.asarray(v), P(None, None, "x")), jnp.asarray(KV_LEN))
    got = tfd.sp_gqa_flash_decode(initialize_distributed(("x",),
                                                         device="cpu"),
                                  _t(q), _t(k), _t(v), _t(KV_LEN),
                                  ag_method=ag_method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _tiny_models():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(n_layers=2),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(n_layers=2),
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu", dtype=tcfg.dtype)
    return jcfg, jparams, tcfg, tparams


PROMPT_B, PROMPT_LEN, MAX_SEQ = 2, 8, 32


def _prompt():
    return np.random.RandomState(3).randint(
        1, 512, (PROMPT_B, PROMPT_LEN)).astype(np.int32)


def test_decode_step_matches_jax_over_three_steps():
    jcfg, jparams, tcfg, tparams = _tiny_models()
    prompt = _prompt()
    jcache = jl.init_kv_cache(jcfg, PROMPT_B, MAX_SEQ)
    _, jcache = jax.jit(lambda p, t, c: jl.prefill(p, t, jcfg, c))(
        jparams, jnp.asarray(prompt), jcache)
    tcache = tl.init_kv_cache(tcfg, PROMPT_B, MAX_SEQ, device="cpu")
    _, tcache = tl.prefill(tparams, _t(prompt), tcfg, tcache)
    step = jax.jit(lambda p, t, pos, c: jl.decode_step(p, t, pos, jcfg, c))
    token = prompt[:, -1]
    for i in range(3):
        pos = PROMPT_LEN + i
        j_logits, jcache = step(jparams, jnp.asarray(token), pos, jcache)
        t_logits, tcache = tl.decode_step(tparams, _t(token), pos, tcfg,
                                          tcache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=ATOL, rtol=RTOL)
        # the cache was written in place at pos, as JAX's update wrote it
        np.testing.assert_allclose(tcache["k"][:, :, :, pos].numpy(),
                                   np.asarray(jcache["k"])[:, :, :, pos],
                                   atol=ATOL, rtol=RTOL)
        token = np.asarray(j_logits).argmax(-1).astype(np.int32)


def test_generate_tokens_match_jax():
    """Each row's tokens equal JAX ``generate``'s up to the row's first step
    whose top-2 logit gap is within the tolerance (after it the paths may
    part)."""
    jcfg, jparams, tcfg, tparams = _tiny_models()
    prompt = _prompt()
    new = 4
    want = np.asarray(jax.jit(lambda p, t: jl.generate(
        p, t, jcfg, new, max_seq=MAX_SEQ))(jparams, jnp.asarray(prompt)))
    got = tl.generate(tparams, _t(prompt), tcfg, new, max_seq=MAX_SEQ)
    assert got.shape == (PROMPT_B, new) and got.dtype == torch.int32
    # the gaps of the port's own logits along its path
    cache = tl.init_kv_cache(tcfg, PROMPT_B, MAX_SEQ, device="cpu")
    logits, cache = tl.prefill(tparams, _t(prompt), tcfg, cache)
    clear = torch.ones(PROMPT_B, dtype=torch.bool)
    compared = 0
    for i in range(new):
        top2 = logits.topk(2, -1).values
        clear &= (top2[:, 0] - top2[:, 1]) > 10 * ATOL
        assert np.array_equal(got[clear, i].numpy(), want[clear.numpy(), i])
        compared += int(clear.sum())
        if i + 1 < new:
            logits, cache = tl.decode_step(tparams, got[:, i],
                                           PROMPT_LEN + i, tcfg, cache)
    assert compared >= new, f"only {compared} tokens had a clear top-2 gap"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ag_method", ["fused", "push", "ring"])
def test_decode_step_sp_one_rank_is_decode_step_bitwise(ag_method, dtype):
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(n_layers=2), dtype=dtype)
    params = tl.init_params(cfg, seed=4, device="cpu")
    ctx = initialize_distributed(("x",), device="cpu")
    token = _t(_prompt()[:, 0])
    caches = [tl.init_kv_cache(cfg, PROMPT_B, MAX_SEQ, device="cpu")
              for _ in range(2)]
    for pos in range(3):
        ref, caches[0] = tl.decode_step(params, token, pos, cfg, caches[0])
        got, caches[1] = tl.decode_step_sp(ctx, params, token, pos, cfg,
                                           caches[1], ag_method=ag_method)
        assert torch.equal(got, ref)
        token = ref.argmax(-1).to(torch.int32)
    assert all(torch.equal(caches[0][n], caches[1][n]) for n in ("k", "v"))


def test_sp_layer_max_batch_padding_equals_the_unpadded_call():
    ctx = initialize_distributed(("x",), device="cpu")
    (q, k, v), _, _ = _decode_case("float32")
    q, k, v, lens = _t(q), _t(k), _t(v), _t(KV_LEN)
    plain = SpGQAFlashDecodeAttention(ctx, HQ, HKV, D)
    padded = dataclasses.replace(plain, max_batch=B)
    full = plain(q, k, v, lens)
    sub = padded(q[:2], k, v, lens[:2])       # 2 rows served in a 3-row cache
    assert sub.shape == (2, HQ, D)
    assert torch.equal(sub, full[:2])
    assert torch.equal(padded(q, k, v, lens), full)
    with pytest.raises(ValueError, match="two or more axes"):
        dataclasses.replace(plain, ag_method="push_2d")(q, k, v, lens)
    with pytest.raises(ValueError, match="ag_method"):
        dataclasses.replace(plain, ag_method="tree")(q, k, v, lens)


def test_paged_layer_update_and_attend_equals_write_then_attend():
    rng = np.random.RandomState(5)
    P_, PS, PPS = 9, 8, 4
    pool = [rng.randn(P_, HKV, PS, D).astype(np.float32) for _ in range(2)]
    q = rng.randn(B, HQ, D).astype(np.float32)
    k_new, v_new = (rng.randn(B, HKV, D).astype(np.float32)
                    for _ in range(2))
    bt = np.arange(1, 1 + B * PPS).reshape(B, PPS).astype(np.int32) % P_
    pos = np.array([0, 9, 30], np.int32)
    layer = PagedGQADecodeAttention(HQ, HKV, D, page_size=PS)
    out, lse, kp, vp = layer.update_and_attend(
        _t(q), _t(k_new), _t(v_new), _t(pool[0]), _t(pool[1]), _t(bt),
        _t(pos))
    kp2, vp2 = tfd.paged_kv_write(_t(pool[0]), _t(pool[1]), _t(k_new),
                                  _t(v_new), _t(bt), _t(pos))
    ref, ref_lse = tfd.gqa_decode_paged(_t(q), kp2, vp2, _t(bt), _t(pos + 1))
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_one_rank_context_and_its_limits():
    ctx = initialize_distributed(("sp", "tp"), device="cpu")
    assert isinstance(ctx, ShmemContext)
    assert ctx.axis_names == ("sp", "tp") and ctx.num_ranks == 1
    assert ctx.axis_size("sp") == ctx.axis_size(("sp", "tp")) == 1
    assert ctx.device == torch.device("cpu")
    # more ranks share the one device since the shmem layer came
    for shape in ((4,), (1, 2)):
        wide = initialize_distributed(("x", "y")[:len(shape)], shape,
                                      device="cpu")
        assert wide.num_ranks == int(np.prod(shape))
    assert ShmemContext(("x",), (2,), torch.device("cpu")).num_ranks == 2
    with pytest.raises(ValueError, match="expected 1 partial"):
        tfd.ll_ag_merge(ctx, torch.zeros(2, 1, HQ, D), torch.zeros(2, 1, HQ),
                        torch.float32, "sp")


# ---------------------------------------------------------------------------
# across ranks: every rank on one device, the JAX side on a 4-device mesh
# ---------------------------------------------------------------------------

N_SP = 4


def _shard_s(a, n):
    """[B, Hkv, S, D] -> the port's rank-major [n, B, Hkv, S / n, D]."""
    b, h, s, d = a.shape
    return a.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous()


def test_ll_ag_merge_across_ranks_matches_jax():
    """The fused gather and merge at 4 ranks, one rank's segment empty for
    one row: every replica is ``ll_merge`` of the stacked partials, within
    1e-6 of JAX's ``ll_ag_merge`` (the same running merge)."""
    rng = np.random.RandomState(7)
    outs = rng.randn(N_SP, B, HQ, D).astype(np.float32)
    lses = (rng.randn(N_SP, B, HQ) * 3).astype(np.float32)
    outs[2, 1] = 0.0
    lses[2, 1] = tfd.NEG_INF
    jctx = _jax_ctx4()
    packed = np.concatenate(
        [outs, np.broadcast_to(lses[..., None], lses.shape + (128,))], -1)
    want = np.asarray(jax.jit(lambda pk: jfd.ll_ag_merge(
        jctx, pk, D, jnp.float32, "x"))(jctx.shard(jnp.asarray(packed),
                                                   P("x"))))
    ctx = initialize_distributed(("x",), (N_SP,), device="cpu")
    got = tfd.ll_ag_merge(ctx, _t(outs), _t(lses), torch.float32, "x")
    assert got.shape == (N_SP, B, HQ, D)
    merged = tfd.ll_merge(_t(outs), _t(lses))
    for r in range(N_SP):
        assert torch.equal(got[r], merged)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_sp_decode(ag_method: str, dtype: str):
    (q, k, v), _, _ = _decode_case(dtype)
    ctx = _jax_ctx4()
    return np.asarray(jax.jit(lambda *a: jfd.sp_gqa_flash_decode(
        ctx, *a, ag_method=ag_method))(
        jnp.asarray(q), ctx.shard(jnp.asarray(k), P(None, None, "x")),
        ctx.shard(jnp.asarray(v), P(None, None, "x")),
        jnp.asarray(KV_LEN)), np.float32)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("ag_method", ["fused", "push", "ring"])
def test_sp_gqa_flash_decode_four_ranks_matches_jax(ag_method, dtype, atol):
    """S = 192 over 4 ranks (48 keys each) with kv_len (192, 0, 77): row 1
    is empty on every rank and row 2 on ranks 2 and 3, whose (0, NEG_INF)
    partials every merge takes as an exact no-op. f32 within 1e-6 of
    JAX's, bf16 within 2e-2; every replica bitwise equal."""
    want = _jax_sp_decode(ag_method, dtype)
    (q, k, v), _, _ = _decode_case(dtype)
    ctx = initialize_distributed(("x",), (N_SP,), device="cpu")
    kt, vt = _shard_s(_t(k), N_SP), _shard_s(_t(v), N_SP)
    reps = tfd.sp_gqa_flash_decode(ctx, _t(q), kt, vt, _t(KV_LEN),
                                   ag_method=ag_method, replicas=True)
    assert reps.shape == (N_SP, B, HQ, D) and reps.dtype == _t(q).dtype
    assert all(torch.equal(reps[r], reps[0]) for r in range(N_SP))
    np.testing.assert_allclose(reps[0].float().numpy(), want, atol=atol,
                               rtol=0 if dtype == "bfloat16" else 1e-6)
    assert not reps[0, 1].float().any()
    # push and ring gather the same wire and merge it the same way
    if ag_method == "ring":
        push = tfd.sp_gqa_flash_decode(ctx, _t(q), kt, vt, _t(KV_LEN),
                                       ag_method="push")
        assert torch.equal(push, reps[0])
    # the layer, with its batch padded to max_batch, gives the same rows
    layer = SpGQAFlashDecodeAttention(ctx, HQ, HKV, D, ag_method=ag_method,
                                      max_batch=B)
    assert torch.equal(layer(_t(q)[:2], kt, vt, _t(KV_LEN)[:2]),
                       reps[0][:2])


# the reference's SP decode test's model (tests/test_decode.py:111-112)
SP_CFG = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
              n_kv_heads=2, d_ff=256, max_seq_len=4 * 32)
SP_B, SP_STEPS = 4, 3


@functools.lru_cache(maxsize=None)
def _jax_decode_step_sp():
    """JAX ``decode_step_sp`` over a 4-way sharded cache, 3 steps, each
    fed the argmax of the last: (params, tokens fed, logits)."""
    from jax.sharding import NamedSharding

    ctx = _jax_ctx4()
    cfg = jl.LlamaConfig(**SP_CFG)
    params = jl.init_params(jax.random.key(0), cfg)
    cache = jl.init_kv_cache(cfg, SP_B, cfg.max_seq_len)
    spec = P(None, None, None, "x", None)
    cache = {n: jax.device_put(a, NamedSharding(ctx.mesh, spec))
             for n, a in cache.items()}
    step = jax.jit(lambda p, t, pos, c: jl.decode_step_sp(
        ctx, p, t, pos, cfg, c, axis="x"))
    token = np.random.RandomState(8).randint(
        0, cfg.vocab_size, SP_B).astype(np.int32)
    fed, logits = [], []
    for pos in range(SP_STEPS):
        fed.append(token)
        lg, cache = step(params, jnp.asarray(token), pos, cache)
        logits.append(np.asarray(lg))
        token = logits[-1].argmax(-1).astype(np.int32)
    return jax.tree.map(np.asarray, params), fed, logits


def test_decode_step_sp_four_ranks_matches_jax():
    """The port's SP step at 4 ranks against JAX's on the reference test's
    model in bf16, fed the same tokens: logits within 1e-2, as JAX's own
    test holds its SP step against its one-device step."""
    jparams, fed, want = _jax_decode_step_sp()
    cfg = tl.LlamaConfig(**SP_CFG)
    params = params_from_jax(jparams, device="cpu", dtype=cfg.dtype)
    ctx = initialize_distributed(("x",), (N_SP,), device="cpu")
    cache = tl.shard_kv_cache(
        tl.init_kv_cache(cfg, SP_B, cfg.max_seq_len, device="cpu"), N_SP)
    assert cache["k"].shape == (2, N_SP, SP_B, 2, 32, 128)
    for pos in range(SP_STEPS):
        checks = []
        got, cache = tl.decode_step_sp(ctx, params, _t(fed[pos]), pos, cfg,
                                       cache, replica_checks=checks)
        np.testing.assert_allclose(got.numpy(), want[pos], rtol=1e-2,
                                   atol=1e-2)
        assert len(checks) == cfg.n_layers and all(bool(c) for c in checks)


def _unshard_kv_cache(cache: dict) -> dict:
    """The inverse of ``shard_kv_cache``: ``[L, n, B, Hkv, S / n, D]`` back
    to ``[L, B, Hkv, S, D]``."""
    def unshard(t):
        L, n, B, H, s, D = t.shape
        return t.permute(0, 2, 3, 1, 4, 5).reshape(L, B, H, n * s, D)
    return {name: unshard(t) for name, t in cache.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_decode_step_sp_across_ranks_matches_one_rank(n):
    """Within the port, in f32: after a prefill, the SP step at n ranks
    (every method) gives one rank's logits within 1e-5 of their scale,
    every replica bitwise equal, push and ring bit for bit; the sharded
    cache holds one rank's rows."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(n_layers=2),
                              dtype=torch.float32)
    params = tl.init_params(cfg, seed=6, device="cpu")
    prompt = _t(_prompt())
    cache = tl.init_kv_cache(cfg, PROMPT_B, MAX_SEQ, device="cpu")
    logits, cache = tl.prefill(params, prompt, cfg, cache)
    first = logits.argmax(-1).to(torch.int32)
    sharded = {m: tl.shard_kv_cache(cache, n) for m in tfd.AG_METHODS}
    assert torch.equal(_unshard_kv_cache(sharded["fused"])["k"],
                       cache["k"])
    toks = {m: first for m in tfd.AG_METHODS}
    token = first
    for i in range(3):
        pos = PROMPT_LEN + i
        ref, cache = tl.decode_step(params, token, pos, cfg, cache)
        scale = ref.abs().max()
        got = {}
        for m in tfd.AG_METHODS:
            checks = []
            got[m], sharded[m] = tl.decode_step_sp(
                ctx := initialize_distributed(("x",), (n,), device="cpu"),
                params, toks[m], pos, cfg, sharded[m], ag_method=m,
                replica_checks=checks)
            assert ctx.num_ranks == n and all(bool(c) for c in checks)
            assert (got[m] - ref).abs().max() <= 1e-5 * scale
        assert torch.equal(got["push"], got["ring"])
        token = ref.argmax(-1).to(torch.int32)
        toks = {m: token for m in tfd.AG_METHODS}
    for m in tfd.AG_METHODS:
        assert torch.allclose(_unshard_kv_cache(sharded[m])["k"],
                              cache["k"], atol=1e-5)
