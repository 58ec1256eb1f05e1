"""The port's Llama serving math against the JAX package at
``LlamaConfig.tiny``: the same weights (made by the JAX init, passed through
numpy) and the same numpy inputs through both models.

Tolerances: f32 logits ``atol 1e-4, rtol 1e-3`` (the frameworks sum in other
orders); greedy tokens are equal wherever the reference's top-2 gap exceeds
ten times that. bf16 logits ``atol 2e-2`` (bf16 rounds at the same points
in both, but a rounding may fall the other way after a tiny f32 difference,
and one bf16 ulp of a logit near 1 is ~8e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.models import llama as jl
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models.convert import (params_from_jax,
                                                  tensor_from_numpy)

pytestmark = pytest.mark.port

ATOL, RTOL = 1e-4, 1e-3
PS, PPS, P = 8, 4, 12


def _models(dtype):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(n_layers=2), dtype=dtype)
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(n_layers=2),
        dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, device="cpu", dtype=tcfg.dtype)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def f32():
    return _models(jnp.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _pool(cfg, seed):
    """A page pool already holding random KV, as numpy arrays."""
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, P, cfg.n_kv_heads, PS, cfg.head_dim)
    return {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}


def _assert_tokens_agree(got_tokens, ref_logits, tol=ATOL):
    ref_logits = np.asarray(ref_logits, np.float64)
    top2 = np.sort(ref_logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 10 * tol
    want = ref_logits.argmax(-1)
    assert np.array_equal(np.asarray(got_tokens)[clear], want[clear])


def test_params_from_jax_keeps_keys_shapes_and_bits(f32):
    _, jparams, _, tparams = f32
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        t = tparams
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert np.array_equal(t.numpy(), np.asarray(leaf))


def test_prefill_bucketed_logits_and_cache_match_jax(f32):
    jcfg, jparams, tcfg, tparams = f32
    rng = np.random.RandomState(0)
    S = 16
    tokens = rng.randint(1, jcfg.vocab_size, size=(2, S)).astype(np.int32)
    length = np.array([11, 16], np.int32)
    tokens[0, 11:] = 0
    j_logits, j_cache = jax.jit(
        lambda p, t, c, n: jl.prefill(p, t, jcfg, c, length=n))(
        jparams, jnp.asarray(tokens), jl.init_kv_cache(jcfg, 2, S),
        jnp.asarray(length))
    t_logits, t_cache = tl.prefill(tparams, _t(tokens), tcfg,
                                   tl.init_kv_cache(tcfg, 2, S, device="cpu"),
                                   length=_t(length))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=ATOL, rtol=RTOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(t_cache[k][:, 0, :, :11].numpy(),
                                   np.asarray(j_cache[k])[:, 0, :, :11],
                                   atol=ATOL, rtol=RTOL)
    _assert_tokens_agree(t_logits.argmax(-1).numpy(), j_logits)


def test_decode_step_paged_matches_jax(f32):
    """Three rows at their own depths over a pool holding KV already; the
    third row is parked (active=False) and writes to the scratch page."""
    jcfg, jparams, tcfg, tparams = f32
    pool = _pool(jcfg, 1)
    token = np.array([5, 77, 300], np.int32)
    pos = np.array([9, 30, 3], np.int32)
    bt = np.array([[1, 2, 0, 0], [3, 4, 5, 6], [7, 0, 0, 0]], np.int32)
    active = np.array([True, True, False])
    j_logits, j_pages = jax.jit(
        lambda p, tk, ps, pg, b, a: jl.decode_step_paged(
            p, tk, ps, jcfg, pg, b, active=a))(
        jparams, jnp.asarray(token), jnp.asarray(pos),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(bt),
        jnp.asarray(active))
    t_pool = {k: _t(v) for k, v in pool.items()}
    t_logits, t_pages = tl.decode_step_paged(
        tparams, _t(token), _t(pos), tcfg, t_pool, _t(bt), active=_t(active))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=ATOL, rtol=RTOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(t_pages[k].numpy(),
                                   np.asarray(j_pages[k]), atol=ATOL,
                                   rtol=RTOL)
    _assert_tokens_agree(t_logits.argmax(-1).numpy(), j_logits)


def test_prefill_chunk_paged_matches_jax_and_inline_prefill(f32):
    """A 21-token prompt in chunks of 8 (the last one padded): the first
    token equals the JAX chunk program's and the port's own bucketed inline
    prefill's, and the pages hold the same KV."""
    jcfg, jparams, tcfg, tparams = f32
    rng = np.random.RandomState(2)
    prompt = rng.randint(1, jcfg.vocab_size, size=21).astype(np.int32)
    row = np.array([3, 8, 5, 0], np.int32)
    zeros = {k: np.zeros((jcfg.n_layers, P, jcfg.n_kv_heads, PS,
                          jcfg.head_dim), np.float32) for k in ("k", "v")}
    j_pages = {k: jnp.asarray(v) for k, v in zeros.items()}
    t_pages = {k: _t(v) for k, v in zeros.items()}
    chunk = jax.jit(lambda p, t, s, n, pg, b: jl.prefill_chunk_paged(
        p, t, s, n, jcfg, pg, b))
    C = 8
    for start in range(0, 21, C):
        toks = np.zeros(C, np.int32)
        part = prompt[start:start + C]
        toks[:len(part)] = part
        j_tok, j_pages = chunk(jparams, jnp.asarray(toks), jnp.int32(start),
                               jnp.int32(21), j_pages, jnp.asarray(row))
        t_tok, t_pages = tl.prefill_chunk_paged(tparams, _t(toks), start, 21,
                                                tcfg, t_pages, _t(row))
    assert int(t_tok) == int(j_tok)
    live = row[:3]
    for k in ("k", "v"):
        np.testing.assert_allclose(t_pages[k][:, live].numpy(),
                                   np.asarray(j_pages[k])[:, live],
                                   atol=ATOL, rtol=RTOL)
    logits, _ = tl.prefill(tparams, _t(prompt[None]), tcfg,
                           tl.init_kv_cache(tcfg, 1, 24, device="cpu"))
    assert int(logits[0].argmax()) == int(t_tok)


def test_decode_multistep_paged_matches_jax_with_eos_and_limits(f32):
    """Horizon 4 over three rows: a full-budget row, a row clamped to two
    steps, and a parked row (limit 0); then again with ``eos_id`` set to the
    token the first row emits at its second step, which freezes that row."""
    jcfg, jparams, tcfg, tparams = f32
    pool = _pool(jcfg, 3)
    token = np.array([11, 222, 0], np.int32)
    pos = np.array([12, 5, 0], np.int32)
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    limit = np.array([4, 2, 0], np.int32)

    def run_both(eos_id):
        j = jax.jit(lambda p, tk, ps, pg, b, lim: jl.decode_multistep_paged(
            p, tk, ps, jcfg, pg, b, lim, horizon=4, eos_id=eos_id))(
            jparams, jnp.asarray(token), jnp.asarray(pos),
            {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(bt),
            jnp.asarray(limit))
        t = tl.decode_multistep_paged(
            tparams, _t(token), _t(pos), tcfg,
            {k: _t(v) for k, v in pool.items()}, _t(bt), _t(limit),
            horizon=4, eos_id=eos_id)
        return j, t

    for eos_id in (None, "second"):
        if eos_id == "second":
            eos_id = int(j_toks[1, 0])
        (j_toks, j_tok, j_pos, _), (t_toks, t_tok, t_pos, _) = \
            run_both(eos_id)
        live = np.array([[1, 1, 0]] * 2 + [[1, 0, 0]] * 2, bool)
        assert np.array_equal(t_toks.numpy()[live], np.asarray(j_toks)[live])
        assert np.array_equal(t_tok.numpy(), np.asarray(j_tok))
        assert np.array_equal(t_pos.numpy(), np.asarray(j_pos))
    # the EOS froze row 0 after two steps; row 1 stopped at its limit
    assert t_pos.tolist() == [14, 7, 0]


def test_bf16_decode_step_paged_matches_jax():
    jcfg, jparams, tcfg, tparams = _models(jnp.bfloat16)
    pool = _pool(jcfg, 4)
    pool_j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in pool.items()}
    pool_t = {k: tensor_from_numpy(np.asarray(v), "cpu")
              for k, v in pool_j.items()}
    token = np.array([5, 77], np.int32)
    pos = np.array([9, 30], np.int32)
    bt = np.array([[1, 2, 0, 0], [3, 4, 5, 6]], np.int32)
    j_logits, _ = jax.jit(lambda p, tk, ps, pg, b: jl.decode_step_paged(
        p, tk, ps, jcfg, pg, b))(jparams, jnp.asarray(token),
                                 jnp.asarray(pos), pool_j, jnp.asarray(bt))
    t_logits, _ = tl.decode_step_paged(tparams, _t(token), _t(pos), tcfg,
                                       pool_t, _t(bt))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=2e-2, rtol=0)
    _assert_tokens_agree(t_logits.argmax(-1).numpy(), j_logits, tol=2e-2)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    """Without a card the entry points raise unless asked for the CPU; they
    never fall back to it silently."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tl.LlamaConfig.tiny()
    for call in (lambda: tl.init_params(cfg),
                 lambda: tl.init_page_pool(cfg, 4, 8),
                 lambda: tl.init_kv_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tl.init_params(cfg, device="cpu")["embed"].device.type == "cpu"
