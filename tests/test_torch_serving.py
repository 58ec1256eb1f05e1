"""The port's serving tier: its token streams against the JAX
``ServingEngine`` on one trace, and its own determinism contract — a
contended trace with forced preemptions is bit-identical, request by
request, to the same requests served one at a time — at every decode
horizon and on both admission paths."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.models import llama as jl
from triton_dist_tpu.serving import KVPagePool as JPool
from triton_dist_tpu.serving import ServingEngine as JEngine
from triton_dist_tpu.serving.metrics import ServingMetrics as JMetrics
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models.convert import params_from_jax
from triton_dist_tpu_torch.serving import KVPagePool, PageLedgerError
from triton_dist_tpu_torch.serving import ServingEngine
from triton_dist_tpu_torch.serving import ServingMetrics

pytestmark = pytest.mark.port


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(n_layers=2),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(n_layers=2),
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _requests(vocab, n, seed, mnt_lo=2, mnt_hi=10):
    rng = np.random.RandomState(seed)
    return [(list(rng.randint(1, vocab, size=int(rng.randint(3, 20)))),
             int(rng.randint(mnt_lo, mnt_hi)))
            for _ in range(n)]


def test_ledger_decisions_match_jax():
    """The same allocation story on both ledgers hands out the same pages
    and leaves the same free list."""
    ops = [("alloc", "a", 3), ("alloc", "b", 2), ("ensure", "a", 40),
           ("free_tail", "a", 2), ("alloc", "c", 4), ("free_seq", "b"),
           ("ensure", "c", 70), ("alloc", "d", 9), ("free_seq", "a")]
    pools = (KVPagePool(12, 8, reserved=1), JPool(12, 8, reserved=1))
    for op, sid, *arg in ops:
        got = [getattr(p, op)(sid, *arg) for p in pools]
        assert got[0] == got[1], op
        assert pools[0]._free == pools[1]._free
        for s in "abcd":
            assert pools[0].pages_of(s) == pools[1].pages_of(s)
    pools[0].check()
    with pytest.raises(PageLedgerError):
        pools[0]._release_page("c", pools[0]._free[0])


def test_metrics_line_has_the_reference_keys():
    assert set(json.loads(ServingMetrics().json_line())) == \
        set(json.loads(JMetrics().json_line()))


def test_engine_tokens_match_jax_engine(tiny):
    """Eight requests through the bucketed inline path at horizon 4: the
    port's token streams and control counters equal the JAX engine's."""
    jcfg, jparams, tcfg, tparams = tiny
    reqs = _requests(jcfg.vocab_size, 8, seed=5)
    kw = dict(num_slots=2, page_size=8, num_pages=16, pages_per_seq=4,
              decode_horizon=4)
    j_eng = JEngine(jparams, jcfg, **kw)
    t_eng = ServingEngine(tparams, tcfg, device="cpu", **kw)
    for eng in (j_eng, t_eng):
        for p, m in reqs:
            eng.submit(p, m)
    j_res = j_eng.run(max_steps=500)
    t_res = t_eng.run(max_steps=500)
    assert t_res == j_res
    for key in ("prefills", "dispatches", "decode_steps", "host_syncs",
                "tokens_generated", "requests_finished", "preemptions"):
        assert t_eng.metrics.counters[key] == j_eng.metrics.counters[key], key


@pytest.mark.parametrize("buckets", [None, (16, 32)])
def test_prefill_buckets_give_the_same_tokens(tiny, buckets):
    """Exact-length and explicit-bucket inline prefill equal the default
    power-of-two buckets token for token (the length mask hides padding)."""
    _, _, tcfg, tparams = tiny
    reqs = _requests(tcfg.vocab_size, 6, seed=7)
    runs = []
    for b in ("pow2", buckets):
        eng = ServingEngine(tparams, tcfg, num_slots=2, page_size=8,
                            num_pages=16, pages_per_seq=4, prefill_buckets=b,
                            device="cpu")
        for p, m in reqs:
            eng.submit(p, m)
        runs.append(eng.run(max_steps=500))
    assert runs[0] == runs[1]


def test_engine_rejects_impossible_requests(tiny):
    _, _, tcfg, tparams = tiny
    eng = ServingEngine(tparams, tcfg, num_slots=1, page_size=8, num_pages=4,
                        pages_per_seq=2, device="cpu")
    with pytest.raises(ValueError):
        eng.submit([1] * 16, 2)          # 17 tokens > 2 pages of 8
    with pytest.raises(ValueError):
        eng.submit([], 2)


@pytest.fixture(scope="module")
def golden(tiny):
    """Thirty requests through ONE single-slot engine with an ample pool:
    each request is served alone."""
    _, _, tcfg, tparams = tiny
    reqs = _requests(tcfg.vocab_size, 30, seed=2, mnt_lo=6, mnt_hi=14)
    eng = ServingEngine(tparams, tcfg, num_slots=1, page_size=8,
                        num_pages=8, pages_per_seq=8, device="cpu")
    rids = [eng.submit(p, m) for p, m in reqs]
    gold = eng.run(max_steps=5000)
    assert eng.metrics.counters["preemptions"] == 0
    return reqs, [gold[r] for r in rids]


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("chunk", [None, 8])
def test_trace_bit_identical_under_preemption(tiny, golden, chunk, horizon):
    """Four slots over a pool too small for four long tails: growth must
    preempt, and every request (the preempted ones included) must equal its
    uncontended stream bit for bit."""
    _, _, tcfg, tparams = tiny
    reqs, gold = golden
    eng = ServingEngine(tparams, tcfg, num_slots=4, page_size=8, num_pages=9,
                        pages_per_seq=8, decode_horizon=horizon,
                        prefill_chunk=chunk, device="cpu")
    res = eng.run(max_steps=5000,
                  arrivals=[(i // 2, p, m) for i, (p, m) in enumerate(reqs)])
    c = eng.metrics.counters
    assert c["requests_finished"] == len(reqs)
    assert c["preemptions"] >= 1, "the trace was meant to force preemption"
    assert any(r.preemptions for r in eng._finished)
    if chunk is not None:
        assert c["prefill_chunks"] >= len(reqs)
    assert [res[i] for i in range(len(reqs))] == gold
    eng.alloc.check()
    assert eng.alloc.used_pages == 0
    if horizon > 1:
        assert c["dispatches"] < c["tokens_generated"] - c["prefills"]
        assert c["host_syncs"] <= c["dispatches"]


@pytest.mark.parametrize("chunk", [None, 8])
def test_eos_ends_requests_early(tiny, golden, chunk):
    """With ``eos_id`` set to a token the golden streams emit, each request
    stops right after its first EOS (on the first token, inside a horizon,
    or never), and its tokens are the golden's up to there."""
    _, _, tcfg, tparams = tiny
    reqs, gold = golden
    eos = gold[0][2]
    eng = ServingEngine(tparams, tcfg, num_slots=4, page_size=8, num_pages=9,
                        pages_per_seq=8, decode_horizon=4, eos_id=eos,
                        prefill_chunk=chunk, device="cpu")
    res = eng.run(max_steps=5000,
                  arrivals=[(i // 2, p, m) for i, (p, m) in enumerate(reqs)])
    want = [g[:g.index(eos) + 1] if eos in g else g for g in gold]
    assert [res[i] for i in range(len(reqs))] == want
    assert sum(len(w) < len(g) for w, g in zip(want, gold)) >= 1
