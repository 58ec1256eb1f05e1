"""The port's disaggregated prefill/decode serving: the page transport
(``migrate_pages``, ``lend_pages``, TPU kernel B23's plain version) bitwise
the JAX package's on ``test_disagg.py``'s stamped pools, the signal ledger
and the channel's refusals (``test_disagg.py:68-135`` as the checklist),
the ledger's migration checks against JAX ``KVPagePool``, and the port's
``DisaggServingEngine`` held against the port's colocated chunked
``ServingEngine``: every request's tokens bitwise, with and without a
forced prefill preemption, and a dropped landed report or a starved
transport failing (or degrading) that request only, after the deadline
and its retries.

No JAX engine runs here (the JAX disaggregated golden alone takes about a
minute on this CPU): the engine-level contracts are the ones the reference
keeps within itself, held within the port. The transport compares exactly;
the JAX interpret path mirror-writes the producer's scratch page 0, which
the contract leaves as write-only garbage, so that page is left out."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.ops import lend_pages as j_lend_pages
from triton_dist_tpu.ops import migrate_pages as j_migrate_pages
from triton_dist_tpu.serving.kv_pool import KVPagePool as JPool
from triton_dist_tpu.serving.kv_pool import PageLedgerError as JLedgerError
from triton_dist_tpu.shmem.context import initialize_distributed as jinit
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.ops import lend_pages, migrate_pages
from triton_dist_tpu_torch.serving import (ChunkSignalLedger,
                                           DisaggServingEngine,
                                           MigrationSignalTimeout,
                                           PageLedgerError,
                                           PageMigrationChannel,
                                           ServingEngine, ServingMetrics,
                                           SignalProtocolError)
from triton_dist_tpu_torch.serving.disagg import DECODE_ROLE, PREFILL_ROLE
from triton_dist_tpu_torch.serving.kv_pool import KVPagePool
from triton_dist_tpu_torch.serving.scheduler import RequestState
from triton_dist_tpu_torch.shmem import initialize_distributed
from triton_dist_tpu_torch.shmem.device import ShmemError

pytestmark = pytest.mark.port

ENGINE = dict(num_slots=2, page_size=8, num_pages=32, pages_per_seq=8,
              prefill_chunk=8)


# ---------------------------------------------------------------------------
# the signal ledger and the channel
# ---------------------------------------------------------------------------

def test_ledger_signal_count_matches_pages():
    """A chunk covers its pages exactly when its count reaches its page
    count; a partial count covers nothing; a signal for a chunk nobody
    expected is a protocol bug."""
    led = ChunkSignalLedger()
    led.expect(7, 0, [3, 4, 5])
    assert not led.chunk_complete(7, 0) and led.covered(7) == set()
    led.landed(7, 0, 2)
    assert led.covered(7) == set() and not led.complete(7)
    led.landed(7, 0, 1)
    assert led.chunk_complete(7, 0) and led.complete(7)
    assert led.covered(7) == {3, 4, 5}
    with pytest.raises(KeyError):
        led.landed(7, 9, 1)
    with pytest.raises(KeyError):
        led.landed(8, 0, 1)


def test_ledger_out_of_order_stale_and_over_signal():
    """Coverage is the union over complete chunks whatever their order;
    re-expecting a chunk resets it and bumps its generation, a report of
    the old generation is discarded; over-signal raises with the dump."""
    led = ChunkSignalLedger()
    led.expect(1, 0, [2, 3])
    led.expect(1, 1, [4])
    led.expect(1, 2, [5, 6])
    led.landed(1, 2, 2)
    assert led.covered(1) == {5, 6}
    led.landed(1, 0, 2)
    assert led.covered(1) == {2, 3, 5, 6} and not led.complete(1)
    assert [c for c, _, _ in led.incomplete_chunks(1)] == [1]
    led.landed(1, 1, 1)
    assert led.complete(1) and led.covered(1) == {2, 3, 4, 5, 6}
    led.expect(1, 0, [2, 3], src_ids=[9, 10], generation=1)
    assert led.covered(1) == {4, 5, 6}
    assert led.incomplete_chunks(1) == [(0, (9, 10), (2, 3))]
    assert led.landed(1, 0, 2, generation=0) is False       # stale
    assert led.covered(1) == {4, 5, 6} and led.generation(1, 0) == 1
    with pytest.raises(SignalProtocolError, match="over-signal"):
        led.landed(1, 0, 3, generation=1)
    led.reset(1)
    assert led.covered(1) == set() and led.expected(1) == set()
    assert led.describe(1) == "no chunks recorded"


def test_channel_refuses_scratch_page_and_checks_the_tag():
    """A scratch page is never migrated: the channel refuses before any
    launch or ledger entry. A report echoing another attempt's tag is a
    protocol fault."""
    def boom(*_a):
        raise AssertionError("no launch for a refused chunk")

    ch = PageMigrationChannel(boom, pmax=4, reserved=1,
                              metrics=ServingMetrics())
    with pytest.raises(PageLedgerError, match="scratch"):
        ch.send_chunk(0, 0, [0, 2], [3, 4])
    with pytest.raises(PageLedgerError, match="scratch"):
        ch.send_chunk(0, 0, [2, 3], [4, 0])
    assert ch.ledger.expected(0) == set()
    sent = []

    def echo(src, dst, n, tag):
        sent.append((src, dst, n, tag))
        return np.array([[n, tag], [n, tag]])

    ch = PageMigrationChannel(echo, pmax=4, reserved=1,
                              metrics=ServingMetrics())
    ch.send_chunk(3, 0, [5, 6], [7, 8])
    ch.send_chunk(3, 0, [5, 6], [7, 8])      # a re-send: attempt 1
    assert sent == [([5, 6, 0, 0], [7, 8, 0, 0], 2, 0),
                    ([5, 6, 0, 0], [7, 8, 0, 0], 2, 1)]
    assert ch.ledger.covered(3) == {7, 8}
    assert ch.metrics.counters["pages_migrated"] == 4
    ch._launch = lambda src, dst, n, tag: np.array([[n, 0], [n, 0]])
    with pytest.raises(SignalProtocolError, match="tag"):
        ch.send_chunk(3, 0, [5, 6], [7, 8])   # attempt 2 echoed as 0


# ---------------------------------------------------------------------------
# the transport against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def role_ctx():
    return jinit(axis_names=("role",), mesh_shape=(2,))


def _stamped():
    L, Pg, H, ps, D = 2, 8, 2, 4, 8
    host_k = np.zeros((2, L, Pg, H, ps, D), np.float32)
    host_v = np.zeros_like(host_k)
    for p in range(Pg):
        host_k[0, :, p] = 100 + p
        host_v[0, :, p] = 200 + p
    return host_k, host_v


@pytest.mark.parametrize("front", ["migrate", "lend"])
def test_transport_is_bitwise_jax(role_ctx, front):
    """``test_migrate_pages_exact_copy``'s stamped pools through the port's
    transport and JAX's: the pools bitwise equal (the producer's scratch
    page aside), padding never moved, landed (n, tag) at both roles."""
    host_k, host_v = _stamped()
    spec = jax.sharding.PartitionSpec("role")
    src, dst = [3, 5, 1, 7], [2, 6, 4, 7]
    j_fn, t_fn, roles = (
        (j_migrate_pages, migrate_pages, {}) if front == "migrate"
        else (j_lend_pages, lend_pages, {"lender": 0, "borrower": 1}))
    jk, jv, jl_ = j_fn(role_ctx, role_ctx.shard(jnp.asarray(host_k), spec),
                       role_ctx.shard(jnp.asarray(host_v), spec),
                       jnp.array(src, jnp.int32), jnp.array(dst, jnp.int32),
                       jnp.array([3], jnp.int32), axis="role", tag=5,
                       **roles)
    ctx = initialize_distributed(("role",), (2,), device="cpu")
    tk, tv = torch.from_numpy(host_k.copy()), torch.from_numpy(host_v.copy())
    tk, tv, landed = t_fn(ctx, tk, tv, src, dst, 3, axis="role", tag=5,
                          **roles)
    jk, jv = np.asarray(jk), np.asarray(jv)
    np.testing.assert_array_equal(landed.numpy(), np.asarray(jl_))
    assert landed.tolist() == [[3, 5], [3, 5]]
    for t, j in ((tk.numpy(), jk), (tv.numpy(), jv)):
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_array_equal(t[0, :, 1:], j[0, :, 1:])
    assert not tk[1, :, 7].any()
    assert (tk[0, :, 0] == 100).all()        # the port leaves scratch alone


def test_transport_refuses_bad_arguments():
    ctx = initialize_distributed(("role",), (2,), device="cpu")
    pk = ctx.create_symm_tensor((1, 4, 1, 8, 4), torch.float32)
    with pytest.raises(ValueError, match="ids"):
        migrate_pages(ctx, pk, pk.clone(), [1, 9], [2, 3], 2)
    with pytest.raises(ValueError, match="roles"):
        migrate_pages(ctx, pk, pk.clone(), [1], [2], 1, producer=1,
                      consumer=1)
    with pytest.raises(ValueError, match="symmetric"):
        migrate_pages(ctx, pk[0], pk[0].clone(), [1], [2], 1)


def test_migration_checks_match_jax():
    """``check_migratable`` refuses what the reference's ledger refuses
    (scratch, SP padding, foreign pages) and ``landed_row`` exposes the
    same landed prefix."""
    j = JPool(11, 8, reserved=1, sp_ranks=4)
    t = KVPagePool(11, 8, reserved=1, sp_ranks=4)
    for pool in (j, t):
        pool.alloc("a", 4)
        pool.alloc("b", 2)
    assert t.pages_of("a") == j.pages_of("a")
    a = t.pages_of("a")
    t.check_migratable("a", a)
    j.check_migratable("a", a)
    for ids, match in (([0], "scratch"), ([11], "padding"),
                       (t.pages_of("b")[:1], "not owned")):
        for pool, error in ((j, JLedgerError), (t, PageLedgerError)):
            with pytest.raises(error, match=match):
                pool.check_migratable("a", ids)
    for covered in (set(), {a[0]}, {a[0], a[2]}, set(a)):
        assert t.landed_row("a", covered, 6) == j.landed_row("a", covered, 6)
    assert t.holds("a") and not t.holds("z")


# ---------------------------------------------------------------------------
# the engine within the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(n_layers=2),
                              dtype=torch.float32)
    return cfg, tl.init_params(cfg, seed=0, device="cpu")


def _requests(cfg, n, seed=11):
    rng = np.random.RandomState(seed)
    return [(list(rng.randint(1, cfg.vocab_size,
                              size=int(rng.randint(3, 20)))),
             int(rng.randint(2, 7))) for _ in range(n)]


@pytest.fixture(scope="module")
def golden(tiny):
    """The colocated chunked engine over the trace."""
    cfg, params = tiny
    reqs = _requests(cfg, 6)
    eng = ServingEngine(params, cfg, device="cpu", **ENGINE)
    rids = [eng.submit(p, m) for p, m in reqs]
    gold = eng.run(max_steps=2000)
    assert sorted(gold) == rids
    return reqs, gold


def _disagg(tiny, **kw):
    cfg, params = tiny
    return DisaggServingEngine(params, cfg, device="cpu",
                               **dict(ENGINE, num_prefill_slots=2) | kw)


@pytest.mark.parametrize("preempt,pages", [
    (False, ENGINE["num_pages"]), (True, ENGINE["num_pages"]), (False, 4)],
    ids=["plain", "forced-prefill-preemption", "decode-preemption"])
def test_disagg_bitwise_colocated(tiny, golden, preempt, pages):
    """Every request's tokens equal the colocated engine's bit for bit;
    the decode worker processes no prompt token; every request is handed
    off and the pages moved are its prompt's. With a forced prefill
    preemption mid-prompt the resumed prefill sends only new pages; in a
    4-page pool the decode worker preempts, and its victims re-prefill and
    migrate again."""
    reqs, gold = golden
    eng = _disagg(tiny, num_pages=pages)
    for p, m in reqs:
        eng.submit(p, m)
    preempted = None
    for _ in range(2000):
        if preempt and preempted is None:
            mid = [r for r in eng.sched_p.slots if r is not None
                   and 0 < r.prefill_cursor < len(r.prompt)]
            if mid:
                preempted = mid[0].rid
                assert eng.force_preempt_prefill() is not None
        if not eng.step():
            break
    got = {r.rid: r.generated for r in eng._finished}
    assert got == gold
    assert not eng.failed
    assert eng.metrics_decode.hist["step_prefill_tokens"].max == 0
    c = eng.metrics.counters
    prompt_pages = sum(-(-len(p) // 8) for p, _ in reqs)
    if pages < ENGINE["num_pages"]:
        assert eng.metrics_decode.counters["preemptions"] >= 1
        assert c["pages_migrated"] > prompt_pages
    else:
        assert c["handoffs"] == len(reqs)
        assert c["pages_migrated"] == prompt_pages
    if preempt:
        assert preempted is not None and c["preemptions"] == 1
    assert eng.alloc_p.used_pages == 0 and eng.alloc_d.used_pages == 0
    eng.alloc_p.check()
    eng.alloc_d.check()


def _drop_reports_of(eng, rid, starve=False):
    """Monkeypatch the channel's launch so the landed reports of ``rid``'s
    sends (its prefill pages as sources, retries too) never arrive: the
    pages move, the count stays 0. With ``starve`` the launch raises
    ``ShmemError`` instead, as the transport does on the card when the
    consumer's wait runs out of its spin budget."""
    launch = eng.channel._launch

    def dropped(src, dst, n, tag):
        landed = launch(src, dst, n, tag)
        if set(src[:n]) <= set(eng.alloc_p.pages_of(rid)):
            if starve:
                raise ShmemError("paged_transport: rank 1 waited past its "
                                 "budget")
            landed = landed.clone()
            landed[DECODE_ROLE, 0] = 0
        return landed

    eng.channel._launch = dropped


@pytest.mark.parametrize("degrade", [False, True],
                         ids=["fails", "degrades"])
def test_dropped_report_fails_only_that_request(tiny, golden, degrade):
    """Request 0's landed reports are dropped: after the deadline and every
    retry rung it fails with ``MigrationSignalTimeout`` (or, allowed to
    degrade, re-prefills on the decode worker and finishes bitwise), and
    every other request finishes bitwise the golden."""
    reqs, gold = golden
    eng = _disagg(tiny, signal_deadline_steps=2, max_retries=1,
                  allow_degradation=degrade)
    _drop_reports_of(eng, 0)
    got = eng.run(max_steps=2000, arrivals=[(0, p, m) for p, m in reqs])
    d = eng.metrics_decode.counters
    assert d["retries"] == 1
    if degrade:
        assert got == gold and d["degradations"] == 1 and not eng.failed
    else:
        assert [r.rid for r in eng.failed] == [0]
        assert isinstance(eng.failed[0].failure, MigrationSignalTimeout)
        assert eng.failed[0].state is RequestState.FAILED
        assert "chunk 0" in str(eng.failed[0].failure)
        assert got == {k: v for k, v in gold.items() if k != 0}
    assert eng.alloc_p.used_pages == 0 and eng.alloc_d.used_pages == 0


@pytest.mark.parametrize("degrade", [False, True],
                         ids=["fails", "degrades"])
def test_starved_transport_fails_only_that_request(tiny, golden, degrade):
    """Request 0's transport starves (``ShmemError`` out of every launch of
    its sends): the channel counts no landed page, the ladder runs as for a
    dropped report, and the engine serves every other request bitwise."""
    reqs, gold = golden
    eng = _disagg(tiny, signal_deadline_steps=2, max_retries=1,
                  allow_degradation=degrade)
    _drop_reports_of(eng, 0, starve=True)
    got = eng.run(max_steps=2000, arrivals=[(0, p, m) for p, m in reqs])
    assert eng.metrics_decode.counters["retries"] == 1
    if degrade:
        assert got == gold and not eng.failed
    else:
        assert [r.rid for r in eng.failed] == [0]
        assert isinstance(eng.failed[0].failure, MigrationSignalTimeout)
        assert got == {k: v for k, v in gold.items() if k != 0}
    assert eng.alloc_p.used_pages == 0 and eng.alloc_d.used_pages == 0


@pytest.mark.parametrize("kw,item", [
    ({"fault_plan": object()}, "item 10"),
    ({"journal": object()}, "item 10"),
    ({"checkpoint_every": 4}, "item 10"),
    ({"queue_cap": 2}, "item 10"),
    ({"ttl_steps": 8}, "item 10"),
    ({"prefix_cache": True}, "item 10"),
    ({"slo": object()}, "item 10"),
    ({"artifact": object()}, "item 12")],
    ids=["fault-plan", "journal", "checkpoint", "queue-cap", "ttl",
         "prefix-cache", "slo", "artifact"])
def test_unported_options_raise(tiny, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        _disagg(tiny, **kw)


def test_engine_preconditions(tiny):
    cfg, params = tiny
    with pytest.raises(ValueError, match="exactly 2"):
        DisaggServingEngine(params, cfg, initialize_distributed(
            ("role",), (4,), device="cpu"), device="cpu")
    eng = _disagg(tiny)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(list(range(1, 70)), 4)
    assert eng.pool_k.shape[:3] == (2, cfg.n_layers, ENGINE["num_pages"] + 1)
    assert eng.pages[PREFILL_ROLE]["k"].data_ptr() == eng.pool_k.data_ptr()
