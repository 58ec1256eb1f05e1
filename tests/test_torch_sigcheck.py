"""sigcheck in the port, on the CPU: the checker, the decoder of the traced
log, the plain gallery (B26), the registry's surface, and ring attention at
head dim 256 (B24, B25).

The checker is held against the JAX package's: the reference captures its
gallery specimens (module-level, once: about 4 s), each event is carried
field for field into the port's ``Event`` with one lane a rank, and both
checkers must give the same findings (kind, op, n, detail, in order). The
port's plain gallery, the per-rank event streams the CUDA specimens log
(``csrc/sigcheck_gallery.cu``), must be flagged as the reference flags its
Pallas specimens. The traced kernels themselves run on the card
(``chip_smoke.py`` phase 23, ``tools_torch/sigcheck.py``).

Ring attention at D = 256: the port's plain ring attention against the
reference's on a 2-rank CPU mesh (interpret mode), forward and gradients
at ``atol 1e-5``; then the cp train step at head_dim 256 against the step
without cp, at ``tests/test_torch_train_cp.py``'s tolerances.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.analysis import capture as j_capture
from triton_dist_tpu.analysis import checker as j_checker
from triton_dist_tpu.analysis.gallery import GALLERY as J_GALLERY
from triton_dist_tpu.shmem.context import initialize_distributed as j_init
from triton_dist_tpu_torch.analysis import api, capture, checker, gallery
from triton_dist_tpu_torch.analysis.events import Event, Region, SemId
from triton_dist_tpu_torch.analysis.registry import (REGISTRY,
                                                     surface_names)
from triton_dist_tpu_torch.models.llama import LlamaConfig
from triton_dist_tpu_torch.parallel import ParallelPlan, make_train_step
from triton_dist_tpu_torch.shmem import initialize_distributed

jra = importlib.import_module("triton_dist_tpu.ops.ring_attention")
tra = importlib.import_module("triton_dist_tpu_torch.ops.ring_attention")

pytestmark = pytest.mark.port

# what the reference's check_gallery() gives each Pallas specimen
EXPECTED = {
    "missing_wait": ["over_signal", "over_signal", "unordered_read"],
    "dropped_signal": ["under_signal"],
    "seg_dropped_signal": ["under_signal"],
    "lend_dropped_last_signal": ["under_signal"],
    "fold_dropped_slice_signal": ["under_signal"],
    "over_signal": ["over_signal", "over_signal"],
    "swapped_sem": ["unordered_read", "unordered_read"],
    "wait_cycle": ["deadlock", "deadlock"],
}


def _port_event(e) -> Event:
    """A reference event field for field, lane 0 of its rank."""
    def sem(s):
        return None if s is None else SemId(s.alloc, tuple(s.cell), s.kind)

    def region(r):
        return None if r is None else Region(r.buffer, tuple(r.intervals))

    return Event(rank=e.rank, seq=e.seq, kind=e.kind, sem=sem(e.sem),
                 send_sem=sem(e.send_sem), dst_rank=e.dst_rank,
                 value=e.value, src=region(e.src), dst=region(e.dst),
                 rdma_id=e.rdma_id, grid=(0,), site=e.site)


@pytest.fixture(scope="module")
def reference_gallery():
    """Each Pallas specimen's reference streams at its meshes, captured
    once: {name: [(n, {rank: [Event]})]}."""
    out = {}
    for name, entry in J_GALLERY.items():
        if entry.run is None:
            continue
        out[name] = []
        for mesh in entry.meshes:
            n = int(np.prod(list(mesh.values())))
            out[name].append((n, j_capture.capture_op(entry.run, mesh)))
    return out


def _fields(findings):
    return [(f.kind, f.op, f.n, f.detail) for f in findings]


def test_port_checker_matches_the_reference_checker(reference_gallery):
    assert set(reference_gallery) == set(gallery.SPECIMENS)
    for name, captures in reference_gallery.items():
        want, got = [], []
        for n, streams in captures:
            want += j_checker.check_events(name, streams, n)
            got += checker.check_events(
                name, {(r, 0): [_port_event(e) for e in evs]
                       for r, evs in streams.items()}, n)
        assert _fields(got) == _fields(want), name
        assert [f.kind for f in want] == EXPECTED[name], name


def test_plain_gallery_is_flagged_as_the_reference_flags_it():
    reports = api.check_gallery(device="cpu")
    assert list(reports) == list(gallery.SPECIMENS)
    for name, (expected, rep) in reports.items():
        assert rep.finding_kinds == EXPECTED[name], name
        assert expected in rep.finding_kinds, name
    kinds = {k for _, rep in reports.values() for k in rep.finding_kinds}
    assert kinds == {"under_signal", "over_signal", "deadlock",
                     "unordered_read"}


@pytest.mark.parametrize("name", gallery.SPECIMENS)
def test_plain_specimen_is_its_wrapper_on_the_cpu(name):
    """On a CPU context the specimen's wrapper runs its plain version: the
    streams, one lane a rank, every rank's in program order."""
    ctx = initialize_distributed(("x",), (3,), device="cpu")
    got = gallery.run_specimen(ctx, name)
    assert sorted(got) == [(r, 0) for r in range(3)]
    assert gallery.protocol_of(got) == gallery.protocol_of(
        gallery.plain_streams(name, 3))
    for (r, _), events in got.items():
        assert [e.seq for e in events] == list(range(len(events)))
        assert all(e.rank == r and e.grid == (0,) for e in events)
    with pytest.raises(ValueError, match="2 or more"):
        gallery.run_specimen(initialize_distributed(device="cpu"), name)


# -- the actor model ---------------------------------------------------------

def _ev(rank, lane, seq, kind, word=None, dst=None, value=0, **kw):
    sem = None if word is None else SemId("pad", (word,))
    return Event(rank=rank, seq=seq, kind=kind, sem=sem, dst_rank=dst,
                 value=value, grid=(lane,), **kw)


def test_waits_across_lanes_are_feasible():
    """Lane 0 of rank 0 waits on a word that lane 1 of rank 1 signals, and
    lane 0 of rank 1 on one that lane 1 of rank 0 signals: feasible lane by
    lane (a rank-level replay would call it a cycle)."""
    streams = {
        (0, 0): [_ev(0, 0, 0, "wait", 0, value=1)],
        (0, 1): [_ev(0, 1, 1, "signal", 1, dst=1, value=1)],
        (1, 0): [_ev(1, 0, 2, "wait", 1, value=1)],
        (1, 1): [_ev(1, 1, 3, "signal", 0, dst=0, value=1)],
    }
    assert checker.check_events("cross", streams, 2) == []
    # the same protocol with each rank's lanes merged into one stream, its
    # wait first, deadlocks
    merged = {r: [streams[(r, 0)][0], streams[(r, 1)][0]] for r in (0, 1)}
    assert [f.kind for f in checker.check_events("merged", merged, 2)] == \
        ["deadlock"]


def _fan_in(consume: bool):
    """Rank 1's two lanes put and then count on rank 0's word 5; rank 0's
    three lanes wait_peek the count (2), read, arrive on the finish word 9,
    and the last consumes the count (finish_block)."""
    buf = Region("buf0[0]", ((0, 64),))
    streams = {(1, lane): [
        Event(rank=1, seq=10 * lane, kind="put", dst=buf, dst_rank=0,
              value=64, grid=(lane,)),
        _ev(1, lane, 10 * lane + 1, "signal", 5, dst=0, value=1)]
        for lane in (0, 1)}
    for lane in range(3):
        evs = [_ev(0, lane, 100 + 10 * lane, "wait_peek", 5, value=2),
               Event(rank=0, seq=101 + 10 * lane, kind="read", src=buf,
                     grid=(lane,)),
               _ev(0, lane, 102 + 10 * lane, "signal", 9, dst=0, value=1)]
        if lane == 2:
            evs.append(_ev(0, lane, 103 + 10 * lane, "wait", 9, value=3))
            if consume:
                evs.append(_ev(0, lane, 104 + 10 * lane, "wait", 5, value=2))
        streams[(0, lane)] = evs
    return streams


def test_wait_peek_fan_in_with_the_last_lane_consuming_is_clean():
    assert checker.check_events("fan_in", _fan_in(True), 2) == []


def test_wait_peek_fan_in_without_the_consume_over_signals():
    assert [f.kind for f in checker.check_events("fan_in", _fan_in(False),
                                                 2)] == ["over_signal"]


def test_a_read_not_ordered_after_a_store_put_is_flagged():
    buf = Region("buf0[1]", ((0, 32),))
    put = Event(rank=0, seq=0, kind="put", dst=buf, dst_rank=1, value=32,
                grid=(0,))
    sig = _ev(0, 0, 1, "signal", 0, dst=1, value=1)
    read = Event(rank=1, seq=1, kind="read", src=buf, grid=(0,))
    wait = _ev(1, 0, 0, "wait", 0, value=1)
    ordered = {(0, 0): [put, sig], (1, 0): [wait, read]}
    assert checker.check_events("ordered", ordered, 2) == []
    early = {(0, 0): [put, sig], (1, 0): [
        Event(rank=1, seq=0, kind="read", src=buf, grid=(0,)),
        _ev(1, 0, 1, "wait", 0, value=1)]}
    assert [f.kind for f in checker.check_events("early", early, 2)] == \
        ["unordered_read"]


# -- the decoder -------------------------------------------------------------

def _record(seq, rank, lane, kind, word=0, value=0, dst=0, src=0, nbytes=0,
            launch=1):
    return [seq, rank, lane, kind, word, value, dst, src, nbytes, launch]


def test_decoder_names_pads_and_symmetric_rows():
    """Two pads and one symmetric tensor: words become (family, word) cells
    owned by the pad's row, a put's destination the tensor's row and byte
    interval, launches apart, and an unknown word raises."""
    pad_a, pad_b, buf = 0x1000, 0x2000, 0x10000
    allocs = capture.Allocations([
        capture.Allocation("fam_a", pad_a, 2, 256, "fam_a"),
        capture.Allocation("fam_b", pad_b, 2, 256, "fam_b"),
        capture.Allocation("buf0", buf, 2, 4096)])
    log = np.array([
        _record(3, 1, 0, 3, word=pad_a + 256 + 8, value=1),
        _record(0, 0, 0, 5, dst=buf + 4096 + 128, src=buf + 64, nbytes=32),
        _record(1, 0, 0, 1, word=pad_a + 256 + 8, value=1),
        _record(2, 1, 2, 4, word=pad_b + 4, value=3),
        _record(4, 1, 0, 6, src=buf + 4096 + 128, nbytes=32),
        _record(5, 0, 0, 7, dst=buf, nbytes=0),
        _record(6, 0, 1, 1, word=pad_b + 256, value=2, launch=2),
    ], np.int64)
    launches = capture.decode(log, allocs, 2)
    assert len(launches) == 2
    first = launches[0]
    assert sorted(first) == [(0, 0), (1, 0), (1, 2)]
    put, sig = first[(0, 0)]
    assert put == Event(rank=0, seq=0, kind="put",
                        dst=Region("buf0[1]", ((128, 160),)),
                        src=Region("buf0[0]", ((64, 96),)), dst_rank=1,
                        value=32, grid=(0,), site="launch1")
    assert (sig.kind, sig.sem, sig.dst_rank, sig.value) == \
        ("signal", SemId("fam_a", (2,)), 1, 1)
    wait, read = first[(1, 0)]
    assert (wait.kind, wait.sem, wait.dst_rank, wait.value) == \
        ("wait", SemId("fam_a", (2,)), None, 1)
    assert read.src == Region("buf0[1]", ((128, 160),))
    (peek,) = first[(1, 2)]
    assert (peek.kind, peek.sem, peek.dst_rank, peek.value) == \
        ("wait_peek", SemId("fam_b", (1,)), 0, 3)
    second = launches[1]
    assert sorted(second) == [(0, 1), (1, 0)] and second[(1, 0)] == []
    assert second[(0, 1)][0].sem == SemId("fam_b", (0,))
    # rank 1's peek of 3 on fam_b's word 1 has no supply
    assert [f.kind for f in checker.check_events("decoded", first, 2)] == \
        ["under_signal"]
    with pytest.raises(capture.CaptureError, match="no known pad"):
        capture.decode(np.array([_record(0, 0, 0, 1, word=0x9999)]), allocs,
                       2)


def test_capture_off_the_card_raises():
    with pytest.raises(capture.CaptureError, match="on the card"):
        capture.capture_op(lambda ctx: None, {"x": 2}, device="cpu")


# -- guards ------------------------------------------------------------------

def test_capture_error_is_a_finding():
    def broken(run, mesh):
        raise RuntimeError("no log")

    rep = api.sigcheck(lambda ctx: None, op="broken", meshes=({"x": 2},),
                       capture=broken)
    assert rep.finding_kinds == ["capture_error"] and not rep.ok
    assert "no log" in rep.findings[0].detail


def test_registry_names_the_whole_ops_surface():
    assert set(REGISTRY) == surface_names()
    assert len(REGISTRY) == 92
    local = {n for n, e in REGISTRY.items()
             if e.skip == "single-device kernel, no signal protocol"}
    assert {"gqa_decode_paged", "matmul", "gqa_decode_partial",
            "decode_combine", "fd_page_partials", "grouped_gemm",
            "grouped_gemm_gated"} <= local
    for name, e in REGISTRY.items():
        assert (e.run is None) != (e.skip is None), name
        if e.skip is not None:
            assert e.skip.strip(), name


_CHECKED = sorted(n for n, e in REGISTRY.items() if e.skip is None)


@pytest.mark.parametrize("name", _CHECKED)
def test_registry_run_takes_its_meshes(name):
    """Each checked op's run drives the op at every mesh of its entry (the
    plain versions here: the shapes are ones the op accepts)."""
    entry = REGISTRY[name]
    for mesh in entry.meshes:
        entry.run(initialize_distributed(tuple(mesh), tuple(mesh.values()),
                                         device="cpu"))


# -- ring attention at head dim 256 ------------------------------------------

def _ring_inputs(S, D, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(1, 2, S, D).astype(np.float32) * 0.5
                 for _ in range(4))


def test_ring_attention_at_head_dim_256_matches_jax():
    """Forward and gradients on a 2-rank mesh, f32, causal, S = 512."""
    q, k, v, do = _ring_inputs(512, 256)
    jctx = j_init(axis_names=("cp",), mesh_shape=(2,))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = jra.ring_attention_fwd(jctx, jq, jk, jv, axis="cp")
    jgrads = jra.ring_attention_bwd(jctx, jq, jk, jv, jout, jlse, jdo,
                                    causal=True, sm_scale=None, axis="cp")
    ctx = initialize_distributed(("cp",), (2,), device="cpu")
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tra.ring_attention(ctx, *leaves, axis="cp")
    out.backward(torch.from_numpy(do))
    _, lse = tra.ring_attention_fwd(ctx, *(torch.from_numpy(a)
                                           for a in (q, k, v)), axis="cp")
    for name, got, want in zip(
            ("out", "lse", "dq", "dk", "dv"),
            (out, lse, *(x.grad for x in leaves)),
            (jout, jlse, *jgrads)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_head_dims_follow_the_reference():
    """Any multiple of 128 on the plain path; the kernels name theirs."""
    ctx = initialize_distributed(("cp",), (2,), device="cpu")
    q = torch.zeros(1, 2, 64, 200)
    with pytest.raises(ValueError, match="multiple of 128"):
        tra.ring_attention_fwd(ctx, q, q, q, axis="cp")
    q = torch.zeros(1, 2, 64, 384)
    out, _ = tra.ring_attention_fwd(ctx, q, q, q, axis="cp")
    assert out.shape == q.shape
    assert tra.KERNEL_HEAD_DIMS == (128, 256)
    with pytest.raises(ValueError, match=r"\(128, 256\)"):
        tra._check_kernel_args("ring_attention_fwd", q, q, q)


CFG256 = LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=2,
                     n_kv_heads=1, d_ff=256, max_seq_len=64,
                     dtype=torch.float32)


def test_cp_step_at_head_dim_256_equals_the_step_without_cp():
    """make_train_step with cp over 2 ranks at head_dim 256 against the
    step without cp, three AdamW steps (test_torch_train_cp.py's
    tolerances: losses rtol 1e-4, parameters atol 1e-3)."""
    assert CFG256.head_dim == 256
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, CFG256.vocab_size, (4, 32)))

    def train(mesh, plan):
        init_fn, step_fn = make_train_step(CFG256, mesh, plan, device="cpu")
        state = init_fn(0)
        losses = []
        for _ in range(3):
            state, loss = step_fn(state, tokens)
            losses.append(loss.item())
        return losses, state.params

    cp = ParallelPlan(dp=None, tp=None, cp="cp", sp=False)
    got = train({"cp": 2}, cp)
    want = train(None, dataclasses.replace(cp, cp=None))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)

    def flat(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from flat(val, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", val

    ref = dict(flat(want[1]))
    for name, t in flat(got[1]):
        np.testing.assert_allclose(t.detach().numpy(),
                                   ref[name].detach().numpy(), atol=1e-3,
                                   err_msg=name)
    with pytest.raises(ValueError, match="multiple of 128"):
        make_train_step(dataclasses.replace(CFG256, d_model=384, n_heads=2),
                        {"cp": 2}, cp, device="cpu")[1](None, tokens)
