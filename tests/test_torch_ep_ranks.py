"""The port's EP wire across ranks against the JAX package on the same numpy
inputs: the plain B21 (``all_to_all_push``) at 2 and 4 ranks, with its
quantised forms (fp8 and int8, quantised and dequantised in the wire);
the quantiser; the EP ``dispatch`` and ``combine`` at 4 ranks for each
edge; B22 (``all_to_all_push_seg``) against B21; the wire's size and the
``auto`` pick for a given fit; the collectives over a group inside a 2-D
and a 3-D mesh; and ``moe_mlp_ep_overlap`` at ep = 4.

On the CPU every wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode on the conftest's virtual CPU
devices. The CUDA kernels are held against the plain versions on the card
by ``chip_smoke.py`` phase 16. Tolerances: the wires, ids, slots and
quantised rows are copies or the same f32 arithmetic, bitwise (the port's
quantiser multiplies by the f32 reciprocal of qmax, as XLA compiles the
reference's ``amax / qmax``); the combine sums in f32 in k order in both,
within 1e-6 in f32 and one ulp in bf16; the MoE block against JAX's in f32
within 1e-5 (the frameworks' products sum in other orders), and bitwise
within the port across microbatches and rank counts.
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

from triton_dist_tpu.layers.ep_a2a_layer import EPAll2AllLayer as JLayer
from triton_dist_tpu.models import moe as jm
from triton_dist_tpu.ops import all_to_all as ja
from triton_dist_tpu.ops import allgather as jag
from triton_dist_tpu.ops.common import barrier_all_op as j_barrier_all_op
from triton_dist_tpu.shmem.context import initialize_distributed as jinit
from triton_dist_tpu_torch.layers import EPAll2AllLayer
from triton_dist_tpu_torch.models import moe as tm
from triton_dist_tpu_torch.models.convert import tensor_from_numpy
from triton_dist_tpu_torch.ops import all_to_all as ta
from triton_dist_tpu_torch.ops import allgather as tag
from triton_dist_tpu_torch.ops.common import barrier_all_op
from triton_dist_tpu_torch.shmem import initialize_distributed

pytestmark = pytest.mark.port

H, T, K, E = 128, 8, 2, 8           # hidden, rows a rank, top-k, experts
WIRES = {"float8_e4m3fn": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
         "int8": (jnp.int8, torch.int8)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def watchdog():
    """Each test gets 60 s; a hung collective fails instead of stalling."""
    def boom(signum, frame):
        raise TimeoutError("test exceeded its 60 s watchdog")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(60)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bits(t):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return t.contiguous().view(ints[t.element_size()])


def _equal(port, jax_arr) -> bool:
    j = _t(jax_arr)
    return port.shape == j.shape and torch.equal(_bits(port), _bits(j))


@functools.lru_cache(maxsize=None)
def _jctx(names=("x",), shape=(4,)):
    return jinit(axis_names=names, mesh_shape=shape)


def _payload(n: int, cap: int, dtype: str, seed: int = 0):
    """A wire payload [n * n, cap, H] whose rows hit the quantiser's edges:
    a zero row, a row of one value at its amax (quotients at qmax), a row of
    tiny values, a huge one."""
    x = np.random.RandomState(seed).randn(n * n, cap, H).astype(np.float32)
    x[0, 0] = 0
    x[1, 1] = 448.0 * 3
    x[2, 2] *= 1e-6
    x[3, 3] *= 1e4
    return np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32)), x


def _ids(n: int, cap: int, seed: int = 1):
    cols = ta._id_cols(cap)
    return np.random.RandomState(seed).randint(
        -1, 4, size=(n * n, cols // 128, 128)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4])
def test_plain_push_matches_jax_bitwise(n, dtype):
    x, _ = _payload(n, 16, dtype)
    ids = _ids(n, 16)
    jctx = _jctx(shape=(n,))
    jx = jnp.asarray(x, JDT[dtype])
    want = jax.jit(lambda a, b: ja.all_to_all_push(jctx, a, b, axis="x"))(
        jctx.shard(jx, P("x")), jctx.shard(jnp.asarray(ids), P("x")))
    ctx = initialize_distributed(("x",), (n,), device="cpu")
    got = ta.all_to_all_push(ctx, _t(jx.astype(jnp.float32)).to(TDT[dtype]),
                             _t(ids), axis="x")
    assert all(_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("wire,form", [
    ("float8_e4m3fn", "quant+dequant"), ("float8_e4m3fn", "quant"),
    ("float8_e4m3fn", "dequant"), ("int8", "quant+dequant")])
def test_quantised_push_matches_jax_bitwise(wire, form):
    """At 4 ranks: the quantised wire, its scale wire (padded with ones)
    and the dequantised rows."""
    n, cap = 4, 32
    jw, tw = WIRES[wire]
    x, _ = _payload(n, cap, "bfloat16")
    ids = _ids(n, cap)
    jctx = _jctx()
    jx = jnp.asarray(x, jnp.bfloat16)
    sh = lambda a: jctx.shard(a, P("x"))  # noqa: E731
    ctx = initialize_distributed(("x",), (n,), device="cpu")
    tx = _t(jx.astype(jnp.float32)).to(torch.bfloat16)
    if form == "dequant":
        q, s = jax.jit(lambda v: ja._quant(v, jw))(jx.reshape(-1, H))
        sc = jnp.ones((n * n, ta._id_cols(cap)), jnp.float32).at[
            :, :cap].set(s.reshape(n * n, cap)).reshape(n * n, -1, 128)
        q = q.reshape(jx.shape)
        want = jax.jit(lambda a, b, c: ja.all_to_all_push(
            jctx, a, b, c, axis="x", dequant_to=jnp.bfloat16))(
            sh(q), sh(jnp.asarray(ids)), sh(sc))
        tq = _t(np.asarray(q).view(np.uint8)).view(tw)
        got = ta.all_to_all_push(ctx, tq, _t(ids), _t(sc), axis="x",
                                 dequant_to=torch.bfloat16)
    else:
        deq = {"dequant_to": jnp.bfloat16} if form == "quant+dequant" else {}
        # the reference's send-side quantise in its kernel returns NaN
        # scales for the remote slots in interpret mode on this CPU (its
        # local slot's are right); its unfused form, one quantise pass in
        # front of the wire, is the same arithmetic by its own docstring
        want = jax.jit(lambda a, b: ja.all_to_all_push(
            jctx, a, b, axis="x", quant_from=jw, fuse_quant=False, **deq))(
            sh(jx), sh(jnp.asarray(ids)))
        got = ta.all_to_all_push(
            ctx, tx, _t(ids), axis="x", quant_from=tw,
            **({"dequant_to": torch.bfloat16} if deq else {}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.itemsize == 1 and w.dtype != np.int8:
            assert torch.equal(_bits(g), _t(w.view(np.uint8))), form
        else:
            assert _equal(g, w), form


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
def test_quant_matches_compiled_jax(wire, dtype):
    """``_quant`` bitwise JAX's jitted ``_quant``, zero rows and quotients
    a hair from qmax included; eager JAX divides by qmax instead of
    multiplying by its reciprocal, and differs by an ulp on some rows."""
    jw, tw = WIRES[wire]
    rs = np.random.RandomState(3)
    x = (rs.randn(2048, H) * rs.rand(2048, 1) * 10).astype(np.float32)
    x[0] = 0
    x[1] = 1344.0
    x[2, ::2] = -7.0
    jx = jnp.asarray(x, JDT[dtype])
    qj, sj = jax.jit(lambda v: ja._quant(v, jw))(jx)
    qt, st = ta._quant(_t(jx.astype(jnp.float32)).to(TDT[dtype]), tw)
    assert np.array_equal(np.asarray(sj), st.numpy())
    assert np.array_equal(np.asarray(qj).view(np.uint8),
                          qt.view(torch.uint8).numpy())
    assert st[0] == 1 and not qt[0].float().any()
    _, se = ja._quant(jx, jw)                          # eager: a division
    assert np.abs(np.asarray(se).view(np.int32)
                  - np.asarray(sj).view(np.int32)).max() <= 1


EDGES = [("none", None, "fused", "post", "bfloat16"),
         ("fp8-pre", "float8_e4m3fn", "pre", "post", "bfloat16"),
         ("fp8-kernel", "float8_e4m3fn", "kernel", "kernel", "float32"),
         ("int8-fused", "int8", "fused", "post", "bfloat16")]


@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_dispatch_combine_match_jax(edge):
    """At 4 ranks: the received rows, ids and the routing layout bitwise
    JAX's; the combine within 1e-6 (f32) or one ulp (bf16)."""
    _, wire, qe, de, dtype = edge
    n = 4
    rs = np.random.RandomState(5)
    tokens = np.asarray(jnp.asarray(rs.randn(n * T, H).astype(np.float32),
                                    JDT[dtype]).astype(jnp.float32))
    ids = rs.randint(0, E, size=(n * T, K)).astype(np.int32)
    ids[:, 1] = (ids[:, 0] + 1 + rs.randint(0, E - 1, size=n * T)) % E
    w = rs.rand(n * T, K).astype(np.float32)
    jctx = _jctx()
    jw = None if wire is None else WIRES[wire][0]
    tw = None if wire is None else WIRES[wire][1]
    jlay = JLayer.create(jctx, max_tokens=T, hidden=H, topk=K, num_experts=E,
                         axis="x", dtype=JDT[dtype], wire_dtype=jw,
                         quant_edge=qe, dequant_edge=de)

    def jrun(tok, i, wt):
        rt, rid, lay = jlay.dispatch(tok, i)
        out = jlay.combine(rt * 1.5, lay, wt)
        return rt, rid, lay, out

    jt = jnp.asarray(tokens, JDT[dtype])
    rt, rid, (d, s, v), out = jax.jit(jrun)(
        jctx.shard(jt, P("x")), jctx.shard(jnp.asarray(ids), P("x")),
        jctx.shard(jnp.asarray(w), P("x")))
    ctx = initialize_distributed(("x",), (n,), device="cpu")
    lay = EPAll2AllLayer.create(ctx, max_tokens=T, hidden=H, topk=K,
                                num_experts=E, axis="x", dtype=TDT[dtype],
                                wire_dtype=tw, quant_edge=qe,
                                dequant_edge=de)
    trt, trid, (td, tsl, tv) = lay.dispatch(_t(tokens).to(TDT[dtype]),
                                            _t(ids))
    assert _equal(trt, rt) and _equal(trid, rid)
    assert _equal(td, d) and _equal(tsl, s)
    assert torch.equal(tv, _t(v))
    assert all(torch.equal(a, b) for a, b in zip(lay.preprocess(_t(ids)),
                                                  (td, tsl, tv)))
    tout = lay.combine(trt * 1.5, (td, tsl, tv), _t(w))
    if dtype == "float32":
        np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-6,
                                   rtol=0)
    else:
        diff = (_bits(tout).int() - _t(np.asarray(out).view(np.int16))
                .int()).abs()
        assert diff.max() <= 1


def test_seg_chunks_and_seg_push_match():
    """``_seg_chunks`` is the reference's split; B22's plain version gives
    B21's outputs bitwise, the quantised wire too."""
    for shape, isz in (((4, 16, 128), 2), ((4, 128, 4096), 1),
                       ((4, 1, 128), 4), ((4, 256), 2), ((2, 64, 128), 4)):
        for seg in (1, 2, 3):
            assert ta._seg_chunks(shape, seg, isz) == \
                ja._seg_chunks(shape, seg, isz)
    n, cap = 4, 32
    ctx = initialize_distributed(("x",), (n,), device="cpu")
    x = _t(_payload(n, cap, "bfloat16")[0]).to(torch.bfloat16)
    ids = _t(_ids(n, cap))
    for kw in ({}, {"quant_from": torch.float8_e4m3fn},
               {"quant_from": torch.int8, "dequant_to": torch.bfloat16}):
        a = ta.all_to_all_push(ctx, x, ids, axis="x", **kw)
        b = ta.all_to_all_push_seg(ctx, x, ids, axis="x", segments=2, **kw)
        assert all(torch.equal(_bits(u), _bits(v)) for u, v in zip(a, b))


def test_wire_bytes_pick_capacity_and_routing_match_jax():
    fit = {"bf16": {"t0_us": 40.0, "gb_per_s": 600.0},
           "fp8": {"t0_us": 70.0, "gb_per_s": 600.0}}
    for n in (1, 2, 4, 8):
        for mt in (1, 2, 4, 32, 128, 512):
            for hidden in (128, 4096, 7168):
                for wire in (None, (jnp.float8_e4m3fn, torch.float8_e4m3fn)):
                    assert ta.a2a_wire_bytes(
                        n, mt, hidden, 2, wire and wire[1]) == \
                        ja.a2a_wire_bytes(n, mt, hidden, 2, wire and wire[0])
                for f in (fit, None):
                    jp = ja.pick_wire_dtype(n, mt, hidden, 8, wire_fit=f or
                                            ta.WIRE_FIT)
                    tp = ta.pick_wire_dtype(n, mt, hidden, 8, wire_fit=f)
                    assert (jp is None) == (tp is None)
            for wire in (None, (jnp.int8, torch.int8)):
                assert ta.expected_capacity(n, mt, 8, 1.5, wire and wire[1]) \
                    == ja.expected_capacity(n, mt, 8, 1.5, wire and wire[0])
    for cap in (1, 15, 16, 17, 100, 128, 129, 4096):
        assert ta._id_cols(cap) == ja._id_cols(cap)
        for isz in (1, 2, 4):
            assert ta._cap_round(cap, isz) == ja._cap_round(cap, isz)
    ids = np.random.RandomState(2).randint(0, E, size=(T, K)).astype(np.int32)
    jctx, ctx = _jctx((("x",)), (2,)), initialize_distributed(("x",), (2,),
                                                             device="cpu")
    ja2 = ja.create_all_to_all_context(jctx, T, H, K, E, capacity=4)
    ta2 = ta.create_all_to_all_context(ctx, T, H, K, E, capacity=4)
    jr = ja.route_tokens(ja2, jnp.asarray(ids))
    tr = ta.route_tokens(ta2, ids)
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in
               zip(jr, tr))


@pytest.mark.parametrize("kw", [{"expert_major": True},
                                {"dequant_edge": "expert",
                                 "wire_dtype": torch.float8_e4m3fn},
                                {"axis": ("x", "y")}],
                         ids=["expert-major", "expert-edge", "2-tier"])
def test_ep_forms_outside_the_slice_raise(kw):
    """Named for the EP forms that an earlier slice of the port refused;
    each now runs on a (2, 2) mesh: identity experts (the expert edge's
    rows dequantised) and top-k weights of 1/k bring every row back,
    exactly on the plain wire and within two fp8 roundings (2 * 2**-4 of
    the row's scale) on the expert edge. Microbatches still refuse the
    expert-major and the 2-tier layer (ValueError, as the reference)."""
    ctx = initialize_distributed(("x", "y"), (2, 2), device="cpu")
    kw = dict({"axis": "x"}, **kw)
    lay = EPAll2AllLayer.create(ctx, T, H, K, E, dtype=torch.float32, **kw)
    n = lay.a2a.n_ranks
    tokens, ids = _distinct_ids_rows(n)
    recv, _, layout = lay.dispatch(tokens, ids)
    if isinstance(recv, ta.QuantTokens):
        recv = recv.q.float() * recv.scale[..., None]
    out = lay.combine(recv, layout, torch.full((n * T, K), 1.0 / K))
    err = (out - tokens).abs().amax(-1) / tokens.abs().amax(-1)
    assert err.max() <= (0.0 if "wire_dtype" not in kw else 2 * 2 ** -4)
    if "wire_dtype" not in kw:
        with pytest.raises(ValueError, match="microbatches"):
            tm.moe_mlp_ep_overlap(ctx, lay, tokens, torch.rand(H, E),
                                  torch.zeros(E, H, 64),
                                  torch.zeros(E, H, 64),
                                  torch.zeros(E, 64, H), microbatches=2)


def _distinct_ids_rows(n: int):
    """Rows of every rank and top-k ids with k distinct experts a row."""
    rs = np.random.RandomState(13)
    ids = rs.randint(0, E, size=(n * T, K)).astype(np.int32)
    ids[:, 1] = (ids[:, 0] + 1 + rs.randint(0, E - 1, size=n * T)) % E
    return _t(rs.randn(n * T, H).astype(np.float32)), _t(ids)


GROUPS = [((("a", "b")), (2, 2), "a"), ((("a", "b")), (2, 2), "b"),
          ((("a", "b")), (2, 3), "b"), ((("t", "s", "e")), (2, 2, 2), "s"),
          ((("t", "s", "e")), (2, 2, 2), "e")]


@pytest.mark.parametrize("group", GROUPS,
                         ids=["2x2-a", "2x2-b", "2x3-b", "2x2x2-s",
                              "2x2x2-e"])
def test_gather_and_barrier_inside_a_mesh_match_jax(group):
    """B9 over a group inside a 2-D and a 3-D mesh: every rank's replica
    bitwise JAX's (each device's); B14 over the group returns every rank's
    1, as JAX's returns its ones."""
    names, shape, axis = group
    n = int(np.prod([shape[names.index(a)] for a in
                     ((axis,) if isinstance(axis, str) else axis)]))
    x = np.random.RandomState(4).randn(n * 4, 128).astype(np.float32)
    jctx = _jctx(names, shape)
    want = jax.jit(lambda v: jag.all_gather(jctx, v, axis=axis,
                                            method="push"))(
        jctx.shard(jnp.asarray(x), P(axis)))
    replicas = [np.asarray(s.data) for s in want.addressable_shards]
    ctx = initialize_distributed(names, shape, device="cpu")
    got = tag.all_gather(ctx, _t(x), axis=axis, method="push")
    assert got.shape == (ctx.num_ranks, n * 4, 128)
    for r in range(ctx.num_ranks):
        assert all(np.array_equal(got[r].numpy(), rep) for rep in replicas)
    assert np.array_equal(np.asarray(j_barrier_all_op(
        jctx, axis if isinstance(axis, str) else None)()), np.ones(shape[0]))
    assert torch.equal(barrier_all_op(ctx, axis)(),
                       torch.ones(ctx.num_ranks, dtype=torch.int32))


@pytest.fixture(scope="module")
def micro_moe():
    """Layer 0 of a micro MoE block (d_model 128, 8 experts of width 64,
    f32), numpy normals handed to both frameworks."""
    rs = np.random.RandomState(12)
    shapes = {"w_router": (128, E), "we_gate": (E, 128, 64),
              "we_up": (E, 128, 64), "we_down": (E, 64, 128)}
    ws = {k: (rs.randn(*v) * 0.05).astype(np.float32)
          for k, v in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in ws.items()},
            {k: _t(v) for k, v in ws.items()})


def test_moe_block_at_ep4_matches_jax(micro_moe):
    """``moe_mlp_ep_overlap`` at ep = 4 within 1e-5 of JAX's (the plain
    wire); with the fp8 wire, M = 2 microbatches (over B22) bitwise M = 1,
    and bitwise the block at ep = 1 on the same rows."""
    jp, tp = micro_moe
    n, rows = 4, 16
    x = np.random.RandomState(6).randn(rows, 128).astype(np.float32)
    jctx = _jctx()
    jlay = JLayer.create(jctx, max_tokens=rows // n, hidden=128, topk=K,
                         num_experts=E, axis="x", dtype=jnp.float32)
    ws = ("w_router", "we_gate", "we_up", "we_down")
    want = jax.jit(lambda v, *w: jm.moe_mlp_ep_overlap(
        jctx, jlay, v, *w, axis="x", block_m=16))(
        jctx.shard(jnp.asarray(x), P("x")), *(jp[k] for k in ws))
    ctx = initialize_distributed(("x",), (n,), device="cpu")
    plain = tm.moe_mlp_ep_overlap(
        ctx, EPAll2AllLayer.create(ctx, rows // n, 128, K, E, axis="x",
                                   dtype=torch.float32),
        _t(x), *(tp[k] for k in ws), block_m=16)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    outs = {}
    for ranks in (1, n):
        ctx = initialize_distributed(("x",), (ranks,), device="cpu")
        lay = EPAll2AllLayer.create(ctx, rows // ranks, 128, K, E, axis="x",
                                    dtype=torch.float32,
                                    wire_dtype=torch.float8_e4m3fn)
        for m in (1, 2):
            la = lay if m == 1 else dataclasses.replace(
                lay, a2a=dataclasses.replace(lay.a2a, seg_push=2))
            outs[ranks, m] = tm.moe_mlp_ep_overlap(
                ctx, la, _t(x), *(tp[k] for k in ws), block_m=16,
                microbatches=m)
    for key in ((n, 2), (1, 1), (1, 2)):
        assert torch.equal(outs[key], outs[n, 1]), key


def test_plain_wire_block_is_the_same_at_every_ep_size(micro_moe):
    """With the plain wire, the block at ep = 2 and 4 is bitwise the block
    at ep = 1 on the same rows, and at ep = 1 the aligned row block does
    not change a bit."""
    _, tp = micro_moe
    rows = 12
    x = _t(np.random.RandomState(8).randn(rows, 128).astype(np.float32))
    ws = [tp[k] for k in ("w_router", "we_gate", "we_up", "we_down")]
    outs = {}
    for n, bm in ((1, 16), (1, 64), (2, 16), (4, 16)):
        ctx = initialize_distributed(("x",), (n,), device="cpu")
        lay = EPAll2AllLayer.create(ctx, rows // n, 128, K, E, axis="x",
                                    dtype=torch.float32)
        outs[n, bm] = tm.moe_mlp_ep_overlap(ctx, lay, x, *ws, block_m=bm)
    for key in ((1, 64), (2, 16), (4, 16)):
        assert torch.equal(outs[key], outs[1, 16]), key
