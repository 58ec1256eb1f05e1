"""The deployed EP MoE block of the port against the JAX package on the same
numpy inputs: the grouped GEMMs' options (``row_scale`` on int8 rows, the
packed gate‖up stream, ``block_k``, ``prefetch_depth``), ``route_tokens``
under ``expert_major``, ``dispatch``/``combine`` on the expert edge of an
fp8 and an int8 wire, the 2-tier ``dispatch_2d``/``combine_2d`` and the
block over a (2, 3) mesh, ``moe_mlp_ep_overlap`` in its deployed form
(expert-major slots, fp8 on the expert edge, packed weights) at one and two
ranks, and ``moe_decode_step_sp`` with that layer.

On the CPU every wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode on the conftest's virtual CPU devices,
one-device meshes where the op allows. The CUDA kernels are held against
the plain versions on the card by ``chip_smoke.py`` phase 21. Tolerances:
the packing, the routing, the wire rows, ids and scales are copies or the
same f32 arithmetic, bitwise; a grouped GEMM 1e-5 of its scale in f32 and
2e-2 in bf16 (both sum in f32 in other orders and round once); the combine
and the blocks 1e-5 of their scale in f32 (another order of the same f32
sums), the 2-tier block 2e-2 in bf16; within the port, the packed stream,
every ``block_k`` and every depth bitwise the plain form, and expert-major
slots bitwise rank-major ones where no row drops.
"""

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
from triton_dist_tpu.ops import all_to_all as ja
from triton_dist_tpu.ops import group_gemm as jg
from triton_dist_tpu.shmem.context import initialize_distributed as jinit
from triton_dist_tpu_torch.layers import EPAll2AllLayer
from triton_dist_tpu_torch.models import llama as tl
from triton_dist_tpu_torch.models import moe as tm
from triton_dist_tpu_torch.models.convert import (packed_from_jax,
                                                  params_from_jax,
                                                  tensor_from_numpy)
from triton_dist_tpu_torch.ops import all_to_all as ta
from triton_dist_tpu_torch.ops import group_gemm as tg
from triton_dist_tpu_torch.shmem import initialize_distributed

pytestmark = pytest.mark.port

E, H, F, BM, BN = 4, 128, 256, 16, 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WIRES = {"float8_e4m3fn": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
         "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch ops run far slower beside JAX's interpret-mode threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jctx(names=("x",), shape=(1,)):
    return jinit(axis_names=names, mesh_shape=shape)


def _t(a):
    """A numpy or JAX array as a CPU tensor, bit for bit (fp8 through its
    bytes)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return tensor_from_numpy(a.view(np.uint8), "cpu").view(
            torch.float8_e4m3fn)
    return tensor_from_numpy(a, "cpu")


def _bits(t):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return t.contiguous().view(ints[t.element_size()])


def _equal(port, jax_arr) -> bool:
    j = _t(jax_arr)
    return port.shape == j.shape and torch.equal(_bits(port), _bits(j))


def _rel(got, want) -> float:
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(g.astype(np.float32) - w).max() / np.abs(w).max())


# ---------------------------------------------------------------------------
# the grouped GEMMs' options
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemm_data():
    """Expert-aligned int8 rows (their scales), bf16-valued weights, the
    block table with blocks past the bound."""
    rng = np.random.RandomState(3)
    ids = rng.randint(0, E - 1, 40).astype(np.int32)
    g, v, be, nb = (np.array(a) for a in jg.align_tokens_by_expert(
        jnp.asarray(ids), E, BM, with_used_count=True))
    q = np.where(v[:, None], rng.randint(-127, 128, (40, H))[g], 0)
    scale = np.where(v, rng.rand(40)[g] * 0.01 + 1e-3, 1.0)
    w = {k: np.asarray(jnp.asarray(rng.randn(*s) * 0.05, jnp.bfloat16)
                       .astype(jnp.float32))
         for k, s in (("wg", (E, H, F)), ("wu", (E, H, F)),
                      ("wd", (E, F, H)))}
    assert int(nb) < len(be)
    return dict(q=q.astype(np.int8), scale=scale.astype(np.float32), be=be,
                nb=int(nb), **w)


def test_pack_gated_weights_matches_jax_bitwise(gemm_data):
    """The interleave bitwise JAX's, carried with its width; JAX's packed
    array through ``packed_from_jax`` is the port's pack; a width that does
    not divide F, or two other shapes, are refused."""
    d = gemm_data
    jw = jg.pack_gated_weights(jnp.asarray(d["wg"], jnp.bfloat16),
                               jnp.asarray(d["wu"], jnp.bfloat16), BN)
    tw = tg.pack_gated_weights(_t(d["wg"]).bfloat16(),
                               _t(d["wu"]).bfloat16(), BN)
    assert tw.block_n == BN and tw.shape == (E, H, 2 * F)
    assert _equal(tw.w, jw.w)
    conv = packed_from_jax(np.asarray(jw.w), BN, device="cpu")
    assert conv.block_n == BN and torch.equal(_bits(conv.w), _bits(tw.w))
    g, u = tg.unpack_gated_weights(tw.w, BN)
    assert torch.equal(g.float(), _t(d["wg"])) and \
        torch.equal(u.float(), _t(d["wu"]))
    with pytest.raises(ValueError):
        tg.pack_gated_weights(_t(d["wg"]), _t(d["wu"]), 96)
    with pytest.raises(ValueError):
        tg.pack_gated_weights(_t(d["wg"]), _t(d["wd"]), BN)
    with pytest.raises(ValueError):
        packed_from_jax(np.asarray(jw.w), 96, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_int8_rows_packed_and_k_split_match_jax(gemm_data, dtype):
    """int8 rows with ``row_scale`` through ``grouped_gemm`` (K split in 2)
    and ``grouped_gemm_gated`` over the packed stream (K split in 4), the
    used rows within the dtype's tolerance of JAX's; each option bitwise
    the port's plain form, at every ring depth."""
    d = gemm_data
    jdt, tdt = JDT[dtype], TDT[dtype]
    nb, be = d["nb"], d["be"]
    rows = nb * BM
    jq, jsc = jnp.asarray(d["q"]), jnp.asarray(d["scale"])
    tq, tsc, tbe = _t(d["q"]), _t(d["scale"]), torch.from_numpy(be)
    jw = {k: jnp.asarray(d[k], jdt) for k in ("wg", "wu", "wd")}
    tw = {k: _t(d[k]).to(tdt) for k in ("wg", "wu", "wd")}
    jpk = jg.pack_gated_weights(jw["wg"], jw["wu"], BN)
    tpk = tg.pack_gated_weights(tw["wg"], tw["wu"], BN)

    want_g = jg.grouped_gemm_gated(
        jq, jpk, None, jnp.asarray(be), block_m=BM, block_n=BN,
        n_blocks_used=jnp.int32(nb), row_scale=jsc, block_k=32,
        packed=True)
    got_g = tg.grouped_gemm_gated(
        tq, tpk, None, tbe, block_m=BM, block_n=BN, n_blocks_used=nb,
        row_scale=tsc, block_k=32, packed=True, prefetch_depth=3)
    assert got_g.dtype == tdt
    assert _rel(got_g[:rows], np.asarray(want_g)[:rows]) <= TOL[dtype]
    two_streams = tg.grouped_gemm_gated(tq, tw["wg"], tw["wu"], tbe,
                                        block_m=BM, n_blocks_used=nb,
                                        row_scale=tsc)
    assert torch.equal(got_g, two_streams)
    for depth in (1, 2, 4):
        assert torch.equal(two_streams, tg.grouped_gemm_gated(
            tq, tw["wg"], tw["wu"], tbe, block_m=BM, n_blocks_used=nb,
            row_scale=tsc, prefetch_depth=depth))

    want = jg.grouped_gemm(jq, jw["wg"], jnp.asarray(be), block_m=BM,
                           n_blocks_used=jnp.int32(nb), row_scale=jsc,
                           block_k=64)
    got = tg.grouped_gemm(tq, tw["wg"], tbe, block_m=BM, n_blocks_used=nb,
                          row_scale=tsc, block_k=64)
    assert got.dtype == tdt
    assert _rel(got[:rows], np.asarray(want)[:rows]) <= TOL[dtype]
    assert torch.equal(got, tg.grouped_gemm(tq, tw["wg"], tbe, block_m=BM,
                                            n_blocks_used=nb, row_scale=tsc))
    assert not got[rows:].float().any()


def test_grouped_options_are_checked(gemm_data):
    """The reference's refusals: a pack width other than the packed one,
    packed off the bounded path or with w_up, a block_k not dividing H."""
    d = gemm_data
    x = _t(d["q"]).float()
    be = torch.from_numpy(d["be"])
    pk = tg.pack_gated_weights(_t(d["wg"]), _t(d["wu"]), BN)
    for kw in (dict(block_n=128, n_blocks_used=2),
               dict(block_n=BN, n_blocks_used=None)):
        with pytest.raises(ValueError):
            tg.grouped_gemm_gated(x, pk, None, be, block_m=BM, packed=True,
                                  **kw)
    with pytest.raises(ValueError):
        tg.grouped_gemm_gated(x, pk, _t(d["wu"]), be, block_m=BM,
                              packed=True, block_n=BN, n_blocks_used=2)
    with pytest.raises(ValueError):
        tg.grouped_gemm(x, _t(d["wg"]), be, block_m=BM, block_k=48)
    with pytest.raises(ValueError):
        tg.grouped_gemm_gated(x, _t(d["wg"]), _t(d["wu"]), be, block_m=BM,
                              prefetch_depth=0)


def test_apply_grouped_scales_rows_as_jax():
    """``apply_grouped`` gathers each row's scale through the alignment (1
    for an empty aligned row) and passes it on, as JAX's does."""
    rng = np.random.RandomState(4)
    ids = rng.randint(-1, E, 24).astype(np.int32)
    q = rng.randint(-127, 128, (24, H)).astype(np.int8)
    sc = (rng.rand(24) + 0.5).astype(np.float32)

    want = jax.jit(lambda a, b, c: jg.apply_grouped(
        a, b, E, lambda x, be, nb, s: x.astype(jnp.float32) * s[:, None],
        block_m=BM, row_scale=c))(jnp.asarray(q), jnp.asarray(ids),
                                  jnp.asarray(sc))
    got = tg.apply_grouped(_t(q), torch.from_numpy(ids), E,
                           lambda x, be, nb, s: x.float() * s[:, None],
                           block_m=BM, row_scale=_t(sc))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the EP wire's deployed forms
# ---------------------------------------------------------------------------

T, K, EE, HH = 8, 2, 8, 128       # rows a rank, top-k, experts, hidden


def _ep_inputs(n: int, seed: int = 5, experts: int = EE):
    rs = np.random.RandomState(seed)
    tokens = rs.randn(n * T, HH).astype(np.float32)
    ids = rs.randint(0, experts, size=(n * T, K)).astype(np.int32)
    ids[:, 1] = (ids[:, 0] + 1 + rs.randint(0, experts - 1, size=n * T)) \
        % experts
    w = rs.rand(n * T, K).astype(np.float32)
    return tokens, ids, w


def test_expert_major_routing_matches_jax_bitwise():
    """Slots counted per global expert over ``capacity_per_expert``, a
    tight budget so some rows drop: JAX's (dest, slot, valid) bitwise; the
    capacity split and rounded as JAX's."""
    n = 2
    jctx, ctx = _jctx(shape=(n,)), initialize_distributed(("x",), (n,),
                                                          device="cpu")
    for wire, cap in ((None, 6), ((jnp.int8, torch.int8), 40)):
        jc = ja.create_all_to_all_context(jctx, T, HH, K, EE, capacity=cap,
                                          expert_major=True,
                                          wire_dtype=wire and wire[0])
        tc = ta.create_all_to_all_context(ctx, T, HH, K, EE, capacity=cap,
                                          expert_major=True,
                                          wire_dtype=wire and wire[1])
        assert (tc.capacity, tc.capacity_per_expert) == \
            (jc.capacity, jc.capacity_per_expert)
        _, ids, _ = _ep_inputs(1, seed=9)
        want = ja.route_tokens(jc, jnp.asarray(ids))
        got = ta.route_tokens(tc, ids)
        assert all(np.array_equal(np.asarray(a), b.numpy())
                   for a, b in zip(want, got))
    assert not np.asarray(want[2]).all() or cap >= T * K


EXPERT_EDGES = [("fp8-fused", "float8_e4m3fn", "fused", False),
                ("int8-pre-em", "int8", "pre", True),
                ("fp8-kernel-em", "float8_e4m3fn", "kernel", True)]


@pytest.mark.parametrize("edge", EXPERT_EDGES, ids=[e[0] for e in EXPERT_EDGES])
def test_expert_edge_dispatch_combine_match_jax(edge):
    """At 2 ranks, f32 compute: the wire rows, their scales and the ids
    bitwise JAX's ``QuantTokens``; the combine (the return trip quantised,
    each row's scale folded into the f32 sum) within 1e-5 of its scale.
    The expert-major cases route over 4 experts, so the capacity stays
    under 128 slots: there JAX quantises the return trip in one XLA pass,
    where its in-kernel quantise returns NaN scales for remote slots in
    interpret mode."""
    _, wire, qe, em = edge
    jw, tw = WIRES[wire]
    n, experts = 2, (4 if em else EE)
    tokens, ids, w = _ep_inputs(n, experts=experts)
    jctx = _jctx(shape=(n,))
    jlay = JLayer.create(jctx, max_tokens=T, hidden=HH, topk=K,
                         num_experts=experts, axis="x", dtype=jnp.float32,
                         wire_dtype=jw, quant_edge=qe, dequant_edge="expert",
                         expert_major=em)

    def jrun(tok, i, wt):
        rt, rid, lay = jlay.dispatch(tok, i)
        processed = rt.q.astype(jnp.float32) * rt.scale[..., None] * 1.5
        return rt.q, rt.scale, rid, jlay.combine(processed, lay, wt)

    q, sc, rid, out = jax.jit(jrun)(
        jctx.shard(jnp.asarray(tokens), P("x")),
        jctx.shard(jnp.asarray(ids), P("x")),
        jctx.shard(jnp.asarray(w), P("x")))
    ctx = initialize_distributed(("x",), (n,), device="cpu")
    lay = EPAll2AllLayer.create(ctx, T, HH, K, experts, axis="x",
                                dtype=torch.float32, wire_dtype=tw,
                                quant_edge=qe, dequant_edge="expert",
                                expert_major=em)
    assert lay.a2a.capacity < 128
    rt, trid, layout = lay.dispatch(_t(tokens), _t(ids))
    assert isinstance(rt, ta.QuantTokens)
    if wire == "int8":
        assert _equal(rt.q, q)
    else:
        assert torch.equal(_bits(rt.q), _t(np.asarray(q).view(np.uint8)))
    assert _equal(rt.scale, sc) and _equal(trid, rid)
    processed = rt.q.float() * rt.scale[..., None] * 1.5
    assert _rel(lay.combine(processed, layout, _t(w)), out) <= 1e-5


# ---------------------------------------------------------------------------
# the 2-tier context
# ---------------------------------------------------------------------------

MESH_2D = (("a", "b"), (2, 3))


def test_dispatch_2d_combine_2d_match_jax():
    """On (2, 3) with an int8 wire on the expert edge: tier 1's plan, the
    received rows, scales and ids bitwise JAX's; the combine within 1e-5
    of its scale (f32); the bf16 wire within the port bitwise the flat
    1-D dispatch's rows per expert; a 2-tier layer refuses
    ``expert_major``."""
    names, shape = MESH_2D
    n = shape[0] * shape[1]
    tokens, ids, w = _ep_inputs(n, seed=11)
    ids = ids % (2 * n)
    jctx = _jctx(names, shape)
    jlay = JLayer.create(jctx, max_tokens=T, hidden=HH, topk=K,
                         num_experts=2 * n, axis=names, dtype=jnp.float32,
                         wire_dtype=jnp.int8, dequant_edge="expert")
    spec = P(names)

    def jrun(tok, i, wt):
        rt, rid, lays = jlay.dispatch(tok, i)
        processed = rt.q.astype(jnp.float32) * rt.scale[..., None]
        return rt.q, rt.scale, rid, lays[0], jlay.combine(processed, lays,
                                                           wt)

    q, sc, rid, plan1, out = jax.jit(jrun)(
        jctx.shard(jnp.asarray(tokens), spec),
        jctx.shard(jnp.asarray(ids), spec), jctx.shard(jnp.asarray(w), spec))
    ctx = initialize_distributed(names, shape, device="cpu")
    lay = EPAll2AllLayer.create(ctx, T, HH, K, 2 * n, axis=names,
                                dtype=torch.float32, wire_dtype=torch.int8,
                                dequant_edge="expert")
    assert lay.is_2d
    rt, trid, layouts = lay.dispatch(_t(tokens), _t(ids))
    assert _equal(rt.q, q) and _equal(rt.scale, sc) and _equal(trid, rid)
    assert all(_equal(a, b) for a, b in zip(layouts[0], plan1))
    assert all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in
               zip(lay.preprocess(_t(ids)), layouts[0]))
    processed = rt.q.float() * rt.scale[..., None]
    assert _rel(lay.combine(processed, layouts, _t(w)), out) <= 1e-5
    with pytest.raises(ValueError):
        EPAll2AllLayer.create(ctx, T, HH, K, 2 * n, axis=names,
                              expert_major=True)


@pytest.fixture(scope="module")
def moe_weights():
    """One MoE layer (d_model 128, experts of width 128) for 12 experts,
    numpy normals."""
    rs = np.random.RandomState(12)
    shapes = {"w_router": (HH, 12), "we_gate": (12, HH, 128),
              "we_up": (12, HH, 128), "we_down": (12, 128, HH)}
    return {k: (rs.randn(*v) * (0.3 if k == "w_router" else 0.1))
            .astype(np.float32) for k, v in shapes.items()}


WS = ("w_router", "we_gate", "we_up", "we_down")


def test_moe_block_over_two_tiers_matches_jax(moe_weights):
    """``moe_mlp_ep_overlap`` over a 2-tier layer on (2, 3) in bf16 (the
    rows, the gate, up and down weights bf16, the router f32) within 2e-2
    of JAX's scale; within the port bitwise the flat 1-D block over the
    six ranks, and with the fp8 wire on the expert edge within 5e-2 of
    it (one quantisation each way)."""
    names, shape = MESH_2D
    n = shape[0] * shape[1]
    x = np.asarray(jnp.asarray(np.random.RandomState(6).randn(n * T, HH)
                               * 0.3, jnp.bfloat16).astype(jnp.float32))
    bf = {k: (jnp.asarray(v, jnp.float32) if k == "w_router" else
              jnp.asarray(v, jnp.bfloat16)) for k, v in moe_weights.items()}
    jctx = _jctx(names, shape)
    jlay = JLayer.create(jctx, max_tokens=T, hidden=HH, topk=K,
                         num_experts=12, axis=names)
    want = jax.jit(lambda v, *ws: jm.moe_mlp_ep_overlap(
        jctx, jlay, v, *ws, block_m=16))(
        jctx.shard(jnp.asarray(x, jnp.bfloat16), P(names)),
        *(bf[k] for k in WS))
    tw = [_t(np.asarray(bf[k])) for k in WS]
    tx = _t(x).bfloat16()
    ctx = initialize_distributed(names, shape, device="cpu")
    got = tm.moe_mlp_ep_overlap(
        ctx, EPAll2AllLayer.create(ctx, T, HH, K, 12, axis=names), tx, *tw,
        block_m=16)
    assert _rel(got, want) <= TOL["bfloat16"]
    flat_ctx = initialize_distributed(("x",), (n,), device="cpu")
    flat = tm.moe_mlp_ep_overlap(
        flat_ctx, EPAll2AllLayer.create(flat_ctx, T, HH, K, 12, axis="x"),
        tx, *tw, block_m=16)
    assert torch.equal(got, flat)
    fp8 = tm.moe_mlp_ep_overlap(
        ctx, EPAll2AllLayer.create(ctx, T, HH, K, 12, axis=names,
                                   wire_dtype=torch.float8_e4m3fn,
                                   dequant_edge="expert"), tx, *tw,
        block_m=16)
    assert _rel(fp8, flat.float().numpy()) <= 5e-2


# ---------------------------------------------------------------------------
# the deployed block and the decode step
# ---------------------------------------------------------------------------

EXPERTS_DEPLOYED = 4   # expert-major capacities under 128 slots at 2 ranks


def _deployed(lib_layer, ctx, rows: int, dtype, **kw):
    return lib_layer.create(ctx, rows, HH, K, EXPERTS_DEPLOYED, axis="x",
                            dtype=dtype, expert_major=True,
                            dequant_edge="expert", **kw)


@pytest.mark.parametrize("n", [1, 2])
def test_deployed_block_matches_jax(moe_weights, n):
    """``moe_mlp_ep_overlap`` with an expert-major layer, the fp8 wire on
    the expert edge and the packed gate‖up stream (f32 compute), within
    1e-5 of JAX's scale; within the port bitwise its two-stream form, and
    at ep = 1 the fast path (a budget a multiple of block_m, no alignment)
    bitwise the aligned one. Four experts keep the capacity at two ranks
    under 128 slots (see ``test_expert_edge_dispatch_combine_match_jax``)."""
    rows = 16 // n
    ws = {k: v[:, :EXPERTS_DEPLOYED] if k == "w_router"
          else v[:EXPERTS_DEPLOYED] for k, v in moe_weights.items()}
    x = np.random.RandomState(7).randn(16, HH).astype(np.float32)
    jctx = _jctx(shape=(n,))
    jlay = _deployed(JLayer, jctx, rows, jnp.float32,
                     wire_dtype=jnp.float8_e4m3fn)
    jw = {k: jnp.asarray(v) for k, v in ws.items()}
    jpk = jg.pack_gated_weights(jw["we_gate"], jw["we_up"], BN)
    want = jax.jit(lambda v, pk, *w: jm.moe_mlp_ep_overlap(
        jctx, jlay, v, *w, block_m=16, block_n=BN, we_gate_up_packed=pk))(
        jctx.shard(jnp.asarray(x), P("x")), jpk, *(jw[k] for k in WS))
    ctx = initialize_distributed(("x",), (n,), device="cpu")
    lay = _deployed(EPAll2AllLayer, ctx, rows, torch.float32,
                    wire_dtype=torch.float8_e4m3fn)
    tw = [_t(ws[k]) for k in WS]
    tpk = packed_from_jax(np.asarray(jpk.w), BN, device="cpu")
    got = tm.moe_mlp_ep_overlap(ctx, lay, _t(x), *tw, block_m=16,
                                block_n=BN, we_gate_up_packed=tpk)
    assert _rel(got, want) <= TOL["float32"]
    assert torch.equal(got, tm.moe_mlp_ep_overlap(ctx, lay, _t(x), *tw,
                                                  block_m=16))
    cap_e = lay.a2a.capacity_per_expert
    assert cap_e % 16 == 0 and cap_e % 64 != 0
    assert torch.equal(got, tm.moe_mlp_ep_overlap(ctx, lay, _t(x), *tw,
                                                  block_m=64))
    with pytest.raises(ValueError):
        tm.moe_mlp_ep_overlap(ctx, lay, _t(x), *tw, block_n=128,
                              we_gate_up_packed=tpk)
    with pytest.raises(ValueError):
        tm.moe_mlp_ep_overlap(ctx, lay, _t(x), *tw, microbatches=2)


def test_moe_decode_step_sp_with_a_deployed_layer_matches_jax():
    """``moe_decode_step_sp`` on ``MoEConfig.tiny(1)`` (f32; one layer
    keeps JAX's compile short) with an expert-major layer on the fp8 wire's
    expert edge, two teacher-forced steps at one rank within 1e-5 of JAX's
    logit scale; the port at two ranks within 1e-5 of its one-rank
    steps."""
    jcfg = jm.MoEConfig.tiny(1)
    jcfg = jm.MoEConfig(base=jl.LlamaConfig(**{
        **{f: getattr(jcfg.base, f) for f in
           ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
            "d_ff", "max_seq_len")}, "dtype": jnp.float32}),
        num_experts=jcfg.num_experts, topk=jcfg.topk,
        moe_d_ff=jcfg.moe_d_ff)
    shapes = jax.eval_shape(lambda: jm.init_moe_params(jax.random.key(0),
                                                       jcfg))
    rng = np.random.RandomState(21)
    params_np = jax.tree_util.tree_map_with_path(
        lambda path, s: (1.0 + 0.1 * rng.randn(*s.shape) if "norm" in
                         jax.tree_util.keystr(path) else
                         0.05 * rng.randn(*s.shape)).astype(np.float32),
        shapes)
    B, steps = 4, 2
    toks = np.random.RandomState(8).randint(0, 512, (steps, B)) \
        .astype(np.int32)
    jctx = _jctx(shape=(1,))
    jlay = JLayer.create(jctx, max_tokens=B, hidden=128, topk=2,
                         num_experts=4, axis="x", dtype=jnp.float32,
                         wire_dtype=jnp.float8_e4m3fn,
                         dequant_edge="expert", expert_major=True)
    spec = NamedSharding(jctx.mesh, P(None, None, None, "x", None))
    cache = {k: jax.device_put(v, spec) for k, v in jl.init_kv_cache(
        jcfg.base, B, jcfg.base.max_seq_len).items()}
    step = jax.jit(lambda p, t, pos, c: jm.moe_decode_step_sp(
        jctx, jlay, p, t, pos, jcfg, c, sp_axis="x"))
    jparams = jax.tree.map(jnp.asarray, params_np)
    want = []
    for pos in range(steps):
        logits, cache = step(jparams, jnp.asarray(toks[pos]), pos, cache)
        want.append(np.asarray(logits))
    cfg = tm.MoEConfig(base=tl.LlamaConfig(
        vocab_size=512, d_model=128, n_layers=1, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq_len=128, dtype=torch.float32), num_experts=4,
        topk=2, moe_d_ff=128)
    params = params_from_jax(params_np, device="cpu", dtype=torch.float32)
    got = {}
    for n in (1, 2):
        ctx = initialize_distributed(("x",), (n,), device="cpu")
        lay = EPAll2AllLayer.create(ctx, B // n, 128, 2, 4, axis="x",
                                    dtype=torch.float32,
                                    wire_dtype=torch.float8_e4m3fn,
                                    dequant_edge="expert", expert_major=True)
        tcache = tl.init_kv_cache(cfg.base, B, 128, device="cpu")
        if n > 1:
            tcache = tl.shard_kv_cache(tcache, n)
        got[n] = []
        for pos in range(steps):
            logits, tcache = tm.moe_decode_step_sp(
                ctx, lay, params, _t(toks[pos]), pos, cfg, tcache,
                sp_axis="x")
            got[n].append(logits)
    for g, w in zip(got[1], want):
        assert _rel(g, w) <= TOL["float32"]
    for g, w in zip(got[2], got[1]):
        assert _rel(g, w.numpy()) <= TOL["float32"]
