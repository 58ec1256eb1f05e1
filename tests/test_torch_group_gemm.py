"""The port's grouped GEMMs and MoE token alignment against the JAX package.

The same numpy inputs (made from a seed) go through
``triton_dist_tpu.ops.group_gemm`` (its Pallas kernels in interpret mode, as
the JAX tests run them on the CPU) and ``triton_dist_tpu_torch.ops.group_gemm``
(whose wrappers take their plain PyTorch versions on CPU tensors). Four
experts, one of which gets no row, and rows routed nowhere (id -1).
Tolerances: f32 at 1e-5 (sums in another order), bf16 at 2e-2 (a bf16 ulp
near the outputs' largest values is 2**-7 = 7.8e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.ops import group_gemm as jg
from triton_dist_tpu_torch.ops import group_gemm as tg

pytestmark = pytest.mark.port

E, H, F, T = 4, 128, 256, 32
BM = 16
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops here are tiny: one thread keeps torch's workers
    from contending with the JAX runtime's for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, E - 1, T).astype(np.int32)   # expert E - 1 idle
    ids[rng.choice(T, 5, replace=False)] = -1
    return ids


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(1)
    return {"ids": _ids(),
            "x": rng.randn(T, H).astype(np.float32),
            "wg": (rng.randn(E, H, F) * 0.05).astype(np.float32),
            "wu": (rng.randn(E, H, F) * 0.05).astype(np.float32),
            "wd": (rng.randn(E, F, H) * 0.05).astype(np.float32)}


def _j(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("block_m", [8, 16, 32])
@pytest.mark.parametrize("host_ids", [False, True], ids=["tensor", "numpy"])
def test_align_tokens_by_expert_matches_jax(host_ids, block_m):
    ids = _ids(seed=block_m)
    j_in = ids if host_ids else jnp.asarray(ids)
    t_in = ids if host_ids else torch.from_numpy(ids)
    want = jg.align_tokens_by_expert(j_in, E, block_m, with_used_count=True)
    got = tg.align_tokens_by_expert(t_in, E, block_m, with_used_count=True)
    assert [g.dtype for g in got] == [torch.int32, torch.bool, torch.int32,
                                      torch.int32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert len(tg.align_tokens_by_expert(t_in, E, block_m)) == 3
    assert int(tg.used_block_count(t_in, E, block_m)) == \
        int(jg.used_block_count(jnp.asarray(ids), E, block_m))


@pytest.fixture(scope="module")
def aligned(data):
    g, v, be, nb = (np.array(a) for a in jg.align_tokens_by_expert(
        jnp.asarray(data["ids"]), E, BM, with_used_count=True))
    x = np.where(v[:, None], data["x"][g], 0).astype(np.float32)
    assert nb < len(be), "the layout must hold blocks past the bound"
    return {"x": x, "be": be, "nb": int(nb)}


CASES = [("float32", False, True), ("float32", True, True),
         ("float32", True, False), ("bfloat16", False, True),
         ("bfloat16", True, True), ("bfloat16", True, False)]


def _case_id(c):
    return f"{c[0]}-{'bounded' if c[1] else 'full'}-" \
        f"{'masked' if c[2] else 'unmasked'}"


@pytest.mark.parametrize("gated", [False, True], ids=["gemm", "gated"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_grouped_gemm_matches_jax(data, aligned, case, gated):
    """Rows below the bound agree; with masked=True the rows past it are
    zero in both; unmasked, rows past it are not compared."""
    dtype, bounded, masked = case
    nb = aligned["nb"] if bounded else None
    t_nb = None if nb is None else torch.tensor(nb, dtype=torch.int32)
    be = aligned["be"]
    ws = (data["wg"], data["wu"]) if gated else (data["wg"],)
    jfn = jg.grouped_gemm_gated if gated else jg.grouped_gemm
    tfn = tg.grouped_gemm_gated if gated else tg.grouped_gemm
    want = jfn(_j(aligned["x"], dtype), *(_j(w, dtype) for w in ws),
               jnp.asarray(be), block_m=BM,
               n_blocks_used=None if nb is None else jnp.int32(nb),
               masked=masked)
    got = tfn(_t(aligned["x"], dtype), *(_t(w, dtype) for w in ws),
              torch.from_numpy(be), block_m=BM, n_blocks_used=t_nb,
              masked=masked)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    rows = len(be) * BM if (nb is None or masked) else nb * BM
    np.testing.assert_allclose(_f32(got)[:rows], _f32(want)[:rows],
                               atol=ATOL[dtype], rtol=0)
    if bounded and masked:
        assert not _f32(got)[nb * BM:].any()


def _moe_fns(data, dtype, lib, conv, block_m):
    """The serving FFN of ``moe_mlp_ep_overlap`` (gated, then down, both
    bounded and unmasked) for ``apply_grouped``."""
    wg, wu, wd = (conv(data[k], dtype) for k in ("wg", "wu", "wd"))

    def ffn(x, be, nb):
        h = lib.grouped_gemm_gated(x, wg, wu, be, block_m=block_m,
                                   n_blocks_used=nb, masked=False)
        return lib.grouped_gemm(h, wd, be, block_m=block_m, n_blocks_used=nb,
                                masked=False)
    return ffn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_grouped_matches_jax(data, dtype):
    ids = data["ids"]
    want = jg.apply_grouped(_j(data["x"], dtype), jnp.asarray(ids), E,
                            _moe_fns(data, dtype, jg, _j, BM), block_m=BM)
    got = tg.apply_grouped(_t(data["x"], dtype), torch.from_numpy(ids), E,
                           _moe_fns(data, dtype, tg, _t, BM), block_m=BM)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL[dtype],
                               rtol=0)
    assert not _f32(got)[ids < 0].any()


def test_moe_ffn_local_matches_jax(data):
    """Up-projection, SiLU between the two grouped GEMMs, down-projection
    (f32; bf16 takes the same kernels through apply_grouped above)."""
    ids = data["ids"]
    want = jg.moe_ffn_local(jnp.asarray(data["x"]), jnp.asarray(ids),
                            jnp.asarray(data["wg"]), jnp.asarray(data["wd"]),
                            block_m=BM)
    got = tg.moe_ffn_local(torch.from_numpy(data["x"]), torch.from_numpy(ids),
                           torch.from_numpy(data["wg"]),
                           torch.from_numpy(data["wd"]), block_m=BM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_do_not_depend_on_block_m(data, dtype):
    """Within the port, the same rows through the MoE FFN at block_m 16, 32
    and 64 give the same bits: a row's sums do not depend on the padding or
    on its neighbours."""
    outs = [tg.apply_grouped(_t(data["x"], dtype),
                             torch.from_numpy(data["ids"]), E,
                             _moe_fns(data, dtype, tg, _t, bm), block_m=bm)
            for bm in (16, 32, 64)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("option", ["row_scale", "packed", "block_k",
                                    "prefetch_depth", "pack_gated_weights"])
def test_options_of_later_slices_raise(data, aligned, option):
    """Named for the options that an earlier slice of the port refused;
    each now runs, and on the CPU its plain form is exact against the
    option-free call: ``row_scale`` multiplies the f32 product rows,
    the packed stream, ``block_k`` and ``prefetch_depth`` change no bit,
    and ``pack_gated_weights`` interleaves bitwise as JAX's does."""
    x = _t(aligned["x"], "float32")
    wg, wu = _t(data["wg"], "float32"), _t(data["wu"], "float32")
    be = torch.from_numpy(aligned["be"])
    nb = aligned["nb"]
    if option == "pack_gated_weights":
        pk = tg.pack_gated_weights(wg, wu, 64)
        want = jg.pack_gated_weights(jnp.asarray(data["wg"]),
                                     jnp.asarray(data["wu"]), 64)
        assert pk.block_n == want.block_n == 64
        assert np.array_equal(pk.w.numpy(), np.asarray(want.w))
        return
    if option == "row_scale":
        s = torch.from_numpy(np.random.RandomState(2).rand(x.shape[0])
                             .astype(np.float32))
        got = tg.grouped_gemm(x, wg, be, block_m=BM, n_blocks_used=nb,
                              row_scale=s)
        plain = tg.grouped_gemm(x, wg, be, block_m=BM, n_blocks_used=nb)
        assert torch.equal(got, plain * s[:, None])
        return
    plain = tg.grouped_gemm_gated(x, wg, wu, be, block_m=BM,
                                  n_blocks_used=nb)
    if option == "packed":
        got = tg.grouped_gemm_gated(x, tg.pack_gated_weights(wg, wu, 128),
                                    None, be, block_m=BM, n_blocks_used=nb,
                                    packed=True)
    else:
        got = tg.grouped_gemm_gated(x, wg, wu, be, block_m=BM,
                                    n_blocks_used=nb,
                                    **{option: 32 if option == "block_k"
                                       else 2})
    assert torch.equal(got, plain)
