"""The port's dense GEMM (``ops/gemm.py``: ``matmul``, ``gemm_into``,
``slot_reduce``) against the JAX package's ``matmul`` on the same numpy
inputs.

On the CPU the wrappers run their plain PyTorch versions (f32 sums, one
cast), the arithmetic the Hopper kernel of ``csrc/gemm.cu`` repeats; the JAX
side runs its Pallas kernel in interpret mode. The kernel itself is held
against the plain version on the card by ``chip_smoke.py`` (phase 11a).

Tolerances, relative to the result's largest magnitude: f32 1e-5 (the
frameworks sum in other orders), bf16 2e-2 (both sum in f32 and round once,
but a rounding may fall the other way: one bf16 ulp is 2^-8 of a value).
The shapes keep JAX's ``block_k`` at None (no K-split, whose strips round
into the output type; ROADMAP Queue C).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.ops import gemm as jg
from triton_dist_tpu_torch.models.convert import tensor_from_numpy
from triton_dist_tpu_torch.ops import gemm as tg

pytestmark = pytest.mark.port

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (M, K, N) and the JAX tile that divides the output
CASES = (((64, 96, 128), (32, 64)), ((128, 256, 64), (64, 64)))


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _inputs(M: int, K: int, N: int, dtype: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    a, b = rng.randn(M, K).astype(np.float32), rng.randn(K, N).astype(
        np.float32)
    if dtype == "bfloat16":
        a, b = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (a, b))
    return a, b


@functools.lru_cache(maxsize=None)
def _jax_matmul(M: int, K: int, N: int, dtype: str, tile: tuple,
                out_dtype: str | None = None):
    a, b = _inputs(M, K, N, dtype)
    want = jg.matmul(jnp.asarray(a), jnp.asarray(b), jg.GemmConfig(*tile),
                     out_dtype=None if out_dtype is None else
                     jnp.dtype(out_dtype))
    return a, b, np.asarray(want.astype(jnp.float32)), str(want.dtype)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, tile", CASES,
                         ids=["x".join(map(str, s)) for s, _ in CASES])
def test_matmul_matches_jax(shape, tile, dtype):
    a, b, want, want_dtype = _jax_matmul(*shape, dtype, tile)
    before = tg.matmul.launches
    got = tg.matmul(_t(a), _t(b), tg.GemmConfig(*tile))
    assert str(got.dtype).split(".")[-1] == want_dtype == dtype
    assert _rel(got.float().numpy(), want) <= TOL[dtype]
    assert tg.matmul.launches == before       # the CPU runs the plain version


def test_matmul_bf16_into_f32_matches_jax():
    (M, K, N), tile = CASES[0]
    a, b, want, want_dtype = _jax_matmul(M, K, N, "bfloat16", tile,
                                         "float32")
    got = tg.matmul(_t(a), _t(b), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and want_dtype == "float32"
    # the same f32 sums of the same bf16 products, never rounded to bf16
    assert _rel(got.numpy(), want) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transposed_b_matches_jax(dtype):
    """``b`` given as the transpose of a row-major [N, K] (the backward's
    ``dc @ b^T``): the kernel reads that storage as [N, K] and copies
    nothing."""
    (M, K, N), tile = CASES[1]
    a, b, want, _ = _jax_matmul(M, K, N, dtype, tile)
    bt = _t(np.ascontiguousarray(np.asarray(b).T))          # [N, K]
    operand, trans = tg._b_operand(bt.t())
    assert trans and operand.data_ptr() == bt.data_ptr()
    got = tg.matmul(_t(a), bt.t())
    assert _rel(got.float().numpy(), want) <= TOL[dtype]


def test_b_operand_copies_only_a_strided_view():
    b = torch.arange(24.0).reshape(4, 6)
    assert tg._b_operand(b) == (b, False)
    strided = b[:, ::2]
    operand, trans = tg._b_operand(strided)
    assert not trans and operand.is_contiguous()
    assert torch.equal(operand, strided)


def test_ragged_matmul_matches_numpy():
    """M, K and N off every tile (the card's masked tails)."""
    a, b = _inputs(100, 72, 200, "float32", seed=1)
    got = tg.matmul(_t(a), _t(b))
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert got.shape == (100, 200)
    assert _rel(got.numpy(), want) <= TOL["float32"]


def test_gemm_config_divisibility_raises_like_jax():
    a, b = _inputs(64, 32, 96, "float32")
    cfg = (64, 64)                    # divides M = 64, not N = 96
    with pytest.raises(AssertionError, match="not divisible by tile"):
        jg.matmul(jnp.asarray(a), jnp.asarray(b), jg.GemmConfig(*cfg))
    with pytest.raises(ValueError, match="not divisible by tile"):
        tg.matmul(_t(a), _t(b), tg.GemmConfig(*cfg))
    with pytest.raises(ValueError, match="not divisible by tile"):
        tg.GemmConfig(48, 32).check(64, 96)
    tg.GemmConfig(32, 32, block_k=16).check(64, 96)       # block_k ignored


def test_gemm_into_checks_shapes():
    a, b = _inputs(8, 16, 24, "float32")
    with pytest.raises(ValueError, match="do not chain"):
        tg.gemm_into(_t(a), _t(b), torch.empty(8, 23))
    out = torch.empty(8, 24)
    assert tg.gemm_into(_t(a), _t(b), out) is out


def test_hopper_tile_table():
    """128-row tiles where they fill the 132 SMs, else 64 rows."""
    assert tg.hopper_tile(4096, 28672) == (128, 128)
    assert tg.hopper_tile(4096, 4096) == (128, 128)
    assert tg.hopper_tile(512, 4096) == (64, 128)
    assert tg.hopper_tile(100, 200) == (64, 128)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_slot_reduce_sums_slots_in_order(out_dtype):
    """The slot reduction of GEMM-RS: f32 slots summed in slot order, cast
    once; one slot is a cast."""
    ws = torch.from_numpy(np.random.RandomState(2).randn(3, 5, 7)
                          .astype(np.float32))
    want = ((ws[0] + ws[1]) + ws[2]).to(out_dtype)
    assert torch.equal(tg.slot_reduce(ws, out_dtype), want)
    assert torch.equal(tg.slot_reduce(ws[:1], out_dtype), ws[0].to(out_dtype))
