"""The port's one-rank EP dispatch and combine against the JAX package's.

The same numpy inputs (made from a seed) go through JAX
``ops.all_to_all.dispatch`` / ``combine`` on a one-device mesh (no quantised
wire; ``all_to_all_push`` as the JAX tests run it on the CPU) followed, on the
dispatch side, by ``align_tokens_by_expert``'s gather, and through the port's
``ep_dispatch`` / ``ep_combine`` (plain PyTorch versions on CPU tensors).
The dispatch is a copy, so the aligned rows must be equal to the bit;
the combine's f32 sums at 1e-6 in f32 and one bf16 ulp (2e-2 near the
largest outputs) in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.ops import all_to_all as ja
from triton_dist_tpu.ops import group_gemm as jg
from triton_dist_tpu.shmem.context import initialize_distributed
from triton_dist_tpu_torch.ops import all_to_all as ta
from triton_dist_tpu_torch.ops import group_gemm as tg

pytestmark = pytest.mark.port

E, H, T, BM = 4, 128, 24, 16
ATOL = {"float32": 1e-6, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def ctx():
    return initialize_distributed(axis_names=("x",), mesh_shape=(1,))


def _inputs(topk: int, seed: int = 0):
    """Tokens [T, H], each token's topk distinct experts (expert E - 1 gets
    none at topk 1), and renormalised positive weights [T, topk]."""
    rng = np.random.RandomState(seed + topk)
    x = rng.randn(T, H).astype(np.float32)
    n_e = E - 1 if topk == 1 else E
    ids = np.argsort(rng.rand(T, n_e), -1)[:, :topk].astype(np.int32)
    w = rng.rand(T, topk).astype(np.float32) + 0.1
    return x, ids, w / w.sum(-1, keepdims=True)


_RUNS = {}


def _jax_run(ctx, dtype: str, topk: int):
    """One jitted JAX dispatch and combine of ``_inputs(topk)`` (the
    combine over seeded per-slot processed rows), cached per case: (recv
    rows [cap, H] f32, recv ids [cap], slot, valid, processed rows, the
    combined rows f32)."""
    key = (dtype, topk)
    if key not in _RUNS:
        jdt = getattr(jnp, dtype)
        a2a = ja.create_all_to_all_context(ctx, max_tokens=T, hidden=H,
                                           topk=topk, num_experts=E,
                                           axis="x", dtype=jdt,
                                           wire_dtype=None)
        x, ids, w = _inputs(topk)
        proc = np.random.RandomState(11).randn(a2a.capacity, H).astype(
            np.float32)

        def run(x, ids, proc, w):
            recv, recv_ids, layout = ja.dispatch(a2a, x, ids)
            out = ja.combine(a2a, proc[None], layout, w)
            return (recv.reshape(-1, H).astype(jnp.float32),
                    recv_ids.reshape(-1), layout[1], layout[2],
                    out.astype(jnp.float32))

        got = jax.jit(run)(jnp.asarray(x, jdt), jnp.asarray(ids),
                           jnp.asarray(proc, jdt), jnp.asarray(w))
        got = [np.asarray(a) for a in got]
        _RUNS[key] = (*got[:4], proc, got[4])
    return _RUNS[key]


CASES = [("float32", 1), ("float32", 2), ("bfloat16", 2)]


@pytest.mark.parametrize("dtype,topk", CASES)
def test_ep_dispatch_matches_jax(ctx, dtype, topk):
    """JAX dispatch, then the expert side's alignment gather, against
    ``ep_dispatch`` on the port's alignment of the same pairs: the same
    blocks, bound and rows below it."""
    x, ids, _ = _inputs(topk)
    rows, recv_ids, slot, valid, _, _ = _jax_run(ctx, dtype, topk)
    # one rank: every pair is kept, in the slot of its own index
    assert valid.all()
    np.testing.assert_array_equal(slot.reshape(-1), np.arange(T * topk))
    g, v, be, nb = (np.asarray(a) for a in jg.align_tokens_by_expert(
        recv_ids, E, BM, with_used_count=True))
    want = np.where(v[:, None], rows[g], 0)

    src, ok, t_be, t_nb, _ = tg.expert_alignment(
        torch.from_numpy(ids.reshape(-1)), E, BM)
    got = ta.ep_dispatch(torch.from_numpy(x).to(getattr(torch, dtype)), src,
                         ok, topk)
    assert got.dtype == getattr(torch, dtype)
    assert int(t_nb) == int(nb)
    used = int(nb) * BM
    np.testing.assert_array_equal(t_be.numpy()[:int(nb)], be[:int(nb)])
    np.testing.assert_array_equal(got.float().numpy()[:used], want[:used])
    assert not got[used:].any()


@pytest.mark.parametrize("dtype,topk", CASES)
def test_ep_combine_matches_jax(ctx, dtype, topk):
    """JAX combine of per-slot processed rows against ``ep_combine`` of the
    same rows at their expert-aligned positions."""
    _, ids, w = _inputs(topk)
    *_, processed, want = _jax_run(ctx, dtype, topk)
    src, _, _, _, pos = tg.expert_alignment(
        torch.from_numpy(ids.reshape(-1)), E, BM)
    pairs = torch.from_numpy(processed[:T * topk]).to(getattr(torch, dtype))
    y = torch.zeros(src.shape[0], H, dtype=pairs.dtype)
    y[pos.long()] = pairs                     # slot r's row at its place
    got = ta.ep_combine(y, pos, torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype) and got.shape == (T, H)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL[dtype],
                               rtol=0)


def test_pairs_routed_nowhere():
    """An invalid aligned row dispatches zeros, an index out of range counts
    as routed nowhere, and a pair whose position lies outside the rows adds
    nothing to its token."""
    tokens = torch.arange(1, 7, dtype=torch.float32).view(3, 2)
    src = torch.tensor([5, 0, 6, -1, 2], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False])
    out = ta.ep_dispatch(tokens, src, valid, 2)
    assert torch.equal(out, torch.tensor([[5., 6.], [1., 2.], [0., 0.],
                                          [0., 0.], [0., 0.]]))
    y = torch.tensor([[1., 2.], [3., 4.]])
    pos = torch.tensor([1, 2, -1, 0], dtype=torch.int32)
    w = torch.tensor([[0.25, 0.75], [0.5, 0.5]])
    got = ta.ep_combine(y, pos, w)
    assert torch.equal(got, torch.tensor([[0.75, 1.0], [0.5, 1.0]]))
