"""The port's paged decode attention, paged KV write and cache/page
converters against the JAX package on the same numpy inputs.

On the CPU ``gqa_decode_paged`` runs its plain PyTorch version, the
arithmetic the Hopper kernel repeats; the JAX side runs the Pallas kernel in
interpret mode, as the JAX package's own tests run it. The kernel itself is
held against the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.ops import flash_decode as jfd
from triton_dist_tpu.serving import kv_pool as jkv
from triton_dist_tpu_torch.models.convert import tensor_from_numpy
from triton_dist_tpu_torch.ops import flash_decode as tfd
from triton_dist_tpu_torch.serving import kv_pool as tkv

pytestmark = pytest.mark.port

B, HQ, HKV, D, PS, PPS, P = 6, 4, 2, 32, 8, 4, 12


def _case(seed: int, dtype):
    """Ragged rows: a full row, a ragged row, an empty row, a one-token row,
    and two rows sharing one sequence's pages at staggered lengths (the
    chunked-prefill idiom). Block-table entries past each row's live pages
    are garbage, out of range both ways."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, HQ, D).astype(np.float32)
    k = rng.randn(P, HKV, PS, D).astype(np.float32)
    v = rng.randn(P, HKV, PS, D).astype(np.float32)
    kv_len = np.array([PPS * PS, 13, 0, 1, 17, 20], np.int32)
    bt = rng.randint(1, P, size=(B, PPS)).astype(np.int32)
    bt[5] = bt[4]
    for b in range(B):
        live = -(-int(kv_len[b]) // PS)
        bt[b, live:] = rng.choice([-7, P, 10 ** 6], size=PPS - live)
    if dtype == "bfloat16":
        q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        q, k, v = (np.asarray(a) for a in (q, k, v))
    return q, k, v, bt, kv_len


def _torch(*arrays):
    return [tensor_from_numpy(a, "cpu") for a in arrays]


@pytest.mark.parametrize("dtype,atol,rtol", [
    ("float32", 1e-5, 1e-5),
    # bf16 out is rounded once (to bf16) in both; the inputs are identical
    ("bfloat16", 2e-2, 0.0),
])
def test_gqa_decode_paged_matches_jax(dtype, atol, rtol):
    q, k, v, bt, kv_len = _case(0, dtype)
    j_out, j_lse = jfd.gqa_decode_paged(*(jnp.asarray(a) for a in
                                          (q, k, v, bt, kv_len)))
    launches = tfd.gqa_decode_paged.launches
    t_out, t_lse = tfd.gqa_decode_paged(*_torch(q, k, v, bt, kv_len))
    assert tfd.gqa_decode_paged.launches == launches   # CPU: plain version
    assert t_out.dtype == torch.bfloat16 if dtype == "bfloat16" \
        else t_out.dtype == torch.float32
    assert t_lse.shape == (B, HQ)
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=atol, rtol=rtol)
    # lse: the port's [B, Hq] is the TPU kernel's lane-broadcast [..., 0]
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=1e-5 if dtype == "float32" else 1e-4,
                               rtol=1e-5)
    # the empty row: zeros and NEG_INF
    assert not t_out[2].float().any()
    assert (t_lse[2] == tfd.NEG_INF).all()


def test_gqa_decode_paged_plain_matches_dense_softmax():
    """An independent float64 golden: softmax over each row's first kv_len
    keys, gathered through the live block-table entries."""
    q, k, v, bt, kv_len = _case(1, "float32")
    out, lse = tfd.gqa_decode_paged(*_torch(q, k, v, bt, kv_len))
    G = HQ // HKV
    for b in range(B):
        n = int(kv_len[b])
        if n == 0:
            continue
        pages = bt[b, :-(-n // PS)]
        kk = k[pages].transpose(1, 0, 2, 3).reshape(HKV, -1, D)[:, :n]
        vv = v[pages].transpose(1, 0, 2, 3).reshape(HKV, -1, D)[:, :n]
        for h in range(HQ):
            s = kk[h // G].astype(np.float64) @ q[b, h] / np.sqrt(D)
            w = np.exp(s - s.max())
            np.testing.assert_allclose(out[b, h].numpy(),
                                       w @ vv[h // G] / w.sum(), atol=1e-5)
            np.testing.assert_allclose(lse[b, h].item(),
                                       s.max() + np.log(w.sum()), atol=1e-5)


def test_paged_kv_write_matches_jax_with_parking():
    """Bit-exact against the JAX scatter, with frozen rows parked on the
    scratch page 0 and one row frozen one past its last page (its block-
    table column is clamped)."""
    rng = np.random.RandomState(2)
    kp = rng.randn(P, HKV, PS, D).astype(np.float32)
    vp = rng.randn(P, HKV, PS, D).astype(np.float32)
    k_new = rng.randn(B, HKV, D).astype(np.float32)
    v_new = rng.randn(B, HKV, D).astype(np.float32)
    bt = (np.arange(B * PPS).reshape(B, PPS) % (P - 1) + 1).astype(np.int32)
    pos = np.array([0, 9, 31, 5, PPS * PS, 17], np.int32)
    active = np.array([True, True, True, False, False, True])
    j_k, j_v = jfd.paged_kv_write(*(jnp.asarray(a) for a in
                                    (kp, vp, k_new, v_new, bt, pos, active)))
    t_k, t_v = tfd.paged_kv_write(*_torch(kp, vp, k_new, v_new, bt, pos,
                                          active))
    # page 0 took the parked rows' writes, in an order neither promises
    assert np.array_equal(t_k[1:].numpy(), np.asarray(j_k)[1:])
    assert np.array_equal(t_v[1:].numpy(), np.asarray(j_v)[1:])
    assert np.array_equal(t_k[0, :, 1:4].numpy(), kp[0, :, 1:4])


def test_cache_page_converters_match_jax_bit_exact():
    rng = np.random.RandomState(3)
    L, nb, n_pages, S = 2, 2, 3, 32
    cache = rng.randn(L, nb, HKV, S, D).astype(np.float32)
    pages = rng.randn(L, P, HKV, PS, D).astype(np.float32)
    bt = np.array([[3, 7, 1], [9, 2, 11]], np.int32)
    j_pages = np.asarray(jkv.cache_to_pages(jnp.asarray(cache),
                                            jnp.asarray(pages),
                                            jnp.asarray(bt)))
    t_pages = tkv.cache_to_pages(*_torch(cache, pages, bt))
    assert np.array_equal(t_pages.numpy(), j_pages)
    back = tkv.pages_to_cache(t_pages, torch.from_numpy(bt))
    assert np.array_equal(back.numpy(),
                          np.asarray(jkv.pages_to_cache(jnp.asarray(j_pages),
                                                        jnp.asarray(bt))))
    assert np.array_equal(back.numpy(), cache[:, :, :, :n_pages * PS])


def test_tensor_from_numpy_bf16_is_bit_exact():
    a = np.asarray(jnp.asarray(np.random.RandomState(4).randn(64),
                               jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          a.view(np.uint16))
