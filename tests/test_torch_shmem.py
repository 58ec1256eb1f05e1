"""The port's shmem layer against the JAX package: the mesh's flat rank ids,
the barrier (B14), tutorial 01's ring ping, symmetric tensors and signal
pads, and the build cache's view of the kernels' shared header.

On the CPU the collective wrappers run their plain PyTorch versions; the
CUDA kernels (``csrc/shmem.cu`` and the collectives that include
``csrc/shmem.cuh``) are held against them on the card by ``chip_smoke.py``.
The JAX side runs on the conftest's virtual CPU devices, as the JAX
package's own tests do. Ids and barriers are integers: exact.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.ops.common import barrier_all_op as j_barrier_all_op
from triton_dist_tpu.shmem import device as jshd
from triton_dist_tpu.shmem.context import \
    initialize_distributed as j_initialize_distributed
from triton_dist_tpu_torch import csrc
from triton_dist_tpu_torch.ops.common import barrier_all_op
from triton_dist_tpu_torch.shmem import (MAX_RANKS, ShmemContext,
                                         initialize_distributed, ring_ping)
from triton_dist_tpu_torch.shmem.context import clear_live_signal_pads

pytestmark = pytest.mark.port

MESHES = [(("x",), (4,)), (("a", "b"), (2, 3))]


@functools.lru_cache(maxsize=None)
def _jax_ids(names, shape):
    """JAX's ids on every device of the mesh, [n, ids]: ``my_pe`` over all
    axes, ``pe_at`` for every axis and index, ``pe_at_group`` for every
    group of axes and index."""
    ctx = j_initialize_distributed(axis_names=names, mesh_shape=shape)
    groups = [names[i:] for i in range(len(names))]

    def f():
        ids = [jshd.my_pe(names)]
        for axis, size in zip(names, shape):
            ids += [jshd.my_pe(axis)]
            ids += [jshd.pe_at(names, axis, i) for i in range(size)]
        for group in groups:
            ids += [jshd.pe_at_group(names, group, i)
                    for i in range(math.prod(shape[names.index(group[0]):]))]
        return jnp.stack([jnp.asarray(i, jnp.int32) for i in ids])[None]

    return np.asarray(jax.jit(ctx.shard_map(f, in_specs=(),
                                            out_specs=P(names)))())


def _port_ids(ctx, rank):
    names, shape = ctx.axis_names, ctx.mesh_shape
    ids = [ctx.my_pe(rank, names)]
    for axis, size in zip(names, shape):
        ids += [ctx.my_pe(rank, axis)]
        ids += [ctx.pe_at(rank, axis, i) for i in range(size)]
    for k in range(len(names)):
        group = names[k:]
        ids += [ctx.pe_at_group(rank, group, i)
                for i in range(math.prod(shape[k:]))]
    return ids


@pytest.mark.parametrize("names,shape", MESHES)
def test_flat_ids_match_jax(names, shape):
    """Row-major flat ids over the axes, as JAX's logical device ids."""
    want = _jax_ids(names, shape)
    ctx = initialize_distributed(names, shape, device="cpu")
    assert ctx.num_ranks == math.prod(shape) == want.shape[0]
    got = np.array([_port_ids(ctx, r) for r in range(ctx.num_ranks)])
    np.testing.assert_array_equal(got, want)
    for r in range(ctx.num_ranks):
        assert ctx.flat_id(ctx.coords(r)) == r


@pytest.mark.parametrize("names,shape", MESHES)
def test_context_accepts_ranks_on_one_device(names, shape):
    ctx = initialize_distributed(names, shape, device="cpu")
    assert isinstance(ctx, ShmemContext) and ctx.device.type == "cpu"
    assert ctx.axis_size(names[-1]) == shape[-1]
    assert ctx.axis_size(names) == ctx.axis_size() == math.prod(shape)
    # a symmetric tensor is one allocation, rank r's buffer at row r, and
    # a kernel reaches it through the table of row addresses
    symm = ctx.create_symm_tensor((3, 5), torch.float32)
    assert symm.shape == (ctx.num_ranks, 3, 5) and not symm.any()
    table = ctx.peer_table(symm)
    assert table == tuple(symm[r].data_ptr() for r in range(ctx.num_ranks))
    with pytest.raises(ValueError, match="symmetric"):
        ctx.peer_table(symm[:1])
    # each family its own pad, zero, grown on demand
    a, b = ctx.signal_pad("fam_a", 8), ctx.signal_pad("fam_b", 8)
    assert a.data_ptr() != b.data_ptr() and not a.any()
    assert ctx.signal_pad("fam_a", 4) is a
    assert ctx.signal_pad("fam_a", 1000).shape == (ctx.num_ranks, 1000)
    with pytest.raises(ValueError, match="at most"):
        initialize_distributed(("x",), (MAX_RANKS + 1,), device="cpu")


def test_a_starved_spin_clears_the_pads_of_every_live_context():
    """The error report names no context: raising it zeroes the pads of
    every live context, two meshes of the same shape included."""
    ctxs = [initialize_distributed(("x",), (2,), device="cpu")
            for _ in range(2)] + [initialize_distributed(("a", "b"), (2, 2),
                                                         device="cpu")]
    pads = [c.signal_pad(f"fam_{i}", 8) for i, c in enumerate(ctxs)]
    for pad in pads:
        pad.fill_(3)
    clear_live_signal_pads()
    assert not any(pad.any() for pad in pads)


@functools.lru_cache(maxsize=None)
def _jax_barrier():
    ctx = j_initialize_distributed(axis_names=("x",), mesh_shape=(4,))
    return np.asarray(j_barrier_all_op(ctx)())


def test_barrier_all_op_returns_ones_as_jax():
    want = _jax_barrier()
    ctx = initialize_distributed(("x",), (4,), device="cpu")
    launches = barrier_all_op.launches
    got = barrier_all_op(ctx)()
    assert barrier_all_op.launches == launches      # CPU: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.ones(4, np.int32))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_ping_delivers_the_left_neighbours_block(n):
    """Tutorial 01: block i carries i; afterwards rank i holds rank i-1's."""
    ctx = initialize_distributed(("x",), (n,), device="cpu")
    blocks = torch.arange(n, dtype=torch.float32)[:, None, None] \
        * torch.ones(1, 8, 128)
    got = ring_ping(ctx, blocks)
    np.testing.assert_array_equal(
        got[:, 0, 0].numpy(), np.roll(np.arange(n, dtype=np.float32), 1))
    with pytest.raises(ValueError, match="blocks"):
        ring_ping(ctx, blocks[:1])


def test_build_digest_sees_the_shared_header(tmp_path, monkeypatch):
    """A kernel's library is named by its source and every local header it
    includes, so an edited ``shmem.cuh`` rebuilds (nothing is built
    here)."""
    assert [h.name for h in csrc.local_headers(
        csrc._DIR / "allgather.cu")] == ["ag_relay_2d.cuh", "shmem.cuh"]
    for name in ("allgather", "reduce_scatter", "flash_decode", "shmem"):
        assert name in csrc.SOURCES
    for name in ("allgather.cu", "ag_relay_2d.cuh", "shmem.cuh"):
        (tmp_path / name).write_bytes((csrc._DIR / name).read_bytes())
    monkeypatch.setattr(csrc, "_DIR", tmp_path)
    before = csrc.library_path("allgather")
    assert before == csrc.library_path("allgather")
    (tmp_path / "shmem.cuh").write_text(
        (tmp_path / "shmem.cuh").read_text() + "\n// edited\n")
    after = csrc.library_path("allgather")
    assert after != before and after.parent == before.parent
