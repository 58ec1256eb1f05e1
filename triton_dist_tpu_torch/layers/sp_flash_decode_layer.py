"""The decode attention modules: sequence-parallel over a contiguous cache,
and paged over the serving pool.

Counterpart of ``triton_dist_tpu/layers/sp_flash_decode_layer.py``. The JAX
modules hold one jitted forward each; PyTorch runs eagerly, so these hold
their settings and call the ops. ``max_batch`` keeps its meaning: the cache
is allocated at ``max_batch`` rows and a smaller batch is padded to it, so
every step launches the same shapes (pad rows attend to one token of the
cache and are sliced away).
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops.flash_decode import (gqa_decode_paged,
                                                    paged_kv_write,
                                                    sp_gqa_flash_decode)
from triton_dist_tpu_torch.shmem.context import ShmemContext


@dataclasses.dataclass(frozen=True)
class SpGQAFlashDecodeAttention:
    """Sequence-parallel GQA decode attention (``sp_gqa_flash_decode``):
    each rank's split-KV partial, the partial all-gather and the lse merge,
    over ``ctx``'s ``axis``: one axis (in a multi-axis mesh, each group
    along it apart) or a tuple of axes (``ag_method`` ``push_2d``,
    ``ring_2d`` or ``auto``). At one rank the cache is [B, Hkv, S, D]; at n
    ranks along the axis it is sharded on S, rank-major [n, B, Hkv, S / n,
    D]. Returns rank 0's replica (every rank's is the same)."""

    ctx: ShmemContext
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    axis: str | tuple | None = None
    block_s: int = 128
    ag_method: str = "fused"
    max_batch: int | None = None

    def _fwd(self, q, k_cache, v_cache, lens):
        return sp_gqa_flash_decode(self.ctx, q, k_cache, v_cache, lens,
                                   axis=self.axis, block_s=self.block_s,
                                   ag_method=self.ag_method)

    def __call__(self, q, k_cache, v_cache, global_kv_lens):
        """q [B, Hq, D]; k/v_cache [(n,) B', Hkv, S(/n), D]; global_kv_lens
        [B] int32. Returns [B, Hq, D] in q's type. With ``max_batch`` set,
        B' must be ``max_batch`` and any B <= ``max_batch`` is padded to
        it."""
        B, Hq, D = q.shape
        assert Hq == self.num_q_heads and D == self.head_dim
        lead = k_cache.dim() - 4          # the rank dim of a sharded cache
        cache_b, heads = k_cache.shape[lead], k_cache.shape[lead + 1]
        assert heads == self.num_kv_heads, (
            f"cache has {heads} kv heads, layer configured for "
            f"{self.num_kv_heads}")
        if self.max_batch is None or B == cache_b == self.max_batch:
            return self._fwd(q, k_cache, v_cache, global_kv_lens)
        mb = self.max_batch
        assert B <= mb, f"batch {B} exceeds the layer's max_batch {mb}"
        assert cache_b == mb, (
            f"with max_batch={mb} the KV cache must be allocated at "
            f"max_batch (got batch dim {cache_b})")
        q_pad = torch.cat([q, q.new_zeros(mb - B, Hq, D)])
        lens_pad = torch.cat([global_kv_lens,
                              global_kv_lens.new_ones(mb - B)])
        return self._fwd(q_pad, k_cache, v_cache, lens_pad)[:B]


@dataclasses.dataclass(frozen=True)
class PagedGQADecodeAttention:
    """Paged GQA decode attention over the serving page pool
    (``gqa_decode_paged``). The pool is the growable buffer and the block
    table the only thing that moves, so the module owns nothing."""

    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    page_size: int = 16
    sm_scale: float | None = None

    def __call__(self, q, k_pages, v_pages, block_table, kv_len):
        """q [B, Hq, D]; k/v_pages [P, Hkv, page_size, D]; block_table
        [B, pages_per_seq] int32; kv_len [B] int32 (0 allowed). Returns
        ``(out [B, Hq, D], lse [B, Hq] f32)``."""
        B, Hq, D = q.shape
        assert Hq == self.num_q_heads and D == self.head_dim
        assert k_pages.shape[1] == self.num_kv_heads, (
            f"pool has {k_pages.shape[1]} kv heads, layer configured for "
            f"{self.num_kv_heads}")
        assert k_pages.shape[2] == self.page_size, (
            f"pool page_size {k_pages.shape[2]} != layer page_size "
            f"{self.page_size}")
        return gqa_decode_paged(q, k_pages, v_pages, block_table, kv_len,
                                sm_scale=self.sm_scale)

    def update_and_attend(self, q, k_new, v_new, k_pages, v_pages,
                          block_table, pos, active=None):
        """Write this step's (k, v) row into the pool (``paged_kv_write``,
        in place), then attend over ``kv_len = pos + 1``. ``pos`` [B] int32;
        ``active`` [B] bool parks frozen rows' writes on the scratch page.
        Returns ``(out, lse, k_pages, v_pages)``."""
        k_pages, v_pages = paged_kv_write(k_pages, v_pages, k_new, v_new,
                                          block_table, pos, active=active)
        out, lse = self(q, k_pages, v_pages, block_table,
                        (pos + 1).to(torch.int32))
        return out, lse, k_pages, v_pages


__all__ = ["PagedGQADecodeAttention", "SpGQAFlashDecodeAttention"]
