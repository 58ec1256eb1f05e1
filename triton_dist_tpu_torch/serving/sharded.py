"""Sharded MoE serving over a TP×SP×EP mesh: the port of
``triton_dist_tpu/serving/sharded.py::ShardedServingEngine``.

The engine's two programs (``prefill_chunk_paged`` and
``decode_multistep_paged``) run over the mesh through the model hooks, the
same code at every mesh size:

- attention (SP): the page pool is sharded on its page dim over ``sp``
  (padded to a multiple of |sp|; the allocator never hands out a padding
  page) and each layer runs ``ops.flash_decode.sp_paged_attend_write``:
  the masked writes, the page-order pool gather through B9 (through the
  start-local gather B6 with ``overlap="ep+sp"``) and the replicated B1
  walk. ``long_context=True`` swaps in ``flash_decode_dist`` over an
  interleaved layout: at sp = 1 the fused page fold, at sp > 1 each rank's
  per-page partials over its slice (B7) and the fold across ranks (B8).
- projections (TP): ``ops.allgather_gemm.tp_column_linear``, each rank's
  column block (B2 on the card, a fixed per-element order of the sum) and
  the column gather through B9 (``tp_impl="ag_gemm"``: through B15 over
  the TP axis, a group inside the mesh at sp or ep > 1; allclose to
  "xla" only, and bitwise the 2x1x1 ``ag_gemm`` engine at every mesh).
- MoE FFN (EP): ``models.moe.moe_mlp_ep_overlap`` through two
  ``EPAll2AllLayer``s (decode rows and chunk rows): B21's dispatch, each
  rank's local experts (B18, B17), B21's combine; ``wire_dtype`` fp8 or
  int8 quantises the wire, and ``overlap="ep"`` microbatches the block over
  B22, the segmented wire (``overlap="ep+sp"``: the same, and B6 on the
  attention leg).

Every rank of the mesh runs in this one process on one card (see
``shmem/context.py``); each collective is one launch over every rank, and
work whose result every rank of a group replicates (the B1 walk, the
router, the expert rows of one EP rank) runs once, on rank 0's group's
data.

The contract, as in the reference: the served tokens are bitwise
identical at every mesh size, because (1) a column block's product is its
columns of the whole product and the gather concatenates; (2) each row's
dispatch, quantisation round trip, expert FFN and k-order fold do not
depend on which rank computed it (the 1×1×1 engine runs the same wire,
quantiser included); (3) the pool gather (B9 or B6) is a page-order
concatenation, and the long-context fold visits pages in block-table
order, ranks interleaved at each page, one entry real.
No floating-point sum crosses ranks, which is why ``tp_impl="gemm_rs"`` is
refused.

The host control plane is replicated-decision: one allocator and one
scheduler decide for every rank, and ``check_replicated_decisions``
gathers each rank's control digest through B9 and compares them with rank
0's every ``digest_every`` steps at more than one rank (``_digest_skew``
injects a divergence for the tests). Without a journal a divergence raises
``ReplicatedDecisionError``, as the reference does; its restore rung waits
for ROADMAP.md Queue A, item 10.

Still raising ``NotImplementedError``: ``speculate`` and ``journal``, item
10; the tuned microbatch registry (item 11) is not consulted. In
long-context mode the modelled attention split (``fd_attn_split_us``, over
this card's ``FD_FIT``) is observed every step as ``attn_local_us`` and
``attn_fold_wait_us``; they are 0 otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from triton_dist_tpu_torch.layers.ep_a2a_layer import EPAll2AllLayer
from triton_dist_tpu_torch.models.moe import MoEConfig, moe_mlp_ep_overlap
from triton_dist_tpu_torch.ops.all_to_all import WIRE_FIT, a2a_wire_bytes
from triton_dist_tpu_torch.ops.allgather import all_gather
from triton_dist_tpu_torch.ops.allgather_gemm import tp_column_linear
from triton_dist_tpu_torch.ops.flash_decode import (flash_decode_dist,
                                                    sp_paged_attend_write)
from triton_dist_tpu_torch.serving.engine import ServingEngine
from triton_dist_tpu_torch.serving.kv_pool import shard_pool_arrays
from triton_dist_tpu_torch.shmem.context import (ShmemContext,
                                                 initialize_distributed)
from triton_dist_tpu_torch.utils.env import default_device

MESH_AXES = ("tp", "sp", "ep")
# aligned row blocks of the two programs' MoE FFNs: decode rows (slots x
# top-k, 16 at 8 slots x top-2) in one 16-row block per used expert instead
# of padding each to the TPU's 128; chunk rows (512 at 256 x top-2) in the
# kernel's 64-row tensor-core tile, each expert padded by under 64 rows
DECODE_BLOCK_M = 16
CHUNK_BLOCK_M = 64
# the default microbatches of overlap="ep" (double buffering)
OVERLAP_MICROBATCHES = 2

_SERVING = 'item 10 "the rest of the single-device serving tier"'


class ReplicatedDecisionError(AssertionError):
    """The ranks' control-plane digests diverged: some rank's allocator or
    scheduler decided otherwise than rank 0's, and the block tables are
    about to disagree."""


# The fit t = t0 + bytes / rate of the long-context fold across ranks (B8)
# that ``fd_attn_split_us`` prices with: chip_smoke.py phase 17a's
# least-squares fit of B8's kernel-alone times (``torch.profiler``) at 2 and
# 4 ranks on the 16384-token prompt's decode rows (8) and chunk rows (one
# block of 64 or 32), bytes the remote slabs a rank folds ((n - 1) x rows x
# pages x Hq x (D + 1) f32). On one NVIDIA H100 80GB HBM3 at a 700 W power
# limit, every rank on the one card (emulated ranks, not NVLink).
FD_FIT = {"t0_us": 169.01, "gb_per_s": 760.54}


def fd_attn_split_us(n_sp: int, n_layers: int, slots: int, steps: int,
                     page_kv_bytes: int, slab_row_bytes: int,
                     fit: dict | None = None) -> tuple[float, float]:
    """The modelled attention split of a long-context decode step (the
    reference's ``fd_attn_split_us``), priced on ``fit`` (t = t0 + bytes /
    rate; this card's ``FD_FIT`` by default): ``attn_local_us``, each
    rank's walk of its own slice of a slot's ``steps`` block-table pages
    (``ceil(steps / n_sp)`` pages of ``page_kv_bytes`` a slot and layer),
    and ``attn_fold_wait_us``, the fold's wait on the n - 1 remote slabs
    (``slots x steps x slab_row_bytes`` each, one t0 a layer), 0 at one
    rank. A model, not a measurement."""
    fit = fit or FD_FIT
    bw = fit["gb_per_s"] * 1e3          # bytes a microsecond
    local = n_layers * slots * (-(-steps // n_sp)) * page_kv_bytes / bw
    if n_sp == 1:
        return local, 0.0
    fold = n_layers * (fit["t0_us"]
                       + (n_sp - 1) * slots * steps * slab_row_bytes / bw)
    return local, fold


def serving_mesh(tp: int = 1, sp: int = 1, ep: int = 1) -> ShmemContext:
    """The TP×SP×EP serving mesh over ``MESH_AXES`` (at most 8 ranks on
    the one card), on the card; the engine moves it to its own device."""
    return ShmemContext(MESH_AXES, (tp, sp, ep), torch.device("cuda"))


def _later(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue A, "
                              f"{item}")


class ShardedServingEngine(ServingEngine):
    """``ServingEngine`` serving an MoE model on a TP×SP×EP mesh (see the
    module docstring).

    ``cfg`` is a ``MoEConfig`` and ``params`` its parameters; ``ctx`` a
    ``serving_mesh`` (1×1×1 by default). ``prefill_chunk`` is required;
    ``num_slots`` and ``prefill_chunk`` must split over |ep|, and
    ``d_model`` must be a multiple of 128. ``wire_dtype`` is None (the
    plain wire, the port's default), ``"auto"`` (``pick_wire_dtype`` over
    the card's ``WIRE_FIT``), ``torch.float8_e4m3fn`` or ``torch.int8``.
    ``tp_impl`` is "xla" or "ag_gemm". ``overlap`` is "off", "ep" (with
    ``overlap_microbatches``, 2 by default) or "ep+sp" (the same, and the
    pool gathered by B6). ``long_context`` serves through
    ``flash_decode_dist`` over an interleaved pool at any SP size.
    ``moe_block_m`` sets both programs' aligned row block
    (``DECODE_BLOCK_M`` / ``CHUNK_BLOCK_M`` by default).
    ``digest_every=k`` checks the replicated decisions every k-th
    productive step (0: never)."""

    def __init__(self, params: dict, cfg: MoEConfig, ctx=None,
                 num_slots: int = 4, page_size: int = 16,
                 num_pages: int = 64, pages_per_seq: int = 8,
                 decode_horizon: int = 1, eos_id: int | None = None,
                 prefill_chunk: int | None = None,
                 stall_deadline_steps: int = 256, wire_dtype=None,
                 tp_impl: str = "xla", tp_cfg=None,
                 moe_block_m: int | None = None, overlap: str = "off",
                 overlap_microbatches: int | None = None,
                 digest_every: int = 1, journal=None,
                 long_context: bool = False, speculate=None,
                 device="cuda"):
        dev = default_device(device)
        ctx = ctx or serving_mesh()
        if tuple(ctx.axis_names) != MESH_AXES:
            raise ValueError(f"the mesh's axes are {ctx.axis_names}; build it "
                             f"with serving_mesh(tp, sp, ep)")
        if ctx.device != dev:
            ctx = initialize_distributed(ctx.axis_names, ctx.mesh_shape,
                                         device=dev)
        if prefill_chunk is None:
            raise ValueError("sharded serving requires prefill_chunk: the "
                             "bucketed inline prefill takes no hook")
        n_tp, n_sp, n_ep = (ctx.axis_size(a) for a in MESH_AXES)
        if speculate not in (None, 0, "off"):
            _later("speculate", _SERVING)
        if journal is not None:
            _later("the journal and its restore rung", _SERVING)
        if overlap not in ("off", "ep", "ep+sp"):
            raise ValueError(f"overlap must be 'off', 'ep' or 'ep+sp', got "
                             f"{overlap!r}")
        if tp_impl not in ("xla", "ag_gemm"):      # raises with its reason
            tp_column_linear(ctx, None, None, impl=tp_impl)
        if num_slots % n_ep or prefill_chunk % n_ep:
            raise ValueError(f"num_slots {num_slots} and prefill_chunk "
                             f"{prefill_chunk} must split over ep = {n_ep}")
        self.ctx = ctx
        self.moe_cfg = cfg
        self.mesh_desc = f"{n_tp}x{n_sp}x{n_ep}"
        self.long_context = long_context

        def layer(rows: int, seg: int = 0):
            lay = EPAll2AllLayer.create(
                ctx, max_tokens=rows // n_ep, hidden=cfg.base.d_model,
                topk=cfg.topk, num_experts=cfg.num_experts, axis="ep",
                dtype=cfg.base.dtype, wire_dtype=wire_dtype)
            if seg:
                lay = dataclasses.replace(lay, a2a=dataclasses.replace(
                    lay.a2a, seg_push=seg))
            return lay

        self.overlap = overlap
        mb = 1
        if overlap != "off":
            mb = int(overlap_microbatches or OVERLAP_MICROBATCHES)
            if mb < 1 or (num_slots // n_ep) % mb or \
                    (prefill_chunk // n_ep) % mb:
                raise ValueError(f"rows a rank ({num_slots // n_ep} decode, "
                                 f"{prefill_chunk // n_ep} chunk) must split "
                                 f"into {mb} microbatches")
        self.overlap_microbatches = mb
        seg = 2 if mb > 1 else 0
        self.a2a_decode = layer(num_slots, seg)
        self.a2a_chunk = (self.a2a_decode if prefill_chunk == num_slots
                          else layer(prefill_chunk, seg))
        wd, wc = self.a2a_decode.a2a.wire_dtype, self.a2a_chunk.a2a.wire_dtype
        self.wire_dtype = None if wd is None else str(wd).split(".")[-1]
        self.wire_dtype_chunk = None if wc is None else str(wc).split(".")[-1]

        def moe_ffn(lay, block_m: int):
            def ffn(h, p):
                return moe_mlp_ep_overlap(ctx, lay, h, p["w_router"],
                                          p["we_gate"], p["we_up"],
                                          p["we_down"], block_m=block_m,
                                          microbatches=mb)
            return ffn

        if long_context:
            self._pool_layout = "interleaved"

            def attn_io(q, k, v, kp, vp, bt, pos, kv_len, active):
                return flash_decode_dist(ctx, q, k, v, kp, vp, bt, pos,
                                         kv_len, axis="sp", active=active)
        else:
            sp_overlap = overlap == "ep+sp"

            def attn_io(q, k, v, kp, vp, bt, pos, kv_len, active):
                return sp_paged_attend_write(ctx, q, k, v, kp, vp, bt, pos,
                                             kv_len, axis="sp", active=active,
                                             overlap=sp_overlap)

        def linear(h, w, name):
            return tp_column_linear(ctx, h, w, axis="tp", impl=tp_impl,
                                    cfg=tp_cfg)

        self._pool_sp_ranks = n_sp
        self._exposed_comm_us, self._overlapped_comm_us = \
            self._comm_split_us(cfg.base.n_layers, mb)
        base = cfg.base
        self._attn_local_us, self._attn_fold_wait_us = (
            fd_attn_split_us(
                n_sp, base.n_layers, num_slots, pages_per_seq,
                2 * base.n_kv_heads * page_size * base.head_dim
                * base.dtype.itemsize,
                base.n_heads * (base.head_dim + 1) * 4)
            if long_context else (0.0, 0.0))
        super().__init__(params, cfg.base, num_slots=num_slots,
                         page_size=page_size, num_pages=num_pages,
                         pages_per_seq=pages_per_seq,
                         decode_horizon=decode_horizon, eos_id=eos_id,
                         prefill_chunk=prefill_chunk,
                         stall_deadline_steps=stall_deadline_steps,
                         ffn=moe_ffn(self.a2a_decode,
                                     moe_block_m or DECODE_BLOCK_M),
                         ffn_chunk=moe_ffn(self.a2a_chunk,
                                           moe_block_m or CHUNK_BLOCK_M),
                         attn_io=attn_io, linear=linear, device=dev)
        self.pool = shard_pool_arrays(self.pool, n_sp)
        self.digest_every = digest_every
        self.n_ranks = ctx.num_ranks
        self._digest_skew = np.zeros(self.n_ranks, np.uint32)

    def _comm_split_us(self, n_layers: int, mb: int) -> tuple[float, float]:
        """(exposed, overlapped) µs of EP wire a decode step, modelled with
        the card's ``WIRE_FIT`` (t = t0 + bytes / rate): with M microbatches
        all but one round of each all-to-all hides behind the FFN, and the
        total pays M launches. Zero at ep = 1 (no wire to hide). A model,
        not a measurement: on one card the ranks' puts and the FFN share
        the SMs and the HBM."""
        a2a = self.a2a_decode.a2a
        if a2a.n_ranks == 1:
            return 0.0, 0.0
        wire = a2a.wire_dtype
        fit = WIRE_FIT["fp8" if wire is not None and wire.itemsize == 1
                       else "bf16"]
        bw_us = fit["gb_per_s"] * 1e3
        b = a2a_wire_bytes(a2a.n_ranks, a2a.max_tokens, a2a.hidden, a2a.topk,
                           wire)
        total = n_layers * (mb * fit["t0_us"] + b / bw_us)
        exposed = n_layers * (fit["t0_us"] + b / (mb * bw_us))
        return exposed, max(0.0, total - exposed)

    def check_replicated_decisions(self) -> None:
        """Gather every rank's control digest over the whole mesh (B9) and
        compare each with rank 0's; raise ``ReplicatedDecisionError`` on a
        divergence. ``_digest_skew`` [ranks] is added to the ranks' words
        (the tests' way to fork one). One rank has nothing to compare: the
        check returns at once. With every rank emulated in this process,
        one allocator and one scheduler decide for all of them, so only the
        skew can make the words differ: the check exercises the gather and
        the guard, not an independent control plane."""
        if self.n_ranks == 1:
            return
        h = self.control_digest()
        vals = (np.full(self.n_ranks, h, np.uint32)
                + self._digest_skew).view(np.int32)
        words = torch.from_numpy(vals.copy()).to(self.device)
        g = all_gather(self.ctx, words, axis=MESH_AXES,
                       method="push").view(-1, self.n_ranks)
        mismatch = bool((g != g[:, :1]).any().item())
        self.metrics.inc("digest_checks")
        if mismatch:
            bad = np.nonzero(vals != vals[0])[0].tolist()
            raise ReplicatedDecisionError(
                f"control-plane digest diverged across ranks at step "
                f"{self._steps}: ranks {bad} disagree with rank 0 (digest "
                f"0x{h:08x}, mesh {self.mesh_desc}); the block tables are no "
                f"longer trustworthy")

    def _post_step(self) -> None:
        """The modelled comm split's observations, then the digest check
        every ``digest_every`` steps; with no journal to restore from, a
        divergence raises."""
        self.metrics.observe("exposed_comm_us", self._exposed_comm_us)
        self.metrics.observe("overlapped_comm_us", self._overlapped_comm_us)
        self.metrics.observe("attn_local_us", self._attn_local_us)
        self.metrics.observe("attn_fold_wait_us", self._attn_fold_wait_us)
        if self.digest_every and self._steps % self.digest_every == 0:
            self.check_replicated_decisions()


__all__ = ["CHUNK_BLOCK_M", "DECODE_BLOCK_M", "FD_FIT", "MESH_AXES",
           "OVERLAP_MICROBATCHES", "ReplicatedDecisionError",
           "ShardedServingEngine", "fd_attn_split_us", "serving_mesh"]
