"""MoE serving on one rank: the one-rank form of the JAX
``triton_dist_tpu/serving/sharded.py::ShardedServingEngine``.

The JAX engine runs the serving programs over a TP×SP×EP mesh. At mesh
1×1×1 every hook reduces to its one-rank form: the SP attention to the
paged KV write plus ``gqa_decode_paged`` (the base engine's own path), the
TP projections (``tp_impl="xla"``) to plain products, and the EP MoE FFN to
``models.moe.moe_mlp_ep_overlap``'s one-rank form, whose dispatch and
combine (B21's one-rank form) and grouped GEMMs (B18, B17) are hand-written
kernels. That is the engine this module
builds: ``ServingEngine`` with the MoE ``ffn`` hooks. The JAX package uses
the same 1×1×1 engine as the golden of every mesh size.

``long_context=True`` swaps the attention leg for
``ops.flash_decode.flash_decode_dist`` (per-page partials folded in page
order, ``csrc/flash_decode_dist.cu``) over an ``"interleaved"`` pool layout,
as the JAX engine does. At one rank the layout is the identity and the fold
has one rank's pages: the attention is the plain engine's, summed in another
order. The JAX engine's modeled attention split (``fd_attn_split_us``) is
not ported: it is priced with the TPU's wire fit, and the split across ranks
waits for ROADMAP.md Queue A, item 8 "SP decode and sharded serving across
ranks", where it is to be priced from an H100 measurement.

Mesh axes above 1, a quantised a2a wire, the overlap schedules and
speculation raise ``NotImplementedError``: they wait for the kernels across
ranks behind them (ROADMAP.md Queue A, items 7 "MoE / EP across ranks" and
8 "SP decode and sharded serving across ranks"; speculation is item 10,
"the rest of the single-device serving tier"). The replicated-decision digest has nothing to compare at one
rank.
"""

from __future__ import annotations

import dataclasses

from triton_dist_tpu_torch.models.moe import MoEConfig, moe_mlp_ep_overlap
from triton_dist_tpu_torch.ops.flash_decode import flash_decode_dist
from triton_dist_tpu_torch.serving.engine import ServingEngine

MESH_AXES = ("tp", "sp", "ep")
# aligned row blocks of the two programs' MoE FFNs: decode rows (slots x
# top-k, 16 at 8 slots x top-2) in one 16-row block per used expert instead
# of padding each to the TPU's 128; chunk rows (512 at 256 x top-2) in the
# kernel's 64-row tensor-core tile, each expert padded by under 64 rows
DECODE_BLOCK_M = 16
CHUNK_BLOCK_M = 64


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """The sizes of the serving mesh's ``MESH_AXES``."""

    tp: int = 1
    sp: int = 1
    ep: int = 1

    def axis_size(self, name: str) -> int:
        return getattr(self, name)


def serving_mesh(tp: int = 1, sp: int = 1, ep: int = 1) -> ServingMesh:
    """The TP×SP×EP serving mesh (the port serves 1×1×1 only)."""
    return ServingMesh(tp, sp, ep)


def _later(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue A, "
                              f"{item}")


_MOE = 'item 7 "MoE / EP across ranks"'
_SP = 'item 8 "SP decode and sharded serving across ranks"'


class ShardedServingEngine(ServingEngine):
    """``ServingEngine`` serving an MoE model at mesh 1×1×1 (see the module
    docstring).

    ``cfg`` is a ``MoEConfig`` and ``params`` its parameters
    (``models.moe.init_moe_params`` or ``models.convert.params_from_jax``).
    ``prefill_chunk`` is required, as in the JAX engine. ``moe_block_m`` sets
    the aligned row block of both programs' MoE FFN; by default decode takes
    ``DECODE_BLOCK_M`` and prefill chunks ``CHUNK_BLOCK_M`` (a row's result
    does not depend on it). ``wire_dtype`` defaults to None here, the only
    value one rank takes (the JAX default "auto" picks a wire for the a2a).
    ``long_context=True`` serves the attention through
    ``flash_decode_dist`` over an interleaved pool layout (see the module
    docstring); the projections stay plain products (``tp_impl="xla"``).
    """

    def __init__(self, params: dict, cfg: MoEConfig, ctx=None,
                 num_slots: int = 4, page_size: int = 16,
                 num_pages: int = 64, pages_per_seq: int = 8,
                 decode_horizon: int = 1, eos_id: int | None = None,
                 prefill_chunk: int | None = None,
                 stall_deadline_steps: int = 256, wire_dtype=None,
                 tp_impl: str = "xla", moe_block_m: int | None = None,
                 overlap: str = "off", long_context: bool = False,
                 speculate=None, device="cuda"):
        ctx = ctx or serving_mesh()
        wide = {ax: ctx.axis_size(ax) for ax in MESH_AXES
                if ctx.axis_size(ax) > 1}
        if wide:
            _later(f"serving on mesh axes {wide}", _SP)
        if wire_dtype is not None:
            _later(f"the a2a wire dtype {wire_dtype!r} (B21)", _MOE)
        if overlap != "off":
            _later(f"overlap={overlap!r} (B22, B6)", f"{_MOE} and {_SP}")
        if speculate not in (None, 0, "off"):
            _later("speculate", 'item 10 "the rest of the single-device '
                   'serving tier"')
        if tp_impl != "xla":
            _later(f"tp_impl={tp_impl!r} (tp_column_linear's modes)", _SP)
        if prefill_chunk is None:
            raise ValueError("sharded serving requires prefill_chunk: the "
                             "bucketed inline prefill takes no hook")
        self.ctx = ctx
        self.moe_cfg = cfg
        self.long_context = long_context
        attn_io = None
        if long_context:
            self._pool_layout = "interleaved"

            def attn_io(q, k, v, kp, vp, bt, pos, kv_len, active):
                return flash_decode_dist(ctx, q, k, v, kp, vp, bt, pos,
                                         kv_len, axis="sp", active=active)
        self._pool_sp_ranks = ctx.axis_size("sp")

        def moe_ffn(block_m: int):
            def ffn(h, p):
                return moe_mlp_ep_overlap(h, p["w_router"], p["we_gate"],
                                          p["we_up"], p["we_down"], cfg.topk,
                                          block_m=block_m)
            return ffn

        super().__init__(params, cfg.base, num_slots=num_slots,
                         page_size=page_size, num_pages=num_pages,
                         pages_per_seq=pages_per_seq,
                         decode_horizon=decode_horizon, eos_id=eos_id,
                         prefill_chunk=prefill_chunk,
                         stall_deadline_steps=stall_deadline_steps,
                         ffn=moe_ffn(moe_block_m or DECODE_BLOCK_M),
                         ffn_chunk=moe_ffn(moe_block_m or CHUNK_BLOCK_M),
                         attn_io=attn_io, device=device)


__all__ = ["MESH_AXES", "ServingMesh", "ShardedServingEngine",
           "serving_mesh"]
