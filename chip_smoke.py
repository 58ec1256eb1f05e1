#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``triton_dist_tpu_torch``).

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its lines:

1. device: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, the TF32 switches (both off);
2. build: every CUDA source of the port compiled with ``nvcc`` for sm_90a,
   all at once, from the files in the repository;
3. kernels: each kernel against its plain PyTorch version at the shapes of
   the serving path, in bf16 and f32, with stated tolerances, and timed
   beside its plain version and the closest single PyTorch call;
4. model: the paged decode step's logits against a dense full-sequence
   forward, in f32 at the full width of Llama-3-8B with the depth cut to 4
   layers, and in bf16 at full width and depth (random weights from a seed);
5. engine: a seeded trace served by ``ServingEngine`` at full width, with
   admission, chunked prefill, growth and preemption; every request must
   finish, the kernel's launch count must match the dispatches, and a rerun
   must give bit-identical token streams;
6. profile: one decode dispatch under ``torch.profiler``, its device time by
   kernel family and the device's idle share;
7. ring attention: the forward and backward kernels against their plain
   versions at the training shape (B=1, Hq=32, Hkv=8, D=128, S=4096,
   causal) in bf16 and f32, at a ragged S=1000 in both, and not causal;
   errors against stated tolerances, two launches bitwise equal, and times
   beside the plain versions, the bound and ``scaled_dot_product_attention``;
8. train: the cp train step (ring attention in every layer) at the full
   width of Llama-3-8B: first its loss and gradients against the dense-
   attention step in f32 at depth 2, S=1024; then 5 bf16 steps at depth 16
   on one seeded batch of 4096 tokens (losses finite and falling, each
   kernel launched layers x steps times), its step time, tokens/s, peak
   memory and one step under ``torch.profiler``;
9. MoE: Mixtral-8x7B's widths (d_model 4096, 32/8 heads, 8 experts top-2,
   expert FFN 14336, vocab 32000) with the depth cut to 4 layers, random
   weights from a seed: the one-rank EP dispatch and combine
   (``ep_dispatch``, ``ep_combine``) and the grouped GEMM kernels
   (``grouped_gemm_gated``, ``grouped_gemm``) against their plain versions
   at the decode and chunk row counts in bf16 and f32 (bitwise repeatable,
   timed beside the bound, the plain version and ``F.embedding_bag`` or
   ``torch._grouped_mm``), the MoE block against a plain reference block
   written out in this script, a seeded trace served twice by the one-rank
   ``ShardedServingEngine`` (every request finishes, preemptions, launches =
   layers x (decode steps + chunks) for each kernel, bit-identical rerun),
   and one decode dispatch under ``torch.profiler``;
10. contiguous-cache decode on phase 5's 32-layer bf16 params: the split-KV
   decode (``gqa_decode_partial``), its combine (``decode_combine``) and
   the SP merge (``ll_merge``, the merge half of ``ll_ag_merge``) against
   their plain versions in bf16 and f32 at G-batch's and G-long's decode
   shapes and at ragged lengths (bitwise repeatable, each row alone equal
   to its row in the batch; timed beside the bound, the plain version and
   ``scaled_dot_product_attention``), and the one-rank push/ring
   ``all_gather`` at the SP wire's shape (exact, timed beside a clone);
   ``decode_step`` against the dense forward in f32 at depth 4 (run beside
   phase 4), with the one-rank ``decode_step_sp`` (fused, push and ring)
   bitwise equal to it; ``generate`` at full width and
   depth for G-batch (8 prompts of 1024 tokens, 128 new, run twice,
   bit-identical) and G-long (one prompt of 7936 tokens, 128 new, cache of
   8192), with each kernel launched layers x decode steps times; and one
   G-batch decode step under ``torch.profiler``;
11. the tensor-parallel overlap forward on phase 5's params: the dense GEMM
   (``matmul``, B2) against its plain version at the four GEMMs of a layer
   at 4096 token rows, a ragged shape, a transposed B and in f32 (bitwise
   repeatable, timed beside the bound, the plain version and
   ``torch.matmul``); AG-GEMM (B15) and GEMM-RS (B16) through the
   persistent ``tp_linear`` layers, and GEMM-RS's slot reduction alone;
   ``forward_tp_overlap`` against the dense ``forward`` in f32 at depth 4
   (run beside phase 4), and at full depth in bf16 on 2 x 2048 tokens
   twice (bit-identical; launches, time by family, idle share, peak memory,
   the dense forward beside it); ``mlp_tp_overlap``'s f32 gradients against
   the dense MLP's, and one bf16 forward plus backward at 4096 rows;
12. long-context serving at one rank on phase 9's weights (run inside
   phase 9's lifetime): the per-page partials (``fd_page_partials``, B7)
   against their plain version at a decode shape (8 rows over 2056 pages,
   ragged lengths up to 32896) and a chunk shape in bf16 and f32 (neutral
   entries exact, bitwise repeatable, a rank-1 slice of the pool giving the
   rank-0 bits on its pages and the neutral entry off them), the fused n = 1
   route (``fd_partials_fold``) bitwise equal to the fold of B7's slab and
   within a row's rounding of its plain version, at S <= 256 and at the
   long prompt's decode (8 rows) and last chunk, where it is timed beside
   its bound, plain version and ``scaled_dot_product_attention``, and
   ``flash_decode_dist`` against ``gqa_decode_paged``; one prompt of 16384 tokens
   (Mixtral's window of 32768, cut to hold the phase's time) plus 128
   new through ``ShardedServingEngine(long_context=True)`` twice
   (bit-identical; TTFT, prefill s, decode ms per step, tok/s, peak memory,
   launches), one decode dispatch at the prompt's length under the
   profiler, and phase 9's first four requests through the long-context
   and the plain engine (in bf16 the streams equal up to each one's first
   divergence, which must be a near-tie of both engines' logits; in f32 at
   full width, the depth cut to 2 layers, equal);
13. the MoE tensor-parallel block on layer 0's experts at 8, 256 and 4096
   tokens: at one rank ``ag_moe_group_gemm`` (B19), ``moe_reduce_rs``
   (B20) and B20's grouped GEMM from bf16 into f32 against their plain
   versions (padding rows, bitwise repeat), ``moe_mlp_tp_overlap`` against a
   plain per-expert block written out in this script, each timed beside its
   bound, plain version and ``torch._grouped_mm``, and the block's launches;
   across ranks, at 2 and 4 (``csrc/moe_tp.cu``): B19 and B20 bitwise their
   composition from the one-rank kernels (B17 by column block; B17's f32
   partials by K block through the slot reduction) on a rerun and 5 fresh
   calls, within tolerance of their plain versions, padding rows zero,
   every pad zero, a call whose rank 1 never signals raising within 2 s and
   the next call bitwise; the block against the plain block and the
   one-rank block; timed beside the bound over all ranks' work, the plain
   version, the one-rank op and ``torch._grouped_mm``; the block's launches
   at each n (one B19, one B20, two B9 gathers a call).
14. the shmem layer across ranks, every rank of a mesh on the one card
   (inside phase 5's lifetime, on its 32-layer bf16 params): tutorial 01's
   ring ping and the barrier (``barrier_all_op``, B14) at 2 and 4 ranks
   (exact, bitwise repeat), a ping whose rank 1 never signals raising
   within 2 s; the push and ring ``all_gather`` (B9) of AG-GEMM's input
   (4096 x 4096 bf16) and the ring ``reduce_scatter`` (B13) of GEMM-RS's
   f32 partial (4096 x 4096 on every rank; bf16 too at 4 ranks) at 2 and 4
   ranks against their plain versions (bit for bit, repeated with fresh
   data), the fused gather and merge (``ll_ag_merge``, B5) at the SP decode's
   shapes (every replica bitwise ``ll_merge`` of the stacked partials);
   then the main path, launches counted: G-long (one prompt of 7936 in 8192
   slots) at 2 and 4 ranks and G-batch (8 of 1024 in 4096) at 4 ranks, 32
   greedy ``decode_step_sp`` steps of each method (fused, push, ring) over
   the prefilled cache sharded on S (replicas bitwise equal, push and ring
   bit for bit, a bitwise rerun, the tokens of ``decode_step`` up to each
   row's first near-tie), and the collectives once each at TP widths; one
   SP decode step under the profiler at 1 and 4 ranks. Beside phase 4 (f32,
   full width, depth 4), ``decode_step_sp`` at 2 and 4 ranks, every method,
   fed one rank's tokens, must give ``decode_step``'s logits within 1e-5
   of their scale. A time at n > 1 is
   the kernels and their protocol on one card's SMs and HBM, not NVLink.
15. tensor-parallel overlap across ranks on the one card (inside phase 5's
   lifetime, on its 32-layer bf16 params): AG-GEMM (B15) and GEMM-RS (B16)
   at Llama-3-8B's TP widths over 4096 token rows (qkv, gate‖up; wo, down)
   at 2 and 4 ranks, bf16, through their persistent contexts: bitwise
   their composition from the one-rank kernels (B2 on the gathered A by
   column block; B2's f32 partials through the slot reduction in slot
   order), on a rerun and on 5 calls with fresh data, within 2e-2 of their
   plain versions, the workspace slots as the protocol leaves them and the
   signal pads zero; timed beside the bound over all ranks' work, the plain
   version, one-rank B2 on the whole product and ``torch.matmul``. Then
   the main path, launches counted: ``forward_tp_overlap`` at 1, 2 and 4
   ranks on 2 x 2048 tokens (twice each, bitwise; wall time, peak memory,
   device time by family and idle share under the profiler), its logits at
   n ranks within a gate of one rank's scale and a control (one rank's
   shard of ``wo`` zeroed in every layer) outside it; and
   ``mlp_tp_overlap``'s output and gradients in f32 at 1024 tokens at 2
   and 4 ranks within 1e-5 of one rank's scale. Beside phase 4 (f32, full
   width, the depth cut to 2), the logits at 2 and 4 ranks within 1e-5 of
   one rank's scale.
16. the sharded MoE serving engine across ranks on the one card (inside
   phase 9's lifetime, on its Mixtral weights): (a) the EP wire, B21
   (``all_to_all_push``) and B22 (``all_to_all_push_seg``, 2 segments),
   at 2, 4 and 8 ranks at the engine's decode rows (8 tokens, top-2) and
   chunk rows (256), H 4096, for the plain, fp8 and int8 wires with the
   quantise and dequantise in the kernel (both, each alone) and the
   pre-quantised wire: every rank's outputs bitwise the plain version's,
   on a rerun and 5 fresh calls, every pad zero; timed (between CUDA
   events, the kernel alone, plain, ``transpose(0, 1).contiguous()``,
   bound); a wire whose rank 1 never signals raises within its budget;
   (b) ``moe_mlp_ep_overlap`` of layer 0 at ep = 4, plain and fp8 wire, 1
   and 2 microbatches, bitwise the block at ep = 1; B2's column blocks of
   the projections bitwise its whole product (cuBLAS's recorded); (c) the
   main path,
   launches counted: the first 10 requests of phase 9's trace through
   ``ShardedServingEngine`` with the fp8 wire at 1x1x1 (the golden), 1x1x2,
   1x1x4, 1x1x4 with ``overlap="ep"``, 2x1x2, 1x2x2 and 2x2x2, and with the
   plain wire at 1x1x1 and 1x1x4: every mesh's streams bitwise its golden's,
   every request finished, a preemption in each; tok/s and TTFT per mesh,
   the 1x1x1 engine's time with cuBLAS projections beside it, one decode
   dispatch of the 1x1x4 engine under the profiler; (d) the
   wire fit t = t0 + bytes / rate of the bf16 and fp8 wires from (a)'s
   kernel times. A time at n > 1 is every rank on the one card.
   Phase 17 extends (c) with ``overlap="ep+sp"`` at 1x2x2 and 2x2x2
   (B22's microbatches and B6's start-local pool gather).
17. the sharded engine's SP modes and disaggregated serving: (a) after
   phase 16, with no model weights held: B8 (``fd_fold_dist``, through
   ``flash_decode_dist`` in blocks of rows) at 2 and 4 ranks at the long
   prompt's decode (8 rows) and chunk (256 rows) shapes, bitwise the fused
   n = 1 fold on a rerun and 5 fresh calls, within a row's rounding of its
   plain version, pads zero, the peak a call adds under 8 GiB, and the fit
   t = t0 + bytes / rate of its times (the engine's ``FD_FIT``); B6
   (``pool_ag_start_local``) at 2 and 4 ranks and inside a 2x2x2 mesh's sp
   groups on one layer of the engine's pools, bitwise its plain version
   and B9's gather; B23 (``paged_transport``, through ``migrate_pages``
   and ``lend_pages``) at Llama-3-8B's pools, 17 pages in a 64-entry id
   list over 32 layers, bitwise its plain version with the padding
   untouched and landed (n, tag), a starved call raising within 2 s and
   the next one bitwise; each timed between CUDA events and under the
   profiler beside its bound, plain version and closest PyTorch call. (b)
   inside phase 12: its prompt through ``long_context=True`` at 1x2x1 and
   1x4x1, bitwise phase 12's 1x1x1 streams, every kernel of the path to
   its exact count. (c) inside phase 5's lifetime: its trace through
   ``DisaggServingEngine`` twice (the same slots, chunk and horizon, a
   pool the decode worker never outgrows, a forced prefill preemption):
   every request bitwise the colocated engine's, the decode worker's
   prompt tokens 0, each prompt page migrated once; tok/s, TTFT, B23's
   launches and pages, and one step under the profiler.

18. the SP + EP MoE decode step (inside phase 9's lifetime, on its
   Mixtral weights): ``moe_decode_step_sp`` at 1, 2 and 4 ranks, B = 8
   rows, a cache of 4096 slots sharded on S, a 64-token prompt
   teacher-forced through the step and 32 greedy steps (the largest rank
   count twice): replicas bitwise, the rerun bitwise, the tokens n = 1's up
   to each row's first near-tie, B3, B5, B21 (twice), B18 and B17 launched
   once a layer-step; ms a step and one step under the profiler. In f32 at
   full width, the depth cut to 2 and 32 slots, the logits at 2 and 4 ranks
   within 1e-5 of one rank's scale, and one rank's within 1e-3 of a dense
   golden (``decode_step`` with a plain per-expert FFN written out here).
19. the collectives in full across ranks (inside phase 5's lifetime, on
   its 32-layer bf16 params): B11 (``all_gather`` ``push_2d``, the 2-tier
   relay of ``csrc/ag_relay_2d.cuh``) and ``ring_2d`` on (2, 2), (2, 4) and
   (2, 2, 2) meshes at AG-GEMM's input (4096 x 4096 bf16 in all) and the SP
   wire at B = 8, beside ``Tensor.repeat`` and the flat 1-D B9 push over the
   same ranks; B10 (``all_gather_ll``) at 2, 4 and 8 ranks at 4, 16 and 64
   KiB a rank and the B = 1 SP wire, 6 calls through one ``AgLLContext``
   (each parity three times, a barriered B9 push after the third), the
   workspace's slots checked, timed beside B9's push at the same payload;
   B12 (``broadcast``) at 2, 4 and 8 ranks, roots 0 and n - 1, 4 KiB and 32
   MiB, and inside the groups of (2, 2), beside
   ``x[root].expand(N, ...).clone()``; B13 over each axis's groups and as
   ``ring_2d`` on (2, 2) and (2, 4) (GEMM-RS's f32 partial, bf16 too on
   (2, 2)), every group's segments checked, beside ``torch.sum``; B5 over
   the groups of (2, 2) at G-batch's and G-long's partials. Each bitwise
   its plain version on a rerun and 5 fresh calls, every pad zero, a call
   whose rank 1 never signals raising within 2 s and the next one bitwise.
   Then the main path, launches counted: G-long (7936 tokens in 8192
   slots), 16 greedy ``decode_step_sp`` steps on (2, 2) over ("a", "b")
   (``push_2d``, ``ring_2d``, ``auto``) and over b's two groups (fused,
   push, ring; the last twice), beside the 1-D runs at 4 ranks (push) and 2
   (each method): replicas bitwise, the 2-D runs bitwise the 4-rank push,
   the b runs bitwise the 2-rank runs, the rerun bitwise, the tokens one
   rank's up to each row's first near-tie, each kernel its exact count a
   layer-step; the collectives once each; one step under the profiler.
   Beside phase 4 (f32, full width, depth 4) the same meshes and methods
   within 1e-5 of ``decode_step``'s logit scale.
20. TP overlap and the MoE-TP block over a group and over two tiers: (a)
   inside phase 5's lifetime, AG-GEMM (B15) and GEMM-RS (B16) at TP_OPS's
   widths over ("a", "b") of (2, 2) and (2, 4), over ("a", "b", "c") of
   (2, 2, 2) (B15 over the 2-tier relay with B2's tile as its emit; B16's
   inner-group stage on the strided rows, then B13's ring over the outer
   axis) and over b's groups of (2, 2); inside phase 9's lifetime, B19 and
   B20 at phase 13's 8 / 256 / 4096 tokens over ("a", "b") and over b of
   (2, 2). B15 and B19 bitwise their one-axis kernels over as many ranks,
   B16 and B20 over a group bitwise theirs and over two tiers bitwise
   their stage-then-B13 composition from the one-rank kernels; each on a
   rerun, in every group's replica and on 5 fresh calls, within tolerance
   of its plain version, the slots as the protocol leaves them, every pad
   zero, a call whose rank 1 never signals raising within 2 s and the next
   call bitwise; timed beside the one-axis kernel, the bound, the plain
   version and ``torch.matmul`` / ``torch._grouped_mm``. (b) the main
   path, launches counted: ``forward_tp_overlap`` at full width and depth
   on 2 x 2048 tokens over ("a", "b") and over b of (2, 2) (twice each,
   bitwise; within the phase 15 gate of the one-axis run over as many
   ranks; wall time, peak, device time by family); beside phase 4, in f32
   at depth 2, within 1e-4 of the dense forward. (c) inside phase 16: phase
   16c's first 10 requests through ``ShardedServingEngine(tp_impl=
   "ag_gemm")`` at 2x1x1, 2x1x2 and 2x2x2, every stream bitwise the
   2x1x1 engine's, each projection one B15 launch; tok/s and TTFT. (d)
   ``moe_mlp_tp_overlap`` over ("a", "b") and over b at 8 / 256 / 4096
   tokens against the plain block and the one-axis block, launches
   counted.
21. the EP MoE block in its deployed form at DeepSeek-infer's widths
   (d_model 7168, 64 experts of 2048, top-8; the preset's 4 layers, random
   bf16 weights, seed 21; after phase 9 frees Mixtral's): (a) B18 and B17
   in each option's form (fp8 and int8 rows with ``row_scale``, the packed
   gate|up stream, ``block_k`` 256 and 1024, ring depths 2 and 3) on the
   block's aligned rows at 128 and 512 tokens top-8, against their plain
   versions, bitwise on a rerun, the packed stream, every depth and every
   K split bitwise the plain form, timed beside the bound and
   ``torch._grouped_mm``; (b) ``moe_mlp_ep_overlap`` on layer 0 at 1, 2, 4,
   8 ranks, 128 rows a rank, rank-major bf16 (the golden), expert-major
   (bitwise the golden where no row drops; drops counted), the fp8 wire
   post and on the expert edge (within ``FP8_BLOCK_TOL``), and the
   deployed form (expert-major, fp8 expert edge, packed, bitwise its
   two-stream twin): ms a block, idle share, the path taken; (c) the
   2-tier layer on (2, 2) and (2, 4), bf16 bitwise and fp8 within
   tolerance of the flat layer; (d) ``moe_decode_step_sp`` at 4 layers and
   1, 2, 4 ranks, 8 rows a rank, 32 greedy steps with the deployed layer,
   bitwise its fp8 rank-major twin, step 0's logits within
   ``SP_STEP0_TOL`` of the rank-major bf16 layer's in relative L2 and a
   zeroed-cache-shard control outside, launches counted, ms a step.
22. context-parallel training across ranks on the one card (after phase
   8): (a) B24 and B25 across ranks (``csrc/ring_attention.cu``'s ring
   kernels, one cooperative launch a call; the backward after its delta
   pass) at the training shape (B=1, Hq=32, Hkv=8, D=128, global S=4096,
   causal) at 2 and 4 ranks in bf16 and f32, contiguous and zigzag, not
   causal at 4 ranks, and over the (2, 2) ("dp", "cp") mesh with B=2 and
   the batch over dp: against their plain versions within ``RING_TOL`` and
   ``LSE_ATOL``, bitwise on a rerun and on 5 fresh calls, one launch a
   call, every pad zero, a forward and a backward whose rank 1 never
   signals raising within 2 s and the next call bitwise; timed beside the
   bound over every rank's pairs plus the ring's transport, the one-rank
   kernel on the whole sequence, the plain version and
   ``scaled_dot_product_attention``; (b) in f32 at full width, depth 2,
   1024 tokens, the cp step's loss and gradients at 2 and 4 ranks against
   one rank within ``TRAIN_F32``'s tolerances; (c) phase 8's bf16 trainer
   (16 layers, 4096 tokens, 5 steps at lr 1e-5) over a ("cp",) mesh of 2
   and of 4 ranks: losses finite and falling, each ring kernel launched
   layers x steps times, step time, tokens/s, peak memory and one step
   under the profiler. Every time at n > 1 is every rank on the one card.
23. sigcheck on the card (after phase 22): (a) phase 2 builds the traced
   libraries (``-DTDT_SHMEM_TRACE``) beside the untraced ones, in one
   ``build()``, and logs the seconds of each; (b) the broken-protocol
   gallery (B26, ``csrc/sigcheck_gallery.cu``) traced at 2 ranks (and 3
   for ``wait_cycle``): each specimen flagged with its expected kind, and
   each rank's decoded protocol equal to the plain version's; (c) the
   gallery untraced at 2 ranks: each starved specimen raising
   ``ShmemError`` within 2 s naming the gallery kernel, a rank and the
   starved word, ``over_signal`` leaving n - 1 on its word, every pad
   zeroed after each and a B14 barrier clean; (d) ``check_registry()`` at
   every entry's meshes: zero findings on every checked op, events logged
   at every n; (e) B24 and B25 at head dim 256, Gemma-7B's attention widths
   (Hq = Hkv = 16, D = 256, S = 4096, causal) in bf16 and f32, at one rank
   and across 2 and 4 ranks, contiguous and zigzag, against their plain
   versions, bitwise on a rerun, pads zero, timed (bf16) beside the bound
   and ``scaled_dot_product_attention``; then the cp step in f32 at that
   head dim (Llama-3-8B's width with 16 heads of 256, depth 2, 1024
   tokens) at 2 ranks against one rank.

It then prints one JSON line of kernel results and, last, the JSON result
line. Without CUDA, or away from the rest of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and op/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain version: out tolerance by type, lse tolerance (f32 both)
OUT_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_ATOL = 1e-3

HQ, HKV, D, PS, PPS = 32, 8, 128, 16, 64           # Llama-3-8B serving path
# a pool of 128 pages (2048 tokens) is small enough that the trace below
# preempts (three times) while every request still fits alone
ENGINE = dict(num_slots=8, page_size=PS, pages_per_seq=PPS, num_pages=128,
              decode_horizon=4, prefill_chunk=256)
N_REQUESTS = 16


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_cases(dtype, device, seed: int = 0) -> dict:
    """The two shapes the serving path gives ``gqa_decode_paged``.

    ``decode``: 8 slots of one decode step, ragged lengths with an empty row
    and a full row, garbage block-table entries past each row's live pages.
    ``chunk``: 256 rows of one prefill chunk, all walking one sequence's
    pages at staggered lengths (chunk start 512, 240 real rows, 16 padded
    rows with length 0)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    n_pages = 1 + 8 * PPS                      # page 0 is the scratch page

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    def garbage(n):
        return torch.randint(-10 ** 6, 10 ** 6, (n,), generator=gen,
                             device=device, dtype=torch.int32)

    k = randn(n_pages, HKV, PS, D)
    v = randn(n_pages, HKV, PS, D)
    pages = torch.arange(1, n_pages, device=device,
                         dtype=torch.int32).view(8, PPS)

    kv_dec = torch.tensor([PPS * PS, 0, 1, 517, 300, 16, 17, 999],
                          dtype=torch.int32, device=device)
    bt_dec = pages.clone()
    for b in range(8):
        live = -(-int(kv_dec[b]) // PS)
        bt_dec[b, live:] = garbage(PPS - live)

    start, real, rows = 512, 240, 256
    kv_chunk = torch.zeros(rows, dtype=torch.int32, device=device)
    kv_chunk[:real] = torch.arange(start + 1, start + real + 1,
                                   dtype=torch.int32, device=device)
    live = -(-(start + real) // PS)
    row = pages[0].clone()
    row[live:] = garbage(PPS - live)
    bt_chunk = row[None].expand(rows, PPS).contiguous()
    return {
        "decode": dict(q=randn(8, HQ, D), k=k, v=v, bt=bt_dec, kv_len=kv_dec,
                       shared=False),
        "chunk": dict(q=randn(rows, HQ, D), k=k, v=v, bt=bt_chunk,
                      kv_len=kv_chunk, shared=True),
    }


def attention_bound(case: dict, dtype_name: str) -> tuple[float, str]:
    """Least time for the work: each input byte read once (the distinct
    live pages, however many rows share them), each output byte written
    once, against 2 * 2 * Hq * D operations per (row, key)."""
    q, kv_len, bt = case["q"], case["kv_len"], case["bt"]
    esize = q.element_size()
    B = q.shape[0]
    live = set()
    for b in range(B):
        n = -(-int(kv_len[b]) // PS)
        live.update(int(p) for p in bt[b, :n])
    page_bytes = HKV * PS * D * esize
    nbytes = (2 * q.numel() * esize + B * HQ * 4 + 2 * len(live) * page_bytes
              + sum(-(-int(n) // PS) for n in kv_len) * 4 + B * 4)
    ops = 4 * HQ * D * int(kv_len.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(case: dict):
    """The closest single PyTorch call, as a yardstick only: scaled dot-
    product attention over the same K/V gathered contiguous outside the
    timed call, with the lengths as a mask."""
    import torch
    import torch.nn.functional as F

    q, kv_len = case["q"], case["kv_len"]
    P = case["k"].shape[0]
    B = q.shape[0]
    S = PPS * PS
    keys = torch.arange(S, device=q.device)
    if case["shared"]:
        pages = case["bt"][0].long().clamp(0, P - 1)
        kc = case["k"][pages].permute(1, 0, 2, 3).reshape(1, HKV, S, D)
        vc = case["v"][pages].permute(1, 0, 2, 3).reshape(1, HKV, S, D)
        qc = q.transpose(0, 1)[None]                          # [1, Hq, B, D]
        mask = (keys[None, :] < kv_len[:, None])[None, None]  # [1,1,B,S]
    else:
        pages = case["bt"].long().clamp(0, P - 1)
        kc = case["k"][pages].permute(0, 2, 1, 3, 4).reshape(B, HKV, S, D)
        vc = case["v"][pages].permute(0, 2, 1, 3, 4).reshape(B, HKV, S, D)
        qc = q[:, :, None]                                    # [B, Hq, 1, D]
        mask = (keys[None, :] < kv_len[:, None])[:, None, None]
    return lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)


def check_attention(device, timed: bool = True) -> list[dict]:
    """Kernel against plain version in bf16 and f32 at both shapes; raises
    on disagreement. Returns one record per (type, shape)."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.utils.perf import perf_func

    records = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for shape, case in attention_cases(dtype, device).items():
            args = (case["q"], case["k"], case["v"], case["bt"],
                    case["kv_len"])
            out, lse = fd.gqa_decode_paged(*args)
            ref_out, ref_lse = fd.gqa_decode_paged_plain(*args)
            err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            rec = {"case": f"{name} {shape} B={case['q'].shape[0]}",
                   "max_abs_err": err, "lse_max_abs_err": lse_err,
                   "atol": OUT_ATOL[name], "lse_atol": LSE_ATOL}
            if timed:
                rec["ms"] = perf_func(lambda: fd.gqa_decode_paged(*args))[1]
                rec["plain_ms"] = perf_func(
                    lambda: fd.gqa_decode_paged_plain(*args), iters=5)[1]
                rec["library_ms"] = perf_func(sdpa_call(case))[1]
                rec["bound_ms"], rec["bound_by"] = attention_bound(case, name)
            log("kernel gqa_decode_paged", json.dumps(rec))
            if not (err <= OUT_ATOL[name] and lse_err <= LSE_ATOL):
                raise AssertionError(f"gqa_decode_paged disagrees with its "
                                     f"plain version: {rec}")
            records.append(rec)
    return records


# ---------------------------------------------------------------------------
# phase 4: the paged decode step against a dense forward
# ---------------------------------------------------------------------------

# max |logit diff| / max |logit| of the paged decode step against the dense
# forward: f32 sums in another order only; bf16 rounds activations at every
# layer, and at 32 layers of random weights that reaches a few percent
MODEL_TOL = {"float32": 1e-3, "bfloat16": 0.1}


def check_model(params, cfg, device, prompt_len: int = 64) -> dict:
    """One decode step through the paged pool (the kernel) against a dense
    full-sequence forward over the same tokens (no kernel): the logits agree
    within ``MODEL_TOL`` of their scale, and the greedy tokens agree wherever
    the reference's top-2 gap is wider than that."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.serving.kv_pool import cache_to_pages

    gen = torch.Generator(device=device).manual_seed(1)
    B = 4
    toks = torch.randint(1, cfg.vocab_size, (B, prompt_len + 1),
                         generator=gen, device=device)
    ref, _ = llama.prefill(params, toks, cfg,
                           llama.init_kv_cache(cfg, B, prompt_len + 1,
                                               device=device))
    cache = llama.init_kv_cache(cfg, B, prompt_len, device=device)
    _, cache = llama.prefill(params, toks[:, :prompt_len], cfg, cache)
    n = prompt_len // PS + 1
    pool = llama.init_page_pool(cfg, 1 + B * n, PS, device=device)
    bt = torch.arange(1, 1 + B * n, dtype=torch.int32,
                      device=device).view(B, n)
    cache_to_pages(cache["k"], pool["k"], bt[:, :prompt_len // PS])
    cache_to_pages(cache["v"], pool["v"], bt[:, :prompt_len // PS])
    pos = torch.full((B,), prompt_len, dtype=torch.int32, device=device)
    got, _ = llama.decode_step_paged(params, toks[:, -1].int(), pos, cfg,
                                     pool, bt)
    tol = MODEL_TOL[str(cfg.dtype).split(".")[-1]]
    scale = ref.abs().max().item()
    rel = (got - ref).abs().max().item() / scale
    top2 = ref.topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol * scale
    same = got.argmax(-1) == ref.argmax(-1)
    rec = {"dtype": str(cfg.dtype), "layers": cfg.n_layers, "rows": B,
           "prompt_len": prompt_len, "max_rel_err": rel, "tol": tol,
           "finite": bool(torch.isfinite(got).all()),
           "shape": list(got.shape), "clear_rows": int(clear.sum()),
           "tokens_equal_rows": int(same.sum())}
    log("model decode_step_paged vs dense", json.dumps(rec))
    if not (rec["finite"] and rel <= tol and bool(same[clear].all())
            and rec["shape"] == [B, cfg.vocab_size]):
        raise AssertionError(f"paged decode disagrees with the dense "
                             f"forward: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 5: the serving engine
# ---------------------------------------------------------------------------

def make_trace(cfg, n: int, seed: int, lo: int = 64, hi: int = 768):
    """``n`` seeded requests, prompts of ``lo``..``hi`` tokens and 16..64 new
    tokens, arriving one per engine step. The lengths come from their own
    generator, so the page schedule (and the preemptions) do not depend on
    the vocabulary."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, n)
    budgets = rng.randint(16, 65, n)
    tok_rng = np.random.RandomState(seed + 1)
    return [(i, [int(t) for t in tok_rng.randint(1, cfg.vocab_size, plen)],
             int(m)) for i, (plen, m) in enumerate(zip(lens, budgets))]


def serve(make_engine, device, trace, kernels) -> tuple:
    """Serve ``trace`` on a fresh engine from ``make_engine()``; returns
    (tokens by rid, engine, wall seconds, launches by kernel in the run). The
    launch counts of ``kernels`` are set to 0 just before the run."""
    import torch

    eng = make_engine()
    if device.type == "cuda":
        torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = eng.run(max_steps=10_000, arrivals=trace)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (res, eng, time.perf_counter() - t0,
            {k.__name__: k.launches for k in kernels})


def check_engine(params, cfg, device, trace, engine_kw: dict,
                 card: str) -> dict:
    """Serve the trace twice; raise unless every request finished with its
    full budget (``tokens_generated`` also counts the tokens a preempted
    request generated again), a preemption happened, the kernel ran on every
    attention of the run and the two runs' token streams are bit-identical."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.serving import ServingEngine

    def make():
        return ServingEngine(params, cfg, device=device, **engine_kw)

    kernels = (fd.gqa_decode_paged,)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res, eng, wall, launches = serve(make, device, trace, kernels)
    launches = launches["gqa_decode_paged"]
    c = eng.metrics.counters
    h = eng.metrics.hist
    expect_launches = cfg.n_layers * (eng.decode_horizon * c["dispatches"]
                                      + c["prefill_chunks"])
    rec = {
        "card": card, "requests": len(trace),
        "finished": c["requests_finished"],
        "tokens_generated": c["tokens_generated"],
        "tokens_expected": sum(m for _, _, m in trace),
        "prompt_tokens": sum(len(p) for _, p, _ in trace),
        "preemptions": c["preemptions"], "dispatches": c["dispatches"],
        "prefill_chunks": c["prefill_chunks"],
        "gqa_decode_paged_launches": launches,
        "launches_expected": expect_launches,
        "wall_s": wall, "tok_per_s": c["tokens_generated"] / wall,
        "ttft_p50_s": h["ttft_s"].percentile(50),
        "step_device_mean_s": h["step_device_s"].mean,
        "step_host_mean_s": h["step_host_s"].mean,
        "prefill_stall_mean_s": h["prefill_stall_s"].mean,
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if device.type == "cuda" else None),
    }
    del eng
    res2, eng2, wall2, launches2 = serve(make, device, trace, kernels)
    launches2 = launches2["gqa_decode_paged"]
    rec["rerun_bit_identical"] = res2 == res
    rec["rerun_wall_s"] = wall2
    del eng2
    log("engine", json.dumps(rec))
    ok = (rec["finished"] == len(trace) and len(res) == len(trace)
          and all(len(res[i]) == m for i, (_, _, m) in enumerate(trace))
          and rec["tokens_generated"] >= rec["tokens_expected"]
          and rec["preemptions"] >= 1 and launches > 0
          and launches == expect_launches and launches2 == launches
          and rec["rerun_bit_identical"])
    if not ok:
        raise AssertionError(f"engine run failed its checks: {rec}")
    rec["tokens"] = res
    return rec


# ---------------------------------------------------------------------------
# phase 6: where a decode dispatch's time goes
# ---------------------------------------------------------------------------

CUBLAS_NAMES = ("gemm", "gemv", "xmma", "nvjet", "cutlass")


def device_time_by_family(fn, card: bool, families) -> tuple[dict, int]:
    """Run ``fn`` once under ``torch.profiler``: the device seconds of its
    kernels by family (the first of ``families``, ``(name, substrings)``
    pairs, whose substring a kernel's name holds; then cuBLAS's GEMMs;
    then the rest) and the number of device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] +
                 ([ProfilerActivity.CUDA] if card else [])) as prof:
        fn()
        if card:
            torch.cuda.synchronize()
    fams = {name: 0.0 for name, _ in families}
    fams.update(gemm=0.0, other=0.0)
    ops = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ops += 1
        name = e.name.lower()
        fam = next((f for f, keys in families
                    if any(k in name for k in keys)),
                   "gemm" if any(k in name for k in CUBLAS_NAMES)
                   else "other")
        fams[fam] += e.time_range.elapsed_us() / 1e6
    return fams, ops


def profile_dispatch(params, cfg, device, slots: int = 8, kv: int = 512,
                     horizon: int = 4, ffn=None, distinct_tokens: bool = False,
                     label: str = "", attn_io=None, linear=None) -> dict:
    """One decode dispatch (``horizon`` steps over ``slots`` rows at ``kv``
    tokens each, the layers' FFN, attention and projections replaced by
    ``ffn``, ``attn_io`` and ``linear`` when given): its median
    wall time over three plain runs (the ``.cpu()`` of the token slab waits
    for the card), then one run under ``torch.profiler`` for the device time
    by kernel family and the device ops per step. The idle share is 1 -
    device time / plain wall time. Every slot starts from token 1, or with
    ``distinct_tokens`` from a token of its own (1..slots), so that MoE rows
    route to several experts."""
    import torch

    from triton_dist_tpu_torch.models import llama

    n = -(-(kv + horizon) // PS)
    pool = llama.init_page_pool(cfg, 1 + slots * n, PS, device=device)
    bt = torch.arange(1, 1 + slots * n, dtype=torch.int32,
                      device=device).view(slots, n)
    token = (torch.arange(1, slots + 1, dtype=torch.int32, device=device)
             if distinct_tokens else
             torch.ones(slots, dtype=torch.int32, device=device))
    pos = torch.full((slots,), kv, dtype=torch.int32, device=device)
    limit = torch.full((slots,), horizon, dtype=torch.int32, device=device)

    def dispatch():
        return llama.decode_multistep_paged(params, token, pos, cfg, pool, bt,
                                            limit, horizon=horizon, ffn=ffn,
                                            attn_io=attn_io,
                                            linear=linear)[0].cpu()

    card = device.type == "cuda"
    dispatch()                                   # warm-up
    if card:
        torch.cuda.synchronize()
    walls = []
    for _ in range(3):                           # unprofiled wall clock
        t0 = time.perf_counter()
        dispatch()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    fams, kernels = device_time_by_family(
        dispatch, card, (("attention", ("decode_paged_kernel",)),
                         ("grouped_gemm", ("grouped_gemm",)),
                         ("ep_rows", ("ep_dispatch", "ep_combine")),
                         ("ep_wire", ("a2a_push", "a2a_seg")),
                         ("dense_gemm", ("tdt_gemm",)),
                         ("all_gather", ("ag_push", "ag_ring"))))
    busy = sum(fams.values())
    rec = {"slots": slots, "kv_len": kv, "horizon": horizon,
           "wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1 - busy / wall if busy else None,
           "device_s_by_family": fams,
           "device_ops_per_step": kernels / horizon}
    log(f"profile {label}decode dispatch", json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 7: ring attention, forward and backward, against the plain versions
# ---------------------------------------------------------------------------

RING = dict(B=1, Hq=32, Hkv=8, D=128)      # Llama-3-8B attention, one rank
# (dtype, S, causal); the first is the training path's shape
RING_CASES = [("bfloat16", 4096, True), ("float32", 4096, True),
              ("bfloat16", 1000, True), ("float32", 1000, True),
              ("bfloat16", 2048, False)]
# max |kernel - plain| / max |plain| for out, dq, dk, dv: f32 sums in
# another order only; bf16 rounds p and dS to bf16 at the same points, but a
# rounding may fall the other way (one bf16 ulp is 2^-8 of the value)
RING_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def ring_bound(S: int, causal: bool, esize: int, dtype_name: str,
               backward: bool, dims=RING, ranks: int = 1) -> tuple[float, str]:
    """Least time: each input read once and each output written once,
    against 4*D operations per (query, key) pair that counts in the forward
    (q.k and p.v) and 10*D in the backward (s, dp, dq, dk, dv). Across
    ``ranks`` on the one card the pairs are the global sequence's, and the
    ring's transport adds its bytes: each of the n - 1 hops writes every
    K||V block into a relay slot and reads it there, and in the backward
    each of the n hops does the same with every f32 dk||dv accumulator."""
    B, Hq, Hkv, D = dims["B"], dims["Hq"], dims["Hkv"], dims["D"]
    pairs = S * (S + 1) // 2 if causal else S * S
    q_bytes, kv_bytes = B * Hq * S * D * esize, B * Hkv * S * D * esize
    if backward:   # q o do -> dq, k v -> dk dv, lse
        nbytes = 4 * q_bytes + 4 * kv_bytes + B * Hq * S * 4
        ops = 10 * D * B * Hq * pairs + 2 * B * Hq * S * D
    else:          # q k v -> out, lse
        nbytes = 2 * q_bytes + 2 * kv_bytes + B * Hq * S * 4
        ops = 4 * D * B * Hq * pairs
    if ranks > 1:
        nbytes += 2 * (ranks - 1) * 2 * kv_bytes
        if backward:
            nbytes += 2 * ranks * 2 * (B * Hkv * S * D * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_calls(q, k, v, do, causal: bool):
    """The yardstick, timed only: ``scaled_dot_product_attention`` forward,
    its backward alone, and both, on the same q, k, v, do."""
    import torch
    import torch.nn.functional as F

    def fwd(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=causal,
                                              enable_gqa=True)

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fwd(*leaves)
    return (lambda: fwd(q, k, v),
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
            lambda: torch.autograd.grad(fwd(*leaves), leaves, do))


def check_ring_attention(device, timed: bool = True, cases=RING_CASES,
                         dims=RING) -> list[dict]:
    """Each case: forward and backward kernels against their plain versions
    on the same inputs (the backward on the kernel forward's out and lse),
    relative errors within ``RING_TOL``, lse within ``LSE_ATOL``, and a
    second launch of each bitwise equal to the first. Raises on any
    failure. Returns one record per case."""
    import torch

    from triton_dist_tpu_torch.ops.ring_attention import (
        ring_attention_bwd, ring_attention_bwd_plain, ring_attention_fwd,
        ring_attention_fwd_plain)
    from triton_dist_tpu_torch.utils.perf import perf_func

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    def absmax(a, b):
        return (a.float() - b.float()).abs().max().item()

    B, Hq, Hkv, D = dims["B"], dims["Hq"], dims["Hkv"], dims["D"]
    records = []
    for name, S, causal in cases:
        dtype = getattr(torch, name)
        gen = torch.Generator(device=device).manual_seed(S + causal)

        def randn(*shape):
            return (torch.randn(shape, generator=gen, device=device,
                                dtype=torch.float32) * 0.5).to(dtype)

        q, do = randn(B, Hq, S, D), randn(B, Hq, S, D)
        k, v = randn(B, Hkv, S, D), randn(B, Hkv, S, D)
        out, lse = ring_attention_fwd(None, q, k, v, causal=causal)
        out2, lse2 = ring_attention_fwd(None, q, k, v, causal=causal)
        ref_out, ref_lse = ring_attention_fwd_plain(q, k, v, causal)
        grads = ring_attention_bwd(None, q, k, v, out, lse, do,
                                   causal=causal)
        grads2 = ring_attention_bwd(None, q, k, v, out, lse, do,
                                    causal=causal)
        ref_grads = ring_attention_bwd_plain(q, k, v, out, lse, do, causal)
        rec = {"case": f"{name} S={S} {'causal' if causal else 'full'}",
               "tol": RING_TOL[name], "lse_atol": LSE_ATOL,
               "out_rel_err": rel(out, ref_out),
               "lse_max_abs_err": absmax(lse, ref_lse),
               "out_max_abs_err": absmax(out, ref_out)}
        for n, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
            rec[f"{n}_rel_err"] = rel(got, want)
            rec[f"{n}_max_abs_err"] = absmax(got, want)
        rec["bitwise_repeat"] = bool(
            torch.equal(out, out2) and torch.equal(lse, lse2)
            and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        if timed:
            esize = q.element_size()
            rec["fwd_ms"] = perf_func(
                lambda: ring_attention_fwd(None, q, k, v, causal=causal))[1]
            rec["bwd_ms"] = perf_func(lambda: ring_attention_bwd(
                None, q, k, v, out, lse, do, causal=causal), iters=10)[1]
            rec["fwd_plain_ms"] = perf_func(
                lambda: ring_attention_fwd_plain(q, k, v, causal), iters=5)[1]
            rec["bwd_plain_ms"] = perf_func(lambda: ring_attention_bwd_plain(
                q, k, v, out, lse, do, causal), iters=5)[1]
            s_fwd, s_bwd, s_both = sdpa_calls(q, k, v, do, causal)
            rec["fwd_sdpa_ms"] = perf_func(s_fwd)[1]
            rec["bwd_sdpa_ms"] = perf_func(s_bwd)[1]
            rec["fwd_bwd_sdpa_ms"] = perf_func(s_both)[1]
            rec["fwd_bound_ms"], rec["fwd_bound_by"] = ring_bound(
                S, causal, esize, name, False, dims)
            rec["bwd_bound_ms"], rec["bwd_bound_by"] = ring_bound(
                S, causal, esize, name, True, dims)
        log("kernel ring_attention", json.dumps(rec))
        tol = RING_TOL[name]
        ok = (rec["bitwise_repeat"] and rec["lse_max_abs_err"] <= LSE_ATOL
              and all(rec[f"{n}_rel_err"] <= tol
                      for n in ("out", "dq", "dk", "dv")))
        if not ok:
            raise AssertionError(f"ring attention kernels disagree with "
                                 f"their plain versions: {rec}")
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# phase 8: the single-card trainer with ring attention in every layer
# ---------------------------------------------------------------------------

# f32 at full width, depth 2: the cp step (kernels) against the dense-
# attention step, the loss relative and each gradient relative to its scale;
# they differ only in the attention's summation order
TRAIN_F32 = dict(layers=2, seq=1024, loss_rtol=1e-5, grad_rtol=1e-3)
# bf16, one sequence per step. At the default AdamW lr of 3e-4 the first
# step of a 4.5 B-parameter model at random init overshoots (on the H100:
# 12.59, 2.26, 6.38, 2.57, 10.46 over five steps), so the run takes 1e-5,
# where each step lowers the loss on the repeated batch
TRAIN = dict(layers=16, seq=4096, steps=5, lr=1e-5)


def _flat(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def check_train_f32(device, cfg, seq: int = TRAIN_F32["seq"]) -> dict:
    """Loss and gradients of the cp plan (ring attention kernels) against
    the plan without cp (dense attention in PyTorch ops) on the same
    params and tokens; raises outside the stated tolerances."""
    import torch

    from triton_dist_tpu_torch.models.llama import init_params
    from triton_dist_tpu_torch.parallel import ParallelPlan, make_loss_fn

    params = init_params(cfg, seed=2, device=device)
    leaves = [t.requires_grad_(True) for _, t in _flat(params)]
    names = [n for n, _ in _flat(params)]
    gen = torch.Generator(device=device).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                           device=device)
    result = {}
    for key, plan in (("cp", ParallelPlan(dp=None, tp=None, cp="cp",
                                          sp=False)),
                      ("dense", ParallelPlan(dp=None, tp=None, sp=False))):
        loss = make_loss_fn(cfg, plan)(params, tokens)
        result[key] = (loss.item(), torch.autograd.grad(loss, leaves))
    (loss_cp, g_cp), (loss_ref, g_ref) = result["cp"], result["dense"]
    grad_rel = {n: ((a - b).abs().max() / b.abs().max()).item()
                for n, a, b in zip(names, g_cp, g_ref)}
    rec = {"dtype": "float32", "layers": cfg.n_layers, "seq": seq,
           "loss_cp": loss_cp,
           "loss_dense": loss_ref,
           "loss_rel_err": abs(loss_cp - loss_ref) / abs(loss_ref),
           "loss_rtol": TRAIN_F32["loss_rtol"],
           "grad_rel_err_max": max(grad_rel.values()),
           "grad_rtol": TRAIN_F32["grad_rtol"], "grad_rel_err": grad_rel}
    log("train f32 cp vs dense", json.dumps(rec))
    del params, leaves, result, g_cp, g_ref
    if not (rec["loss_rel_err"] <= rec["loss_rtol"]
            and rec["grad_rel_err_max"] <= rec["grad_rtol"]):
        raise AssertionError(f"the cp train step disagrees with the dense "
                             f"one: {rec}")
    return rec


def _family(name: str) -> str:
    name = name.lower()
    if "ring_fwd_kernel" in name or "ring_fwd_ranks_kernel" in name:
        return "attention_fwd"
    if any(k in name for k in ("ring_delta_kernel", "ring_dq_kernel",
                               "ring_dkv_kernel", "ring_bwd_ranks_kernel")):
        return "attention_bwd"
    if any(k in name for k in ("gemm", "gemv", "xmma", "nvjet", "cutlass")):
        return "gemm"
    return "other"


def check_train(device, cfg, card: str, seq: int = TRAIN["seq"],
                steps: int = TRAIN["steps"], ranks: int = 1) -> dict:
    """``steps`` cp steps on one seeded batch of ``seq`` tokens, each timed
    to a synchronize; raises unless every loss is finite and below the one
    before, and each kernel ran layers x steps times. Then one more step
    under ``torch.profiler``: device time by family, the busiest kernels,
    and the idle share of that step (1 - the union of its device intervals
    / its wall time). At ``ranks`` > 1 the step runs over a ("cp",) mesh
    of that many ranks and the counts are the ring kernels'
    (``launches_ring``)."""
    import gc
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from triton_dist_tpu_torch.ops.ring_attention import (ring_attention_bwd,
                                                          ring_attention_fwd)
    from triton_dist_tpu_torch.parallel import (ParallelPlan, adamw,
                                                make_mesh, make_train_step)

    on_card = device.type == "cuda"
    count = "launches" if ranks == 1 else "launches_ring"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        gc.collect()        # tensors of earlier phases held only in cycles
        torch.cuda.reset_peak_memory_stats()
    plan = ParallelPlan(dp=None, tp=None, cp="cp", sp=False)
    init_fn, step_fn = make_train_step(
        cfg, make_mesh({"cp": ranks}, device) if ranks > 1 else None, plan,
        functools.partial(adamw, lr=TRAIN["lr"]), device=device)
    state = init_fn(0)
    n_params = sum(t.numel() for _, t in _flat(state.params))
    gen = torch.Generator(device=device).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                           device=device)
    sync()
    setattr(ring_attention_fwd, count, 0)
    setattr(ring_attention_bwd, count, 0)
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens)
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = {"ring_attention_fwd": getattr(ring_attention_fwd, count),
                "ring_attention_bwd": getattr(ring_attention_bwd, count)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    step_s = statistics.median(walls[1:])

    with profile(activities=[ProfilerActivity.CPU] +
                 ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens)
        sync()
        wall = time.perf_counter() - t0
    fams = {"attention_fwd": 0.0, "attention_bwd": 0.0, "gemm": 0.0,
            "other": 0.0}
    by_name, spans = {}, []
    for e in prof.events():
        # GPU-side user annotations (``Optimizer.step#AdamW.step``) span
        # kernels that are counted on their own
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = e.time_range.elapsed_us()
        fams[_family(e.name)] += us / 1e6
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, last = 0.0, None
    for start, end in sorted(spans):          # union of device intervals
        if last is not None and start < last:
            start = last
        if end > start:
            busy_us += end - start
        last = end if last is None else max(last, end)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    expect = cfg.n_layers * steps
    rec = {"card": card, "dtype": str(cfg.dtype), "layers": cfg.n_layers,
           "ranks": ranks, "d_model": cfg.d_model, "seq": seq,
           "params_b": n_params / 1e9,
           "steps": steps,
           "losses": losses, "step_s": walls, "step_s_median": step_s,
           "tokens_per_s": seq / step_s, "peak_mem_gib": peak,
           "launches": launches, "launches_expected": expect,
           "profiled_step": {"wall_s": wall, "device_busy_s": busy_us / 1e6,
                             "device_idle_share": 1 - busy_us / 1e6 / wall,
                             "device_s_by_family": fams,
                             "device_ops": len(spans),
                             "top_kernels_ms": [[n[:80], t] for n, t in top]}}
    log(f"train bf16{'' if ranks == 1 else f' cp={ranks}'}", json.dumps(rec))
    ok = (all(math.isfinite(x) for x in losses)
          and all(b < a for a, b in zip(losses, losses[1:]))
          and all(n == expect for n in launches.values()))
    if not ok:
        raise AssertionError(f"the train run failed its checks: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 9: MoE serving at Mixtral-8x7B width through the grouped GEMMs
# ---------------------------------------------------------------------------

# Mixtral-8x7B's published widths with the depth cut from 32 to 4 layers:
# 6 B parameters, 12 GB in bf16 (32 layers would need 93 GB); 16 layers
# until the phases on these weights (9, 12, 13, 16-18, 20) outgrew the
# script's time limit on a slow host, 8 until phase 22 took the script to
# 978 s of its 1200 on another (most of these phases' time is the host's,
# a layer at a time)
MOE_LAYERS = 4
# (tokens, aligned row block) of the engine's two programs, each token top-2:
# a decode step of 8 slots and a 256-token prefill chunk
GG_SHAPES = {"decode": (8, 16), "chunk": (256, 64)}
# max |kernel - plain| / max |plain| for the grouped GEMMs and the MoE block:
# both sum in f32, in other orders; bf16 then rounds once, and a rounding may
# fall the other way (one bf16 ulp is 2^-8 of the value)
GG_TOL = {"bfloat16": 1e-2, "float32": 1e-5}


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1e-30)).item()


def grouped_bound(ids, H: int, N: int, n_w: int, esize: int, n_blocks: int,
                  dtype_name: str) -> tuple[float, str]:
    """Least time: the used experts' ``n_w`` weight matrices, the routed
    rows in and out, the block table and the bound each read or written
    once, against 2 * H * N operations per routed row and weight matrix."""
    routed = ids[ids >= 0]
    rows, used = int(routed.numel()), int(routed.unique().numel())
    nbytes = (n_w * used * H * N + rows * (H + N)) * esize + 4 * n_blocks + 4
    ops = 2 * n_w * rows * H * N
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def grouped_mm_call(x_rows, ids, w):
    """The yardstick, timed only: one ``torch._grouped_mm`` over the routed
    rows sorted by expert. Returns (the call, None) or (None, why not)."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    if x_rows.dtype != torch.bfloat16:
        return None, "torch._grouped_mm takes bf16 only"
    order = torch.argsort(ids, stable=True)
    xs = x_rows[order].contiguous()
    offs = torch.bincount(ids, minlength=w.shape[0]).cumsum(0).to(torch.int32)
    errors = []
    # row-major weights first, then the column-major layout some builds need
    for wl in (w, w.transpose(-2, -1).contiguous().transpose(-2, -1)):
        try:
            def call(wl=wl):
                return torch._grouped_mm(xs, wl, offs=offs)
            call()
            torch.cuda.synchronize()
            return call, None
        except (RuntimeError, TypeError, ValueError) as e:
            errors.append(str(e).splitlines()[0][:160])
    return None, "torch._grouped_mm refused: " + " | ".join(errors)


def check_grouped(device, w_gate, w_up, w_down, timed: bool = True,
                  shapes=GG_SHAPES, seed: int = 5) -> list[dict]:
    """B18 (``grouped_gemm_gated``) and B17 (``grouped_gemm``) against their
    plain versions at the engine's two row counts, in bf16 and f32, on one
    layer's expert weights (w_gate, w_up [E, H, F], w_down [E, F, H]). Rows
    are routed top-2 from a seeded draw, so some blocks lie past the bound.
    Compared: the rows below the bound (unmasked, as the engine calls them);
    a second launch gives the same bits; ``masked=True`` zeroes the rows
    past the bound and leaves the others' bits. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.utils.perf import perf_func

    E, H, F = w_gate.shape
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        wg, wu, wd = (w.to(dtype) for w in (w_gate, w_up, w_down))
        for shape, (T, bm) in shapes.items():
            gen = torch.Generator(device=device).manual_seed(seed + T)
            ids = torch.rand(T, E, generator=gen, device=device) \
                .topk(2, -1).indices.reshape(-1).to(torch.int32)
            g, valid, be, nb = gg.align_tokens_by_expert(ids, E, bm,
                                                         with_used_count=True)
            rows = torch.randn(T, H, generator=gen, device=device,
                               dtype=torch.float32).to(dtype)
            rows = rows.repeat_interleave(2, 0)
            x = torch.where(valid[:, None], rows[g.long()],
                            torch.zeros((), dtype=dtype, device=device))
            used = int(nb) * bm
            h_ref = gg.grouped_gemm_gated_plain(x, wg, wu, be, bm, nb)
            cases = (
                ("grouped_gemm_gated", gg.grouped_gemm_gated, x, (wg, wu),
                 h_ref, F),
                ("grouped_gemm", gg.grouped_gemm, h_ref, (wd,),
                 gg.grouped_gemm_plain(h_ref, wd, be, bm, nb), H))
            for kname, fn, inp, ws, ref, N in cases:
                out = fn(inp, *ws, be, block_m=bm, n_blocks_used=nb,
                         masked=False)
                out2 = fn(inp, *ws, be, block_m=bm, n_blocks_used=nb,
                          masked=False)
                masked = fn(inp, *ws, be, block_m=bm, n_blocks_used=nb)
                rec = {"kernel": kname, "dtype": name, "shape": shape,
                       "case": f"{name} {shape} T={T} top-2 E={E} H={H} "
                               f"N={N} block_m={bm}",
                       "rows": int(valid.sum()), "aligned_rows": x.shape[0],
                       "used_blocks": int(nb), "blocks": be.numel(),
                       "rel_err": _rel(out[:used], ref[:used]),
                       "max_abs_err": (out[:used].float()
                                       - ref[:used].float()).abs().max()
                       .item(), "tol": GG_TOL[name],
                       "bitwise_repeat": bool(torch.equal(out[:used],
                                                          out2[:used])),
                       "masked_ok": bool(torch.equal(masked[:used],
                                                     out[:used])
                                         and not masked[used:].any())}
                if timed:
                    rec["ms"] = perf_func(lambda: fn(
                        inp, *ws, be, block_m=bm, n_blocks_used=nb,
                        masked=False))[1]
                    plain = (gg.grouped_gemm_gated_plain if len(ws) == 2
                             else gg.grouped_gemm_plain)
                    rec["plain_ms"] = perf_func(lambda: plain(
                        inp, *ws, be, bm, nb), iters=3, warmup_iters=1)[1]
                    rec["bound_ms"], rec["bound_by"] = grouped_bound(
                        ids, H if len(ws) == 2 else F, N, len(ws),
                        inp.element_size(), be.numel(), name)
                    routed = inp[valid]
                    sorted_ids = ids[ids >= 0].sort(stable=True).values
                    if len(ws) == 2:
                        # no single call computes silu(x@wg) * (x@wu): the
                        # library's grouped product over gate|up is timed
                        # beside it, not as its yardstick
                        rec["library_ms"] = None
                        rec["library_none_because"] = (
                            "no single PyTorch call computes silu(x@Wg) * "
                            "(x@Wu)")
                        call, why = grouped_mm_call(
                            routed, sorted_ids,
                            torch.cat(ws, -1) if dtype == torch.bfloat16
                            else ws[0])
                        rec["grouped_mm_gate_up_products_ms"] = (
                            perf_func(call)[1] if call else why)
                    else:
                        call, why = grouped_mm_call(routed, sorted_ids, wd)
                        rec["library_ms"] = perf_func(call)[1] \
                            if call else None
                        if why:
                            rec["library_none_because"] = why
                log(f"kernel {kname}", json.dumps(rec))
                if not (rec["rel_err"] <= rec["tol"] and rec["bitwise_repeat"]
                        and rec["masked_ok"]):
                    raise AssertionError(f"{kname} disagrees with its plain "
                                         f"version: {rec}")
                records.append(rec)
            del h_ref
        del wg, wu, wd
    return records


def kernel_device_ms(fn, match: str, calls: int = 10,
                     per_call: int | None = None,
                     floor_ms: float | None = None) -> float:
    """The median device time of the kernels whose name holds ``match`` over
    ``calls`` calls of ``fn`` under ``torch.profiler``: the kernel alone,
    where a CUDA-event time around one call also holds the host's time to
    enqueue it when the kernel is shorter than that. A profile late in a
    long run may hold no events; it is taken again, three times in all.
    With ``per_call`` the profile must hold exactly ``calls * per_call``
    such kernels, and with ``floor_ms`` (the least time the card could
    take) its median may not fall under it (on an H100 a profile has given
    a kernel about half its CUDA-event time): such a profile is logged and
    taken again, five times in all, and then this raises."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    checked = per_call is not None or floor_ms is not None
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(5 if checked else 3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and match in e.name]
        med = statistics.median(times) if times else None
        seen.append((len(times), med))
        if times and (per_call is None or len(times) == calls * per_call) \
                and (floor_ms is None or med >= floor_ms):
            if checked and len(seen) > 1:
                log(f"profile of {match} taken again: (kernels, median ms) "
                    f"{seen}")
            return med
    if checked:
        raise AssertionError(
            f"{len(seen)} profiles of {calls} calls missed "
            f"{calls * (per_call or 1)} kernels named {match!r} at or above "
            f"{floor_ms} ms: (kernels, median ms) {seen}")
    return None


def batched_device_ms(fn, calls: int = 20) -> float:
    """The device time of a call of ``fn`` whose kernel runs longer than
    the host takes to enqueue the next call: CUDA events around ``calls``
    back-to-back calls, so the host's work hides under the running kernel
    (the grouped GEMMs of phase 21a run 0.75 ms and more, their wrappers'
    host work a tenth of that). No profiler, whose events a long run may
    drop or shorten."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def ep_rows_bound(nbytes: int) -> tuple[float, str]:
    """Least time of a row movement: its bytes at the HBM rate (one multiply
    and add per value at most, far under the operations bound)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def embedding_bag_call(idx, table, weights):
    """The yardstick, timed only: one ``F.embedding_bag`` (mode sum, per-
    row weights in the table's type) that gathers and sums the same rows.
    Returns (the call, None) or (None, why not)."""
    import torch
    import torch.nn.functional as F

    try:
        def call():
            return F.embedding_bag(idx, table, per_sample_weights=weights,
                                   mode="sum")
        call()
        torch.cuda.synchronize()
        return call, None
    except (RuntimeError, TypeError, ValueError, NotImplementedError) as e:
        return None, "F.embedding_bag refused: " + str(e).splitlines()[0][:160]


# the one-rank dispatch and combine against their plain versions: the same
# f32 operations in the same order (the dispatch only copies), so exact
EP_TOL = 0.0


def check_ep_rows(device, H: int, E: int, topk: int, timed: bool = True,
                  shapes=GG_SHAPES, seed: int = 9) -> list[dict]:
    """B21's one-rank form: ``ep_dispatch`` (the pairs' rows into expert-
    aligned rows) and ``ep_combine`` (the aligned rows back, weighted and
    summed over k in f32) against their plain versions at the engine's two
    row counts, in bf16 and f32, with rows routed top-``topk`` over ``E``
    experts from a seeded draw; a second launch gives the same bits. Raises
    on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import all_to_all as ea
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.utils.perf import perf_func

    records = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for shape, (T, bm) in shapes.items():
            gen = torch.Generator(device=device).manual_seed(seed + T)
            ids = torch.rand(T, E, generator=gen, device=device) \
                .topk(topk, -1).indices.reshape(-1).to(torch.int32)
            src, valid, _, _, pos = gg.expert_alignment(ids, E, bm)
            P = src.shape[0]
            tokens = torch.randn(T, H, generator=gen, device=device,
                                 dtype=torch.float32).to(dtype)
            y = torch.randn(P, H, generator=gen, device=device,
                            dtype=torch.float32).to(dtype)
            w = torch.rand(T, topk, generator=gen, device=device) + 0.1
            w = w / w.sum(-1, keepdim=True)
            es = tokens.element_size()
            cases = (
                ("ep_dispatch", lambda: ea.ep_dispatch(tokens, src, valid,
                                                       topk),
                 lambda: ea.ep_dispatch_plain(tokens, src, valid, topk),
                 # pair ids and validity in, the tokens once, P rows out
                 P * 5 + T * H * es + P * H * es,
                 # one bag per aligned row: its token, weight 1 or 0
                 ((src.long() // topk).clamp(max=T - 1)[:, None], tokens,
                  valid.to(dtype)[:, None])),
                ("ep_combine", lambda: ea.ep_combine(y, pos, w),
                 lambda: ea.ep_combine_plain(y, pos, w),
                 # positions and weights in, the named rows once, T out
                 T * topk * 8 + T * topk * H * es + T * H * es,
                 (pos.long().view(T, topk), y, w.to(dtype))))
            for kname, fn, plain, nbytes, bag in cases:
                out, out2, ref = fn(), fn(), plain()
                err = (out.float() - ref.float()).abs().max().item()
                rec = {"kernel": kname, "dtype": name, "shape": shape,
                       "case": f"{name} {shape} T={T} top-{topk} E={E} "
                               f"H={H} block_m={bm} P={P}",
                       "max_abs_err": err, "tol": EP_TOL,
                       "bitwise_repeat": bool(torch.equal(out, out2))}
                if timed:
                    rec["ms"] = perf_func(fn)[1]
                    rec["kernel_device_ms"] = kernel_device_ms(
                        fn, f"{kname}_kernel")
                    rec["plain_ms"] = perf_func(plain)[1]
                    rec["bound_ms"], rec["bound_by"] = ep_rows_bound(nbytes)
                    call, why = embedding_bag_call(*bag)
                    rec["library_ms"] = perf_func(call)[1] if call else None
                    if why:
                        rec["library_none_because"] = why
                log(f"kernel {kname}", json.dumps(rec))
                if not (err <= EP_TOL and rec["bitwise_repeat"]):
                    raise AssertionError(f"{kname} disagrees with its plain "
                                         f"version: {rec}")
                records.append(rec)
    return records


def moe_block_reference(x, router_w, we_gate, we_up, we_down, topk: int):
    """The MoE block written out plainly, sharing no code with the port's:
    the f32 router, softmax and renormalised top-k; for each expert its
    routed tokens through silu(x @ Wg) * (x @ Wu) in f32, cast, then @ Wd in
    f32, cast; then the weighted sum over k in k order in f32, cast once."""
    import torch

    T, D = x.shape
    probs = torch.softmax(x.float() @ router_w, -1)
    vals, ids = probs.topk(topk, -1)
    vals = vals / vals.sum(-1, keepdim=True)
    y = torch.zeros(T, topk, D, dtype=x.dtype, device=x.device)
    for e in range(we_gate.shape[0]):
        t_idx, j_idx = (ids == e).nonzero(as_tuple=True)
        if t_idx.numel() == 0:
            continue
        xe = x[t_idx].float()
        h = (torch.nn.functional.silu(xe @ we_gate[e].float())
             * (xe @ we_up[e].float())).to(x.dtype)
        y[t_idx, j_idx] = (h.float() @ we_down[e].float()).to(x.dtype)
    acc = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for j in range(topk):
        acc = acc + y[:, j].float() * vals[:, j:j + 1]
    return acc.to(x.dtype)


def check_moe_block(params, cfg, device, shapes=GG_SHAPES) -> list[dict]:
    """The MoE block of layer 0 as the one-rank engine runs it
    (``moe_mlp_ep_overlap`` over a one-rank EP layer with the plain wire:
    the router, top-2, the slot gather, B21, B18, B17, B21 back and the
    fold) against ``moe_block_reference``, at both row counts; a second run
    and a run at the other row block give the same bits. Raises on any
    failure."""
    import torch

    from triton_dist_tpu_torch.layers import EPAll2AllLayer
    from triton_dist_tpu_torch.models.moe import moe_mlp_ep_overlap
    from triton_dist_tpu_torch.shmem import initialize_distributed

    p = {k: v[0] for k, v in params["blocks"].items()}
    ws = (p["w_router"], p["we_gate"], p["we_up"], p["we_down"])
    ctx = initialize_distributed(("ep",), (1,), device=device)
    records = []
    for shape, (T, bm) in shapes.items():
        gen = torch.Generator(device=device).manual_seed(T)
        x = torch.randn(T, cfg.base.d_model, generator=gen, device=device,
                        dtype=torch.float32).to(cfg.base.dtype)
        lay = EPAll2AllLayer.create(ctx, T, cfg.base.d_model, cfg.topk,
                                    cfg.num_experts, axis="ep",
                                    dtype=cfg.base.dtype)

        def block(block_m):
            return moe_mlp_ep_overlap(ctx, lay, x, *ws, block_m=block_m)

        got, again = block(bm), block(bm)
        other = block(64 if bm == 16 else 16)
        ref = moe_block_reference(x, *ws, cfg.topk)
        name = str(cfg.base.dtype).split(".")[-1]
        rec = {"shape": shape, "tokens": T, "block_m": bm, "dtype": name,
               "rel_err": _rel(got, ref), "tol": GG_TOL[name],
               "finite": bool(torch.isfinite(got).all()),
               "bitwise_repeat": bool(torch.equal(got, again)),
               "block_m_invariant": bool(torch.equal(got, other))}
        log("moe block kernels vs reference", json.dumps(rec))
        if not (rec["finite"] and rec["rel_err"] <= rec["tol"]
                and rec["bitwise_repeat"] and rec["block_m_invariant"]):
            raise AssertionError(f"the MoE block disagrees with its "
                                 f"reference: {rec}")
        records.append(rec)
    return records


def engine_kernels() -> tuple:
    """The launch-counted wrappers of the sharded engine's path."""
    from triton_dist_tpu_torch.ops import all_to_all as ea
    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops.allgather import all_gather
    from triton_dist_tpu_torch.ops.gemm import matmul

    return (ea.all_to_all_push, ea.all_to_all_push_seg, all_gather, matmul,
            fd.gqa_decode_paged, ea.ep_dispatch, ea.ep_combine,
            gg.grouped_gemm_gated, gg.grouped_gemm, fd.fd_partials_fold,
            fd.fd_page_partials, fd.fd_fold_dist, fd.pool_ag_start_local)


def engine_launches(eng) -> dict:
    """The launches a sharded engine's run must make of each kernel of its
    path, from its counters. Each of the S = horizon x dispatches + chunks
    program runs goes through L layers: each layer runs the attention once,
    the MoE block's slot gather, B18, B17 and fold once a microbatch (M),
    the wire twice (B21 with overlap off, B22 once a microbatch with
    overlap "ep" or "ep+sp") and four projections (wq, wk, wv, wo); the LM
    head once a run. Each projection is one B2 launch a TP rank (tp_impl
    "xla"). B9 gathers every projection's columns at tp > 1, and the
    digests once a check at more than one rank. The attention: B1, after
    B9's gather of the pool's keys and values at sp > 1 (B6's, once for
    both, with overlap="ep+sp"); with ``long_context`` the fused fold at
    sp = 1, and at sp > 1 each block of rows (``fd_row_block``) B7 once an
    SP rank and B8 once."""
    from triton_dist_tpu_torch.ops.flash_decode import fd_row_block

    c = eng.metrics.counters
    runs = eng.decode_horizon * c["dispatches"] + c["prefill_chunks"]
    base = eng.moe_cfg.base
    L = base.n_layers
    tp, sp = eng.ctx.axis_size("tp"), eng.ctx.axis_size("sp")
    M = eng.overlap_microbatches
    proj = (4 * L + 1) * runs
    want = {k: M * L * runs for k in ("ep_dispatch", "ep_combine",
                                      "grouped_gemm_gated", "grouped_gemm")}
    want.update({"gqa_decode_paged": 0, "fd_partials_fold": 0,
                 "fd_page_partials": 0, "fd_fold_dist": 0,
                 "pool_ag_start_local": 0, "all_gather": 0})
    if eng.long_context and sp > 1:
        rb = fd_row_block(sp, eng.pages_per_seq, base.n_heads,
                          base.head_dim)
        blocks = (eng.decode_horizon * c["dispatches"]
                  * -(-eng.num_slots // rb)
                  + c["prefill_chunks"] * -(-eng.prefill_chunk // rb))
        want.update(fd_fold_dist=L * blocks, fd_page_partials=sp * L * blocks)
    elif eng.long_context:
        want["fd_partials_fold"] = L * runs
    else:
        want["gqa_decode_paged"] = L * runs
        if sp > 1 and eng.overlap == "ep+sp":
            want["pool_ag_start_local"] = L * runs
        elif sp > 1:
            want["all_gather"] = 2 * L * runs
    want.update({"all_to_all_push": 0 if M > 1 else 2 * L * runs,
                 "all_to_all_push_seg": 2 * M * L * runs if M > 1 else 0,
                 "matmul": tp * proj})
    want["all_gather"] += ((c["digest_checks"] if eng.n_ranks > 1 else 0)
                           + (proj if tp > 1 else 0))
    return want


def check_moe_engine(params, cfg, device, trace, engine_kw: dict,
                     card: str) -> dict:
    """Serve the trace twice on the one-rank ``ShardedServingEngine``; raise
    unless every request finished with its full budget, a preemption
    happened, every kernel of the path launched exactly as often as
    ``engine_launches`` says (B1, the slot gather, B18, B17 and the fold
    once a layer of every decode step and chunk, B21 twice, B2 once a
    projection), and the two runs' token streams are bit-identical."""
    import torch

    from triton_dist_tpu_torch.serving import ShardedServingEngine

    def make():
        return ShardedServingEngine(params, cfg, device=device, **engine_kw)

    kernels = engine_kernels()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res, eng, wall, launches = serve(make, device, trace, kernels)
    c = eng.metrics.counters
    h = eng.metrics.hist
    expect = engine_launches(eng)
    rec = {
        "card": card, "requests": len(trace),
        "finished": c["requests_finished"],
        "tokens_generated": c["tokens_generated"],
        "tokens_expected": sum(m for _, _, m in trace),
        "prompt_tokens": sum(len(p) for _, p, _ in trace),
        "preemptions": c["preemptions"], "dispatches": c["dispatches"],
        "prefill_chunks": c["prefill_chunks"], "launches": launches,
        "launches_expected": expect,
        "wall_s": wall, "tok_per_s": c["tokens_generated"] / wall,
        "ttft_p50_s": h["ttft_s"].percentile(50),
        "step_device_mean_s": h["step_device_s"].mean,
        "step_host_mean_s": h["step_host_s"].mean,
        "prefill_stall_mean_s": h["prefill_stall_s"].mean,
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if on_card else None),
    }
    del eng
    res2, eng2, wall2, launches2 = serve(make, device, trace, kernels)
    rec["rerun_bit_identical"] = res2 == res
    rec["rerun_wall_s"] = wall2
    del eng2
    log("moe engine", json.dumps(rec))
    ok = (rec["finished"] == len(trace) and len(res) == len(trace)
          and all(len(res[i]) == m for i, (_, _, m) in enumerate(trace))
          and rec["tokens_generated"] >= rec["tokens_expected"]
          and rec["preemptions"] >= 1 and launches == expect
          and expect["gqa_decode_paged"] > 0
          and launches2 == launches and rec["rerun_bit_identical"])
    if not ok:
        raise AssertionError(f"the MoE engine run failed its checks: {rec}")
    return rec


def check_moe(device, card: str) -> dict:
    """Phase 9: Mixtral-8x7B's widths at MOE_LAYERS layers, random weights
    (seed 0): the grouped GEMMs against their plain versions on layer 0's
    experts, the MoE block against its plain path, a seeded trace through
    the one-rank ``ShardedServingEngine`` (served twice), then one decode
    dispatch through the engine's own hooks under the profiler. Phases 12 (long-context serving) and 13
    (the MoE-TP block) run on the same weights. Frees the weights before it
    returns."""
    import torch

    from triton_dist_tpu_torch.models.moe import MoEConfig, init_moe_params
    from triton_dist_tpu_torch.serving import ShardedServingEngine

    preset = MoEConfig.mixtral_8x7b()
    cfg = dataclasses.replace(preset, base=dataclasses.replace(
        preset.base, n_layers=MOE_LAYERS))
    t0 = time.perf_counter()
    params = init_moe_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["blocks"].values()) \
        + 2 * cfg.base.vocab_size * cfg.base.d_model
    log(f"moe params {cfg.base.n_layers} layers x d_model "
        f"{cfg.base.d_model}, {cfg.num_experts} experts x d_ff "
        f"{cfg.moe_d_ff}, {n_params / 1e9:.3f} B, made in "
        f"{time.perf_counter() - t0:.1f} s")
    blocks = params["blocks"]
    ep_rows = check_ep_rows(device, cfg.base.d_model, cfg.num_experts,
                            cfg.topk)
    grouped = check_grouped(device, blocks["we_gate"][0], blocks["we_up"][0],
                            blocks["we_down"][0])
    torch.cuda.empty_cache()
    block = check_moe_block(params, cfg, device)
    torch.cuda.empty_cache()
    engine = check_moe_engine(params, cfg, device,
                              make_trace(cfg.base, N_REQUESTS, 0), ENGINE,
                              card)

    eng = ShardedServingEngine(params, cfg, device=device, **ENGINE)
    profile = profile_dispatch(params, cfg.base, device, ffn=eng.ffn,
                               attn_io=eng.attn_io, linear=eng.linear,
                               distinct_tokens=True, label="moe 1x1x1 ")
    del eng
    del blocks
    torch.cuda.empty_cache()

    later = check_long_context_and_moe_tp(params, cfg, device, card)
    ep = check_ep_ranks(params, cfg, device, card)
    del params
    torch.cuda.empty_cache()
    return {"ep_rows": ep_rows, "grouped": grouped, "block": block,
            "engine": engine, "profile": profile, "ep": ep, **later}


def check_long_context_and_moe_tp(params, cfg, device, card: str) -> dict:
    """Phase 12 (long-context serving) and phase 13 (the MoE-TP block) on
    phase 9's weights ``params`` (Mixtral-8x7B's widths, ``cfg``)."""
    import torch

    from triton_dist_tpu_torch.models.moe import init_moe_params

    t12 = time.perf_counter()
    fd_kernels = check_fd_kernels(device)
    torch.cuda.empty_cache()
    long = check_long_engine(params, cfg, device, card)
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    long["sp"] = check_long_sp(params, cfg, device, card, long.pop("tokens"))
    log(f"phase 17b (long-context at sp > 1) took "
        f"{time.perf_counter() - t17:.1f} s")
    # phase 9's first four requests through the long-context and the plain
    # engine: on these bf16 weights equal up to near-ties, and in f32 at full
    # width, depth cut to 2 layers, equal
    trace4 = make_trace(cfg.base, N_REQUESTS, 0)[:4]
    long["equal_bf16"] = check_engines_agree(params, cfg, device, trace4,
                                             f"bf16, {MOE_LAYERS} layers",
                                             tol=MODEL_TOL["bfloat16"])
    cfg32 = dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, n_layers=LONG_EQUAL_F32_LAYERS, dtype=torch.float32))
    params32 = init_moe_params(cfg32, seed=2, device=device)
    long["equal_f32"] = check_engines_agree(
        params32, cfg32, device, trace4,
        f"f32, {LONG_EQUAL_F32_LAYERS} layers")
    del params32
    torch.cuda.empty_cache()
    long["seconds"] = time.perf_counter() - t12
    log(f"phase 12 took {long['seconds']:.1f} s")
    t13 = time.perf_counter()
    moe_tp = check_moe_tp(params, cfg, device)
    moe_tp["seconds"] = time.perf_counter() - t13
    log(f"phase 13 took {moe_tp['seconds']:.1f} s")
    t13 = time.perf_counter()
    moe_tp_ranks = check_moe_tp_ranks(params, cfg, device)
    log(f"phase 13 across ranks took {time.perf_counter() - t13:.1f} s")
    torch.cuda.empty_cache()
    moe_tp_2d = check_moe_tp_2d(params, cfg, device)
    torch.cuda.empty_cache()
    moe_sp = check_moe_decode_sp(params, cfg, device, card)
    return {"fd": fd_kernels, "long": long, "moe_tp": moe_tp,
            "moe_tp_ranks": moe_tp_ranks, "moe_tp_2d": moe_tp_2d,
            "moe_sp": moe_sp}


# ---------------------------------------------------------------------------
# phase 10: contiguous-cache decode, generation and the one-rank SP step
# ---------------------------------------------------------------------------

# (case, B, S, kv_len by row) of B3: G-batch's decode shape, G-long's, and
# ragged rows (empty, one key, either side of a split edge, past a split)
DECODE_CASES = (("batch", 8, 4096, (1152,) * 8),
                ("long", 1, 8192, (8192,)),
                ("ragged", 8, 4096, (0, 1, 255, 256, 257, 1000, 2049, 4096)))
# B4 at these R, B5's merge at these n, both on the batch case's partials
COMBINE_R = (1, 8)
MERGE_N = (1, 4)
# greedy generation at Llama-3-8B's widths and depth: a batch at the
# preset's max_seq_len, and one long sequence at its published context
GEN = {"batch": dict(B=8, prompt=1024, new=128, max_seq=4096),
       "long": dict(B=1, prompt=7936, new=128, max_seq=8192)}
# decode_step against the dense forward (f32, full width, depth 4)
DECODE_VS_FORWARD = dict(B=2, prompt=64, steps=8, max_seq=4096)
# rows of the one-rank SP step's push/ring wire (out || lse, f32): phase
# 10b's, and G-batch's
AG_ROWS = (DECODE_VS_FORWARD["B"], GEN["batch"]["B"])
SP_METHODS = ("fused", "push", "ring")


def decode_bound(q, kv_len, S: int, dtype_name: str) -> tuple[float, str]:
    """Least time of B3: the live keys and values read once, q read and
    out written once, lse written and kv_len read, against 2 * 2 * Hq * D
    operations per (row, live key)."""
    B, Hq, Dh = q.shape
    esize = q.element_size()
    live = sum(min(max(int(n), 0), S) for n in kv_len)
    nbytes = (2 * q.numel() * esize + 2 * live * HKV * Dh * esize
              + B * Hq * 4 + B * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * Hq * Dh * live / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def merge_bound(outs, out_esize: int) -> tuple[float, str]:
    """Least time of B4 or B5: the R partials and their lses read once, the
    merged rows written once (a few operations per value, far under the
    operations bound)."""
    rows = outs[0].numel() // outs.shape[-1]
    nbytes = (outs.numel() * outs.element_size() + outs.shape[0] * rows * 4
              + outs[0].numel() * out_esize)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def sdpa_decode_call(q, k, v, kv_len):
    """The yardstick, timed only: scaled dot-product attention with GQA over
    the same cache, the lengths as a mask."""
    import torch
    import torch.nn.functional as F

    keys = torch.arange(k.shape[2], device=q.device)
    mask = (keys[None, :] < kv_len[:, None].long())[:, None, None]
    qc = q[:, :, None]
    return lambda: F.scaled_dot_product_attention(qc, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def check_decode_kernels(device, timed: bool = True, cases=DECODE_CASES,
                         seed: int = 10) -> dict:
    """B3 (``gqa_decode_partial``) against its plain version at each case
    in bf16 and f32: out relative to the plain version's scale within
    ``OUT_ATOL``, lse within ``LSE_ATOL``, two launches bitwise equal, and
    each row alone (B=1) bitwise equal to its row in the batch. On the batch
    case's per-split partials, B4 (``decode_combine``) at ``COMBINE_R`` and
    B5's merge (``ll_merge``) at ``MERGE_N`` against theirs, bitwise
    repeatable. Raises on any failure; returns the records by kernel."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.utils.perf import perf_func

    recs = {"gqa_decode_partial": [], "decode_combine": [], "ll_merge": []}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for case, B, S, lens in cases:
            gen = torch.Generator(device=device).manual_seed(seed + S + B)

            def randn(*shape):
                return torch.randn(shape, generator=gen, device=device,
                                   dtype=torch.float32).to(dtype)

            q, k, v = randn(B, HQ, D), randn(B, HKV, S, D), randn(B, HKV, S, D)
            kv = torch.tensor(lens, dtype=torch.int32, device=device)
            out, lse = fd.gqa_decode_partial(q, k, v, kv)
            out2, lse2 = fd.gqa_decode_partial(q, k, v, kv)
            ref, ref_lse = fd.gqa_decode_partial_plain(q, k, v, kv)
            rows_alone = all(
                torch.equal(o, out[i:i + 1]) and torch.equal(l, lse[i:i + 1])
                for i in range(B)
                for o, l in [fd.gqa_decode_partial(q[i:i + 1], k[i:i + 1],
                                                   v[i:i + 1], kv[i:i + 1])])
            rec = {"case": f"{name} {case} B={B} S={S} kv_len="
                           f"{lens[0] if len(set(lens)) == 1 else list(lens)}",
                   "splits": fd.split_count(S),
                   "rel_err": _rel(out, ref),
                   "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
                   "atol": OUT_ATOL[name], "lse_atol": LSE_ATOL,
                   "finite": bool(torch.isfinite(out.float()).all()),
                   "bitwise_repeat": bool(torch.equal(out, out2)
                                          and torch.equal(lse, lse2)),
                   "row_independent": rows_alone}
            rec["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
            if timed:
                call = lambda: fd.gqa_decode_partial(q, k, v, kv)  # noqa: E731
                rec["ms"] = perf_func(call)[1]
                rec["partial_kernel_device_ms"] = kernel_device_ms(
                    call, "decode_partial_kernel")
                if fd.split_count(S) > 1:
                    rec["combine_kernel_device_ms"] = kernel_device_ms(
                        call, "combine_kernel")
                rec["plain_ms"] = perf_func(
                    lambda: fd.gqa_decode_partial_plain(q, k, v, kv),
                    iters=5)[1]
                rec["library_ms"] = perf_func(sdpa_decode_call(q, k, v,
                                                               kv))[1]
                rec["bound_ms"], rec["bound_by"] = decode_bound(q, lens, S,
                                                                name)
            log("kernel gqa_decode_partial", json.dumps(rec))
            if not (rec["rel_err"] <= OUT_ATOL[name]
                    and rec["lse_max_abs_err"] <= LSE_ATOL and rec["finite"]
                    and rec["bitwise_repeat"] and rows_alone):
                raise AssertionError(f"gqa_decode_partial disagrees with its "
                                     f"plain version: {rec}")
            recs["gqa_decode_partial"].append(rec)
            if case == "batch":
                recs["decode_combine"] += _check_merges(
                    fd.decode_combine, fd.decode_combine_plain,
                    "decode_combine", "combine_kernel", q, k, v, kv, name,
                    timed)
                recs["ll_merge"] += _check_merges(
                    lambda o, l: fd.ll_merge(o.float(), l, o.dtype),
                    lambda o, l: fd.ll_merge_plain(o.float(), l, o.dtype),
                    "ll_merge", "merge_kernel", q, k, v, kv, name, timed)
            del q, k, v, out, out2, ref
    return recs


def _check_merges(fn, plain, kname: str, kernel: str, q, k, v, kv, name: str,
                  timed: bool) -> list[dict]:
    """``fn`` (B4 or B5's merge) against ``plain`` over the first R of B3's
    per-split partials of the cache (each split decoded alone, its partial
    in q's type), at ``COMBINE_R`` or ``MERGE_N``."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.utils.perf import perf_func

    n = fd.split_count(k.shape[2])
    parts = [fd.gqa_decode_partial(
        q, k[:, :, r * fd.SPLIT_KEYS:(r + 1) * fd.SPLIT_KEYS].contiguous(),
        v[:, :, r * fd.SPLIT_KEYS:(r + 1) * fd.SPLIT_KEYS].contiguous(),
        (kv - r * fd.SPLIT_KEYS).clamp(0, fd.SPLIT_KEYS).to(torch.int32))
        for r in range(n)]
    outs_all = torch.stack([o for o, _ in parts])
    lses_all = torch.stack([l for _, l in parts])
    records = []
    for R in (COMBINE_R if kname == "decode_combine" else MERGE_N):
        outs, lses = outs_all[:R].contiguous(), lses_all[:R].contiguous()
        got, got2, ref = fn(outs, lses), fn(outs, lses), plain(outs, lses)
        rec = {"kernel": kname, "case": f"{name} R={R} rows={q.shape[0]}x"
                                        f"{q.shape[1]} D={q.shape[2]}",
               "rel_err": _rel(got, ref), "atol": OUT_ATOL[name],
               "bitwise_repeat": bool(torch.equal(got, got2))}
        rec["max_abs_err"] = (got.float() - ref.float()).abs().max().item()
        if timed:
            call = lambda: fn(outs, lses)  # noqa: E731
            rec["ms"] = perf_func(call)[1]
            rec["kernel_device_ms"] = kernel_device_ms(call, kernel)
            rec["plain_ms"] = perf_func(lambda: plain(outs, lses))[1]
            rec["bound_ms"], rec["bound_by"] = merge_bound(
                outs.float() if kname == "ll_merge" else outs,
                q.element_size())
            rec["library_ms"] = None
            rec["library_none_because"] = (
                "no single PyTorch call computes an lse-weighted merge of "
                "partial attention outputs")
        log(f"kernel {kname}", json.dumps(rec))
        if not (rec["rel_err"] <= rec["atol"] and rec["bitwise_repeat"]):
            raise AssertionError(f"{kname} disagrees with its plain version: "
                                 f"{rec}")
        records.append(rec)
    return records


def check_all_gather(device, timed: bool = True, rows=AG_ROWS,
                     seed: int = 11) -> list[dict]:
    """B9's one-rank form (``all_gather``, push and ring) against its plain
    version on the SP wire [1, B, Hq, D + 1] f32 at each of ``rows``: exact
    and bitwise repeatable, timed beside the bound (the wire read and
    written once) and ``Tensor.clone``, the one PyTorch call that copies
    it. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.shmem import initialize_distributed
    from triton_dist_tpu_torch.utils.perf import perf_func

    ctx = initialize_distributed(("x",), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    records = []
    for B in rows:
        wire = torch.randn((1, B, HQ, D + 1), generator=gen, device=device)
        for method in ("push", "ring"):
            def call():
                return ag.all_gather(ctx, wire, method=method)

            got, got2, ref = call(), call(), ag.all_gather_plain(wire)
            rec = {"kernel": "all_gather",
                   "case": f"float32 {method} wire [1, {B}, {HQ}, {D + 1}]",
                   "max_abs_err": (got - ref).abs().max().item(),
                   "exact": bool(torch.equal(got, ref)),
                   "bitwise_repeat": bool(torch.equal(got, got2))}
            if timed:
                rec["ms"] = perf_func(call)[1]
                rec["kernel_device_ms"] = kernel_device_ms(call,
                                                           "ag_copy_kernel")
                rec["plain_ms"] = perf_func(
                    lambda: ag.all_gather_plain(wire))[1]
                rec["library_ms"] = perf_func(wire.clone)[1]
                rec["library_call"] = "Tensor.clone"
                rec["bound_ms"], rec["bound_by"] = ep_rows_bound(
                    2 * wire.numel() * wire.element_size())
            log("kernel all_gather", json.dumps(rec))
            if not (rec["exact"] and rec["bitwise_repeat"]):
                raise AssertionError(f"all_gather disagrees with its plain "
                                     f"version: {rec}")
            records.append(rec)
    return records


def check_decode_step(params, cfg, device, B: int = DECODE_VS_FORWARD["B"],
                      prompt_len: int = DECODE_VS_FORWARD["prompt"],
                      steps: int = DECODE_VS_FORWARD["steps"],
                      max_seq: int = DECODE_VS_FORWARD["max_seq"]) -> dict:
    """Greedy decode steps through ``decode_step`` (B3, B4 in every layer)
    against the dense ``forward`` over the prompt and the tokens so far,
    within ``MODEL_TOL`` of the logits' scale, and the one-rank
    ``decode_step_sp`` beside it for each of ``SP_METHODS`` (fused: B3 then
    B5's merge; push and ring: B3, B9's one-rank gather and B4), each on its
    own cache and bitwise equal to ``decode_step`` at every step. The launch
    counts are set to 0 just before the steps and read after. Raises on any
    failure."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.shmem import initialize_distributed

    gen = torch.Generator(device=device).manual_seed(2)
    seq = torch.randint(1, cfg.vocab_size, (B, prompt_len), generator=gen,
                        device=device)
    cache = llama.init_kv_cache(cfg, B, max_seq, device=device)
    logits, cache = llama.prefill(params, seq, cfg, cache)
    caches = [cache] + [{n: t.clone() for n, t in cache.items()}
                        for _ in SP_METHODS]
    ctx = initialize_distributed(("x",), device=device)
    tok = logits.argmax(-1).to(torch.int32)
    kernels = (fd.gqa_decode_partial, fd.decode_combine, fd.ll_merge,
               ag.all_gather)
    for kern in kernels:
        kern.launches = 0
    rels, bitwise, clear_same = [], True, True
    tol = MODEL_TOL[str(cfg.dtype).split(".")[-1]]
    for i in range(steps):
        seq = torch.cat([seq, tok[:, None].long()], 1)
        got, caches[0] = llama.decode_step(params, tok, prompt_len + i, cfg,
                                           caches[0])
        for j, method in enumerate(SP_METHODS, 1):
            sp, caches[j] = llama.decode_step_sp(ctx, params, tok,
                                                 prompt_len + i, cfg,
                                                 caches[j], ag_method=method)
            bitwise = bitwise and bool(torch.equal(sp, got))
        with torch.no_grad():
            ref = llama.forward(params, seq, cfg)[:, -1]
        scale = ref.abs().max().item()
        rels.append((got - ref).abs().max().item() / scale)
        top2 = ref.topk(2, -1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol * scale
        clear_same = clear_same and bool(
            (got.argmax(-1) == ref.argmax(-1))[clear].all())
        tok = got.argmax(-1).to(torch.int32)
    launches = {k.__name__: k.launches for k in kernels}
    runs = cfg.n_layers * steps                # of each attention call
    split = fd.split_count(max_seq) > 1
    expect = {"gqa_decode_partial": (1 + len(SP_METHODS)) * runs,
              "decode_combine": ((1 + len(SP_METHODS)) * runs if split
                                 else 0) + 2 * runs,
              "ll_merge": runs,
              "all_gather": 2 * runs}
    rec = {"dtype": str(cfg.dtype), "layers": cfg.n_layers, "rows": B,
           "prompt_len": prompt_len, "steps": steps, "max_seq": max_seq,
           "max_rel_err": max(rels), "rel_err_by_step": rels, "tol": tol,
           "greedy_tokens_agree_where_clear": clear_same,
           "sp_methods": list(SP_METHODS), "sp_bitwise_equal": bitwise,
           "launches": launches, "launches_expected": expect}
    log("model decode_step vs dense forward", json.dumps(rec))
    if not (max(rels) <= tol and bitwise and clear_same
            and launches == expect):
        raise AssertionError(f"decode_step disagrees with the dense forward "
                             f"or decode_step_sp: {rec}")
    return rec


def run_generate(params, cfg, device, name: str, card: str, B: int,
                 prompt: int, new: int, max_seq: int, runs: int,
                 seed: int = 5) -> dict:
    """``generate`` on ``B`` seeded prompts of ``prompt`` tokens, ``runs``
    times: each run's wall time between device synchronisations, its peak
    memory and the launches of B3 and B4 (set to 0 just before each run and
    read after); then ``prefill`` alone once on the same prompts (a fresh
    cache included, as ``generate`` makes one), whose time split from each
    run's gives the decode time, ms per step and tokens/s. Raises unless
    each run launched each kernel layers x decode steps times, the tokens
    lie in the vocabulary, and every run gave the first run's tokens
    bitwise."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=device).manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (B, prompt), generator=gen,
                            device=device)
    kernels = (fd.gqa_decode_partial, fd.decode_combine)
    on_card = device.type == "cuda"

    def clock() -> float:
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    runs_out = []
    for _ in range(runs):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = clock()
        toks = llama.generate(params, prompts, cfg, new, max_seq=max_seq)
        wall = clock() - t0
        runs_out.append((toks, {
            "generate_s": wall,
            "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if on_card else None),
            "launches": {k.__name__: k.launches for k in kernels}}))
    t0 = clock()
    cache = llama.init_kv_cache(cfg, B, max_seq, device=device)
    logits, cache = llama.prefill(params, prompts, cfg, cache)
    logits.argmax(-1)
    prefill_s = clock() - t0
    del cache, logits
    toks = runs_out[0][0]
    steps = new - 1
    for _, r in runs_out:
        r["decode_s"] = r["generate_s"] - prefill_s
        r["decode_ms_per_step"] = r["decode_s"] / steps * 1e3
        r["decode_tok_per_s"] = B * steps / r["decode_s"]
    splits = fd.split_count(max_seq)
    expect = {"gqa_decode_partial": cfg.n_layers * steps,
              "decode_combine": cfg.n_layers * steps if splits > 1 else 0}
    rec = {"run": name, "card": card, "dtype": str(cfg.dtype),
           "layers": cfg.n_layers, "B": B, "prompt": prompt, "new": new,
           "max_seq": max_seq, "splits": splits, "decode_steps": steps,
           "prefill_s": prefill_s,
           "cache_gib": (2 * cfg.n_layers * B * cfg.n_kv_heads * max_seq
                         * cfg.head_dim * toks.new_zeros(0, dtype=cfg.dtype)
                         .element_size() / 2 ** 30),
           "shape_ok": list(toks.shape) == [B, new],
           "in_vocab": bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
           "launches_expected": expect,
           "runs": [r for _, r in runs_out],
           "reruns_bit_identical": all(torch.equal(t, toks)
                                       for t, _ in runs_out[1:]),
           "first_tokens": toks[:, :8].tolist()}
    log(f"generate {name}", json.dumps(rec))
    ok = (rec["shape_ok"] and rec["in_vocab"] and rec["reruns_bit_identical"]
          and all(r["launches"] == expect for _, r in runs_out))
    if not ok:
        raise AssertionError(f"generate {name} failed its checks: {rec}")
    return rec


def profile_decode_step(params, cfg, device, B: int = GEN["batch"]["B"],
                        kv: int = GEN["batch"]["prompt"] + GEN["batch"]["new"],
                        max_seq: int = GEN["batch"]["max_seq"]) -> dict:
    """One ``decode_step`` at G-batch's last position (B rows at ``kv``
    keys): its median wall time over three plain runs (the ``.cpu()`` of
    the greedy tokens waits for the card), then one run under
    ``torch.profiler`` for the device time by family (B3's partial kernel,
    B4's combine, GEMMs, the rest), the device ops and the idle share (1 -
    device time / wall time)."""
    import torch

    from triton_dist_tpu_torch.models import llama

    cache = llama.init_kv_cache(cfg, B, max_seq, device=device)
    token = torch.ones(B, dtype=torch.int32, device=device)

    def step():
        return llama.decode_step(params, token, kv - 1, cfg,
                                 cache)[0].argmax(-1).cpu()

    card = device.type == "cuda"
    step()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    fams, ops = device_time_by_family(
        step, card, (("decode_partial", ("decode_partial_kernel",)),
                     ("decode_combine", ("combine_kernel",))))
    busy = sum(fams.values())
    rec = {"rows": B, "kv_len": kv, "max_seq": max_seq, "wall_s": wall,
           "device_busy_s": busy,
           "device_idle_share": 1 - busy / wall if busy else None,
           "device_s_by_family": fams, "device_ops": ops,
           "device_ops_per_layer": ops / cfg.n_layers}
    log("profile decode_step", json.dumps(rec))
    del cache
    return rec


def check_generation(params, cfg, device, card: str) -> dict:
    """Phase 10 on the 32-layer bf16 params: the kernels against their
    plain versions, G-batch (served twice) and G-long through ``generate``,
    and one G-batch decode step under the profiler."""
    import torch

    kernels = check_decode_kernels(device)
    kernels["all_gather"] = check_all_gather(device)
    torch.cuda.empty_cache()
    gen_batch = run_generate(params, cfg, device, "G-batch", card,
                             runs=2, **GEN["batch"])
    gen_long = run_generate(params, cfg, device, "G-long", card, runs=1,
                            **GEN["long"])
    torch.cuda.empty_cache()
    profile = profile_decode_step(params, cfg, device)
    torch.cuda.empty_cache()
    return {"kernels": kernels, "batch": gen_batch, "long": gen_long,
            "profile": profile}


# ---------------------------------------------------------------------------
# phase 11: the tensor-parallel overlap forward over the dense GEMM
# ---------------------------------------------------------------------------

# B2's cases (name, M, K, N, dtype, B given transposed): the four GEMMs of a
# Llama-3-8B layer at T = 4096 token rows (qkv, wo, gate‖up, down), ragged
# M, K and N, the backward's dy @ w_down^T (B read as [N, K]) and one f32
GEMM_CASES = (("qkv", 4096, 4096, 6144, "bfloat16", False),
              ("wo", 4096, 4096, 4096, "bfloat16", False),
              ("gate_up", 4096, 4096, 28672, "bfloat16", False),
              ("down", 4096, 14336, 4096, "bfloat16", False),
              ("ragged", 100, 72, 200, "bfloat16", False),
              ("down_bt", 4096, 4096, 14336, "bfloat16", True),
              ("f32", 2048, 4096, 4096, "float32", False))
GEMM_MAIN = "gate_up"
# max |kernel - plain| / max |plain|: both sum in f32 and cast once, in
# other orders; in bf16 the one rounding may fall the other way (one bf16
# ulp is 2^-8 of a value)
GEMM_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# B15 and B16 through the persistent tp_linear layers at the qkv and down
# shapes (rows, in, out)
TP_LAYER_SHAPES = {"ag_gemm": (4096, 4096, 6144), "gemm_rs": (4096, 14336, 4096)}
# the overlap forward against the dense one: f32 at full width, depth 4
# (phase 4's params); bf16 at full width and depth, 2 x 2048 tokens
TP_F32 = dict(B=1, S=512, tol=1e-4)
TP_FWD = dict(B=2, S=2048, runs=2)
# mlp_tp_overlap's f32 gradients against autograd through the dense MLP
# (relative to each gradient's scale), and the bf16 step that is timed
TP_MLP = dict(T=512, tol=1e-4, T_timed=4096)


def gemm_bound(M: int, K: int, N: int, esize: int, out_esize: int,
               dtype_name: str) -> tuple[float, str]:
    """Least time of an [M, K] @ [K, N] product: each input read once and
    the output written once, against 2 M N K operations."""
    t_bytes = ((M * K + K * N) * esize + M * N * out_esize) / HBM_BYTES_PER_S
    t_ops = 2 * M * N * K / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _kernel_vs_plain(got, again, ref) -> dict:
    """The kernel's absolute and relative error against the plain version,
    and whether a second launch gave the same bits."""
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    return {"max_abs_err": err,
            "rel_err": err / max(ref.float().abs().max().item(), 1e-30),
            "bitwise_repeat": bool(torch.equal(got, again))}


def _timings(call, plain, library, matches, bound) -> dict:
    """One call between CUDA events, the kernels alone (``torch.profiler``,
    the sum of the medians of the kernels named by ``matches``), the plain
    version, the library call and the bound."""
    from triton_dist_tpu_torch.utils.perf import perf_func

    alone = [kernel_device_ms(call, m) for m in matches]
    rec = {"ms": perf_func(call)[1],
           "kernel_device_ms": (sum(alone) if all(t is not None
                                                  for t in alone) else None),
           "plain_ms": perf_func(plain, iters=5)[1],
           "library_ms": perf_func(library)[1] if library else None}
    rec["bound_ms"], rec["bound_by"] = bound
    return rec


def check_gemm_kernels(device, timed: bool = True, cases=GEMM_CASES,
                       seed: int = 11) -> list[dict]:
    """B2 (``matmul``, the kernel behind ``gemm_into``) against
    ``matmul_plain`` at each case: within ``GEMM_TOL`` of the plain
    version's scale and two launches bitwise equal; timed beside the plain
    version, ``torch.matmul`` on the same operands (TF32 off) and the bound.
    Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import gemm as tg

    gen = torch.Generator(device=device).manual_seed(seed)
    records = []
    for name, M, K, N, dtype_name, trans in cases:
        dtype = getattr(torch, dtype_name)
        a = torch.randn(M, K, generator=gen, device=device).to(dtype)
        b = (torch.randn(N, K, generator=gen, device=device).t() if trans
             else torch.randn(K, N, generator=gen, device=device))
        b = (b * 0.02).to(dtype)
        got = tg.matmul(a, b)
        again = tg.matmul(a, b)
        ref = tg.matmul_plain(a, b)
        rec = {"case": f"{name} {dtype_name} {M}x{K}x{N}"
                       + (" (B as [N, K])" if trans else ""),
               **_kernel_vs_plain(got, again, ref), "tol": GEMM_TOL[dtype_name]}
        if timed:
            esize = a.element_size()
            rec.update(_timings(lambda: tg.matmul(a, b),
                                lambda: tg.matmul_plain(a, b),
                                lambda: torch.matmul(a, b), ("tdt_gemm",),
                                gemm_bound(M, K, N, esize, esize, dtype_name)))
        log("kernel matmul", json.dumps(rec))
        if not (rec["rel_err"] <= rec["tol"] and rec["bitwise_repeat"]):
            raise AssertionError(f"matmul disagrees with its plain version: "
                                 f"{rec}")
        records.append(rec)
        del a, b, got, again, ref
    return records


def check_tp_layers(device, timed: bool = True, shapes=TP_LAYER_SHAPES,
                    seed: int = 12) -> dict:
    """B15 through a persistent ``ColumnParallelLinear`` and B16 through a
    persistent ``RowParallelLinear`` on a one-rank context, in bf16, against
    their plain versions (the f32 product cast once; B16's slot reduction
    of one f32 slot is that cast): within ``GEMM_TOL``, two calls bitwise
    equal, one workspace context reused; then the slot reduction alone on
    the down shape's f32 partial. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.layers import (ColumnParallelLinear,
                                              RowParallelLinear)
    from triton_dist_tpu_torch.ops import gemm as tg
    from triton_dist_tpu_torch.shmem import initialize_distributed

    ctx = initialize_distributed(("tp",), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, layer in (("ag_gemm", ColumnParallelLinear(ctx,
                                                         persistent=True)),
                        ("gemm_rs", RowParallelLinear(ctx, persistent=True))):
        M, K, N = shapes[name]
        x = torch.randn(M, K, generator=gen, device=device).bfloat16()
        w = (torch.randn(K, N, generator=gen, device=device) * 0.02).bfloat16()
        got = layer(x, w)
        again = layer(x, w)
        ref = tg.matmul_plain(x, w)
        ctxs = layer._ag_ctxs if name == "ag_gemm" else layer._rs_ctxs
        rec = {"case": f"{name} bfloat16 {M}x{K}x{N} (persistent "
                       f"{type(layer).__name__})",
               **_kernel_vs_plain(got, again, ref), "tol": GEMM_TOL["bfloat16"],
               "workspace_contexts": len(ctxs)}
        if timed:
            rec.update(_timings(
                lambda: layer(x, w), lambda: tg.matmul_plain(x, w),
                lambda: torch.matmul(x, w),
                ("tdt_gemm",) + (("tdt_slot_reduce",) if name == "gemm_rs"
                                 else ()),
                gemm_bound(M, K, N, 2, 2, "bfloat16")))
        log(f"kernel {name}", json.dumps(rec))
        if not (rec["rel_err"] <= rec["tol"] and rec["bitwise_repeat"]
                and len(ctxs) == 1):
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{rec}")
        out[name] = rec
        if name == "gemm_rs":        # the f32 partial the reduction sums
            ws = next(iter(ctxs.values())).ws[0]
            red = tg.slot_reduce(ws, torch.bfloat16)
            rec = {"case": f"slot_reduce f32 {tuple(ws.shape)} -> bfloat16",
                   **_kernel_vs_plain(red, tg.slot_reduce(ws, torch.bfloat16),
                                      tg.slot_reduce_plain(ws,
                                                           torch.bfloat16)),
                   "tol": 0.0}
            if timed:
                nbytes = ws.numel() * 4 + red.numel() * 2
                rec.update(_timings(
                    lambda: tg.slot_reduce(ws, torch.bfloat16),
                    lambda: tg.slot_reduce_plain(ws, torch.bfloat16),
                    lambda: ws[0].to(torch.bfloat16), ("tdt_slot_reduce",),
                    (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")))
            log("kernel slot_reduce", json.dumps(rec))
            if not (rec["max_abs_err"] == 0.0 and rec["bitwise_repeat"]):
                raise AssertionError(f"slot_reduce disagrees with its plain "
                                     f"version: {rec}")
            out["slot_reduce"] = rec
        del x, w, got, again, ref
    return out


def _tp_kernels():
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import allgather_gemm as agg
    from triton_dist_tpu_torch.ops import gemm as tg
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs

    return {"matmul": tg.matmul, "ag_gemm": agg.ag_gemm,
            "gemm_rs": rs.gemm_rs, "slot_reduce": tg.slot_reduce,
            "all_gather": ag.all_gather}


def _zero_launches() -> dict:
    kernels = _tp_kernels()
    for k in kernels.values():
        k.launches = 0
    return kernels


def check_tp_forward_f32(params, cfg, device, B: int = TP_F32["B"],
                         S: int = TP_F32["S"], tol: float = TP_F32["tol"]
                         ) -> dict:
    """``forward_tp_overlap`` (every linear through B15/B16 over B2) against
    the dense ``forward`` on the same params and tokens: the logits within
    ``tol`` of their scale, 4 GEMM launches a layer. Raises on failure."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import initialize_distributed

    ctx = initialize_distributed(("tp",), device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    with torch.inference_mode():
        kernels = _zero_launches()
        got = llama.forward_tp_overlap(ctx, params, tokens, cfg)
        launches = {n: k.launches for n, k in kernels.items()}
        ref = llama.forward(params, tokens, cfg)
    scale = ref.abs().max().item()
    rec = {"dtype": str(cfg.dtype), "layers": cfg.n_layers, "B": B, "S": S,
           "max_rel_err": (got - ref).abs().max().item() / scale, "tol": tol,
           "finite": bool(torch.isfinite(got).all()),
           "argmax_agree_share": (got.argmax(-1) == ref.argmax(-1)).float()
           .mean().item(), "launches": launches}
    log("model forward_tp_overlap vs dense forward", json.dumps(rec))
    on_card = device.type == "cuda"
    if not (rec["finite"] and rec["max_rel_err"] <= tol and (
            not on_card or launches["matmul"] == 4 * cfg.n_layers)):
        raise AssertionError(f"forward_tp_overlap disagrees with the dense "
                             f"forward: {rec}")
    return rec


def run_tp_forward(params, cfg, device, card: str, B: int = TP_FWD["B"],
                   S: int = TP_FWD["S"], runs: int = TP_FWD["runs"]) -> dict:
    """``forward_tp_overlap`` at full width and depth on B x S seeded tokens
    under ``torch.inference_mode``, ``runs`` times: each run's wall time
    between device synchronisations, its peak memory and the launches (set
    to 0 just before each run and read after: B2 4 a layer, B15, B16 and the
    slot reduction 2 a layer); then one more run under ``torch.profiler``
    (device time by family, idle share against the median wall time), the
    dense ``forward`` beside it (its wall time and the share of positions
    whose argmax agrees, a report), and, timed alone, the LM head's product
    and one layer's plain attention (``_attention``) on seeded q, k, v of
    the forward's shapes. Raises
    unless every run launched as expected and gave the first run's logits
    bitwise, finite and of the right shape."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import initialize_distributed
    from triton_dist_tpu_torch.utils.perf import perf_func

    ctx = initialize_distributed(("tp",), device=device)
    gen = torch.Generator(device=device).manual_seed(6)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    on_card = device.type == "cuda"

    def clock() -> float:
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    L = cfg.n_layers
    expect = {"matmul": 4 * L, "ag_gemm": 2 * L, "gemm_rs": 2 * L,
              "slot_reduce": 2 * L, "all_gather": 0}
    first, run_recs, same = None, [], True
    with torch.inference_mode():
        for _ in range(runs):
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            kernels = _zero_launches()
            t0 = clock()
            logits = llama.forward_tp_overlap(ctx, params, tokens, cfg)
            wall = clock() - t0
            run_recs.append({
                "wall_s": wall,
                "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                 if on_card else None),
                "launches": {n: k.launches for n, k in kernels.items()}})
            if first is None:
                first = logits
                finite = bool(torch.isfinite(logits).all())
            else:
                same = same and bool(torch.equal(logits, first))
            del logits
        tp_argmax = first.argmax(-1)
        shape = list(first.shape)
        del first
        fams, ops = device_time_by_family(
            lambda: llama.forward_tp_overlap(ctx, params, tokens, cfg),
            on_card, (("B2", ("tdt_gemm",)),
                      ("slot_reduce", ("tdt_slot_reduce",)),
                      ("softmax", ("softmax",))))
        t0 = clock()
        dense = llama.forward(params, tokens, cfg)
        dense_s = clock() - t0
        agree = (dense.argmax(-1) == tp_argmax).float().mean().item()
        del dense
        xn = torch.randn(B * S, cfg.d_model, generator=gen, device=device) \
            .to(cfg.dtype)
        head_ms = (perf_func(lambda: xn @ params["lm_head"], iters=5)[1]
                   if on_card else None)
        del xn
        Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = (torch.randn(B, S, h, Dh, generator=gen, device=device)
                   .to(cfg.dtype) for h in (Hq, Hkv, Hkv))
        attn_ms = (perf_func(lambda: llama._attention(q, k, v, Dh ** -0.5),
                             iters=5)[1] if on_card else None)
        del q, k, v
    walls = sorted(r["wall_s"] for r in run_recs)
    wall = walls[len(walls) // 2]
    busy = sum(fams.values())
    rec = {"card": card, "dtype": str(cfg.dtype), "layers": L, "B": B,
           "S": S, "tokens": B * S, "shape": shape, "finite": finite,
           "runs": run_recs, "reruns_bit_identical": same,
           "launches_expected": expect, "device_busy_s": busy,
           "device_idle_share": 1 - busy / wall if busy else None,
           "device_s_by_family": fams, "device_ops": ops,
           "lm_head_ms": head_ms, "attention_ms_per_layer": attn_ms,
           "dense_forward_s": dense_s,
           "argmax_agree_with_dense": agree}
    log("forward_tp_overlap", json.dumps(rec))
    ok = (finite and same and shape == [B, S, cfg.vocab_size]
          and (not on_card or all(r["launches"] == expect
                                  for r in run_recs)))
    if not ok:
        raise AssertionError(f"forward_tp_overlap failed its checks: {rec}")
    return rec


def check_tp_mlp(device, w_gate, w_up, w_down, T: int = TP_MLP["T"],
                 tol: float = TP_MLP["tol"], T_timed: int = TP_MLP["T_timed"],
                 seed: int = 13) -> dict:
    """``mlp_tp_overlap``'s gradients in f32 (weights ``w_gate``, ``w_up``,
    ``w_down`` cast to f32) against autograd through the dense MLP, each of
    dx, dw_gate, dw_up, dw_down within ``tol`` of its scale; then one bf16
    forward plus backward at ``T_timed`` rows on the weights as given,
    timed (median of 3 between synchronisations) with its launches: B2 4
    (B15 2 and B16 2, forward and backward), the slot reduction 2 and B9
    1. Raises on failure."""
    import torch
    import torch.nn.functional as F

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import initialize_distributed

    ctx = initialize_distributed(("tp",), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D = w_gate.shape[0]
    on_card = device.type == "cuda"

    def leaf(t, dtype):
        return t.detach().to(dtype).clone().requires_grad_()

    def grads(mlp, x, ws, g):
        loss = (mlp(x, *ws).float() * g).sum()
        loss.backward()
        return [t.grad for t in (x, *ws)]

    x = leaf(torch.randn(T, D, generator=gen, device=device), torch.float32)
    ws = [leaf(w, torch.float32) for w in (w_gate, w_up, w_down)]
    g = torch.randn(T, D, generator=gen, device=device)
    got = grads(lambda x, *w: llama.mlp_tp_overlap(ctx, x, *w), x, ws, g)
    x2, ws2 = leaf(x, torch.float32), [leaf(w, torch.float32) for w in ws]
    ref = grads(lambda x, wg, wu, wd: (F.silu(x @ wg) * (x @ wu)) @ wd, x2,
                ws2, g)
    rels = {n: ((a - b).abs().max() / b.abs().max()).item()
            for n, a, b in zip(("dx", "dw_gate", "dw_up", "dw_down"), got,
                               ref)}
    del x, ws, x2, ws2, got, ref, g
    xb = leaf(torch.randn(T_timed, D, generator=gen, device=device),
              torch.bfloat16)
    wb = [leaf(w, torch.bfloat16) for w in (w_gate, w_up, w_down)]
    gb = torch.randn(T_timed, D, generator=gen, device=device)
    walls, launches = [], None
    for _ in range(4):                      # a warm-up, then three timed
        for t in (xb, *wb):
            t.grad = None
        kernels = _zero_launches()
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads(lambda x, *w: llama.mlp_tp_overlap(ctx, x, *w), xb, wb, gb)
        if on_card:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = {n: k.launches for n, k in kernels.items()}
    expect = {"matmul": 4, "ag_gemm": 2, "gemm_rs": 2, "slot_reduce": 2,
              "all_gather": 1}
    rec = {"grad_T": T, "d_model": D, "d_ff": w_gate.shape[1],
           "grad_rel_err": rels, "tol": tol, "timed_T": T_timed,
           "fwd_bwd_bf16_s": sorted(walls[1:])[1], "launches": launches,
           "launches_expected": expect}
    log("mlp_tp_overlap gradients and step", json.dumps(rec))
    if not (max(rels.values()) <= tol
            and (not on_card or launches == expect)):
        raise AssertionError(f"mlp_tp_overlap failed its checks: {rec}")
    return rec


def check_tp_overlap(params, cfg, device, card: str) -> dict:
    """Phase 11 on the 32-layer bf16 params: B2 against its plain version,
    B15 and B16 through the persistent layers and the slot reduction alone,
    the forward at full depth twice beside the dense one, and the MLP's
    gradients (its weights are layer 0's)."""
    import torch

    gemm = check_gemm_kernels(device)
    layers = check_tp_layers(device)
    torch.cuda.empty_cache()
    forward = run_tp_forward(params, cfg, device, card)
    torch.cuda.empty_cache()
    b = params["blocks"]
    mlp = check_tp_mlp(device, b["w_gate"][0], b["w_up"][0], b["w_down"][0])
    torch.cuda.empty_cache()
    return {"gemm": gemm, "layers": layers, "forward": forward, "mlp": mlp}


# ---------------------------------------------------------------------------
# phase 12: long-context serving at one rank through the page partials
# ---------------------------------------------------------------------------

# one long prompt, then 128 new tokens. Mixtral-8x7B's published context
# window (max_position_embeddings) is 32768 tokens; at 32768 phase 12 took
# 97.6 s on the H100 (over its 90 s budget: two serves of 33 s), so the
# prompt is cut to 16384 (a quarter of the attention work)
LONG = {"prompt": 16384, "new": 128}
# B7's decode shape: 8 rows over 2056 block-table columns (the long request's
# 32768 + 128 tokens) at ragged lengths: empty, one key, a page edge, mid,
# one past a page, past half, the prompt and the whole request
FD_DECODE_KV = (0, 1, 16, 300, 4097, 16385, 32768, 32896)
# B7's chunk shape: 256 rows of one sequence at staggered lengths (chunk
# start 2304, the last 16 rows padded with length 0)
FD_CHUNK = {"rows": 256, "start": 2304, "real": 240, "pages": 160}
# the depth of the f32 model on which the long-context and plain engines'
# token streams must agree (full width; 12.6 GB beside phase 9's weights)
LONG_EQUAL_F32_LAYERS = 2
# in bf16, a near-tie of a router's k-th and (k+1)-th expert: within a few
# bf16 steps of the row's router logit scale (the two attentions' outputs,
# and so the router's inputs, differ by up to FD_DIST_REL)
ROUTER_TIE_TOL = 2 ** -5
# the fused fold against the fold of B7's slab, bitwise, at S <= 256
FD_FOLD_KV = (0, 1, 17, 256, 1000, 2049, 3333, 4096)
# the partials' out against their plain version: B1's tolerances (bf16 p is
# rounded at the same point, a rounding may fall the other way; f32 sums in
# another order only); lse within LSE_ATOL
FD_OUT_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
# a whole row's attention against its plain version, relative to the row's
# largest output (``_row_rel``): the fused fold against its plain version
# (the same formulas, each page's sums in another order), and
# flash_decode_dist against B1 (another order of the softmax, bf16 p rounded
# against another maximum). bf16: one and two bf16 steps of the row's
# largest output; f32: about four times the largest error seen on an H100
FD_FOLD_REL = {"bfloat16": 2 ** -7, "float32": 4e-6}
FD_DIST_REL = {"bfloat16": 2 ** -6, "float32": 4e-6}


def _row_rel(a, b) -> float:
    """The largest over rows of max |a - b| / max |b|, each row's own scale
    (a row of zeros in ``b`` must be matched exactly)."""
    d = (a.float() - b.float()).flatten(1).abs().amax(1)
    scale = b.float().flatten(1).abs().amax(1)
    return (d / scale.clamp(min=1e-30)).max().item()


def _fd_inputs(dtype, device, kv_lens, S: int, P: int, seed: int,
               shared: bool = False, dead: bool = False) -> dict:
    """q [B, 32, 128], a pool of P pages, a block table [B, S] whose live
    entries are pages of the pool (every row its own random pages, or with
    ``shared`` one row of pages for all) and whose entries past them are
    garbage ids; ``dead`` puts an id outside the pool among one row's live
    pages."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    B = len(kv_lens)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    kv = torch.tensor(kv_lens, dtype=torch.int32, device=device)
    rows = 1 if shared else B
    bt = torch.stack([torch.randperm(P - 1, generator=gen, device=device)[:S]
                      + 1 for _ in range(rows)]).to(torch.int32)
    bt = bt.expand(B, S).contiguous()
    for b in range(B):
        live = min(S, -(-int(kv[b]) // PS))
        bt[b, live:] = torch.randint(-10 ** 6, 10 ** 6, (S - live,),
                                     generator=gen, device=device,
                                     dtype=torch.int32)
    if dead:
        b = next(i for i in range(B) if -(-int(kv[i]) // PS) > 4)
        bt[b, 3] = P + 5
    return {"q": randn(B, HQ, D), "k": randn(P, HKV, PS, D),
            "v": randn(P, HKV, PS, D), "bt": bt, "kv_len": kv,
            "shared": shared}


def fd_bound(case: dict, dtype_name: str, out_bytes: int) -> tuple[float, str]:
    """Least time: q read once, each distinct live page's K and V read once
    (however many rows walk it), ``out_bytes`` written, against
    4 * Hq * D operations per (row, key)."""
    q, kv_len, bt = case["q"], case["kv_len"], case["bt"]
    P = case["k"].shape[0]
    live = set()
    for b in range(q.shape[0]):
        n = min(bt.shape[1], -(-int(kv_len[b]) // PS))
        live.update(p for p in bt[b, :n].tolist() if 0 <= p < P)
    page_bytes = HKV * PS * D * q.element_size()
    nbytes = q.numel() * q.element_size() + 2 * len(live) * page_bytes \
        + out_bytes
    ops = 4 * HQ * D * int(kv_len.long().clamp(max=bt.shape[1] * PS).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_pages_call(case: dict):
    """The yardstick of the fused fold, timed only: scaled dot-product
    attention with GQA over the same K/V gathered contiguous outside the
    timed call, the lengths as a mask. A shared block table gives one
    sequence of queries; separate ones a batch of single queries."""
    import torch
    import torch.nn.functional as F

    q, kv_len, bt = case["q"], case["kv_len"], case["bt"]
    B, S = bt.shape
    P = case["k"].shape[0]
    keys = torch.arange(S * PS, device=q.device)
    if case["shared"]:
        pages = bt[0].long().clamp(0, P - 1)
        kc = case["k"][pages].permute(1, 0, 2, 3).reshape(1, HKV, S * PS, D)
        vc = case["v"][pages].permute(1, 0, 2, 3).reshape(1, HKV, S * PS, D)
        qc = q.transpose(0, 1)[None]
        mask = (keys[None, :] < kv_len[:, None].long())[None, None]
    else:
        pages = bt.long().clamp(0, P - 1)
        kc = case["k"][pages].permute(0, 2, 1, 3, 4).reshape(B, HKV, S * PS,
                                                             D)
        vc = case["v"][pages].permute(0, 2, 1, 3, 4).reshape(B, HKV, S * PS,
                                                             D)
        qc = q[:, :, None]
        mask = (keys[None, :] < kv_len[:, None].long())[:, None, None]
    return lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)


def check_fd_kernels(device, timed: bool = True, decode_kv=FD_DECODE_KV,
                     chunk=FD_CHUNK, fold_kv=FD_FOLD_KV,
                     seed: int = 12) -> dict:
    """B7 (``fd_page_partials``) against its plain version at the decode
    and chunk shapes in bf16 and f32: live entries within the tolerances,
    the neutral entries (dead pages, pages past kv_len, the empty row) exact,
    two launches bitwise equal; a rank-1 slice of the pool gives the neutral
    entry exactly off its slice and the rank-0 slab's bits on it. The fused
    n = 1 route (``fd_partials_fold``) bitwise equal to ``fd_fold_plain`` of
    B7's slab, and within ``FD_FOLD_REL`` of its plain version;
    ``flash_decode_dist`` at one rank within ``FD_DIST_REL`` of
    ``gqa_decode_paged`` (B1) on the same pools. With ``timed``, the same
    checks of the fused fold at the long prompt's decode (8 rows at
    ``LONG["prompt"]`` keys) and last chunk in bf16, and B7 and the fused
    fold beside their bounds, plain versions and (the fold) SDPA. Raises on
    any failure."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.shmem.context import initialize_distributed
    from triton_dist_tpu_torch.utils.perf import perf_func

    long = LONG["prompt"]
    S_dec = -(-max(decode_kv) // PS)
    cs, cr, rows = chunk["start"], chunk["real"], chunk["rows"]
    chunk_kv = tuple(range(cs + 1, cs + cr + 1)) + (0,) * (rows - cr)
    records = {"fd_page_partials": [], "fd_partials_fold": []}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        cases = {
            "decode": _fd_inputs(dtype, device, decode_kv, S_dec,
                                 max(4096, S_dec + 8), seed, dead=True),
            "chunk": _fd_inputs(dtype, device, chunk_kv, chunk["pages"],
                                chunk["pages"] + 64, seed + 1, shared=True)}
        for shape, c in cases.items():
            args = (c["q"], c["k"], c["v"], c["bt"], c["kv_len"])
            out, lse = fd.fd_page_partials(*args)
            out2, lse2 = fd.fd_page_partials(*args)
            ref_out, ref_lse = fd.fd_page_partials_plain(*args)
            P = c["k"].shape[0]
            cols = torch.arange(c["bt"].shape[1], device=device)
            live = ((c["bt"] >= 0) & (c["bt"] < P)
                    & (cols[None] * PS < c["kv_len"][:, None]))
            err = (out - ref_out)[live].abs().max().item()
            lse_err = (lse - ref_lse)[live].abs().max().item()
            neutral = bool((out[~live] == 0).all()
                           and (lse[~live] == fd.NEG_INF).all()
                           and (ref_lse[~live] == fd.NEG_INF).all())
            rec = {"kernel": "fd_page_partials", "dtype": name,
                   "shape": shape,
                   "case": f"{name} {shape} B={c['q'].shape[0]} "
                           f"S={c['bt'].shape[1]} max_kv="
                           f"{int(c['kv_len'].max())}",
                   "live_entries": int(live.sum()),
                   "neutral_entries": int((~live).sum()),
                   "max_abs_err": err, "lse_max_abs_err": lse_err,
                   "atol": FD_OUT_ATOL[name], "lse_atol": LSE_ATOL,
                   "neutral_exact": neutral,
                   "bitwise_repeat": bool(torch.equal(out, out2)
                                          and torch.equal(lse, lse2))}
            ok = (err <= FD_OUT_ATOL[name] and lse_err <= LSE_ATOL
                  and neutral and rec["bitwise_repeat"])
            if shape == "decode":
                half = P // 2
                o1, l1 = fd.fd_page_partials(c["q"], c["k"][half:],
                                             c["v"][half:], c["bt"],
                                             c["kv_len"], rank=1)
                mine = live & (c["bt"] >= half)
                rec["rank1_entries"] = int(mine.sum())
                rec["rank1_exact"] = bool(
                    (o1[~mine] == 0).all() and (l1[~mine] == fd.NEG_INF).all()
                    and torch.equal(o1[mine], out[mine])
                    and torch.equal(l1[mine], lse[mine]))
                ok = ok and rec["rank1_exact"] and rec["rank1_entries"] > 0
                del o1, l1
            if timed:
                rec["ms"] = perf_func(lambda: fd.fd_page_partials(*args))[1]
                rec["kernel_device_ms"] = kernel_device_ms(
                    lambda: fd.fd_page_partials(*args), "fd_page_partials")
                rec["plain_ms"] = perf_func(
                    lambda: fd.fd_page_partials_plain(*args), iters=3,
                    warmup_iters=1)[1]
                rec["bound_ms"], rec["bound_by"] = fd_bound(
                    c, name, out.numel() * 4 + lse.numel() * 4)
                rec["library_ms"] = None
                rec["library_none_because"] = (
                    "no single PyTorch call computes one softmax partial per "
                    "block-table page")
            log("kernel fd_page_partials", json.dumps(rec))
            if not ok:
                raise AssertionError(f"fd_page_partials disagrees with its "
                                     f"plain version: {rec}")
            records["fd_page_partials"].append(rec)
            del out, out2, lse, lse2, ref_out, ref_lse, args
        del cases, c

        # the fused fold: bitwise the fold of B7's slab, at S <= 256
        S_f = -(-max(fold_kv) // PS)
        c = _fd_inputs(dtype, device, fold_kv, S_f, 4 * S_f, seed + 2)
        args = (c["q"], c["k"], c["v"], c["bt"], c["kv_len"])
        got = fd.fd_partials_fold(*args)
        again = fd.fd_partials_fold(*args)
        via_slab = fd.fd_fold_plain(*fd.fd_page_partials(*args), dtype)
        plain = fd.fd_partials_fold_plain(*args)
        err = (got.float() - plain.float()).abs().max().item()
        rel = _row_rel(got, plain)
        # flash_decode_dist at one rank (KV write + fused fold) against B1
        gen = torch.Generator(device=device).manual_seed(seed + 3)
        kn, vn = (torch.randn(len(fold_kv), HKV, D, generator=gen,
                              device=device).to(dtype) for _ in range(2))
        pos = (c["kv_len"] - 1).clamp(min=0)
        kv_w = torch.where(c["kv_len"] > 0, pos + 1, c["kv_len"])
        kp, vp = c["k"].clone(), c["v"].clone()
        ctx = initialize_distributed(("sp",), device=device)
        dist, _, _ = fd.flash_decode_dist(ctx, c["q"], kn, vn, kp, vp,
                                          c["bt"], pos, kv_w, axis="sp",
                                          active=c["kv_len"] > 0)
        paged, _ = fd.gqa_decode_paged(c["q"], kp, vp, c["bt"], kv_w)
        dist_err = (dist.float() - paged.float()).abs().max().item()
        dist_rel = _row_rel(dist, paged)
        rec = {"kernel": "fd_partials_fold", "dtype": name, "shape": "check",
               "case": f"{name} check B={len(fold_kv)} S={S_f} "
                       f"max_kv={max(fold_kv)}",
               "bitwise_equals_fold_of_slab": bool(torch.equal(got,
                                                               via_slab)),
               "bitwise_repeat": bool(torch.equal(got, again)),
               "max_abs_err": err, "row_rel_err": rel,
               "row_rel_tol": FD_FOLD_REL[name],
               "flash_decode_dist_vs_gqa_decode_paged": dist_err,
               "flash_decode_dist_row_rel_err": dist_rel,
               "flash_decode_dist_row_rel_tol": FD_DIST_REL[name]}
        log("kernel fd_partials_fold", json.dumps(rec))
        if not (rec["bitwise_equals_fold_of_slab"] and rec["bitwise_repeat"]
                and rel <= FD_FOLD_REL[name]
                and dist_rel <= FD_DIST_REL[name]):
            raise AssertionError(f"fd_partials_fold fails its checks: {rec}")
        records["fd_partials_fold"].append(rec)
        del c, kp, vp, args, got, again, via_slab, plain, dist, paged

        if not timed or dtype != torch.bfloat16:
            continue
        # the long prompt's shapes in the serving type: 8 rows decoding at
        # `long` keys each, and the prompt's last chunk of 256 rows
        S_l = -(-long // PS)
        timed_cases = {
            "decode": _fd_inputs(dtype, device, (long,) * 8, S_l,
                                 8 * S_l + 1, seed + 4),
            "chunk": _fd_inputs(dtype, device,
                                tuple(range(long - 255, long + 1)), S_l,
                                S_l + 1, seed + 5, shared=True)}
        for shape, c in timed_cases.items():
            args = (c["q"], c["k"], c["v"], c["bt"], c["kv_len"])
            got = fd.fd_partials_fold(*args)
            via_slab = fd.fd_fold_plain(*fd.fd_page_partials(*args), dtype)
            rec = {"kernel": "fd_partials_fold", "dtype": name,
                   "shape": shape,
                   "case": f"{name} {shape} B={c['q'].shape[0]} "
                           f"kv={int(c['kv_len'].min())}.."
                           f"{int(c['kv_len'].max())}",
                   "bitwise_equals_fold_of_slab": bool(torch.equal(
                       got, via_slab)),
                   "ms": perf_func(lambda: fd.fd_partials_fold(*args),
                                   iters=5)[1]}
            del via_slab
            torch.cuda.empty_cache()
            plain, rec["plain_ms"] = perf_func(
                lambda: fd.fd_partials_fold_plain(*args), iters=1,
                warmup_iters=0)
            rec["max_abs_err"] = (got.float() - plain.float()).abs().max() \
                .item()
            rec["row_rel_err"] = _row_rel(got, plain)
            rec["row_rel_tol"] = FD_FOLD_REL[name]
            del plain
            rec["library_ms"] = perf_func(sdpa_pages_call(c), iters=5)[1]
            rec["bound_ms"], rec["bound_by"] = fd_bound(
                c, name, got.numel() * got.element_size())
            log("kernel fd_partials_fold", json.dumps(rec))
            if not (rec["bitwise_equals_fold_of_slab"]
                    and rec["row_rel_err"] <= FD_FOLD_REL[name]):
                raise AssertionError(f"fd_partials_fold disagrees with the "
                                     f"fold of B7's slab or its plain "
                                     f"version: {rec}")
            records["fd_partials_fold"].append(rec)
            del c, got, args
            torch.cuda.empty_cache()
    return records


def profile_long_dispatch(params, cfg, device, attn_io, ffn, linear,
                          kv: int, slots: int = 8, horizon: int = 4) -> dict:
    """One decode dispatch of the long-context engine's shape: ``slots``
    rows, the first at ``kv`` keys and the others parked on the scratch
    page, every layer's attention through ``attn_io``, FFN through ``ffn``
    and projections through ``linear``. Its median wall time over three plain runs, then one run under
    ``torch.profiler``: device time by family, device ops, idle share."""
    import torch

    from triton_dist_tpu_torch.models import llama

    n = -(-(kv + horizon) // PS)
    pool = llama.init_page_pool(cfg, 1 + n, PS, device=device)
    bt = torch.zeros(slots, n, dtype=torch.int32, device=device)
    bt[0] = torch.arange(1, n + 1, dtype=torch.int32, device=device)
    token = torch.ones(slots, dtype=torch.int32, device=device)
    pos = torch.zeros(slots, dtype=torch.int32, device=device)
    pos[0] = kv
    limit = torch.zeros(slots, dtype=torch.int32, device=device)
    limit[0] = horizon

    def dispatch():
        return llama.decode_multistep_paged(
            params, token, pos, cfg, pool, bt, limit, horizon=horizon,
            ffn=ffn, attn_io=attn_io, linear=linear)[0].cpu()

    card = device.type == "cuda"
    dispatch()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        dispatch()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    fams, ops = device_time_by_family(
        dispatch, card, (("attention", ("fd_partials_fold",)),
                         ("grouped_gemm", ("grouped_gemm",)),
                         ("ep_rows", ("ep_dispatch", "ep_combine")),
                         ("ep_wire", ("a2a_push", "a2a_seg")),
                         ("dense_gemm", ("tdt_gemm",)),
                         ("all_gather", ("ag_push", "ag_ring"))))
    busy = sum(fams.values())
    rec = {"slots": slots, "live_rows": 1, "kv_len": kv, "horizon": horizon,
           "wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1 - busy / wall if busy else None,
           "device_s_by_family": fams,
           "device_ops_per_step": ops / horizon}
    log("profile long-context decode dispatch", json.dumps(rec))
    del pool
    return rec


def check_long_engine(params, cfg, device, card: str, long=LONG,
                      engine_kw=None) -> dict:
    """Phase 12's engine: one seeded prompt of ``long["prompt"]`` tokens
    with ``long["new"]`` new ones through ``ShardedServingEngine(
    long_context=True)`` at mesh 1x1x1, twice (bit-identical streams;
    the full budget generated; every kernel of the path launched exactly
    as ``engine_launches`` says, the fused fold on every layer of every
    decode step and chunk, B1 and the slab kernel never); TTFT, prefill s,
    decode ms per step, tok/s and peak memory; one decode dispatch at the
    prompt's length through the engine's own hooks under the profiler.
    Raises on any failure."""
    import numpy as np
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.serving import ShardedServingEngine

    base = cfg.base
    trace, kw = _long_setup(base, long, engine_kw)
    kernels = engine_kernels()

    def make():
        return ShardedServingEngine(params, cfg, device=device,
                                    long_context=True, **kw)

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res, eng, wall, launches = serve(make, device, trace, kernels)
    c, h = eng.metrics.counters, eng.metrics.hist
    expect = engine_launches(eng)
    ttft = h["ttft_s"].percentile(50)
    decode_s = wall - ttft
    rec = {"card": card, "prompt_tokens": long["prompt"],
           "new_tokens": long["new"], "layout": eng.alloc.layout,
           "pages_per_seq": kw["pages_per_seq"],
           "tokens_generated": c["tokens_generated"],
           "dispatches": c["dispatches"],
           "prefill_chunks": c["prefill_chunks"],
           "launches": launches, "launches_expected": expect,
           "wall_s": wall, "ttft_s": ttft,
           "prefill_s": h["ttft_prefill_s"].percentile(50),
           "decode_s": decode_s,
           "decode_ms_per_step": decode_s / max(long["new"] - 1, 1) * 1e3,
           "tok_per_s": c["tokens_generated"] / wall,
           "decode_tok_per_s": (long["new"] - 1) / decode_s,
           "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                            if on_card else None)}
    del eng
    res2, eng2, wall2, launches2 = serve(make, device, trace, kernels)
    rec["rerun_bit_identical"] = res2 == res
    rec["rerun_wall_s"] = wall2
    del eng2
    log("long-context engine", json.dumps(rec))
    ok = (len(res) == 1 and len(res[0]) == long["new"]
          and rec["layout"] == "interleaved"
          and expect["fd_partials_fold"] > 0 and launches == expect
          and launches2 == launches and rec["rerun_bit_identical"])
    if not ok:
        raise AssertionError(f"the long-context engine failed its checks: "
                             f"{rec}")

    eng = make()
    profile = profile_long_dispatch(params, base, device, eng.attn_io,
                                    eng.ffn, eng.linear, long["prompt"])
    del eng
    if on_card:
        torch.cuda.empty_cache()

    return {"engine": rec, "profile": profile, "tokens": res}


def _long_setup(base, long, engine_kw=None) -> tuple:
    """Phase 12's trace (one seeded prompt of ``long["prompt"]`` tokens
    and ``long["new"]`` new ones) and its engine's arguments."""
    import numpy as np

    total = long["prompt"] + long["new"]
    kw = engine_kw or dict(ENGINE, pages_per_seq=-(-total // PS),
                           num_pages=-(-total // PS) + 64)
    rng = np.random.RandomState(3)
    trace = [(0, [int(t) for t in rng.randint(1, base.vocab_size,
                                               long["prompt"])],
              long["new"])]
    return trace, kw


# phase 17b: phase 12's prompt at sp > 1 through the fold across ranks (B8)
LONG_SP_MESHES = ((1, 2, 1), (1, 4, 1))


def check_long_sp(params, cfg, device, card: str, golden: dict, long=LONG,
                  meshes=LONG_SP_MESHES, engine_kw=None) -> list[dict]:
    """Phase 17b: phase 12's prompt through ``ShardedServingEngine(
    long_context=True)`` at each of ``meshes`` (sp > 1: B7 over each SP
    rank's slice of the interleaved pool and B8's fold across ranks),
    once each: the streams bitwise ``golden`` (phase 12's 1x1x1 run), every
    kernel of the path launched exactly as ``engine_launches`` says; TTFT,
    decode ms a step, tok/s, peak memory and the modelled attention split.
    Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.serving import (ShardedServingEngine,
                                               serving_mesh)
    from triton_dist_tpu_torch.shmem import check_errors

    trace, kw = _long_setup(cfg.base, long, engine_kw)
    on_card = device.type == "cuda"
    records = []
    for mesh in meshes:
        def make():
            return ShardedServingEngine(params, cfg, serving_mesh(*mesh),
                                        device=device, long_context=True,
                                        **kw)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        res, eng, wall, launches = serve(make, device, trace,
                                         engine_kernels())
        check_errors(eng.ctx)
        c, h = eng.metrics.counters, eng.metrics.hist
        ttft = h["ttft_s"].percentile(50)
        decode_s = wall - ttft
        rec = {"card": card, "mesh": eng.mesh_desc,
               "prompt_tokens": long["prompt"], "new_tokens": long["new"],
               "layout": eng.alloc.layout,
               "tokens_generated": c["tokens_generated"],
               "dispatches": c["dispatches"],
               "prefill_chunks": c["prefill_chunks"],
               "launches": launches,
               "launches_expected": engine_launches(eng),
               "bitwise_golden": res == golden,
               "first_difference": _first_difference(golden, res),
               "wall_s": wall, "ttft_s": ttft,
               "decode_ms_per_step": decode_s / max(long["new"] - 1, 1)
               * 1e3,
               "tok_per_s": c["tokens_generated"] / wall,
               "attn_local_us_modelled": h["attn_local_us"].mean,
               "attn_fold_wait_us_modelled": h["attn_fold_wait_us"].mean,
               "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                if on_card else None)}
        log("long-context engine across ranks", json.dumps(rec))
        del eng
        if on_card:
            torch.cuda.empty_cache()
        if not (rec["bitwise_golden"] and rec["layout"] == "interleaved"
                and rec["launches_expected"]["fd_fold_dist"] > 0
                and (not on_card or launches == rec["launches_expected"])):
            raise AssertionError(f"the long-context engine at "
                                 f"{rec['mesh']} fails its checks: {rec}")
        records.append(rec)
    return records


def teacher_forced(params, cfg, device, prompt, stream, upto: int,
                   long_context: bool) -> dict:
    """One request through the model functions that the engine calls, with
    ``ENGINE``'s shapes: the prompt's chunks, then decode steps in
    ``num_slots`` rows (the request in row 0, the others parked) fed
    ``stream[:upto]``, through a one-rank engine's own hooks (FFN,
    projections, and attention: ``flash_decode_dist`` when
    ``long_context``, B1 otherwise). A row's bits do not depend on the
    other rows, so this repeats the engine's computation of the request.
    Returns the greedy ``tokens`` of positions 0..upto, ``routers`` (each
    MoE layer call's f32 router logits of the request's rows, in call
    order) and ``logits`` (the LM head's, of the last position)."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.serving import ShardedServingEngine

    base = cfg.base
    slots, chunk = ENGINE["num_slots"], ENGINE["prefill_chunk"]
    routers, heads, rows = [], [], [0]
    eng = ShardedServingEngine(params, cfg, device=device,
                               long_context=long_context, **ENGINE)
    attn_io = eng.attn_io

    def ffn(hook):
        def f(h, p):             # the block's own router product, kept
            routers.append((h.float() @ p["w_router"])[:rows[0]])
            return hook(h, p)
        return f

    def linear(h, w, name):       # the engine's product; keeps the LM head's
        y = eng.linear(h, w, name)
        if name == "lm_head":
            heads.append(y[0].float())
        return y

    n_pages = -(-(len(prompt) + upto + 1) // PS)
    pool = llama.init_page_pool(base, 1 + n_pages, PS, device=device)
    row = torch.zeros(ENGINE["pages_per_seq"], dtype=torch.int32,
                      device=device)
    row[:n_pages] = torch.arange(1, 1 + n_pages, dtype=torch.int32,
                                 device=device)
    tokens = []
    for start in range(0, len(prompt), chunk):
        end = min(start + chunk, len(prompt))
        toks = torch.zeros(chunk, dtype=torch.int32, device=device)
        toks[:end - start] = torch.tensor(prompt[start:end],
                                          dtype=torch.int32, device=device)
        rows[0] = end - start
        tok, pool = llama.prefill_chunk_paged(
            params, toks, start, end, base, pool, row,
            ffn=ffn(eng.ffn_chunk), attn_io=attn_io, linear=linear)
    tokens.append(int(tok))
    bt = torch.zeros(slots, ENGINE["pages_per_seq"], dtype=torch.int32,
                     device=device)
    bt[0] = row
    active = torch.zeros(slots, dtype=torch.bool, device=device)
    active[0] = True
    rows[0] = 1
    for j in range(upto):
        token = torch.zeros(slots, dtype=torch.int32, device=device)
        pos = torch.zeros(slots, dtype=torch.int32, device=device)
        token[0], pos[0] = stream[j], len(prompt) + j
        tok, pool = llama.decode_step_paged(
            params, token, pos, base, pool, bt, active=active, sample=True,
            ffn=ffn(eng.ffn), attn_io=attn_io, linear=linear)
        tokens.append(int(tok[0]))
    del pool, eng
    return {"tokens": tokens, "routers": routers, "logits": heads[-1]}


def _near_tie_gap(values, lo: int, tol: float) -> dict:
    """How far the entry ranked ``lo`` (0-based) lies behind the one ranked
    ``lo - 1``, and whether that is within ``tol`` of the row's scale."""
    top = values.topk(lo + 1).values
    gap = (top[lo - 1] - top[lo]).item()
    scale = values.abs().max().item()
    return {"gap": gap, "scale": scale, "near_tie": gap <= tol * scale}


def explain_divergence(params, cfg, device, prompt, streams: dict, i: int,
                       tol: float, router_tol: float) -> dict:
    """Why the long-context and plain engines' streams of one request part
    at token ``i``: both engines' computation of the request, repeated by
    ``teacher_forced`` (which must give each engine's own tokens 0..i), is
    walked in order to its first discrete choice that differs: an MoE
    layer's top-k experts of some row, or else the greedy token ``i``. That
    choice must be a near-tie in both engines: the experts' k-th and
    (k+1)-th router logits within ``router_tol`` of the row's router logit
    scale, or the two tokens' LM logits within ``tol`` of the logits' scale
    (``check_model``'s criterion)."""
    k = cfg.topk
    tf = {lc: teacher_forced(params, cfg, device, prompt, streams[lc], i, lc)
          for lc in (True, False)}
    rec = {"index": i, "context_tokens": len(prompt) + i,
           "token_long": streams[True][i], "token_plain": streams[False][i],
           "reproduced": all(tf[lc]["tokens"] == streams[lc][:i + 1]
                             for lc in (True, False)),
           "router_calls": len(tf[True]["routers"])}
    n_layers = cfg.base.n_layers
    for e, (ra, rb) in enumerate(zip(tf[True]["routers"],
                                     tf[False]["routers"])):
        ids_a = ra.topk(k, -1).indices.sort(-1).values
        ids_b = rb.topk(k, -1).indices.sort(-1).values
        flipped = (ids_a != ids_b).any(-1).nonzero().flatten().tolist()
        if not flipped:
            continue
        rec["first_flip"] = {
            "kind": "experts", "call": e // n_layers, "layer": e % n_layers,
            "rows": flipped,
            "long": [_near_tie_gap(ra[r], k, router_tol) for r in flipped],
            "plain": [_near_tie_gap(rb[r], k, router_tol) for r in flipped]}
        break
    else:
        la, lb = tf[True]["logits"], tf[False]["logits"]
        rec["first_flip"] = {"kind": "token"}
        for name, lg in (("long", la), ("plain", lb)):
            top = lg.max().item()
            scale = lg.abs().max().item()
            behind = max(top - lg[t].item() for t in (streams[True][i],
                                                      streams[False][i]))
            rec["first_flip"][name] = [{"gap": behind, "scale": scale,
                                        "near_tie": behind <= tol * scale}]
    flip = rec["first_flip"]
    rec["near_tie"] = (rec["reproduced"] and len(tf[False]["routers"])
                       == rec["router_calls"]
                       and all(g["near_tie"] for g in flip["long"]
                               + flip["plain"]))
    return rec


def check_engines_agree(params, cfg, device, trace, label: str,
                        tol: float | None = None,
                        router_tol: float = ROUTER_TIE_TOL) -> dict:
    """``trace`` through ``ShardedServingEngine`` with and without
    ``long_context`` (the fused page fold against B1's online softmax), in
    a pool that holds the whole trace (no preemption). Every request must
    finish. With ``tol`` None the token streams must be equal. The two
    attentions sum in other orders; in bf16 a rounding may tip a near-tie
    of the router's experts or of the greedy token, after which a stream
    goes its own way: with ``tol``, each stream that differs must have its
    first difference explained by ``explain_divergence`` as a near-tie.
    Raises on any failure."""
    from triton_dist_tpu_torch.serving import ShardedServingEngine

    kw = dict(ENGINE, num_pages=1 + len(trace) * ENGINE["pages_per_seq"])
    streams, preempted = {}, 0
    for lc in (True, False):
        eng = ShardedServingEngine(params, cfg, device=device,
                                   long_context=lc, **kw)
        streams[lc] = eng.run(max_steps=10_000, arrivals=trace)
        preempted += eng.metrics.counters["preemptions"]
        del eng
    first = {rid: next(i for i, (a, b) in enumerate(zip(toks, streams[False]
                                                         [rid])) if a != b)
             for rid, toks in streams[True].items()
             if toks != streams[False][rid]}
    divergences = {} if tol is None else {
        rid: explain_divergence(params, cfg, device, trace[rid][1],
                                {lc: streams[lc][rid] for lc in (True, False)},
                                i, tol, router_tol)
        for rid, i in first.items()}
    rec = {"model": label, "requests": len(trace),
           "tokens": sum(len(t) for t in streams[True].values()),
           "preemptions": preempted,
           "streams_equal": streams[True] == streams[False],
           "first_divergence_by_request": first, "tol": tol,
           "router_tol": router_tol, "divergences": divergences}
    log("long-context vs plain engine", json.dumps(rec))
    ok = (preempted == 0 and all(len(streams[lc]) == len(trace)
                                 for lc in (True, False))
          and (rec["streams_equal"] if tol is None else
               all(d["near_tie"] for d in divergences.values())))
    if not ok:
        raise AssertionError(f"the long-context and plain engines' token "
                             f"streams differ: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 13: the MoE tensor-parallel block at one rank
# ---------------------------------------------------------------------------

# tokens of the block at Mixtral-8x7B's widths: a decode step, a prefill
# chunk and a long prefill; the aligned row block is the JAX default
MOE_TP_TOKENS = (8, 256, 4096)
MOE_TP_BLOCK_M = 128
# the grouped GEMM from bf16 into f32 against its plain version: f32 sums
# in another order only (relative to the output's scale)
F32_OUT_TOL = 1e-4


def moe_tp_reference(x, router_w, we_up, we_down, topk: int):
    """The MoE-TP block written out plainly, sharing no code with the
    port's: the f32 router, softmax and renormalised top-k; for each expert
    its routed rows through silu(x @ Wu) in f32 cast to x's type, then @ Wd
    in f32 (kept in f32); then the weighted sum over k in k order in f32,
    cast once."""
    import torch

    T, D = x.shape
    probs = torch.softmax(x.float() @ router_w, -1)
    vals, ids = probs.topk(topk, -1)
    vals = vals / vals.sum(-1, keepdim=True)
    y = torch.zeros(T, topk, D, dtype=torch.float32, device=x.device)
    for e in range(we_up.shape[0]):
        t_idx, j_idx = (ids == e).nonzero(as_tuple=True)
        if t_idx.numel() == 0:
            continue
        h = torch.nn.functional.silu(x[t_idx].float() @ we_up[e].float()) \
            .to(x.dtype)
        y[t_idx, j_idx] = h.float() @ we_down[e].float()
    acc = y[:, 0] * vals[:, 0:1]
    for j in range(1, topk):
        acc = acc + y[:, j] * vals[:, j:j + 1]
    return acc.to(x.dtype)


def moe_rs_bound(ids, T: int, K: int, N: int, esize: int,
                 dtype_name: str) -> tuple[float, str]:
    """Least time of ``moe_reduce_rs``: the used experts' [K, N] weights and
    the routed rows [*, K] read once, the T folded rows [T, N] written once,
    against 2 * K * N operations per routed row."""
    routed = ids[ids >= 0]
    rows, used = int(routed.numel()), int(routed.unique().numel())
    nbytes = (used * K * N + rows * K + T * N) * esize + 4 * ids.numel() \
        + 4 * rows
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * rows * K * N / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def grouped_mm_f32_call(x_rows, ids, w):
    """The yardstick of the bf16-to-f32 grouped GEMM, timed only: one
    ``torch._grouped_mm`` with an f32 output over the routed rows sorted by
    expert. Returns (the call, None) or (None, why not)."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    xs = x_rows[torch.argsort(ids, stable=True)].contiguous()
    offs = torch.bincount(ids, minlength=w.shape[0]).cumsum(0).to(torch.int32)
    try:
        def call():
            return torch._grouped_mm(xs, w, offs=offs,
                                     out_dtype=torch.float32)
        call()
        torch.cuda.synchronize()
        return call, None
    except (RuntimeError, TypeError, ValueError) as e:
        return None, ("torch._grouped_mm into f32 refused: "
                      + str(e).splitlines()[0][:160])


def _route(x, router_w, topk: int):
    """The block's routing: renormalised top-k weights and the pairs'
    expert ids [T * topk] int32."""
    import torch

    probs = torch.softmax(x.float() @ router_w, -1)
    vals, ids = probs.topk(topk, -1)
    return vals / vals.sum(-1, keepdim=True), \
        ids.reshape(-1).to(torch.int32)


def check_moe_tp(params, cfg, device, timed: bool = True,
                 tokens=MOE_TP_TOKENS, block_m: int = MOE_TP_BLOCK_M,
                 seed: int = 13) -> dict:
    """Phase 13 on layer 0's experts: at each token count, the block's
    inputs routed top-2 (two pairs turned into -1 padding rows);
    ``ag_moe_group_gemm`` (B19) and ``moe_reduce_rs`` (B20) against their
    plain versions, bitwise repeatable, padding rows zero; the grouped GEMM
    from bf16 into f32 (B20's slot) against its plain version;
    ``moe_mlp_tp_overlap`` against ``moe_tp_reference``, bitwise
    repeatable. Then the main path: the launch counts set to 0, the block
    run once at each token count, the counts read. With ``timed``, each op
    beside its bound, plain version and ``torch._grouped_mm``. Raises on any
    failure."""
    import torch

    from triton_dist_tpu_torch.models.moe import moe_mlp_tp_overlap
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import gemm as gm
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe as mo
    from triton_dist_tpu_torch.shmem.context import initialize_distributed
    from triton_dist_tpu_torch.utils.perf import perf_func

    p = {k: v[0] for k, v in params["blocks"].items()}
    wr, wu, wd = p["w_router"], p["we_up"], p["we_down"]
    E, Dm, F = wu.shape
    topk = cfg.topk
    ctx = initialize_distributed(("tp",), device=device)
    dtype = cfg.base.dtype
    name = str(dtype).split(".")[-1]
    records = {"ag_moe_group_gemm": [], "moe_reduce_rs": [],
               "grouped_gemm_bf16_f32": [], "block": []}
    for T in tokens:
        gen = torch.Generator(device=device).manual_seed(seed + T)
        x = torch.randn(T, Dm, generator=gen, device=device,
                        dtype=torch.float32).to(dtype)
        tw, ids = _route(x, wr, topk)
        ids_pad = ids.clone()
        ids_pad[[1, ids.numel() - 2]] = -1
        rep = x.repeat_interleave(topk, 0)
        routed = ids_pad[ids_pad >= 0]
        n_blocks = -(-ids.numel() // block_m) + E
        h_ref = mo.ag_moe_group_gemm_plain(ctx, rep, ids_pad, wu,
                                           block_m=block_m)
        h = torch.nn.functional.silu(h_ref.float()).to(dtype)
        bm_rs = min(block_m, -(-ids.numel() // 16) * 16)
        cases = (
            ("ag_moe_group_gemm",
             lambda: mo.ag_moe_group_gemm(ctx, rep, ids_pad, wu,
                                          block_m=block_m),
             lambda: mo.ag_moe_group_gemm_plain(ctx, rep, ids_pad, wu,
                                                block_m=block_m),
             GG_TOL[name],
             # the used experts' weights, the rows in and out, the ids
             grouped_bound(ids_pad, Dm, F, 1, 2, n_blocks, name),
             lambda: grouped_mm_call(rep[ids_pad >= 0], routed, wu)),
            ("moe_reduce_rs",
             lambda: mo.moe_reduce_rs(ctx, h, ids_pad, tw, wd,
                                      block_m=block_m),
             lambda: mo.moe_reduce_rs_plain(ctx, h, ids_pad, tw, wd,
                                            block_m=block_m),
             GG_TOL[name], moe_rs_bound(ids_pad, T, F, Dm, 2, name), None))
        for kname, call, plain, tol, bound, lib in cases:
            got, again, ref = call(), call(), plain()
            rec = {"kernel": kname, "dtype": name, "tokens": T,
                   "case": f"{name} T={T} top-{topk} E={E} D={Dm} F={F} "
                           f"block_m={block_m} (2 padding rows)",
                   **_kernel_vs_plain(got, again, ref), "tol": tol,
                   "padding_rows_zero": (
                       bool(not got[torch.tensor([1, ids.numel() - 2],
                                                 device=device)].any())
                       if kname == "ag_moe_group_gemm" else None)}
            if timed:
                rec["ms"] = perf_func(call)[1]
                rec["plain_ms"] = perf_func(plain, iters=3)[1]
                rec["bound_ms"], rec["bound_by"] = bound
                if lib is not None:
                    fn, why = lib()
                    rec["library_ms"] = perf_func(fn)[1] if fn else None
                    if why:
                        rec["library_none_because"] = why
                else:
                    rec["library_ms"] = None
                    rec["library_none_because"] = (
                        "no single PyTorch call computes the grouped "
                        "down-projection with the top-k fold")
                    fn, why = grouped_mm_call(h[ids_pad >= 0], routed, wd)
                    rec["grouped_mm_down_products_ms"] = (
                        perf_func(fn)[1] if fn else why)
            log(f"kernel {kname}", json.dumps(rec))
            if not (rec["rel_err"] <= tol and rec["bitwise_repeat"]
                    and rec["padding_rows_zero"] is not False):
                raise AssertionError(f"{kname} disagrees with its plain "
                                     f"version: {rec}")
            records[kname].append(rec)

        # B20's grouped GEMM into the f32 slot, on the block's aligned rows
        g, valid, be, nb, _ = gg.expert_alignment(ids_pad, E, bm_rs)
        xs = torch.where(valid[:, None], h[g.long()],
                         torch.zeros((), dtype=dtype, device=device))
        used = int(nb) * bm_rs

        def f32_call():
            return gg.grouped_gemm(xs, wd, be, block_m=bm_rs,
                                   n_blocks_used=nb, masked=False,
                                   out_dtype=torch.float32)

        def f32_plain():
            return gg.grouped_gemm_plain(xs, wd, be, bm_rs, nb,
                                         out_dtype=torch.float32)

        got, again, ref = f32_call(), f32_call(), f32_plain()
        rec = {"kernel": "grouped_gemm_bf16_f32", "dtype": name, "tokens": T,
               "case": f"bf16->f32 T={T} rows={routed.numel()} E={E} "
                       f"K={F} N={Dm} block_m={bm_rs}",
               "out_dtype": str(got.dtype).split(".")[-1],
               **_kernel_vs_plain(got[:used], again[:used], ref[:used]),
               "tol": F32_OUT_TOL}
        if timed:
            rec["ms"] = perf_func(f32_call)[1]
            rec["plain_ms"] = perf_func(f32_plain, iters=3)[1]
            nbytes = ((int(routed.unique().numel()) * F * Dm
                       + routed.numel() * F) * 2 + routed.numel() * Dm * 4)
            t_b = nbytes / HBM_BYTES_PER_S
            t_o = 2 * routed.numel() * F * Dm / PEAK_OPS[name]
            rec["bound_ms"] = max(t_b, t_o) * 1e3
            rec["bound_by"] = "bytes" if t_b >= t_o else "operations"
            fn, why = grouped_mm_f32_call(h[ids_pad >= 0], routed, wd)
            rec["library_ms"] = perf_func(fn)[1] if fn else None
            if why:
                rec["library_none_because"] = why
        log("kernel grouped_gemm_bf16_f32", json.dumps(rec))
        if not (got.dtype == torch.float32 and rec["rel_err"] <= F32_OUT_TOL
                and rec["bitwise_repeat"]):
            raise AssertionError(f"the f32-out grouped GEMM disagrees with "
                                 f"its plain version: {rec}")
        records["grouped_gemm_bf16_f32"].append(rec)

        # the block against the plain reference
        out = moe_mlp_tp_overlap(ctx, x, wr, wu, wd, topk, block_m=block_m)
        out2 = moe_mlp_tp_overlap(ctx, x, wr, wu, wd, topk, block_m=block_m)
        ref = moe_tp_reference(x, wr, wu, wd, topk)
        rec = {"tokens": T, "dtype": name, "block_m": block_m,
               "rel_err": _rel(out, ref), "tol": GG_TOL[name],
               "finite": bool(torch.isfinite(out).all()),
               "bitwise_repeat": bool(torch.equal(out, out2))}
        if timed:
            rec["ms"] = perf_func(lambda: moe_mlp_tp_overlap(
                ctx, x, wr, wu, wd, topk, block_m=block_m))[1]
            rec["reference_ms"] = perf_func(lambda: moe_tp_reference(
                x, wr, wu, wd, topk), iters=3)[1]
        log("moe-tp block vs reference", json.dumps(rec))
        if not (rec["finite"] and rec["rel_err"] <= rec["tol"]
                and rec["bitwise_repeat"]):
            raise AssertionError(f"moe_mlp_tp_overlap disagrees with its "
                                 f"reference: {rec}")
        records["block"].append(rec)
        del h_ref, h, xs, got, again, ref, out, out2

    # the main path: the block at each token count, counted
    counted = (mo.ag_moe_group_gemm, mo.moe_reduce_rs, gg.grouped_gemm,
               gm.slot_reduce, ag.all_gather)
    inputs = []
    for T in tokens:
        gen = torch.Generator(device=device).manual_seed(seed + T)
        inputs.append(torch.randn(T, Dm, generator=gen, device=device,
                                  dtype=torch.float32).to(dtype))
    if device.type == "cuda":
        torch.cuda.synchronize()
    for k in counted:
        k.launches = 0
    gg.grouped_gemm.f32_out_launches = 0
    for x in inputs:
        moe_mlp_tp_overlap(ctx, x, wr, wu, wd, topk, block_m=block_m)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counted}
    launches["grouped_gemm_bf16_f32"] = gg.grouped_gemm.f32_out_launches
    n = len(tokens)
    log("moe-tp main path launches", json.dumps(launches))
    if device.type == "cuda" and not (
            launches["ag_moe_group_gemm"] == launches["moe_reduce_rs"] == n
            and launches["grouped_gemm_bf16_f32"] == n
            and launches["grouped_gemm"] == 2 * n
            and launches["slot_reduce"] == n
            and launches["all_gather"] == n):
        raise AssertionError(f"the MoE-TP block did not launch its kernels: "
                             f"{launches}")
    records["launches"] = launches
    return records


def long_moe_tp_kernels(later: dict) -> list[dict]:
    """The ``kernels`` line's entries of phases 12 and 13, from the records
    of ``check_long_context_and_moe_tp``."""
    fdk, mtp = later["fd"], later["moe_tp"]
    long_launches = later["long"]["engine"]["launches"]
    sp_slabs = sum(r["launches"]["fd_page_partials"]
                   for r in later["long"]["sp"])
    fd_dist_source = "triton_dist_tpu_torch/csrc/flash_decode_dist.cu"
    gg_source = "triton_dist_tpu_torch/csrc/group_gemm.cu"

    def main_rec(records, **match):
        return next(r for r in records
                    if all(r.get(k) == v for k, v in match.items()))

    return [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, **extra,
        "max_abs_err": max(r["max_abs_err"] for r in cases),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "case")},
        "cases": cases}
        for name, source, replaces, launches, extra, main, cases in (
            ("fd_page_partials", fd_dist_source,
             "triton_dist_tpu/ops/flash_decode.py:810",
             long_launches["fd_page_partials"] + sp_slabs,
             {"note": "at one rank the fused fold runs B7's page partial "
                      "(the same __device__ function) with no slab; at sp > "
                      "1 (phase 17b) the slab kernel runs once an SP rank a "
                      "block of rows, before B8"},
             main_rec(fdk["fd_page_partials"], dtype="bfloat16",
                      shape="decode"), fdk["fd_page_partials"]),
            ("fd_partials_fold", fd_dist_source,
             "triton_dist_tpu/ops/flash_decode.py:970",
             long_launches["fd_partials_fold"], {},
             main_rec(fdk["fd_partials_fold"], dtype="bfloat16",
                      shape="decode"), fdk["fd_partials_fold"]),
            ("ag_moe_group_gemm", gg_source,
             "triton_dist_tpu/ops/moe.py:215",
             mtp["launches"]["ag_moe_group_gemm"], {},
             main_rec(mtp["ag_moe_group_gemm"], tokens=4096),
             mtp["ag_moe_group_gemm"]),
            ("moe_reduce_rs", gg_source + " + triton_dist_tpu_torch/csrc/"
             "gemm.cu (slot reduction)", "triton_dist_tpu/ops/moe.py:405",
             mtp["launches"]["moe_reduce_rs"], {},
             main_rec(mtp["moe_reduce_rs"], tokens=4096),
             mtp["moe_reduce_rs"]),
            ("grouped_gemm_bf16_f32", gg_source,
             "triton_dist_tpu/ops/moe.py:261",
             mtp["launches"]["grouped_gemm_bf16_f32"], {},
             main_rec(mtp["grouped_gemm_bf16_f32"], tokens=4096),
             mtp["grouped_gemm_bf16_f32"]))]


# ---------------------------------------------------------------------------
# phase 13 across ranks: B19 and B20 at 2 and 4 ranks on one card, and
# phase 18: the SP + EP MoE decode step at full width
# ---------------------------------------------------------------------------

# ranks of the MoE-TP meshes (every rank on the one card)
MOE_TP_RANKS = (2, 4)
# the token count of the hang checks
MOE_TP_HANG_TOKENS = 256


def moe_tp_compositions(ctx1, rep, ids, tw, h, wu_blocks, wd_blocks,
                        block_m: int):
    """B19 and B20 at n ranks (n = the blocks given) from the one-rank
    kernels: B19 the one-rank ``ag_moe_group_gemm`` (B17) of every row
    against each rank's columns ``wu_blocks[r]``, column block by column
    block; B20 each rank's f32 partial of every row over its K block (B17
    from bf16 into f32 on the rows aligned as one segment, against
    ``wd_blocks[r]``), the n partials through the slot reduction
    (``slot_reduce``) in slot order, unscrambled and folded over k in f32
    in k order, cast once. Returns (B19's [T * topk, F], B20's [T, D])."""
    import torch

    from triton_dist_tpu_torch.ops import gemm as gm
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe as mo

    ag = torch.cat([mo.ag_moe_group_gemm(ctx1, rep, ids, w, block_m=block_m)
                    for w in wu_blocks], 1)
    n = len(wd_blocks)
    Tk, K = h.shape
    T, topk = tw.shape
    kl = K // n
    E = wd_blocks[0].shape[0]
    bm = min(block_m, -(-Tk // 16) * 16)
    gi, rv, be, nb, dest = gg.expert_alignment(ids, E, bm)
    xs = torch.where(rv[:, None], h[gi.long()],
                     torch.zeros((), dtype=h.dtype, device=h.device))
    parts = torch.stack([gg.grouped_gemm(
        xs[:, r * kl:(r + 1) * kl].contiguous(), w, be, block_m=bm,
        n_blocks_used=nb, masked=False, out_dtype=torch.float32)
        for r, w in enumerate(wd_blocks)])
    red = gm.slot_reduce(parts, torch.float32)
    P = red.shape[0]
    dest = dest.long()
    rows = torch.where((dest < P)[:, None], red[dest.clamp(max=P - 1)],
                       torch.zeros((), dtype=red.dtype, device=red.device))
    rows = rows.view(T, topk, -1)
    w = tw.float()
    folded = rows[:, 0] * w[:, 0:1]
    for j in range(1, topk):
        folded = folded + rows[:, j] * w[:, j:j + 1]
    return ag, folded.to(h.dtype)


def moe_tp_ranks_bound(ids, T: int, H: int, N: int, n: int, esize: int,
                       dtype_name: str, rs: bool) -> tuple[float, str]:
    """Least time of B19 (``rs`` False) or B20 at n ranks on one card: the
    used experts' [H, N] weights once, the routed rows in (and B19's out,
    B20's T folded rows), plus the protocol's bytes through the one HBM
    (B19: n - 1 copies of each segment's rows; B20: n f32 partials of each
    routed row), against 2 H N operations per routed row over the ranks."""
    routed = ids[ids >= 0]
    rows, used = int(routed.numel()), int(routed.unique().numel())
    if rs:
        nbytes = (used * H * N + rows * H + T * N) * esize + n * rows * N * 4
    else:
        nbytes = (used * H * N + rows * (H + N) + (n - 1) * rows * H) * esize
    nbytes += 4 * ids.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * rows * H * N / PEAK_OPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_moe_tp_ranks(params, cfg, device, timed: bool = True,
                       ranks=MOE_TP_RANKS, tokens=MOE_TP_TOKENS,
                       block_m: int = MOE_TP_BLOCK_M,
                       fresh: int | None = None, seed: int = 13) -> dict:
    """Phase 13 across ranks on layer 0's experts: at each of ``ranks`` and
    ``tokens``, the block's inputs routed top-2 (two pairs turned into -1
    padding rows); B19 (``ag_moe_group_gemm``) and B20 (``moe_reduce_rs``)
    bitwise their one-rank composition (``moe_tp_compositions``) on a rerun
    and on ``fresh`` calls with fresh data, within ``GG_TOL`` of their plain
    versions, padding rows zero, every signal pad zero after the calls; a
    call whose rank 1 never signals raising ``ShmemError`` within
    ``HANG_LIMIT_S`` and the next call bitwise; ``moe_mlp_tp_overlap``
    against ``moe_tp_reference`` and the one-rank block. Then the main path
    at each n: the counts set to 0, the block run once at each token count,
    the counts read (one B19, one B20 and two B9 gathers a call). With
    ``timed``, each op beside its bound, plain version, the one-rank op and
    ``torch._grouped_mm`` of the whole product. Raises on any failure.
    ``fresh`` is ``FRESH_CALLS`` by default."""
    import torch

    from triton_dist_tpu_torch.models.moe import moe_mlp_tp_overlap
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import gemm as gm
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe as mo
    from triton_dist_tpu_torch.shmem import ShmemError, check_errors
    from triton_dist_tpu_torch.shmem.context import initialize_distributed
    from triton_dist_tpu_torch.utils.perf import perf_func

    p = {k: v[0] for k, v in params["blocks"].items()}
    wr, wu, wd = p["w_router"], p["we_up"], p["we_down"]
    E, Dm, F = wu.shape
    topk = cfg.topk
    dtype = cfg.base.dtype
    name = str(dtype).split(".")[-1]
    ctx1 = initialize_distributed(("tp",), device=device)

    def inputs(T, g):
        x = torch.randn(T, Dm, generator=g, device=device,
                        dtype=torch.float32).to(dtype)
        tw, ids = _route(x, wr, topk)
        ids[[1, ids.numel() - 2]] = -1
        rep = x.repeat_interleave(topk, 0)
        h = torch.nn.functional.silu(torch.randn(
            T * topk, F, generator=g, device=device)).to(dtype)
        return x, tw, ids, rep, h

    fresh = FRESH_CALLS if fresh is None else fresh
    records = {"ag_moe_group_gemm": [], "moe_reduce_rs": [], "block": [],
               "hang": [], "launches": {}}
    for n in ranks:
        ctx = _mesh(n, device)
        nl, kl = F // n, F // n
        wu_blocks = [wu[:, :, r * nl:(r + 1) * nl].contiguous()
                     for r in range(n)]
        wd_blocks = [wd[:, r * kl:(r + 1) * kl].contiguous()
                     for r in range(n)]
        for T in tokens:
            gen = torch.Generator(device=device).manual_seed(seed + T + n)
            x, tw, ids, rep, h = inputs(T, gen)
            calls = {
                "ag_moe_group_gemm": lambda rep=rep, ids=ids, **kw:
                    mo.ag_moe_group_gemm(ctx, rep, ids, wu, block_m=block_m,
                                         **kw),
                "moe_reduce_rs": lambda h=h, ids=ids, tw=tw, **kw:
                    mo.moe_reduce_rs(ctx, h, ids, tw, wd, block_m=block_m,
                                     **kw)}
            plains = {
                "ag_moe_group_gemm": lambda: mo.ag_moe_group_gemm_plain(
                    ctx, rep, ids, wu, block_m=block_m),
                "moe_reduce_rs": lambda: mo.moe_reduce_rs_plain(
                    ctx, h, ids, tw, wd, block_m=block_m)}
            ones = {
                "ag_moe_group_gemm": lambda: mo.ag_moe_group_gemm(
                    ctx1, rep, ids, wu, block_m=block_m),
                "moe_reduce_rs": lambda: mo.moe_reduce_rs(
                    ctx1, h, ids, tw, wd, block_m=block_m)}
            comp = dict(zip(calls, moe_tp_compositions(
                ctx1, rep, ids, tw, h, wu_blocks, wd_blocks, block_m)))
            fresh_ok = {k: [] for k in calls}
            for i in range(fresh):
                g = torch.Generator(device=device).manual_seed(
                    seed + 1000 * (i + 1) + T + n)
                _, tw_i, ids_i, rep_i, h_i = inputs(T, g)
                want = dict(zip(calls, moe_tp_compositions(
                    ctx1, rep_i, ids_i, tw_i, h_i, wu_blocks, wd_blocks,
                    block_m)))
                fresh_ok["ag_moe_group_gemm"].append(bool(torch.equal(
                    calls["ag_moe_group_gemm"](rep_i, ids_i),
                    want["ag_moe_group_gemm"])))
                fresh_ok["moe_reduce_rs"].append(bool(torch.equal(
                    calls["moe_reduce_rs"](h_i, ids_i, tw_i),
                    want["moe_reduce_rs"])))
            for kname, call in calls.items():
                got, again = call(), call()
                check_errors(ctx)
                pads_zero = _pads_zero(ctx)
                ref = plains[kname]()
                rs = kname == "moe_reduce_rs"
                rec = {"kernel": kname, "n": n, "dtype": name, "tokens": T,
                       "case": f"{name} n={n} T={T} top-{topk} E={E} "
                               f"D={Dm} F={F} block_m={block_m} (2 padding "
                               f"rows)",
                       **_kernel_vs_plain(got, again, ref), "tol": GG_TOL[name],
                       "bitwise_composition": bool(torch.equal(got,
                                                               comp[kname])),
                       "fresh_calls_bitwise": all(fresh_ok[kname]),
                       "pads_zero_after": pads_zero and _pads_zero(ctx),
                       "padding_rows_zero": (None if rs else bool(
                           not got[ids < 0].any()))}
                if timed:
                    routed = ids[ids >= 0]
                    bound = moe_tp_ranks_bound(
                        ids, T, F if rs else Dm, Dm if rs else F, n, 2,
                        name, rs)
                    rec.update(_timings(
                        call, plains[kname], None,
                        ("moe_rs_kernel" if rs else "ag_moe_kernel",), bound))
                    rec["one_rank_ms"] = perf_func(ones[kname])[1]
                    rows = h[ids >= 0] if rs else rep[ids >= 0]
                    fn, why = (grouped_mm_f32_call(rows, routed, wd) if rs
                               else grouped_mm_call(rows, routed, wu))
                    rec["library_ms"] = perf_func(fn)[1] if fn else None
                    rec["library_call"] = (
                        "torch._grouped_mm of the whole gathered product"
                        + (" into f32 (no top-k fold)" if rs else ""))
                    if why:
                        rec["library_none_because"] = why
                    rec["note"] = TP_RANKS_NOTE
                log(f"kernel {kname} n={n}", json.dumps(rec))
                if not (rec["bitwise_composition"] and rec["bitwise_repeat"]
                        and rec["fresh_calls_bitwise"]
                        and rec["pads_zero_after"]
                        and rec["rel_err"] <= rec["tol"]
                        and rec["padding_rows_zero"] is not False):
                    raise AssertionError(f"{kname} across ranks failed: "
                                         f"{rec}")
                records[kname].append(rec)
                del got, again, ref
            if T == MOE_TP_HANG_TOKENS and device.type == "cuda":
                for kname, call in calls.items():
                    t0 = time.perf_counter()
                    raised = False
                    try:
                        call(silent_rank=1)
                        check_errors(ctx)
                    except ShmemError as e:
                        raised = True
                        log(f"{kname} n={n} starved signal raised: {e}")
                    waited = time.perf_counter() - t0
                    after = bool(torch.equal(call(), comp[kname]))
                    check_errors(ctx)
                    rec = {"kernel": kname, "n": n, "raised": raised,
                           "seconds": waited, "limit_s": HANG_LIMIT_S,
                           "next_call_bitwise": after,
                           "pads_zero_after": _pads_zero(ctx)}
                    log("moe-tp hang check", json.dumps(rec))
                    if not (raised and waited < HANG_LIMIT_S and after
                            and rec["pads_zero_after"]):
                        raise AssertionError(f"a starved {kname} signal did "
                                             f"not raise within its budget: "
                                             f"{rec}")
                    records["hang"].append(rec)

            out = moe_mlp_tp_overlap(ctx, x, wr, wu, wd, topk,
                                     block_m=block_m)
            out2 = moe_mlp_tp_overlap(ctx, x, wr, wu, wd, topk,
                                      block_m=block_m)
            one = moe_mlp_tp_overlap(ctx1, x, wr, wu, wd, topk,
                                     block_m=block_m)
            ref = moe_tp_reference(x, wr, wu, wd, topk)
            check_errors(ctx)
            rec = {"n": n, "tokens": T, "dtype": name, "block_m": block_m,
                   "rel_err": _rel(out, ref), "rel_err_one_rank": _rel(out,
                                                                       one),
                   "tol": GG_TOL[name],
                   "finite": bool(torch.isfinite(out).all()),
                   "bitwise_repeat": bool(torch.equal(out, out2))}
            if timed:
                rec["ms"] = perf_func(lambda: moe_mlp_tp_overlap(
                    ctx, x, wr, wu, wd, topk, block_m=block_m))[1]
                rec["one_rank_ms"] = perf_func(lambda: moe_mlp_tp_overlap(
                    ctx1, x, wr, wu, wd, topk, block_m=block_m))[1]
                rec["note"] = TP_RANKS_NOTE
            log(f"moe-tp block n={n} vs reference", json.dumps(rec))
            if not (rec["finite"] and rec["bitwise_repeat"]
                    and rec["rel_err"] <= rec["tol"]
                    and rec["rel_err_one_rank"] <= rec["tol"]):
                raise AssertionError(f"moe_mlp_tp_overlap at {n} ranks "
                                     f"disagrees: {rec}")
            records["block"].append(rec)
            del x, rep, h, out, out2, one, ref, comp
        del wu_blocks, wd_blocks
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # the main path at n ranks: the block at each token count, counted
        counted = (mo.ag_moe_group_gemm, mo.moe_reduce_rs, gg.grouped_gemm,
                   gm.slot_reduce, ag.all_gather)
        xs = [torch.randn(T, Dm, generator=torch.Generator(
            device=device).manual_seed(seed + T), device=device,
            dtype=torch.float32).to(dtype) for T in tokens]
        if device.type == "cuda":
            torch.cuda.synchronize()
        for k in counted:
            k.launches = 0
        for x in xs:
            moe_mlp_tp_overlap(ctx, x, wr, wu, wd, topk, block_m=block_m)
        if device.type == "cuda":
            torch.cuda.synchronize()
        check_errors(ctx)
        launches = {k.__name__: k.launches for k in counted}
        log(f"moe-tp main path launches n={n}", json.dumps(launches))
        c = len(tokens)
        if device.type == "cuda" and launches != {
                "ag_moe_group_gemm": c, "moe_reduce_rs": c,
                "grouped_gemm": 0, "slot_reduce": 0, "all_gather": 2 * c}:
            raise AssertionError(f"the MoE-TP block at {n} ranks did not "
                                 f"launch its kernels: {launches}")
        records["launches"][n] = launches
    return records


def moe_tp_ranks_kernels(rk: dict) -> list[dict]:
    """The ``kernels`` line's entries of B19 and B20 at each rank count of
    phase 13 across ranks, headed by the 4096-token case."""
    out = []
    for kname, replaces in (("ag_moe_group_gemm",
                             "triton_dist_tpu/ops/moe.py:215"),
                            ("moe_reduce_rs",
                             "triton_dist_tpu/ops/moe.py:405")):
        for n, launches in rk["launches"].items():
            cases = [r for r in rk[kname] if r["n"] == n]
            main = next(r for r in cases if r["tokens"] == max(
                c["tokens"] for c in cases))
            out.append({
                "name": f"{kname}_x{n}", "route": "cuda",
                "source": "triton_dist_tpu_torch/csrc/moe_tp.cu",
                "replaces": replaces, "ranks": n,
                "launches": launches[kname],
                "max_abs_err": max(r["max_abs_err"] for r in cases),
                **{k: main.get(k) for k in (
                    "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "one_rank_ms", "case",
                    "note")},
                "cases": cases})
    return out


# phase 18: moe_decode_step_sp on phase 9's bf16 Mixtral weights: B rows
# (max_tokens B / n a rank), the cache of S slots sharded on S, a prompt
# teacher-forced through the step, then greedy steps
MOE_SP = dict(B=8, prompt=64, steps=32, max_seq=4096, ranks=(1, 2, 4))
# the f32 check at full width, the depth cut to 2: teacher-forced tokens,
# the logits at n ranks within tol of n = 1's scale, n = 1 within
# MODEL_TOL of a dense golden (decode_step with a plain per-expert FFN).
# 32 slots put the prompt on ranks 0-1 of 4 and the steps on rank 2 (at
# 4096 every key would sit in rank 0's shard and the merge be exact)
MOE_SP_F32 = dict(layers=2, prompt=16, steps=8, max_seq=32, tol=1e-5)


def _moe_sp_launch_counters():
    from triton_dist_tpu_torch.ops import all_to_all as ea
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.ops import group_gemm as gg

    return (fd.gqa_decode_partial, fd.ll_merge, fd.ll_ag_merge,
            ag.all_gather, ea.all_to_all_push, ea.ep_dispatch,
            ea.ep_combine, gg.grouped_gemm_gated, gg.grouped_gemm)


def _moe_sp_run(params, cfg, device, n: int, prompt, steps: int,
                max_seq: int, teacher=None) -> dict:
    """``moe_decode_step_sp`` at n ranks: the prompt [B, P] teacher-forced
    through the step from position 0, then ``steps`` steps of the tokens
    ``teacher`` [B, steps] (or greedy ones), every layer's replicas compared
    in the first ``SP_REPLICA_STEPS``. Returns each step's logits after the
    prompt, the tokens, the seconds of the stepped part between device
    synchronisations, the launches and whether the replicas agreed."""
    import torch

    from triton_dist_tpu_torch.layers import EPAll2AllLayer
    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models.moe import moe_decode_step_sp
    from triton_dist_tpu_torch.shmem import check_errors

    B, P = prompt.shape
    ctx = _mesh(n, device)
    layer = EPAll2AllLayer.create(ctx, B // n, cfg.base.d_model, cfg.topk,
                                  cfg.num_experts, axis="x",
                                  dtype=cfg.base.dtype)
    cache = llama.init_kv_cache(cfg.base, B, max_seq, device=device)
    if n > 1:
        cache = llama.shard_kv_cache(cache, n)

    def step(tok, pos, checks=None):
        return moe_decode_step_sp(ctx, layer, params, tok, pos, cfg, cache,
                                  sp_axis="x", replica_checks=checks)[0]

    checks = []
    for i in range(P):
        logits = step(prompt[:, i].contiguous(), i, checks)
    token = logits.argmax(-1).to(torch.int32)
    counters = _moe_sp_launch_counters()
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    for k in counters:
        k.launches = 0
    toks, logits_all = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        if teacher is not None:
            token = teacher[:, i].contiguous()
        logits = step(token, P + i, checks if i < SP_REPLICA_STEPS else None)
        token = logits.argmax(-1).to(torch.int32)
        toks.append(token)
        logits_all.append(logits)
    sync()
    seconds = time.perf_counter() - t0
    check_errors(ctx)
    return {"tokens": torch.stack(toks, 1), "logits": logits_all,
            "seconds": seconds, "step": lambda: step(token, P + steps),
            "launches": {k.__name__: k.launches for k in counters},
            "replicas_equal": bool(torch.stack(checks).all())}


def _moe_sp_want(L: int, steps: int, n: int) -> dict:
    """The launches of ``steps`` steps of ``moe_decode_step_sp`` at n
    ranks over L layers: a layer-step runs B3's partial once, B5 once (its
    merge ``ll_merge`` at one rank, ``ll_ag_merge`` at n), B21's wire twice
    (``all_to_all_push``) with the one-rank slot gather and fold
    (``ep_dispatch``, ``ep_combine``), B18 and B17 once each; no B9."""
    s = L * steps
    return {"gqa_decode_partial": s, "ll_merge": s if n == 1 else 0,
            "ll_ag_merge": 0 if n == 1 else s, "all_gather": 0,
            "all_to_all_push": 2 * s, "ep_dispatch": s, "ep_combine": s,
            "grouped_gemm_gated": s, "grouped_gemm": s}


def check_moe_decode_f32(device, cfg, spec=MOE_SP_F32, seed: int = 18
                         ) -> dict:
    """``moe_decode_step_sp`` in f32 at Mixtral-8x7B's width, the depth cut
    to ``spec["layers"]``, fed the same teacher-forced tokens at 1, 2 and 4
    ranks: the logits at n ranks within ``tol`` of n = 1's scale, and n = 1
    within ``MODEL_TOL`` of the dense golden (``decode_step`` with
    ``moe_block_reference`` as its FFN). Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models.moe import init_moe_params

    cfg32 = dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, n_layers=spec["layers"], dtype=torch.float32))
    params = init_moe_params(cfg32, seed=3, device=device)
    B, S = MOE_SP["B"], spec["max_seq"]
    gen = torch.Generator(device=device).manual_seed(seed)
    prompt = torch.randint(1, cfg.base.vocab_size, (B, spec["prompt"]),
                           generator=gen, device=device, dtype=torch.int32)
    teacher = torch.randint(1, cfg.base.vocab_size, (B, spec["steps"]),
                            generator=gen, device=device, dtype=torch.int32)
    runs = {n: _moe_sp_run(params, cfg32, device, n, prompt, spec["steps"],
                           S, teacher) for n in MOE_SP["ranks"]}

    def dense_ffn(h, p):
        return moe_block_reference(h, p["w_router"], p["we_gate"],
                                   p["we_up"], p["we_down"], cfg.topk)

    cache = llama.init_kv_cache(cfg32.base, B, S, device=device)
    toks = torch.cat([prompt, teacher], 1)
    golden = []
    for i in range(toks.shape[1]):
        lg, cache = llama.decode_step(params, toks[:, i].contiguous(), i,
                                      cfg32.base, cache, ffn=dense_ffn)
        if i >= spec["prompt"]:
            golden.append(lg)
    one = runs[1]["logits"]
    rec = {"dtype": "float32", "layers": spec["layers"], "B": B,
           "prompt": spec["prompt"], "steps": spec["steps"], "max_seq": S,
           "tol": spec["tol"], "golden_tol": MODEL_TOL["float32"],
           "n1_vs_golden": max(_rel(a, b) for a, b in zip(one, golden)),
           "vs_n1": {n: max(_rel(a, b) for a, b in zip(r["logits"], one))
                     for n, r in runs.items() if n > 1},
           "replicas_equal": all(r["replicas_equal"] for r in runs.values())}
    log("moe sp decode f32", json.dumps(rec))
    del params, runs, cache, golden
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not (rec["replicas_equal"]
            and rec["n1_vs_golden"] <= rec["golden_tol"]
            and all(v <= rec["tol"] for v in rec["vs_n1"].values())):
        raise AssertionError(f"moe_decode_step_sp in f32 disagrees: {rec}")
    return rec


def check_moe_decode_sp(params, cfg, device, card: str, spec=MOE_SP,
                        seed: int = 18) -> dict:
    """Phase 18 on phase 9's bf16 params: at each rank count, a seeded
    prompt teacher-forced through ``moe_decode_step_sp`` and ``steps``
    greedy steps (the largest rank count twice): replicas bitwise, the
    rerun bitwise, the tokens at n ranks n = 1's up to each row's first
    near-tie, each kernel of the path launched its count a layer-step; ms a
    step, and one step under the profiler (device time by family, idle
    share). Then ``check_moe_decode_f32``. Raises on any failure."""
    import torch

    B, P, steps = spec["B"], spec["prompt"], spec["steps"]
    L = cfg.base.n_layers
    gen = torch.Generator(device=device).manual_seed(seed)
    prompt = torch.randint(1, cfg.base.vocab_size, (B, P), generator=gen,
                           device=device, dtype=torch.int32)
    t18 = time.perf_counter()
    rec = {"card": card, "B": B, "prompt": P, "steps": steps,
           "max_seq": spec["max_seq"], "layers": L, "ranks": {}}
    one, ok = None, True
    for n in spec["ranks"]:
        run = _moe_sp_run(params, cfg, device, n, prompt, steps,
                          spec["max_seq"])
        r = {"decode_ms_per_step": run["seconds"] / steps * 1e3,
             "replicas_equal": run["replicas_equal"],
             "launches": run["launches"],
             "launches_as_expected": (device.type != "cuda"
                                      or run["launches"]
                                      == _moe_sp_want(L, steps, n))}
        if n == max(spec["ranks"]):
            again = _moe_sp_run(params, cfg, device, n, prompt, steps,
                                spec["max_seq"])
            r["rerun_bitwise"] = all(torch.equal(a, b) for a, b in zip(
                run["logits"], again["logits"]))
            del again
        if one is None:
            one = run
            clear = _near_tie_steps(one["logits"])
            rec["compared_until"] = clear
        else:
            r["first_divergence"] = _first_divergence(run["tokens"],
                                                      one["tokens"])
            r["tokens_equal_n1_until_near_tie"] = all(
                torch.equal(run["tokens"][b, :clear[b]],
                            one["tokens"][b, :clear[b]]) for b in range(B))
            r["tokens_equal_n1_all"] = bool(torch.equal(run["tokens"],
                                                        one["tokens"]))
        if device.type == "cuda":
            fams, ops = device_time_by_family(
                run["step"], True,
                (("decode_partial", ("decode_partial_kernel",)),
                 ("merge", ("merge_kernel",)),
                 ("ep_wire", ("a2a",)),
                 ("ep_slots", ("ep_dispatch", "ep_combine")),
                 ("grouped_gemm", ("grouped_gemm",))))
            run["step"]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run["step"]()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            busy = sum(fams.values())
            r["profile"] = {"wall_s": wall, "device_busy_s": busy,
                            "device_idle_share": 1 - busy / wall,
                            "device_s_by_family": fams, "device_ops": ops}
        r["note"] = TP_RANKS_NOTE if n > 1 else None
        ok &= (r["replicas_equal"] and r["launches_as_expected"]
               and r.get("rerun_bitwise", True)
               and r.get("tokens_equal_n1_until_near_tie", True))
        rec["ranks"][n] = r
        log(f"moe sp decode n={n}", json.dumps(r))
        del run
    rec["first_tokens"] = one["tokens"][:, :8].tolist()
    del one
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"moe_decode_step_sp failed its checks: {rec}")
    rec["f32"] = check_moe_decode_f32(device, cfg)
    rec["seconds"] = time.perf_counter() - t18
    log("moe sp decode", json.dumps({k: v for k, v in rec.items()
                                     if k != "ranks"}))
    log(f"phase 18 took {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 14: the shmem layer across ranks on one card, the collectives at TP
# widths, and sequence-parallel decode of Llama-3-8B at 2 and 4 ranks
# ---------------------------------------------------------------------------

# ranks of the meshes: every rank of a mesh runs on the one card (one
# launch per collective call covers them all), so a time at n > 1 is the
# kernels and their protocol on shared SMs and one HBM, not an NVLink time
SP_RANKS = (2, 4)
# tutorial 01's ring ping: each rank's block of [8, 128] f32
PING_BLOCK = (8, 128)
# a ping whose rank 1 never signals must raise within this many seconds
HANG_LIMIT_S = 2.0
# the collectives at TP widths of Llama-3-8B at 4096 tokens: AG-GEMM's
# gathered input [M, K] bf16, and GEMM-RS's f32 partial [M, N] on every rank
TP_AG = (4096, 4096)
TP_RS = (4096, 4096)
# calls with fresh data through one context (signal pads reused)
FRESH_CALLS = 5
# SP decode on phase 5's params: G-long (one prompt of 7936 tokens in 8192
# slots) at 2 and 4 ranks, G-batch (8 prompts of 1024 in 4096) at 4
# (each rank count with the methods it runs: G-long's push and ring run at 4
# ranks only, as their gather at 2 ranks is held bit for bit against the
# plain one at this wire shape in check_collectives)
SP_DECODE = {"G-long": dict(B=1, prompt=7936, max_seq=8192,
                            ranks={2: ("fused",), 4: SP_METHODS}),
             "G-batch": dict(B=8, prompt=1024, max_seq=4096,
                             ranks={4: SP_METHODS})}
SP_STEPS = 32
# steps whose replicas are compared in every layer (the compare adds two
# small device ops a layer, so the later steps run without it)
SP_REPLICA_STEPS = 8
# a run's greedy tokens equal n = 1's up to the first step whose top-2
# logit gap is under this share of the logit scale (max |logit|): the SP
# merge rounds in another order than one rank's combine
NEAR_TIE = 2 ** -6
# step 0 of a bf16 SP run reads the same cache and token as n = 1's: its
# logits within this share of n = 1's logit scale (max |diff| / max |ref|).
# The control, one rank's shard zeroed in every layer, must fall outside
# it. On an H100 sound runs read 4.1-4.6% and the controls 87-131%
SP_STEP0_TOL = 0.2
# the SP decode's gather wire, (out || lse) f32 [n, B, HQ, D + 1], at
# G-long's and G-batch's rows
SP_WIRE_ROWS = (1, 8)


# the f32 check of the SP step (full width, depth 4, beside phase 4): fed
# one rank's greedy tokens, the logits within this share of one rank's
# logit scale at every step (the SP merge sums in another order only). 128
# slots put the prompt on ranks 0-1 of 4 and the new tokens on rank 2
SP_F32 = dict(B=2, prompt=64, steps=8, max_seq=128)
SP_F32_TOL = 1e-5


def collective_bound(read_bytes: int, write_bytes: int) -> tuple[float, str]:
    """Least time of a collective on one card: every rank's input read once
    and every rank's output written once, all through the one HBM."""
    return (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3, "bytes"


def _mesh(n: int, device):
    from triton_dist_tpu_torch.shmem import initialize_distributed

    return initialize_distributed(("x",), (n,), device=device)


def check_shmem(device, timed: bool = True, ranks=SP_RANKS) -> dict:
    """The t01 ring ping (``shmem.ring_ping``) and the barrier (B14,
    ``barrier_all_op``) at each of ``ranks`` against their plain versions,
    exact and bitwise repeatable, timed; then the hang check: a ping whose
    rank 1 never signals must raise ``ShmemError`` within
    ``HANG_LIMIT_S``, and the next ping must be right again."""
    import torch

    from triton_dist_tpu_torch.ops.common import (barrier_all_op,
                                                  barrier_all_plain)
    from triton_dist_tpu_torch.shmem import (SPIN_BUDGET_S, ShmemError,
                                             check_errors, ring_ping,
                                             ring_ping_plain)
    from triton_dist_tpu_torch.utils.perf import perf_func

    recs = {"ring_ping": [], "barrier_all_op": []}
    for n in ranks:
        ctx = _mesh(n, device)
        blocks = (torch.arange(n, dtype=torch.float32, device=device)
                  [:, None, None] * torch.ones(PING_BLOCK, device=device))
        got, got2 = ring_ping(ctx, blocks), ring_ping(ctx, blocks)
        check_errors(ctx)
        want = ring_ping_plain(blocks)
        rec = {"case": f"float32 n={n} block {list(PING_BLOCK)}",
               "exact": bool(torch.equal(got, want)),
               "bitwise_repeat": bool(torch.equal(got, got2)),
               "max_abs_err": (got - want).abs().max().item()}
        if timed:
            call = lambda: ring_ping(ctx, blocks)  # noqa: E731
            rec["ms"] = perf_func(call)[1]
            rec["kernel_device_ms"] = kernel_device_ms(call,
                                                       "ring_ping_kernel")
        log("shmem ring_ping", json.dumps(rec))
        if not (rec["exact"] and rec["bitwise_repeat"]):
            raise AssertionError(f"ring_ping failed: {rec}")
        recs["ring_ping"].append(rec)

        barrier = barrier_all_op(ctx)
        b1, b2 = barrier(), barrier()
        check_errors(ctx)
        want = barrier_all_plain(n, device)
        rec = {"kernel": "barrier_all_op", "case": f"int32 n={n}",
               "exact": bool(torch.equal(b1, want)),
               "bitwise_repeat": bool(torch.equal(b1, b2)),
               "max_abs_err": (b1 - want).abs().max().item()}
        if timed:
            rec["ms"] = perf_func(barrier)[1]
            rec["kernel_device_ms"] = kernel_device_ms(barrier,
                                                       "barrier_all_kernel")
            rec["plain_ms"] = perf_func(
                lambda: barrier_all_plain(n, device))[1]
            # each rank adds to n - 1 peers' words and reads its own; the
            # output's n words
            rec["bound_ms"], rec["bound_by"] = collective_bound(
                n * 4, n * (n - 1) * 4 + n * 4)
            rec["library_ms"] = None
            rec["library_none_because"] = (
                "no PyTorch call is a barrier between the ranks of one "
                "launch")
        log("kernel barrier_all_op", json.dumps(rec))
        if not (rec["exact"] and rec["bitwise_repeat"]):
            raise AssertionError(f"barrier_all_op failed: {rec}")
        recs["barrier_all_op"].append(rec)

    ctx = _mesh(2, device)
    blocks = torch.arange(2, dtype=torch.float32, device=device)[:, None] \
        * torch.ones(2, 128, device=device)
    t0 = time.perf_counter()
    raised = None
    try:
        ring_ping(ctx, blocks, silent_rank=1)
        check_errors(ctx)
    except ShmemError as e:
        raised = str(e)
    seconds = time.perf_counter() - t0
    after = ring_ping(ctx, blocks)
    check_errors(ctx)
    rec = {"case": "n=2, rank 1 never signals", "raised": raised,
           "seconds": seconds, "limit_s": HANG_LIMIT_S,
           "budget_s": SPIN_BUDGET_S,
           "next_call_exact": bool(torch.equal(after,
                                               ring_ping_plain(blocks)))}
    log("shmem hang check", json.dumps(rec))
    if not (raised and seconds < HANG_LIMIT_S and rec["next_call_exact"]):
        raise AssertionError(f"the missing signal did not raise in time: "
                             f"{rec}")
    recs["hang"] = rec
    return recs


def check_collectives(device, timed: bool = True, ranks=SP_RANKS,
                      ag_shape=TP_AG, rs_shape=TP_RS, seed: int = 14) -> dict:
    """B9 across ranks (``all_gather``, push and ring, on AG-GEMM's bf16
    input and on the SP decode's f32 wire at ``SP_WIRE_ROWS``) and B13
    (``reduce_scatter``, ring, on GEMM-RS's f32 partial, and in bf16) at
    each of ``ranks`` against their plain versions: every
    replica the concatenation of the shards and the scatter the plain
    ring's sums, bit for bit; a bitwise repeat and ``FRESH_CALLS`` calls
    with fresh data through one context; timed beside the bound, the plain
    version and one PyTorch call of the same function (``Tensor.repeat``,
    ``torch.sum`` over the ranks)."""
    import torch

    from triton_dist_tpu_torch.ops.allgather import (all_gather,
                                                     all_gather_plain)
    from triton_dist_tpu_torch.ops.flash_decode import NEG_INF
    from triton_dist_tpu_torch.ops.reduce_scatter import (
        reduce_scatter, reduce_scatter_plain)
    from triton_dist_tpu_torch.shmem import check_errors
    from triton_dist_tpu_torch.utils.perf import perf_func

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    recs = {"all_gather": [], "reduce_scatter": []}
    for n in ranks:
        ctx = _mesh(n, device)
        M, K = ag_shape
        x = randn(M, K, dtype=torch.bfloat16)
        for method in ("push", "ring"):
            def call(x=x, method=method):
                return all_gather(ctx, x, method=method)

            got, got2 = call(), call()
            check_errors(ctx)
            ref = all_gather_plain(x, n)
            fresh = []
            for _ in range(FRESH_CALLS):
                xi = randn(M, K, dtype=torch.bfloat16)
                fresh.append(bool(torch.equal(call(xi), all_gather_plain(
                    xi, n))))
            check_errors(ctx)
            rec = {"kernel": "all_gather",
                   "case": f"bfloat16 {method} n={n} [{M}, {K}]",
                   "exact": bool(torch.equal(got, ref)),
                   "replicas_are_the_shards": all(torch.equal(got[r], x)
                                                  for r in range(n)),
                   "bitwise_repeat": bool(torch.equal(got, got2)),
                   "fresh_calls_exact": all(fresh),
                   "max_abs_err": (got.float() - ref.float()).abs().max()
                   .item()}
            if timed:
                rec["ms"] = perf_func(call)[1]
                rec["kernel_device_ms"] = kernel_device_ms(
                    call, f"ag_{method}_kernel")
                rec["plain_ms"] = perf_func(
                    lambda: all_gather_plain(x, n))[1]
                rec["library_ms"] = perf_func(lambda: x.repeat(n, 1, 1))[1]
                rec["library_call"] = "Tensor.repeat"
                nbytes = x.numel() * x.element_size()
                rec["bound_ms"], rec["bound_by"] = collective_bound(
                    nbytes, n * nbytes)
            log("kernel all_gather", json.dumps(rec))
            if not (rec["exact"] and rec["replicas_are_the_shards"]
                    and rec["bitwise_repeat"] and rec["fresh_calls_exact"]):
                raise AssertionError(f"all_gather failed: {rec}")
            recs["all_gather"].append(rec)
            del got, got2, ref

        for B in SP_WIRE_ROWS:
            wire = randn(n, B, HQ, D + 1)
            wire[n - 1, 0, :, D] = NEG_INF            # an empty shard's lse
            for method in ("push", "ring"):
                def call(x=wire, method=method):
                    return all_gather(ctx, x, method=method)

                got, got2 = call(), call()
                check_errors(ctx)
                ref = all_gather_plain(wire, n)
                fresh = []
                for _ in range(FRESH_CALLS):
                    xi = randn(n, B, HQ, D + 1)
                    fresh.append(bool(torch.equal(call(xi), all_gather_plain(
                        xi, n))))
                check_errors(ctx)
                rec = {"kernel": "all_gather",
                       "case": f"float32 {method} n={n} SP wire "
                               f"[{n}, {B}, {HQ}, {D + 1}]",
                       "exact": bool(torch.equal(got, ref)),
                       "replicas_are_the_shards": all(
                           torch.equal(got[r], wire) for r in range(n)),
                       "bitwise_repeat": bool(torch.equal(got, got2)),
                       "fresh_calls_exact": all(fresh),
                       "max_abs_err": (got - ref).abs().max().item()}
                if timed:
                    rec["ms"] = perf_func(call)[1]
                log("kernel all_gather", json.dumps(rec))
                if not (rec["exact"] and rec["replicas_are_the_shards"]
                        and rec["bitwise_repeat"]
                        and rec["fresh_calls_exact"]):
                    raise AssertionError(f"all_gather failed: {rec}")
                recs["all_gather"].append(rec)

        Mr, N = rs_shape
        for dtype in ((torch.float32, torch.bfloat16) if n == max(ranks)
                      else (torch.float32,)):
            name = str(dtype).split(".")[-1]
            xr = randn(n * Mr, N, dtype=dtype)

            def rs(xr=xr):
                return reduce_scatter(ctx, xr)

            got, got2 = rs(), rs()
            check_errors(ctx)
            ref = reduce_scatter_plain(xr, n)
            fresh = []
            for _ in range(FRESH_CALLS if dtype == torch.float32 else 1):
                xi = randn(n * Mr, N, dtype=dtype)
                fresh.append(bool(torch.equal(rs(xi),
                                              reduce_scatter_plain(xi, n))))
            check_errors(ctx)
            rec = {"kernel": "reduce_scatter",
                   "case": f"{name} ring n={n} [{Mr}, {N}] a rank",
                   "exact": bool(torch.equal(got, ref)),
                   "bitwise_repeat": bool(torch.equal(got, got2)),
                   "fresh_calls_exact": all(fresh),
                   "max_abs_err": (got.float() - ref.float()).abs().max()
                   .item()}
            if timed:
                rec["ms"] = perf_func(rs)[1]
                rec["kernel_device_ms"] = kernel_device_ms(rs,
                                                           "rs_ring_kernel")
                rec["plain_ms"] = perf_func(
                    lambda: reduce_scatter_plain(xr, n))[1]
                rec["library_ms"] = perf_func(
                    lambda: torch.sum(xr.view(n, Mr, N), 0))[1]
                rec["library_call"] = "torch.sum over the ranks"
                rec["bound_ms"], rec["bound_by"] = collective_bound(
                    xr.numel() * xr.element_size(),
                    Mr * N * xr.element_size())
            log("kernel reduce_scatter", json.dumps(rec))
            if not (rec["exact"] and rec["bitwise_repeat"]
                    and rec["fresh_calls_exact"]):
                raise AssertionError(f"reduce_scatter failed: {rec}")
            recs["reduce_scatter"].append(rec)
            del xr, got, got2, ref
    return recs


def check_ll_ag_merge(device, timed: bool = True, ranks=SP_RANKS,
                      rows=(("G-batch", 8), ("G-long", 1)),
                      seed: int = 15) -> list[dict]:
    """B5 across ranks (``ll_ag_merge``) on the SP decode's partials (B rows
    of 32 heads, D 128, f32; rank n - 1's shard empty for row 0, (0,
    NEG_INF) as B3 gives it): every replica bitwise equal to ``ll_merge``
    over the stacked partials, within ``OUT_ATOL`` of the plain version,
    bitwise repeatable; bf16 and f32 outputs, timed beside the bound (the n
    partials read once, the n replicas written once) and the plain
    version."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.shmem import check_errors
    from triton_dist_tpu_torch.utils.perf import perf_func

    gen = torch.Generator(device=device).manual_seed(seed)
    records = []
    for label, B in rows:
        for n in ranks:
            ctx = _mesh(n, device)
            outs = torch.randn((n, B, HQ, D), generator=gen, device=device)
            lses = torch.randn((n, B, HQ), generator=gen, device=device) * 3
            outs[n - 1, 0] = 0.0
            lses[n - 1, 0] = fd.NEG_INF
            for out_dtype in (torch.bfloat16, torch.float32):
                name = str(out_dtype).split(".")[-1]

                def call():
                    return fd.ll_ag_merge(ctx, outs, lses, out_dtype, "x")

                got, got2 = call(), call()
                check_errors(ctx)
                merged = fd.ll_merge(outs, lses, out_dtype)
                ref = fd.ll_merge_plain(outs, lses, out_dtype)
                rec = {"kernel": "ll_ag_merge",
                       "case": f"float32 -> {name} {label} n={n} rows={B}x"
                               f"{HQ} D={D}",
                       "replicas_equal_ll_merge": all(
                           torch.equal(got[r], merged) for r in range(n)),
                       "rel_err": _rel(got[0], ref), "atol": OUT_ATOL[name],
                       "bitwise_repeat": bool(torch.equal(got, got2)),
                       "max_abs_err": (got[0].float() - ref.float()).abs()
                       .max().item()}
                if timed:
                    rec["ms"] = perf_func(call)[1]
                    rec["kernel_device_ms"] = kernel_device_ms(
                        call, "ll_ag_merge_kernel")
                    rec["plain_ms"] = perf_func(
                        lambda: fd.ll_ag_merge_plain(outs, lses,
                                                     out_dtype))[1]
                    rec["bound_ms"], rec["bound_by"] = collective_bound(
                        (outs.numel() + lses.numel()) * 4,
                        n * merged.numel() * merged.element_size())
                    rec["library_ms"] = None
                    rec["library_none_because"] = (
                        "no single PyTorch call gathers partials across "
                        "ranks and merges them by their lse")
                log("kernel ll_ag_merge", json.dumps(rec))
                if not (rec["replicas_equal_ll_merge"]
                        and rec["rel_err"] <= rec["atol"]
                        and rec["bitwise_repeat"]):
                    raise AssertionError(f"ll_ag_merge failed: {rec}")
                records.append(rec)
    return records


def _greedy(params, cfg, cache, token, pos0: int, steps: int, ctx=None,
            method: str | None = None) -> dict:
    """``steps`` greedy steps from ``token`` at ``pos0``: ``decode_step``
    without ``ctx``, else ``decode_step_sp`` with ``method`` (every layer's
    replicas compared in the first ``SP_REPLICA_STEPS``). Returns the
    tokens [B, steps], each step's logits, the seconds between device
    synchronisations and whether the replicas agreed; raises ``ShmemError``
    if a spin of the run ran out."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    toks, logits_all, checks = [], [], []
    sync = torch.cuda.synchronize if token.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        if ctx is None:
            logits, cache = llama.decode_step(params, token, pos0 + i, cfg,
                                              cache)
        else:
            logits, cache = llama.decode_step_sp(
                ctx, params, token, pos0 + i, cfg, cache, ag_method=method,
                replica_checks=checks if i < SP_REPLICA_STEPS else None)
        token = logits.argmax(-1).to(torch.int32)
        toks.append(token)
        logits_all.append(logits)
    sync()
    seconds = time.perf_counter() - t0
    if ctx is not None:
        check_errors(ctx)
    return {"tokens": torch.stack(toks, 1), "logits": logits_all,
            "seconds": seconds,
            "replicas_equal": (bool(torch.stack(checks).all())
                               if checks else None)}


def _near_tie_steps(logits_all) -> list[int]:
    """Per row, the first step whose top-2 logit gap is under ``NEAR_TIE``
    of the row's max |logit| (the step count when none is)."""
    import torch

    gaps = torch.stack([l.topk(2, -1).values for l in logits_all], 1)
    scale = torch.stack([l.abs().amax(-1) for l in logits_all], 1)
    near = (gaps[..., 0] - gaps[..., 1]) < NEAR_TIE * scale     # [B, steps]
    steps = near.shape[1]
    return [int(row.nonzero()[0]) if row.any() else steps
            for row in near.cpu()]


def check_sp_decode_f32(params, cfg, device, B: int = SP_F32["B"],
                        prompt_len: int = SP_F32["prompt"],
                        steps: int = SP_F32["steps"],
                        max_seq: int = SP_F32["max_seq"],
                        seed: int = 17) -> dict:
    """``decode_step_sp`` at 2 and 4 ranks (every method) against
    ``decode_step`` in f32: after a ``prefill`` of seeded prompts, each step
    feeds both one rank's greedy token; the SP logits must lie within
    ``SP_F32_TOL`` of one rank's logit scale, every replica equal rank 0's
    bit for bit, and push equal ring bit for bit. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    gen = torch.Generator(device=device).manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (B, prompt_len),
                            generator=gen, device=device)
    cache = llama.init_kv_cache(cfg, B, max_seq, device=device)
    logits, cache = llama.prefill(params, prompts, cfg, cache)
    sharded = {(n, m): llama.shard_kv_cache(cache, n)
               for n in SP_RANKS for m in SP_METHODS}
    token = logits.argmax(-1).to(torch.int32)
    worst, replicas_ok, push_ring = {}, True, True
    for i in range(steps):
        pos = prompt_len + i
        ref, cache = llama.decode_step(params, token, pos, cfg, cache)
        scale = ref.abs().max()
        for n in SP_RANKS:
            ctx = _mesh(n, device)
            got = {}
            for m in SP_METHODS:
                checks = []
                got[m], sharded[(n, m)] = llama.decode_step_sp(
                    ctx, params, token, pos, cfg, sharded[(n, m)],
                    ag_method=m, replica_checks=checks)
                replicas_ok &= bool(torch.stack(checks).all())
                key = f"n={n} {m}"
                worst[key] = max(worst.get(key, 0.0),
                                 ((got[m] - ref).abs().max() / scale).item())
            push_ring &= bool(torch.equal(got["push"], got["ring"]))
            check_errors(ctx)
        token = ref.argmax(-1).to(torch.int32)
    rec = {"dtype": str(cfg.dtype), "layers": cfg.n_layers, "B": B,
           "prompt": prompt_len, "steps": steps,
           "max_rel_logit_diff": worst, "tol": SP_F32_TOL,
           "replicas_equal": replicas_ok, "push_equals_ring": push_ring}
    log("sp decode f32", json.dumps(rec))
    if not (replicas_ok and push_ring
            and all(v <= SP_F32_TOL for v in worst.values())):
        raise AssertionError(f"SP decode in f32 disagrees with one rank: "
                             f"{rec}")
    return rec


def _first_divergence(tokens, ref) -> list[int]:
    """Per row, the first step whose token differs from ``ref``'s (the
    step count when none does)."""
    diff = (tokens != ref).cpu()
    return [int(row.nonzero()[0]) if row.any() else diff.shape[1]
            for row in diff]


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp(min=1e-30)).item()


def run_sp_decode(params, cfg, device, card: str, specs=SP_DECODE,
                  steps: int = SP_STEPS, seed: int = 16) -> dict:
    """SP decode on the bf16 params: for each of ``specs``, ``prefill`` of
    seeded prompts into a contiguous cache, ``steps`` greedy
    ``decode_step``s at one rank, then the cache sharded over each rank
    count (``shard_kv_cache``) and ``steps`` greedy ``decode_step_sp``s of
    each of its methods (the first spec's largest rank count's fused run
    twice). Then the gate's control: the last rank holding prompt keys has
    its shard zeroed in every layer, and one step is taken. Raises unless
    every replica agreed, push and ring gave the same logits bit for bit,
    the rerun was bitwise, every run's tokens equal one rank's up to each
    row's first near-tie, every run's step 0 lies within ``SP_STEP0_TOL``
    of one rank's and the control's does not."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    out = {}
    for name, spec in specs.items():
        B, prompt, max_seq = spec["B"], spec["prompt"], spec["max_seq"]
        gen = torch.Generator(device=device).manual_seed(seed)
        prompts = torch.randint(1, cfg.vocab_size, (B, prompt),
                                generator=gen, device=device)
        cache = llama.init_kv_cache(cfg, B, max_seq, device=device)
        t0 = time.perf_counter()
        logits, cache = llama.prefill(params, prompts, cfg, cache)
        first = logits.argmax(-1).to(torch.int32).cpu().to(device)
        prefill_s = time.perf_counter() - t0
        del logits
        sharded = {n: llama.shard_kv_cache(cache, n) for n in spec["ranks"]}
        one = _greedy(params, cfg, cache, first, prompt, steps)
        del cache
        clear = _near_tie_steps(one["logits"])
        rec = {"run": name, "card": card, "B": B, "prompt": prompt,
               "max_seq": max_seq, "steps": steps, "prefill_s": prefill_s,
               "compared_until": clear, "step0_tol": SP_STEP0_TOL,
               "n1": {"decode_ms_per_step": one["seconds"] / steps * 1e3},
               "ranks": {}}
        ok = True
        for n, sc in sharded.items():
            ctx = _mesh(n, device)
            methods = spec["ranks"][n]
            runs = {m: _greedy(params, cfg, sc, first, prompt, steps, ctx, m)
                    for m in methods}
            rerun = None
            if name == next(iter(specs)) and n == max(spec["ranks"]):
                rerun = _greedy(params, cfg, sc, first, prompt, steps, ctx,
                                "fused")
            r = {m: {"decode_ms_per_step": runs[m]["seconds"] / steps * 1e3,
                     "replicas_equal": runs[m]["replicas_equal"],
                     # step 0 reads the same cache and token as n = 1's
                     "step0_logit_rel_diff": _rel(runs[m]["logits"][0],
                                                  one["logits"][0]),
                     "step0_logit_rel_l2": _rel_l2(runs[m]["logits"][0],
                                                   one["logits"][0]),
                     "first_divergence": _first_divergence(
                         runs[m]["tokens"], one["tokens"]),
                     "tokens_equal_n1_until_near_tie": all(
                         torch.equal(runs[m]["tokens"][b, :clear[b]],
                                     one["tokens"][b, :clear[b]])
                         for b in range(B)),
                     "tokens_equal_n1_all": bool(torch.equal(
                         runs[m]["tokens"], one["tokens"]))}
                 for m in methods}
            if "push" in runs and "ring" in runs:
                r["push_equals_ring"] = all(
                    torch.equal(a, b) for a, b in zip(runs["push"]["logits"],
                                                      runs["ring"]["logits"]))
            if rerun is not None:
                r["rerun_bitwise"] = all(
                    torch.equal(a, b) for a, b in zip(runs["fused"]["logits"],
                                                      rerun["logits"]))
            del runs, rerun
            zeroed = (prompt - 1) // (max_seq // n)
            sc["k"][:, zeroed].zero_()
            sc["v"][:, zeroed].zero_()
            ctl = llama.decode_step_sp(ctx, params, first, prompt, cfg, sc)[0]
            check_errors(ctx)
            r["control"] = {"zeroed_rank": zeroed,
                            "step0_logit_rel_diff": _rel(ctl,
                                                         one["logits"][0]),
                            "step0_logit_rel_l2": _rel_l2(ctl,
                                                          one["logits"][0])}
            ok &= (r.get("push_equals_ring", True)
                   and r.get("rerun_bitwise", True)
                   and r["control"]["step0_logit_rel_diff"] > SP_STEP0_TOL
                   and all(r[m]["replicas_equal"]
                           and r[m]["tokens_equal_n1_until_near_tie"]
                           and r[m]["step0_logit_rel_diff"] <= SP_STEP0_TOL
                           for m in methods))
            rec["ranks"][n] = r
        rec["first_tokens"] = one["tokens"][:, :8].tolist()
        log(f"sp decode {name}", json.dumps(rec))
        if not ok:
            raise AssertionError(f"sp decode {name} failed its checks: {rec}")
        out[name] = rec
        del sharded, one
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def host_call_us(fn, calls: int = 200) -> float:
    """The host's microseconds to enqueue one call of ``fn`` (``calls``
    calls between two synchronisations, the clock read before the second):
    the launch overhead a step pays per call when the card is not the
    limit."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def sp_host_costs(cfg, device, cache, n: int, B: int, kv: int) -> dict:
    """The host's cost of each piece of one layer's SP attention at n ranks
    (layer 0 of ``cache``), beside one rank's split-KV call and one torch
    op."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd

    ctx = _mesh(n, device)
    q = torch.randn((B, HQ, D), device=device).to(cfg.dtype)
    ck, cv = cache["k"][0], cache["v"][0]
    lens = torch.full((B,), kv, dtype=torch.int32, device=device)
    rows = (n * B,) + tuple(ck.shape[2:])
    local = fd.sp_local_lens(lens, n, ck.shape[3]).reshape(n * B)
    outs = torch.randn((n, B, HQ, D), device=device)
    lses = torch.randn((n, B, HQ), device=device)
    pieces = {
        "sp_gqa_flash_decode fused": lambda: fd.sp_gqa_flash_decode(
            ctx, q, ck, cv, lens),
        "sp_local_lens": lambda: fd.sp_local_lens(lens, n, ck.shape[3]),
        "q.repeat": lambda: q.repeat(n, 1, 1),
        "gqa_decode_partial over n shards": lambda: fd.gqa_decode_partial(
            q.repeat(n, 1, 1), ck.reshape(rows), cv.reshape(rows), local),
        "ll_ag_merge": lambda: fd.ll_ag_merge(ctx, outs, lses, cfg.dtype,
                                              "x"),
        "one torch op (lens + 1)": lambda: lens + 1}
    return {k: host_call_us(f) for k, f in pieces.items()}


def profile_sp_step(params, cfg, device, B: int = 1, S: int = 8192,
                    kv: int = 7936 + SP_STEPS, ns=(1, 4)) -> dict:
    """One decode step at G-long's last position (B rows at ``kv`` keys),
    at one rank (``decode_step``) and SP at each of ``ns`` (fused): the
    median wall of three runs, then one under ``torch.profiler`` for the
    device time by family (B3's partial, its combine, the fused merge, the
    gathers, GEMMs, the rest) and the idle share; at n > 1 also the host's
    cost of each piece of a layer's SP attention (``sp_host_costs``)."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    token = torch.ones(B, dtype=torch.int32, device=device)
    recs = {}
    for n in ns:
        cache = llama.init_kv_cache(cfg, B, S, device=device)
        if n > 1:
            cache = llama.shard_kv_cache(cache, n)
        ctx = _mesh(n, device) if n > 1 else None

        def step():
            if ctx is None:
                lg = llama.decode_step(params, token, kv - 1, cfg, cache)[0]
            else:
                lg = llama.decode_step_sp(ctx, params, token, kv - 1, cfg,
                                          cache)[0]
            return lg.argmax(-1).cpu()

        step()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[1]
        fams, ops = device_time_by_family(
            step, True, (("decode_partial", ("decode_partial_kernel",)),
                         ("decode_combine", ("combine_kernel",)),
                         ("ll_ag_merge", ("ll_ag_merge_kernel",)),
                         ("merge", ("merge_kernel",))))
        busy = sum(fams.values())
        recs[n] = {"rows": B, "kv_len": kv, "max_seq": S, "wall_s": wall,
                   "device_busy_s": busy,
                   "device_idle_share": 1 - busy / wall if busy else None,
                   "device_s_by_family": fams, "device_ops": ops}
        if ctx is not None:
            recs[n]["host_us_per_call"] = sp_host_costs(cfg, device, cache,
                                                        n, B, kv)
            check_errors(ctx)
        log(f"profile sp decode step n={n}", json.dumps(recs[n]))
        del cache
    return recs


def tp_collectives_path(device, ranks=SP_RANKS, ag_shape=TP_AG,
                        rs_shape=TP_RS) -> None:
    """The collectives once each through their entry points at TP widths:
    the gathers (push and ring), the scatter and the barrier at each of
    ``ranks``."""
    import torch

    from triton_dist_tpu_torch.ops.allgather import all_gather
    from triton_dist_tpu_torch.ops.common import barrier_all_op
    from triton_dist_tpu_torch.ops.reduce_scatter import reduce_scatter
    from triton_dist_tpu_torch.shmem import check_errors

    for n in ranks:
        ctx = _mesh(n, device)
        x = torch.ones(ag_shape, dtype=torch.bfloat16, device=device)
        for method in ("push", "ring"):
            all_gather(ctx, x, method=method)
        reduce_scatter(ctx, torch.ones((n * rs_shape[0], rs_shape[1]),
                                       device=device))
        barrier_all_op(ctx)()
        check_errors(ctx)


def check_sp_and_collectives(params, cfg, device, card: str) -> dict:
    """Phase 14 on the 32-layer bf16 params: the shmem layer, the
    collectives and B5 against their plain versions; then the main path
    with the launch counts set to 0 just before it and read just after: SP
    decode at 2 and 4 ranks, and the collectives once each at TP widths;
    then one SP decode step under the profiler."""
    import importlib

    import torch

    from triton_dist_tpu_torch.ops import allgather, common, flash_decode

    rs = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")

    t0 = time.perf_counter()
    shmem = check_shmem(device)
    coll = check_collectives(device)
    merge = check_ll_ag_merge(device)
    torch.cuda.empty_cache()
    log(f"phase 14 checks took {time.perf_counter() - t0:.1f} s")
    kernels = (flash_decode.ll_ag_merge, allgather.all_gather,
               rs.reduce_scatter, common.barrier_all_op)
    for k in kernels:
        k.launches = 0
    decode = run_sp_decode(params, cfg, device, card)
    tp_collectives_path(device)
    launches = {k.__name__: k.launches for k in kernels}
    # every (spec, rank count): its runs of SP_STEPS and one control step
    # (fused); one fused rerun; the collectives once at each rank count
    meshes = [ms for spec in SP_DECODE.values()
              for ms in spec["ranks"].values()]
    fused = (sum("fused" in ms for ms in meshes) + 1) * SP_STEPS + len(meshes)
    gathers = sum(("push" in ms) + ("ring" in ms) for ms in meshes) * SP_STEPS
    expect = {"ll_ag_merge": fused * cfg.n_layers,
              "all_gather": gathers * cfg.n_layers + 2 * len(SP_RANKS),
              "reduce_scatter": len(SP_RANKS),
              "barrier_all_op": len(SP_RANKS)}
    log("phase 14 launches", json.dumps({"launches": launches,
                                         "expected": expect}))
    if launches != expect:
        raise AssertionError(f"phase 14 launches {launches} != {expect}")
    profile = profile_sp_step(params, cfg, device)
    seconds = time.perf_counter() - t0
    log(f"phase 14 took {seconds:.1f} s")
    return {"shmem": shmem, "collectives": coll, "ll_ag_merge": merge,
            "decode": decode, "profile": profile, "launches": launches,
            "seconds": seconds}


def sp_kernels(sp: dict, gather_cases: list, gather_launches: int) -> list:
    """The ``kernels`` line's entries of phase 14: B14, B9 (its one-rank
    cases of phase 10 and its cases across ranks; launches of both
    phases), B5's fused transport and B13. The main case of each is its
    largest mesh (4 ranks) at the path's shape."""
    coll, launches = sp["collectives"], sp["launches"]

    def main_rec(records, prefix):
        return next(r for r in records if r["case"].startswith(prefix))

    entries = []
    for name, source, replaces, cases, main, n_launches in (
            ("barrier_all_op", "shmem.cu", "triton_dist_tpu/ops/common.py:112",
             sp["shmem"]["barrier_all_op"],
             main_rec(sp["shmem"]["barrier_all_op"], "int32 n=4"),
             launches["barrier_all_op"]),
            ("all_gather", "allgather.cu",
             "triton_dist_tpu/ops/allgather.py:262",
             gather_cases + coll["all_gather"],
             main_rec(coll["all_gather"], "bfloat16 push n=4"),
             gather_launches + launches["all_gather"]),
            ("ll_ag_merge", "flash_decode.cu",
             "triton_dist_tpu/ops/flash_decode.py:431", sp["ll_ag_merge"],
             main_rec(sp["ll_ag_merge"], "float32 -> bfloat16 G-batch n=4"),
             launches["ll_ag_merge"]),
            ("reduce_scatter", "reduce_scatter.cu",
             "triton_dist_tpu/ops/reduce_scatter.py:85",
             coll["reduce_scatter"],
             main_rec(coll["reduce_scatter"], "float32 ring n=4"),
             launches["reduce_scatter"])):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"triton_dist_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            **{k: main.get(k) for k in ("ms", "kernel_device_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "case")},
            "ranks_note": "n > 1 ranks share the one card: times are the "
                          "kernels and their protocol on shared SMs and one "
                          "HBM, not NVLink transfers",
            "cases": cases})
    return entries


# ---------------------------------------------------------------------------
# phase 15: AG-GEMM and GEMM-RS across ranks, and the TP forward at 2 and 4
# ---------------------------------------------------------------------------

# the overlap ops at Llama-3-8B's tensor-parallel widths over 4096 token
# rows, bf16: (name, op, M, K, N) of the global [M, K] @ [K, N]
TP_OPS = (("qkv", "ag_gemm", 4096, 4096, 6144),
          ("gate_up", "ag_gemm", 4096, 4096, 28672),
          ("wo", "gemm_rs", 4096, 4096, 4096),
          ("down", "gemm_rs", 4096, 14336, 4096))
# the case of each op whose numbers head its kernels-line entry
TP_OPS_MAIN = {"ag_gemm": "gate_up", "gemm_rs": "down"}
# each op against its plain version (max |diff| / max |plain|): both sum in
# f32 and cast once, in other orders; a bf16 rounding may fall the other way
TP_OPS_TOL = 2e-2
# forward_tp_overlap on phase 11's bf16 params at each rank count
TP_RANKS_FWD = dict(B=2, S=2048, ranks=(1, 2, 4))
# the bf16 logits at n ranks within this share of n = 1's logit scale (max
# |diff| / max |ref|): GEMM-RS sums each K in n partials, so a bf16 rounding
# may fall the other way, and 32 layers carry it on. The control, the
# second rank's shard of wo zeroed in every layer at 4 ranks, must fall
# outside it. On an H100 sound runs read 4.0% (n = 2) and 4.4% (n = 4), the
# control 126%
TP_RANKS_GATE = 0.2
# the f32 check at full width, the depth cut to 2 layers (phase 4's params):
# the logits at n ranks within tol of n = 1's scale (GEMM-RS's partial sums
# are the only change of order)
TP_RANKS_F32 = dict(B=2, S=512, layers=2, tol=1e-5)
# mlp_tp_overlap in f32 at Llama-3-8B's widths on layer 0's weights: its
# output and four gradients at n ranks within tol of n = 1's scale
TP_MLP_RANKS = dict(T=1024, tol=1e-5)
TP_RANKS_NOTE = ("n > 1 ranks share the one card: times are the kernels and "
                 "their protocol on shared SMs and one HBM, not NVLink "
                 "transfers, and the overlap of puts with compute cannot "
                 "show")


def ag_composition(a, b, n: int, out_dtype=None):
    """AG-GEMM at n ranks from the one-rank kernel: B2 (``matmul``) on the
    gathered A, column block by column block."""
    import torch

    from triton_dist_tpu_torch.ops import gemm as tg

    nl = b.shape[1] // n
    return torch.cat([tg.matmul(a, b[:, r * nl:(r + 1) * nl].contiguous(),
                                out_dtype=out_dtype) for r in range(n)],
                     dim=1)


def rs_composition(a, b, n: int, out_dtype=None):
    """GEMM-RS at n ranks from the one-rank kernels: B2's f32 partial of
    each rank's K block, and each rank's rows the slot reduction of the n
    partials of its segment in slot order. Returns (out, partials)."""
    import torch

    from triton_dist_tpu_torch.ops import gemm as tg

    M, K = a.shape
    kl, m = K // n, M // n
    parts = [tg.matmul(a[:, s * kl:(s + 1) * kl].contiguous(),
                       b[s * kl:(s + 1) * kl].contiguous(),
                       out_dtype=torch.float32) for s in range(n)]
    out = torch.cat([tg.slot_reduce(torch.stack([p[r * m:(r + 1) * m]
                                                 for p in parts]),
                                    out_dtype or a.dtype)
                     for r in range(n)])
    return out, parts


def _pads_zero(ctx) -> bool:
    return all(not bool(p.any()) for p in ctx._pads.values())


def check_tp_ops(device, timed: bool = True, ranks=SP_RANKS, ops=TP_OPS,
                 fresh: int = FRESH_CALLS, seed: int = 17) -> list[dict]:
    """B15 (``ag_gemm``) and B16 (``gemm_rs``) across ranks through their
    persistent contexts (``AgGemmContext``, ``GemmRsContext``) at each of
    ``ranks`` and each of ``ops``, bf16: bitwise their composition from the
    one-rank kernels (``ag_composition``, ``rs_composition``), on a rerun
    and on ``fresh`` calls with fresh data; within ``TP_OPS_TOL`` of their
    plain versions; every workspace slot as the protocol leaves it (AG: rank
    r's slot s holds shard s for s != r; RS: rank r's slot s holds rank s's
    partial of segment r) and every signal pad zero after the calls. Timed
    beside the bound over all ranks' work, the plain version, one-rank B2
    on the whole product and ``torch.matmul``. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import gemm as tg
    from triton_dist_tpu_torch.ops.allgather_gemm import (
        ag_gemm_plain, create_ag_gemm_context)
    from triton_dist_tpu_torch.ops.gemm_reduce_scatter import (
        create_gemm_rs_context, gemm_rs_plain)
    from triton_dist_tpu_torch.shmem import check_errors
    from triton_dist_tpu_torch.utils.perf import perf_func

    gen = torch.Generator(device=device).manual_seed(seed)

    def operands(M, K, N):
        a = torch.randn(M, K, generator=gen, device=device).bfloat16()
        b = (torch.randn(K, N, generator=gen, device=device) * 0.02) \
            .bfloat16()
        return a, b

    records = []
    for n in ranks:
        ctx = _mesh(n, device)
        for name, op, M, K, N in ops:
            m = M // n
            a, b = operands(M, K, N)
            if op == "ag_gemm":
                layer = create_ag_gemm_context(ctx, m, K, torch.bfloat16)
                compose = lambda a, b, n=n: ag_composition(a, b, n)  # noqa
                plain = lambda a=a, b=b, n=n: ag_gemm_plain(a, b, n)  # noqa
            else:
                layer = create_gemm_rs_context(ctx, m, N, torch.bfloat16)
                compose = lambda a, b, n=n: rs_composition(a, b, n)[0]  # noqa
                plain = lambda a=a, b=b, n=n: gemm_rs_plain(a, b, n)  # noqa
            got, again = layer(a, b), layer(a, b)
            check_errors(ctx)
            pads_zero = _pads_zero(ctx)
            if op == "ag_gemm":
                want = ag_composition(a, b, n)
                shards = a.view(n, m, K)
                slots = all(torch.equal(layer.ws[r, s], shards[s])
                            for r in range(n) for s in range(n) if s != r)
            else:
                want, parts = rs_composition(a, b, n)
                slots = all(torch.equal(layer.ws[r, s],
                                        parts[s][r * m:(r + 1) * m])
                            for r in range(n) for s in range(n))
                del parts
            ref = plain()
            err = (got.float() - ref.float()).abs().max().item()
            fresh_ok = []
            for _ in range(fresh):
                ai, bi = operands(M, K, N)
                fresh_ok.append(bool(torch.equal(layer(ai, bi),
                                                 compose(ai, bi))))
                del ai, bi
            check_errors(ctx)
            rec = {"kernel": op, "n": n,
                   "case": f"{name} bfloat16 n={n} {M}x{K}x{N}",
                   "bitwise_composition": bool(torch.equal(got, want)),
                   "bitwise_repeat": bool(torch.equal(got, again)),
                   "fresh_calls_bitwise": all(fresh_ok),
                   "slots_as_the_protocol_leaves_them": slots,
                   "pads_zero_after": pads_zero and _pads_zero(ctx),
                   "max_abs_err": err,
                   "rel_err": err / max(ref.float().abs().max().item(),
                                        1e-30),
                   "tol": TP_OPS_TOL}
            del want, ref
            if timed:
                rec.update(_timings(
                    lambda: layer(a, b), plain, lambda: torch.matmul(a, b),
                    (f"{op}_kernel",), gemm_bound(M, K, N, 2, 2,
                                                  "bfloat16")))
                rec["library_call"] = "torch.matmul of the whole product"
                rec["b2_ms"] = perf_func(lambda: tg.matmul(a, b))[1]
                rec["b2_kernel_device_ms"] = kernel_device_ms(
                    lambda: tg.matmul(a, b), "tdt_gemm")
                rec["share_of_bound"] = rec["bound_ms"] / (
                    rec["kernel_device_ms"] or rec["ms"])
                rec["note"] = TP_RANKS_NOTE
            log(f"kernel {op}", json.dumps(rec))
            if not (rec["bitwise_composition"] and rec["bitwise_repeat"]
                    and rec["fresh_calls_bitwise"]
                    and rec["slots_as_the_protocol_leaves_them"]
                    and rec["pads_zero_after"]
                    and rec["rel_err"] <= rec["tol"]):
                raise AssertionError(f"{op} across ranks failed: {rec}")
            records.append(rec)
            del a, b, got, again, layer
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return records


def _tp_ranks_launches(L: int, n: int) -> dict:
    """The launches of one forward_tp_overlap at n ranks: B15 and B16 two a
    layer each at any n; at one rank they run B2 (four a layer) and the
    slot reduction (two), at n > 1 the overlap kernel alone."""
    one = n == 1
    return {"matmul": 4 * L if one else 0, "ag_gemm": 2 * L,
            "gemm_rs": 2 * L, "slot_reduce": 2 * L if one else 0,
            "all_gather": 0}


def _logit_rel(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def check_tp_ranks_f32(params, cfg, device, B: int = TP_RANKS_F32["B"],
                       S: int = TP_RANKS_F32["S"],
                       layers: int = TP_RANKS_F32["layers"],
                       tol: float = TP_RANKS_F32["tol"],
                       ranks=SP_RANKS) -> dict:
    """``forward_tp_overlap`` in f32 at full width on the first ``layers``
    layers of ``params``: the logits at each of ``ranks`` within ``tol`` of
    one rank's scale, with the launches of ``_tp_ranks_launches``. Raises
    on failure."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=device).manual_seed(18)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    on_card = device.type == "cuda"
    rec = {"dtype": str(cfg.dtype), "layers": layers, "B": B, "S": S,
           "tol": tol, "ranks": {}}
    ok = True
    with torch.inference_mode():
        ref = llama.forward_tp_overlap(_mesh(1, device), params, tokens, cfg)
        for n in ranks:
            ctx = _mesh(n, device)
            kernels = _zero_launches()
            got = llama.forward_tp_overlap(ctx, params, tokens, cfg)
            check_errors(ctx)
            launches = {k: v.launches for k, v in kernels.items()}
            r = {"max_rel_err": _logit_rel(got, ref),
                 "finite": bool(torch.isfinite(got).all()),
                 "launches": launches}
            rec["ranks"][n] = r
            ok &= (r["finite"] and r["max_rel_err"] <= tol
                   and (not on_card or launches
                        == _tp_ranks_launches(layers, n)))
            del got
    log("model forward_tp_overlap f32 across ranks", json.dumps(rec))
    if not ok:
        raise AssertionError(f"forward_tp_overlap across ranks disagrees "
                             f"with one rank in f32: {rec}")
    return rec


def run_tp_ranks(params, cfg, device, card: str,
                 B: int = TP_RANKS_FWD["B"], S: int = TP_RANKS_FWD["S"],
                 ranks=TP_RANKS_FWD["ranks"],
                 gate: float = TP_RANKS_GATE) -> dict:
    """The main path of phase 15: ``forward_tp_overlap`` at full width and
    depth on B x S seeded tokens at each of ``ranks``, under
    ``torch.inference_mode``, twice (the launches set to 0 just before each
    run and read just after; the rerun bitwise), timed between device
    synchronisations with its peak memory, then once under
    ``torch.profiler`` (device time by family, idle share against the
    timed run). The logits at n > 1 must lie within ``gate`` of one rank's
    logit scale, and a control (the second rank's shard of ``wo`` zeroed in
    every layer, at the largest rank count) outside it. Raises on
    failure."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    gen = torch.Generator(device=device).manual_seed(19)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    on_card = device.type == "cuda"
    L = cfg.n_layers

    def clock() -> float:
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    rec = {"card": card, "dtype": str(cfg.dtype), "layers": L, "B": B,
           "S": S, "tokens": B * S, "gate": gate, "ranks": {}}
    ok, ref = True, None
    with torch.inference_mode():
        for n in ranks:
            ctx = _mesh(n, device)
            runs, first = [], None
            for _ in range(2):
                if on_card:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                kernels = _zero_launches()
                t0 = clock()
                logits = llama.forward_tp_overlap(ctx, params, tokens, cfg)
                wall = clock() - t0
                launches = {k: v.launches for k, v in kernels.items()}
                check_errors(ctx)
                runs.append({"wall_s": wall,
                             "peak_mem_gib": (torch.cuda.max_memory_allocated()
                                              / 2 ** 30 if on_card else None),
                             "launches": launches})
                if first is None:
                    first = logits
                else:
                    rerun = bool(torch.equal(logits, first))
                del logits
            fams, dev_ops = device_time_by_family(
                lambda: llama.forward_tp_overlap(ctx, params, tokens, cfg),
                on_card, (("B15", ("ag_gemm_kernel",)),
                          ("B16", ("gemm_rs_kernel",)),
                          ("B2", ("tdt_gemm",)),
                          ("slot_reduce", ("tdt_slot_reduce",)),
                          ("softmax", ("softmax",))))
            check_errors(ctx)
            busy = sum(fams.values())
            wall = runs[-1]["wall_s"]
            r = {"runs": runs, "reruns_bit_identical": rerun,
                 "finite": bool(torch.isfinite(first).all()),
                 "shape": list(first.shape),
                 "launches_expected": _tp_ranks_launches(L, n),
                 "device_busy_s": busy,
                 "device_idle_share": 1 - busy / wall if busy else None,
                 "device_s_by_family": fams, "device_ops": dev_ops,
                 "pads_zero_after": _pads_zero(ctx)}
            if ref is None:
                ref = first
            else:
                r["logit_rel_diff_vs_n1"] = _logit_rel(first, ref)
                r["argmax_agree_with_n1"] = (first.argmax(-1) == ref.argmax(
                    -1)).float().mean().item()
            del first
            ok &= (r["finite"] and rerun and r["pads_zero_after"]
                   and r["shape"] == [B, S, cfg.vocab_size]
                   and r.get("logit_rel_diff_vs_n1", 0.0) <= gate
                   and (not on_card or all(
                       x["launches"] == r["launches_expected"]
                       for x in runs)))
            rec["ranks"][n] = r
            log(f"forward_tp_overlap n={n}", json.dumps(r))
        # the control: the second rank's shard of wo (its rows of the
        # contraction) zeroed in every layer, at the largest rank count
        n = max(ranks)
        kl = cfg.n_heads * cfg.head_dim // n
        wo = params["blocks"]["wo"].clone()
        wo[:, kl:2 * kl] = 0
        ctl_params = dict(params, blocks=dict(params["blocks"], wo=wo))
        ctx = _mesh(n, device)
        ctl = llama.forward_tp_overlap(ctx, ctl_params, tokens, cfg)
        check_errors(ctx)
        rec["control"] = {"n": n, "zeroed_rank": 1,
                          "logit_rel_diff_vs_n1": _logit_rel(ctl, ref)}
        del ctl, ctl_params, wo, ref
    ok &= rec["control"]["logit_rel_diff_vs_n1"] > gate
    log("forward_tp_overlap across ranks", json.dumps(
        {k: v for k, v in rec.items() if k != "ranks"}))
    if not ok:
        raise AssertionError(f"forward_tp_overlap across ranks failed its "
                             f"checks: {rec}")
    return rec


def check_tp_mlp_ranks(device, w_gate, w_up, w_down,
                       T: int = TP_MLP_RANKS["T"],
                       tol: float = TP_MLP_RANKS["tol"], ranks=SP_RANKS,
                       seed: int = 20) -> dict:
    """``mlp_tp_overlap`` in f32 (the weights cast to f32) at one rank and
    at each of ``ranks``: its output and the gradients of x and the three
    weights at n ranks each within ``tol`` of one rank's scale, and the
    launches of one forward plus backward (B15 and B16 two each, B9 one).
    Raises on failure."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    gen = torch.Generator(device=device).manual_seed(seed)
    D = w_gate.shape[0]
    x0 = torch.randn(T, D, generator=gen, device=device)
    g = torch.randn(T, D, generator=gen, device=device)
    on_card = device.type == "cuda"

    def run(n):
        ctx = _mesh(n, device)
        leaves = [t.detach().float().clone().requires_grad_()
                  for t in (x0, w_gate, w_up, w_down)]
        kernels = _zero_launches()
        out = llama.mlp_tp_overlap(ctx, *leaves)
        (out * g).sum().backward()
        check_errors(ctx)
        launches = {k: v.launches for k, v in kernels.items()}
        return [out.detach()] + [t.grad for t in leaves], launches

    names = ("out", "dx", "dw_gate", "dw_up", "dw_down")
    ref, _ = run(1)
    rec = {"T": T, "d_model": D, "d_ff": w_gate.shape[1], "tol": tol,
           "ranks": {}}
    ok = True
    expect = {"matmul": 0, "ag_gemm": 2, "gemm_rs": 2, "slot_reduce": 0,
              "all_gather": 1}
    for n in ranks:
        got, launches = run(n)
        rels = {k: _logit_rel(a, b) for k, a, b in zip(names, got, ref)}
        rec["ranks"][n] = {"rel_err": rels, "launches": launches}
        ok &= (max(rels.values()) <= tol
               and (not on_card or launches == expect))
        del got
    rec["launches_expected"] = expect
    log("mlp_tp_overlap f32 across ranks", json.dumps(rec))
    if not ok:
        raise AssertionError(f"mlp_tp_overlap across ranks failed: {rec}")
    return rec


def check_tp_ranks(params, cfg, device, card: str) -> dict:
    """Phase 15 on the 32-layer bf16 params: B15 and B16 across ranks at TP
    widths, the forward at 1, 2 and 4 ranks (the main path, launches
    counted) with its gate and control, and the MLP's f32 gradients across
    ranks (layer 0's weights)."""
    import torch

    t0 = time.perf_counter()
    ops = check_tp_ops(device)
    torch.cuda.empty_cache()
    forward = run_tp_ranks(params, cfg, device, card)
    torch.cuda.empty_cache()
    b = params["blocks"]
    mlp = check_tp_mlp_ranks(device, b["w_gate"][0], b["w_up"][0],
                             b["w_down"][0])
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 15 took {seconds:.1f} s")
    return {"ops": ops, "forward": forward, "mlp": mlp, "seconds": seconds}


def tp_ranks_kernels(tp: dict) -> list:
    """The ``kernels`` line's entries of phase 15: B15 and B16 across ranks
    at 2 and 4 ranks, each headed by its largest TP shape (``TP_OPS_MAIN``)
    and launched as the forward at that rank count launched it."""
    entries = []
    for op, replaces in (("ag_gemm", "triton_dist_tpu/ops/allgather_gemm.py"
                                     ":243"),
                         ("gemm_rs", "triton_dist_tpu/ops/"
                                     "gemm_reduce_scatter.py:332")):
        for n in SP_RANKS:
            cases = [r for r in tp["ops"] if r["kernel"] == op and r["n"] == n]
            main = next(r for r in cases
                        if r["case"].startswith(TP_OPS_MAIN[op] + " "))
            entries.append({
                "name": f"{op} (n={n})", "route": "cuda",
                "source": "triton_dist_tpu_torch/csrc/tp_overlap.cu",
                "replaces": replaces,
                "launches": tp["forward"]["ranks"][n]["runs"][0]["launches"]
                [op],
                "max_abs_err": max(r["max_abs_err"] for r in cases),
                **{k: main.get(k) for k in ("ms", "kernel_device_ms",
                                            "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "b2_ms", "case")},
                "ranks_note": TP_RANKS_NOTE, "cases": cases})
    return entries


# ---------------------------------------------------------------------------
# phase 16: the sharded MoE serving engine across ranks (B21, B22)
# ---------------------------------------------------------------------------

# ranks of the EP wire's checks; the engine's shapes at Mixtral-8x7B's
# widths: a decode step's 8 token rows (top-2) and a 256-row chunk, cut
# over the ranks
A2A_RANKS = (2, 4, 8)
A2A_ROWS = {"decode": 8, "chunk": 256}
A2A_FRESH = 5
A2A_SEGMENTS = 2
# the meshes served (tp, sp, ep, overlap) and the requests of phase 9's
# trace each serves: a prefix, to hold the phase's time, long enough to
# preempt once in the 128-page pool; the golden is the 1x1x1 engine on the
# same prefix
EP_MESHES = ((1, 1, 2, "off"), (1, 1, 4, "off"), (1, 1, 4, "ep"),
             (2, 1, 2, "off"), (1, 2, 2, "off"), (2, 2, 2, "off"),
             (1, 2, 2, "ep+sp"), (2, 2, 2, "ep+sp"))
EP_PREFIX = 10


def _bits(t):
    """A tensor's raw bits, for comparisons where -0.0 and +0.0 (or two
    NaNs) must count as they are."""
    import torch

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def _same(a, b) -> bool:
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and \
        bool(torch.equal(_bits(a).cpu(), _bits(b).cpu()))


def a2a_inputs(n: int, cap: int, H: int, seed: int, device):
    """A wire's bf16 payload [n * n, cap, H] whose rows hit the quantiser's
    edges (a zero row, a row of one repeated value at its amax, rows of
    tiny values whose quotients fall to fp8's subnormals, one huge row),
    the rest scaled normals; and the int32 id wire."""
    import torch

    from triton_dist_tpu_torch.ops.all_to_all import _id_cols

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n * n, cap, H, generator=gen, device=device)
    x = x * torch.rand(n * n, cap, 1, generator=gen, device=device) * 4
    x[0, 0] = 0
    x[0, 1 % cap] = 3.0
    x[-1, 0] = x[-1, 0] * 1e-6
    x[-1, cap - 1] = x[-1, cap - 1] * 1e4
    cols = _id_cols(cap)
    ids = torch.randint(-1, 4, (n * n, cols // 128, 128), generator=gen,
                        device=device, dtype=torch.int32)
    return x.to(torch.bfloat16), ids


def a2a_bound(ins, outs) -> tuple[float, str]:
    """Every rank's input read once and output written once through the
    one HBM (the ranks share the card)."""
    nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def check_a2a_kernels(device, timed: bool = True, ranks=A2A_RANKS,
                      rows=A2A_ROWS, H: int = 4096, topk: int = 2,
                      fresh: int = A2A_FRESH) -> list[dict]:
    """Phase 16a: B21 (``all_to_all_push``) and B22 (``all_to_all_push_seg``)
    at ``ranks`` ranks on the one card, at the engine's decode and chunk
    rows, for the plain wire and the fp8 and int8 wires: the quantise and
    dequantise in the kernel (both, each alone), the pre-quantised wire,
    and B22 at 2 segments. Every rank's outputs bitwise the plain version's
    (a rerun and ``fresh`` calls with fresh data too), every pad zero after
    a call. Timed: one call between CUDA events, the kernel alone, the
    plain version, ``transpose(0, 1).contiguous()`` of the plain wire, the
    bound. Then a wire whose rank 1 never signals must raise within the
    budget, for B21 and for B22's counted segments, and the next call must
    be right again. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import all_to_all as ea
    from triton_dist_tpu_torch.shmem import check_errors, initialize_distributed
    from triton_dist_tpu_torch.shmem.device import ShmemError

    records = []
    bf16 = torch.bfloat16
    for n in ranks:
        ctx = initialize_distributed(("x",), (n,), device=device)
        for shape, R in rows.items():
            T = R // n
            for wire in (None, torch.float8_e4m3fn, torch.int8):
                itemsize = (wire or bf16).itemsize
                cap = ea._cap_round(T * topk, itemsize)
                wname = "bf16" if wire is None else str(wire).split(".")[-1]

                def make(seed, wire=wire, cap=cap):
                    x, ids = a2a_inputs(n, cap, H, seed, device)
                    if wire is None:
                        return x, ids, None, None
                    q, sc = ea._quant(x.reshape(-1, H), wire)
                    return (x, ids, q.view(x.shape),
                            ea._scale_wire(sc.view(n * n, cap), cap))

                def cases(x, ids, q, sc, wire=wire):
                    """(name, kernel call, plain call, kernel name)"""
                    rep = dict(axis="x", replicas=True)
                    if wire is None:
                        return [
                            ("wire", lambda: ea.all_to_all_push(
                                ctx, x, ids, **rep), lambda: ea.
                             all_to_all_push_plain(ctx, x, ids, **rep),
                             "a2a_push"),
                            (f"seg{A2A_SEGMENTS}", lambda: ea.
                             all_to_all_push_seg(ctx, x, ids,
                                                 segments=A2A_SEGMENTS,
                                                 **rep), lambda: ea.
                             all_to_all_push_plain(ctx, x, ids, **rep),
                             "a2a_seg")]
                    return [
                        ("quant+dequant", lambda: ea.all_to_all_push(
                            ctx, x, ids, quant_from=wire, dequant_to=bf16,
                            **rep), lambda: ea.all_to_all_push_plain(
                            ctx, x, ids, quant_from=wire, dequant_to=bf16,
                            **rep), "a2a_push"),
                        ("quant", lambda: ea.all_to_all_push(
                            ctx, x, ids, quant_from=wire, **rep),
                         lambda: ea.all_to_all_push_plain(
                            ctx, x, ids, quant_from=wire, **rep),
                         "a2a_push"),
                        ("dequant", lambda: ea.all_to_all_push(
                            ctx, q, ids, sc, dequant_to=bf16, **rep),
                         lambda: ea.all_to_all_push_plain(
                            ctx, q, ids, sc, dequant_to=bf16, **rep),
                         "a2a_push"),
                        ("wire", lambda: ea.all_to_all_push(
                            ctx, q, ids, sc, **rep),
                         lambda: ea.all_to_all_push_plain(
                            ctx, q, ids, sc, **rep), "a2a_push"),
                        (f"seg{A2A_SEGMENTS}", lambda: ea.
                         all_to_all_push_seg(ctx, q, ids, sc,
                                             segments=A2A_SEGMENTS, **rep),
                         lambda: ea.all_to_all_push_plain(ctx, q, ids, sc,
                                                          **rep),
                         "a2a_seg")]

                base = make(0)
                listed = cases(*base)
                for ci, (name, call, plain, kname) in enumerate(listed):
                    got = call()
                    again = call()
                    check_errors(ctx)
                    want = plain()
                    ok_fresh = True
                    for f in range(fresh):
                        fr = make(100 + f)
                        c = cases(*fr)[ci]
                        ok_fresh &= _same(c[1](), c[2]())
                    check_errors(ctx)
                    pads_zero = all(int(p.abs().sum()) == 0
                                    for p in ctx._pads.values())
                    rec = {"ranks": n, "shape": shape, "rows_a_rank": T,
                           "cap": cap, "H": H, "wire": wname, "case": name,
                           "bitwise": _same(got, want),
                           "bitwise_repeat": _same(got, again),
                           "bitwise_fresh": ok_fresh,
                           "pads_zero": pads_zero, "max_abs_err": 0.0}
                    if name.startswith("seg"):
                        rec["equals_b21"] = _same(
                            got, listed[0 if wire is None else 3][1]())
                    ins = [base[0], base[1]] if (
                        wire is None or name in ("quant", "quant+dequant")) \
                        else [base[2], base[1], base[3]]
                    rec["wire_bytes_a_rank"] = sum(
                        t.numel() * t.element_size() for t in got) // n
                    if timed:
                        lib = (lambda: base[0].view(n, n, cap, H)
                               .transpose(0, 1).contiguous()) \
                            if (wire is None and name in ("wire", "seg2")) \
                            else None
                        rec.update(_timings(call, plain, lib, (kname,),
                                            a2a_bound(ins, list(got))))
                        rec["library"] = ("transpose(0, 1).contiguous()"
                                          if lib else
                                          "none: no single call quantises "
                                          "and exchanges per slot")
                    log("a2a kernel vs plain", json.dumps(rec))
                    if not (rec["bitwise"] and rec["bitwise_repeat"]
                            and ok_fresh and pads_zero
                            and rec.get("equals_b21", True)):
                        raise AssertionError(f"the EP wire disagrees with "
                                             f"its plain version: {rec}")
                    records.append(rec)
    if device.type != "cuda":         # the plain versions have no spin
        return records
    # the hang checks: rank 1 puts but never signals
    ctx = initialize_distributed(("x",), (2,), device=device)
    x, ids = a2a_inputs(2, 16, H, 7, device)
    for name, wire in (
            ("all_to_all_push", ea.all_to_all_push),
            ("all_to_all_push_seg", functools.partial(
                ea.all_to_all_push_seg, segments=A2A_SEGMENTS))):
        t0 = time.perf_counter()
        raised = False
        try:
            wire(ctx, x, ids, axis="x", silent_rank=1)
            check_errors(ctx)
        except ShmemError as e:
            raised = True
            log(f"{name} starved signal raised: {e}")
        waited = time.perf_counter() - t0
        ok_after = _same(wire(ctx, x, ids, axis="x"),
                         ea.all_to_all_push_plain(ctx, x, ids, axis="x"))
        check_errors(ctx)
        log("a2a hang check", json.dumps({
            "kernel": name, "raised": raised, "seconds": waited,
            "next_call_bitwise": ok_after}))
        if not (raised and waited < 2.5 and ok_after):
            raise AssertionError(f"a starved {name} signal did not raise "
                                 f"within its budget")
    return records


def check_ep_block(params, cfg, device, rows=A2A_ROWS, ranks: int = 4
                   ) -> list[dict]:
    """Phase 16b: ``moe_mlp_ep_overlap`` of layer 0 at ep = ``ranks`` on the
    one card, for the plain and the fp8 wire, with M = 1 and M = 2
    microbatches (B22 for M = 2), bitwise the block at ep = 1 on the same
    rows with the same wire."""
    import torch

    from triton_dist_tpu_torch.layers import EPAll2AllLayer
    from triton_dist_tpu_torch.models.moe import moe_mlp_ep_overlap
    from triton_dist_tpu_torch.shmem import check_errors, initialize_distributed

    p = {k: v[0] for k, v in params["blocks"].items()}
    ws = (p["w_router"], p["we_gate"], p["we_up"], p["we_down"])
    D = cfg.base.d_model
    records = []
    for shape, R in rows.items():
        bm = 16 if shape == "decode" else 64
        gen = torch.Generator(device=device).manual_seed(R + 1)
        x = torch.randn(R, D, generator=gen, device=device).to(cfg.base.dtype)
        for wire in (None, torch.float8_e4m3fn):
            outs = {}
            for n in (1, ranks):
                ctx = initialize_distributed(("ep",), (n,), device=device)
                lay = EPAll2AllLayer.create(ctx, R // n, D, cfg.topk,
                                            cfg.num_experts, axis="ep",
                                            dtype=cfg.base.dtype,
                                            wire_dtype=wire)
                for M in (1, 2):
                    la = lay if M == 1 else dataclasses.replace(
                        lay, a2a=dataclasses.replace(lay.a2a, seg_push=2))
                    outs[n, M] = moe_mlp_ep_overlap(ctx, la, x, *ws,
                                                    block_m=bm,
                                                    microbatches=M)
                check_errors(ctx)
            rec = {"shape": shape, "rows": R, "ranks": ranks,
                   "wire": None if wire is None else "float8_e4m3fn",
                   "finite": bool(torch.isfinite(outs[1, 1].float()).all()),
                   "ranks_equal_one_rank": {
                       f"M={M}": _same(outs[ranks, M], outs[1, 1])
                       for M in (1, 2)},
                   "one_rank_M2_equal": _same(outs[1, 2], outs[1, 1])}
            log("ep block across ranks", json.dumps(rec))
            if not (rec["finite"] and all(rec["ranks_equal_one_rank"].values())
                    and rec["one_rank_M2_equal"]):
                raise AssertionError(f"the EP block across ranks is not "
                                     f"bitwise the one-rank block: {rec}")
            records.append(rec)
    return records


def check_column_products(params, cfg, device, ranks=(2, 4),
                          rows=(8, 256)) -> list[dict]:
    """The sharded engine's projections at Mixtral's widths (layer 0's wq
    and wk, the LM head): B2 (``column_product``) on each rank's column
    block must be bitwise its columns of the whole product, at every rank
    count and row count; cuBLAS (``torch.matmul``) is checked the same way
    and recorded only. Timed: B2 and cuBLAS on the whole product."""
    import torch

    from triton_dist_tpu_torch.ops.allgather_gemm import column_product
    from triton_dist_tpu_torch.utils.perf import perf_func

    blocks = params["blocks"]
    ws = {"wq": blocks["wq"][0], "wk": blocks["wk"][0],
          "lm_head": params["lm_head"]}
    records = []
    for name, w in ws.items():
        N = w.shape[1]
        for R in rows:
            gen = torch.Generator(device=device).manual_seed(R)
            h = torch.randn(R, w.shape[0], generator=gen,
                            device=device).to(w.dtype)
            b2, cu = column_product(h, w), h @ w
            rec = {"weight": name, "rows": R, "K": w.shape[0], "N": N,
                   "b2_split_bitwise": {}, "cublas_split_bitwise": {}}
            for n in ranks:
                nl = N // n
                cols = [slice(r * nl, (r + 1) * nl) for r in range(n)]
                rec["b2_split_bitwise"][n] = bool(torch.equal(torch.cat(
                    [column_product(h, w[:, c]) for c in cols], 1), b2))
                rec["cublas_split_bitwise"][n] = bool(torch.equal(torch.cat(
                    [h @ w[:, c] for c in cols], 1), cu))
            if device.type == "cuda":
                rec["b2_ms"] = perf_func(lambda: column_product(h, w))[1]
                rec["cublas_ms"] = perf_func(lambda: h @ w)[1]
            log("column products", json.dumps(rec))
            if not all(rec["b2_split_bitwise"].values()):
                raise AssertionError(f"B2's column blocks are not its whole "
                                     f"product: {rec}")
            records.append(rec)
    return records


def _first_difference(golden: dict, got: dict) -> dict | None:
    for rid in sorted(golden):
        a, b = golden[rid], got.get(rid)
        if a != b:
            step = next((i for i, (u, v) in enumerate(zip(a, b or []))
                         if u != v), min(len(a), len(b or [])))
            return {"request": rid, "token": step}
    return None


def check_ep_engines(params, cfg, device, card: str,
                     meshes=EP_MESHES, prefix: int = EP_PREFIX) -> dict:
    """Phase 16c: the first ``prefix`` requests of phase 9's trace through
    ``ShardedServingEngine`` on each of ``meshes`` with the fp8 wire, and at
    1x1x4 with the plain wire; each mesh's streams must be bitwise those of
    the 1x1x1 engine with the same wire on the same requests (the golden),
    every request finishing with its full budget, with a preemption. Launch
    counts of the path's kernels are set to 0 before each run, must equal
    ``engine_launches`` exactly (B21 and no B22 with overlap off, B22 and
    no B21 with overlap="ep") and are summed. Then one decode dispatch of
    the 1x1x4 engine under the profiler."""
    import torch

    from triton_dist_tpu_torch.serving import (ShardedServingEngine,
                                               serving_mesh)
    from triton_dist_tpu_torch.shmem import check_errors

    trace = make_trace(cfg.base, N_REQUESTS, 0)[:prefix]
    kernels = engine_kernels()
    fp8 = torch.float8_e4m3fn
    runs = [((1, 1, 1, "off"), fp8)] + [(m, fp8) for m in meshes] \
        + [((1, 1, 1, "off"), None), ((1, 1, 4, "off"), None)]
    goldens, records = {}, []
    totals = {k.__name__: 0 for k in kernels}
    for (tp, sp, ep, overlap), wire in runs:
        def make():
            return ShardedServingEngine(params, cfg, serving_mesh(tp, sp, ep),
                                        device=device, wire_dtype=wire,
                                        overlap=overlap, **ENGINE)
        res, eng, wall, launches = serve(make, device, trace, kernels)
        check_errors(eng.ctx)
        c, h = eng.metrics.counters, eng.metrics.hist
        key = None if wire is None else "float8_e4m3fn"
        golden = goldens.setdefault(key, res)
        rec = {"mesh": eng.mesh_desc, "overlap": overlap, "wire": key,
               "requests": len(trace), "finished": c["requests_finished"],
               "tokens_generated": c["tokens_generated"],
               "preemptions": c["preemptions"], "dispatches": c["dispatches"],
               "prefill_chunks": c["prefill_chunks"],
               "digest_checks": c["digest_checks"], "wall_s": wall,
               "tok_per_s": c["tokens_generated"] / wall,
               "ttft_p50_s": h["ttft_s"].percentile(50),
               "exposed_comm_us_modelled": eng._exposed_comm_us,
               "launches": launches,
               "launches_expected": engine_launches(eng),
               "bitwise_golden": res == golden,
               "first_difference": _first_difference(golden, res)}
        for k, v in launches.items():
            totals[k] += v
        log("ep engine", json.dumps(rec))
        ok = (rec["finished"] == len(trace)
              and all(len(res[i]) == m for i, (_, _, m) in enumerate(trace))
              and rec["preemptions"] >= 1 and rec["bitwise_golden"]
              and launches == rec["launches_expected"])
        del eng
        torch.cuda.empty_cache()
        records.append(rec)
        if not ok:
            raise AssertionError(f"the sharded engine at {rec['mesh']} failed "
                                 f"its checks: {rec}")
    # the cost of B2 in the projections: the 1x1x1 golden engine again
    # with cuBLAS products (timing only; its streams need not be bitwise)
    def make_cublas():
        eng = ShardedServingEngine(params, cfg, serving_mesh(1, 1, 1),
                                   device=device, wire_dtype=fp8, **ENGINE)
        eng.linear = lambda h, w, name: h @ w
        return eng
    _, eng, wall, _ = serve(make_cublas, device, trace, ())
    cublas = {"mesh": "1x1x1", "projections": "cuBLAS (timing only)",
              "wall_s": wall,
              "tok_per_s": eng.metrics.counters["tokens_generated"] / wall,
              "ttft_p50_s": eng.metrics.hist["ttft_s"].percentile(50)}
    log("ep engine", json.dumps(cublas))
    del eng
    eng = ShardedServingEngine(params, cfg, serving_mesh(1, 1, 4),
                               device=device, wire_dtype=fp8, **ENGINE)
    profile = profile_dispatch(params, cfg.base, device, ffn=eng.ffn,
                               attn_io=eng.attn_io, linear=eng.linear,
                               distinct_tokens=True, label="ep 1x1x4 ")
    del eng
    log("ep engines launches", json.dumps(totals))
    return {"runs": records, "launches": totals, "profile": profile,
            "cublas_projections": cublas}


def wire_fit(records: list[dict]) -> dict:
    """Phase 16d: the wire fit ``t = t0 + bytes / rate`` of the plain bf16
    wire and the fp8 wire (quantise and dequantise in the kernel), least
    squares over 16a's kernel-alone times (``torch.profiler``) at every rank
    count and shape, bytes the wire bytes a rank moves one way: the device
    time of the exchange, which the engine's modelled comm split prices."""
    fits = {}
    for label, wire, case in (("bf16", "bf16", "wire"),
                              ("fp8", "float8_e4m3fn", "quant+dequant")):
        pts = [(r["wire_bytes_a_rank"], r["kernel_device_ms"] * 1e3)
               for r in records if r["wire"] == wire and r["case"] == case
               and r.get("kernel_device_ms")]
        m = len(pts)
        sx = sum(b for b, _ in pts)
        sy = sum(t for _, t in pts)
        sxx = sum(b * b for b, _ in pts)
        sxy = sum(b * t for b, t in pts)
        slope = (m * sxy - sx * sy) / (m * sxx - sx * sx)
        t0 = (sy - slope * sx) / m
        fits[label] = {"t0_us": t0, "gb_per_s": (1 / slope / 1e3
                                                 if slope > 0 else None),
                       "points": pts}
    log("a2a wire fit", json.dumps(fits))
    return fits


def check_ep_ranks(params, cfg, device, card: str) -> dict:
    """Phase 16 on phase 9's weights: the EP wire's kernels (16a), the EP
    block across ranks (16b), the sharded engine on its meshes (16c) and
    the wire fit (16d)."""
    import torch

    t0 = time.perf_counter()
    a2a = check_a2a_kernels(device)
    block = check_ep_block(params, cfg, device)
    columns = check_column_products(params, cfg, device)
    torch.cuda.empty_cache()
    engines = check_ep_engines(params, cfg, device, card)
    fit = wire_fit(a2a)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    ag_engines = check_ag_gemm_engines(params, cfg, device, card)
    return {"a2a": a2a, "block": block, "columns": columns,
            "engines": engines, "fit": fit, "ag_gemm_engines": ag_engines}


def ep_kernels(ep: dict) -> list:
    """The kernels line's entries of B21 and B22: the main case is the
    decode wire at 4 ranks (bf16; B22 at 2 segments); every case listed."""
    out = []
    for name, kname, replaces, case in (
            ("all_to_all_push", "a2a_push",
             "triton_dist_tpu/ops/all_to_all.py:347", "wire"),
            ("all_to_all_push_seg", "a2a_seg",
             "triton_dist_tpu/ops/all_to_all.py:549", f"seg{A2A_SEGMENTS}")):
        cases = [r for r in ep["a2a"]
                 if (r["case"].startswith("seg")) == (kname == "a2a_seg")]
        main_rec = next(r for r in cases if r["ranks"] == 4
                        and r["shape"] == "decode" and r["wire"] == "bf16"
                        and r["case"] == case)
        out.append({
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/all_to_all.cu",
            "replaces": replaces,
            "launches": ep["engines"]["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            **{k: main_rec[k] for k in ("ms", "kernel_device_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
            "case": (f"decode, 4 ranks, {main_rec['rows_a_rank']} rows a "
                     f"rank, cap {main_rec['cap']}, H {main_rec['H']}, bf16 "
                     f"wire + ids"),
            "cases": cases})
    return out


# ---------------------------------------------------------------------------
# phase 17: the sharded engine's SP modes and disaggregated serving
# ---------------------------------------------------------------------------

# B8 at the long prompt's shapes: 8 decode rows at the prompt's length, and
# its last chunk of 256 rows, over the long-context engine's block-table
# width (LONG's prompt and new tokens)
FD_DIST_RANKS = (2, 4)
# the most a call of flash_decode_dist at 4 ranks may hold at the chunk
# shape above the pool (its slabs, in blocks of rows)
FD_DIST_PEAK_GIB = 8.0
# B6 at 2 and 4 ranks on one layer of the sharded engine's pools (the
# pool of ENGINE, padded to the SP size), and inside a 2x2x2 mesh's sp groups
POOL_AG_RANKS = (2, 4)
# B23 at Llama-3-8B's pools: a 256-token chunk straddling a page edge
# finalises 17 pages, sent in a 64-entry id list over 32 layers
MIGRATE = {"pages": 17, "pmax": 64, "pool_pages": 128}


def _fd_dist_cases(dtype, device, seed: int) -> dict:
    """The decode and chunk inputs of B8 at the long prompt's shapes; pools
    whose page count splits over 2, 4 and 8 ranks."""
    long = LONG["prompt"]
    S = -(-(long + LONG["new"]) // PS)
    return {"decode": _fd_inputs(dtype, device, (long,) * 8, S, 8 * S + 8,
                                 seed),
            "chunk": _fd_inputs(dtype, device,
                                tuple(range(long - 255, long + 1)), S, S + 8,
                                seed + 1, shared=True)}


def fd_dist_bound(c: dict, n: int, out_esize: int) -> tuple[float, str]:
    """Least time of B8 on n ranks: each rank's slab read once, its lse
    of every live page of its rows and its out of the pages it holds (one
    rank's entry is real a page), and every rank's [B, Hq, D] result
    written; on one card the ranks read their peers' slabs in place, so no
    slab byte need move twice. The fold's operations (about 8 a real
    element) are far below the bytes."""
    kv, S = c["kv_len"], c["bt"].shape[1]
    live = int((kv.long() + PS - 1).div(PS, rounding_mode="floor")
               .clamp(max=S).sum())
    B = c["q"].shape[0]
    nbytes = (n * live * HQ * 4 + live * HQ * D * 4
              + n * B * HQ * D * out_esize)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def check_fd_dist_kernels(device, timed: bool = True, ranks=FD_DIST_RANKS,
                          cases=None, plain_rows: int = 16,
                          seed: int = 40) -> list[dict]:
    """B8 (``fd_fold_dist``) through ``flash_decode_dist`` at each of
    ``ranks`` SP ranks on the long prompt's decode and chunk shapes (bf16):
    every rank's result bitwise the fused n = 1 fold (``fd_partials_fold``)
    on a rerun and on 5 calls with fresh queries, within ``FD_FOLD_REL`` of
    the plain version (on ``plain_rows`` rows of the chunk: a row's fold
    does not depend on the others), every pad zero; the peak memory a call
    adds (its slabs, in blocks of rows) under ``FD_DIST_PEAK_GIB`` at the
    chunk shape. With ``timed``, B8 alone on one block's slabs, between
    CUDA events and under the profiler, beside its plain version and its
    bound. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.shmem import check_errors
    from triton_dist_tpu_torch.shmem.context import initialize_distributed
    from triton_dist_tpu_torch.utils.perf import perf_func

    dtype = torch.bfloat16
    on_card = device.type == "cuda"
    cases = cases or _fd_dist_cases(dtype, device, seed)
    records = []
    for shape, c in cases.items():
        B = c["q"].shape[0]
        args = (c["q"], c["k"], c["v"], c["bt"], c["kv_len"])
        fused = fd.fd_partials_fold(*args)
        gen = torch.Generator(device=device).manual_seed(seed + 7)
        kn = torch.randn(B, HKV, D, generator=gen, device=device).to(dtype)
        parked = torch.zeros(B, dtype=torch.bool, device=device)
        pos = torch.zeros(B, dtype=torch.int32, device=device)
        rows = (list(range(B)) if B <= plain_rows else
                list(range(plain_rows // 2)) + list(range(B - plain_rows // 2,
                                                          B)))
        sub = torch.tensor(rows, device=device)
        for n in ranks:
            ctx = initialize_distributed(("sp",), (n,), device=device)

            def dist(q):
                # active all False: the new rows go to the scratch page 0,
                # which no block table uses, so the pool stays the fused
                # fold's
                return fd.flash_decode_dist(ctx, q, kn, kn, c["k"], c["v"],
                                            c["bt"], pos, c["kv_len"],
                                            active=parked, replicas=True)[0]
            if on_card:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            got = dist(c["q"])
            peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 30
                    if on_card else None)
            again = dist(c["q"])
            check_errors(ctx)
            fresh_ok = True
            for i in range(FRESH_CALLS):
                q2 = torch.randn(c["q"].shape, generator=gen,
                                 device=device).to(dtype)
                ref = fd.fd_partials_fold(q2, *args[1:])
                out = dist(q2)
                fresh_ok &= all(_same(out[r], ref) for r in range(n))
            check_errors(ctx)
            p_local = c["k"].shape[0] // n
            parts = [fd.fd_page_partials_plain(
                c["q"][sub], c["k"][r * p_local:(r + 1) * p_local],
                c["v"][r * p_local:(r + 1) * p_local], c["bt"][sub],
                c["kv_len"][sub], r) for r in range(n)]
            plain = fd.fd_fold_dist_plain(torch.stack([o for o, _ in parts]),
                                          torch.stack([l for _, l in parts]),
                                          dtype)
            del parts
            rec = {"kernel": "fd_fold_dist", "ranks": n, "shape": shape,
                   "dtype": "bfloat16",
                   "case": f"bfloat16 {shape}, {n} ranks, B={B} "
                           f"S={c['bt'].shape[1]} kv="
                           f"{int(c['kv_len'].min())}.."
                           f"{int(c['kv_len'].max())}",
                   "row_block": fd.fd_row_block(n, c["bt"].shape[1], HQ, D),
                   "bitwise_fused_n1": all(_same(got[r], fused)
                                           for r in range(n)),
                   "bitwise_repeat": _same(got, again),
                   "fresh_calls_bitwise": fresh_ok,
                   "pads_zero": _pads_zero(ctx),
                   "max_abs_err": (got[0][sub].float() - plain.float()).abs()
                   .max().item(),
                   "row_rel_err": _row_rel(got[0][sub], plain),
                   "row_rel_tol": FD_FOLD_REL["bfloat16"],
                   "plain_rows": len(rows), "peak_added_gib": peak,
                   "peak_limit_gib": FD_DIST_PEAK_GIB}
            ok = (rec["bitwise_fused_n1"] and rec["bitwise_repeat"]
                  and fresh_ok and rec["pads_zero"]
                  and rec["row_rel_err"] <= FD_FOLD_REL["bfloat16"]
                  and (peak is None or peak <= FD_DIST_PEAK_GIB))
            if timed:
                # B8 alone on one block of rows' slabs
                rb = min(B, rec["row_block"])
                S = c["bt"].shape[1]
                outs = torch.empty(n, rb, S, HQ, D, device=device)
                lses = torch.empty(n, rb, S, HQ, device=device)
                for r in range(n):
                    fd._partials_into(c["q"][:rb],
                                      c["k"][r * p_local:(r + 1) * p_local],
                                      c["v"][r * p_local:(r + 1) * p_local],
                                      c["bt"][:rb], c["kv_len"][:rb], r, None,
                                      outs[r], lses[r], neutral_out=True)
                kv = c["kv_len"][:rb]

                def fold():
                    return fd.fd_fold_dist(ctx, outs, lses, kv, dtype,
                                           replicas=True)
                _, rec["ms"] = perf_func(fold)
                rec["kernel_device_ms"] = kernel_device_ms(fold,
                                                           "fd_fold_dist")
                if rb == B:
                    _, rec["plain_ms"] = perf_func(
                        lambda: fd.fd_fold_dist_plain(outs, lses, dtype),
                        iters=1, warmup_iters=0)
                rec["bound_ms"], rec["bound_by"] = fd_dist_bound(
                    {"q": c["q"][:rb], "kv_len": kv, "bt": c["bt"][:rb]}, n,
                    2)
                rec["library_ms"] = None
                rec["library_none_because"] = (
                    "no single PyTorch call folds per-page partials of "
                    "several ranks in a fixed order")
                rec["timed_rows"] = rb
                rec["pages"] = S
                del outs, lses
            log("kernel fd_fold_dist", json.dumps(rec))
            del got, again, plain
            if on_card:
                torch.cuda.empty_cache()
            if not ok:
                raise AssertionError(f"fd_fold_dist fails its checks: {rec}")
            records.append(rec)
    return records


def check_pool_ag(device, timed: bool = True, ranks=POOL_AG_RANKS,
                  pages: int | None = None, seed: int = 41) -> list[dict]:
    """B6 (``pool_ag_start_local``) on one layer of the sharded engine's K
    and V pools (bf16, ENGINE's pool padded to the SP size) at each of
    ``ranks`` and inside a 2x2x2 mesh's sp groups: every replica bitwise
    the plain version's and B9's gather's, on a rerun and 5 calls with
    fresh pools, every pad zero; timed beside the bound, the plain version
    and ``torch.cat``. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.ops.allgather import all_gather
    from triton_dist_tpu_torch.serving import serving_mesh
    from triton_dist_tpu_torch.shmem import check_errors
    from triton_dist_tpu_torch.shmem.context import (ShmemContext,
                                                     initialize_distributed)
    from triton_dist_tpu_torch.utils.perf import perf_func

    gen = torch.Generator(device=device).manual_seed(seed)
    pages = pages or ENGINE["num_pages"] + 1
    meshes = [(n, initialize_distributed(("sp",), (n,), device=device))
              for n in ranks]
    grid = serving_mesh(2, 2, 2)
    meshes.append((2, ShmemContext(grid.axis_names, grid.mesh_shape,
                                   device)))
    records = []
    for n, ctx in meshes:
        P = pages + (-pages) % n

        def pools():
            return tuple(torch.randn(P, HKV, PS, D, generator=gen,
                                     device=device).to(torch.bfloat16)
                         for _ in range(2))
        kp, vp = pools()
        kf, vf = fd.pool_ag_start_local(ctx, kp, vp)
        kf2, vf2 = fd.pool_ag_start_local(ctx, kp, vp)
        ref = fd.pool_ag_start_local_plain(kp, vp, ctx.num_ranks)
        b9 = (all_gather(ctx, kp, axis="sp"), all_gather(ctx, vp, axis="sp"))
        fresh_ok = True
        for _ in range(FRESH_CALLS):
            k2, v2 = pools()
            fresh_ok &= _same(fd.pool_ag_start_local(ctx, k2, v2),
                              fd.pool_ag_start_local_plain(k2, v2,
                                                           ctx.num_ranks))
        check_errors(ctx)
        mesh = "x".join(map(str, ctx.mesh_shape))
        rec = {"kernel": "pool_ag_start_local", "ranks": n, "mesh": mesh,
               "case": f"bf16 pools [{P}, {HKV}, {PS}, {D}] x 2, sp {n}, "
                       f"mesh {mesh}",
               "bitwise_plain": _same((kf, vf), ref),
               "bitwise_b9": _same((kf, vf), b9),
               "bitwise_repeat": _same((kf, vf), (kf2, vf2)),
               "fresh_calls_bitwise": fresh_ok, "pads_zero": _pads_zero(ctx),
               "max_abs_err": 0.0 if _same((kf, vf), ref) else float("nan")}
        ok = all(rec[k] for k in ("bitwise_plain", "bitwise_b9",
                                  "bitwise_repeat", "fresh_calls_bitwise",
                                  "pads_zero"))
        if timed:
            N = ctx.num_ranks
            _, rec["ms"] = perf_func(lambda: fd.pool_ag_start_local(ctx, kp,
                                                                    vp))
            rec["kernel_device_ms"] = kernel_device_ms(
                lambda: fd.pool_ag_start_local(ctx, kp, vp), "pool_ag")
            _, rec["plain_ms"] = perf_func(
                lambda: fd.pool_ag_start_local_plain(kp, vp, N))
            _, rec["library_ms"] = perf_func(
                lambda: torch.cat([kp, vp] * N))
            rec["library"] = "torch.cat([k, v] * N)"
            nbytes = 2 * kp.numel() * kp.element_size()
            rec["bound_ms"], rec["bound_by"] = collective_bound(nbytes,
                                                                N * nbytes)
        log("kernel pool_ag_start_local", json.dumps(rec))
        del kf, vf, kf2, vf2, ref, b9
        if not ok:
            raise AssertionError(f"pool_ag_start_local fails its checks: "
                                 f"{rec}")
        records.append(rec)
    return records


def _migrate_ids(pages: int, k: int, pmax: int, gen) -> tuple[list, list]:
    """``k`` distinct source and destination ids in [1, pages] in a list of
    ``pmax`` entries; the padding past ``k`` names other real pages, which
    a transport must never touch."""
    import torch

    src = (torch.randperm(pages, generator=gen) + 1).tolist()
    dst = (torch.randperm(pages, generator=gen) + 1).tolist()
    return (src[:k] + src[k:k + pmax - k], dst[:k] + dst[k:k + pmax - k])


def check_page_migrate(device, cfg, timed: bool = True, spec=MIGRATE,
                       seed: int = 42) -> list[dict]:
    """B23 (``paged_transport``, through ``migrate_pages`` and
    ``lend_pages``) at ``cfg``'s pools ([2, L, P + 1, Hkv, 16, D], random
    bf16): ``spec["pages"]`` pages in a ``spec["pmax"]``-entry id list,
    bitwise the plain version's pools (the padding entries' pages
    untouched), landed (n, tag) at both roles, on a rerun and 5 fresh calls
    with other ids and tags, every pad zero; a call whose producer never
    signals raises ``ShmemError`` within ``HANG_LIMIT_S``, and the next
    call is bitwise again. Timed beside the bound, the plain version and
    ``index_copy_``. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import page_migrate as pm
    from triton_dist_tpu_torch.ops.lend_pages import lend_pages
    from triton_dist_tpu_torch.shmem import ShmemError, check_errors
    from triton_dist_tpu_torch.shmem.context import initialize_distributed
    from triton_dist_tpu_torch.utils.perf import perf_func

    ctx = initialize_distributed(("role",), (2,), device=device)
    gen = torch.Generator().manual_seed(seed)
    P, k, pmax = spec["pool_pages"], spec["pages"], spec["pmax"]
    shape = (cfg.n_layers, P + 1, cfg.n_kv_heads, PS, cfg.head_dim)
    pool_k = ctx.create_symm_tensor(shape, cfg.dtype)
    pool_v = ctx.create_symm_tensor(shape, cfg.dtype)
    dgen = torch.Generator(device=device).manual_seed(seed)
    for t in (pool_k, pool_v):
        t.copy_(torch.randn(t.shape, generator=dgen, device=device))

    def one(fn, tag, **kw):
        src, dst = _migrate_ids(P, k, pmax, gen)
        rk, rv = pool_k.clone(), pool_v.clone()
        pm.paged_transport_plain(ctx, rk, rv, src, dst, k, "role",
                                 kw.get("producer", 0),
                                 kw.get("consumer", 1), tag)
        _, _, landed = fn(ctx, pool_k, pool_v, src, dst, k, axis="role",
                          tag=tag, **kw)
        lnd = landed.cpu().tolist()
        return (_same((pool_k, pool_v), (rk, rv))
                and lnd == [[k, tag], [k, tag]]), dst[k:]

    ok_first, _ = one(pm.migrate_pages, 5)
    ok_repeat, _ = one(pm.migrate_pages, 6)
    fresh = all(one(pm.migrate_pages, 10 + i)[0] for i in range(FRESH_CALLS))
    lend_ok, _ = one(lend_pages, 7, lender=0, borrower=1)
    check_errors(ctx)
    pads = _pads_zero(ctx)
    # starvation: the producer puts but never signals
    src, dst = _migrate_ids(P, k, pmax, gen)
    t0 = time.perf_counter()
    raised = False
    try:
        pm.paged_transport(ctx, pool_k, pool_v, src, dst, k, axis="role",
                           tag=99, silent=True)
        check_errors(ctx)
    except ShmemError as e:
        raised = True
        log("paged_transport starved as expected:", str(e))
    hang_s = time.perf_counter() - t0
    after_ok, _ = one(pm.migrate_pages, 100)
    page_bytes = pool_k[0, 0, 0].numel() * pool_k.element_size()
    rec = {"kernel": "paged_transport",
           "case": f"{k} pages in a {pmax}-entry id list, {cfg.n_layers} "
                   f"layers, pools [2, {cfg.n_layers}, {P + 1}, "
                   f"{cfg.n_kv_heads}, {PS}, {cfg.head_dim}] bf16",
           "bitwise_plain": ok_first, "bitwise_repeat": ok_repeat,
           "fresh_calls_bitwise": fresh, "lend_pages_bitwise": lend_ok,
           "pads_zero": pads, "starved_raised": raised,
           "starved_s": hang_s, "hang_limit_s": HANG_LIMIT_S,
           "bitwise_after_starved": after_ok,
           "bytes_moved": 2 * k * cfg.n_layers * page_bytes,
           "max_abs_err": 0.0 if ok_first else float("nan")}
    ok = (ok_first and ok_repeat and fresh and lend_ok and pads and raised
          and hang_s <= HANG_LIMIT_S and after_ok)
    if timed:
        src, dst = _migrate_ids(P, k, pmax, gen)

        def call():
            return pm.migrate_pages(ctx, pool_k, pool_v, src, dst, k,
                                    axis="role", tag=1)
        _, rec["ms"] = perf_func(call)
        rec["kernel_device_ms"] = kernel_device_ms(call, "transport")
        rk, rv = pool_k.clone(), pool_v.clone()
        _, rec["plain_ms"] = perf_func(lambda: pm.paged_transport_plain(
            ctx, rk, rv, src, dst, k, "role", 0, 1, 1))
        si = torch.tensor(src[:k], device=device)
        di = torch.tensor(dst[:k], device=device)
        ks, vs = pool_k[0].index_select(1, si), pool_v[0].index_select(1, si)

        def library():
            rk[1].index_copy_(1, di, ks)
            rv[1].index_copy_(1, di, vs)
        _, rec["library_ms"] = perf_func(library)
        rec["library"] = ("index_copy_ of K and of V, the sources gathered "
                          "outside the timed call")
        rec["bound_ms"], rec["bound_by"] = collective_bound(
            rec["bytes_moved"], rec["bytes_moved"])
        del rk, rv, ks, vs
    log("kernel paged_transport", json.dumps(rec))
    del pool_k, pool_v
    if not ok:
        raise AssertionError(f"paged_transport fails its checks: {rec}")
    return [rec]


def fd_fold_fit(records: list[dict]) -> dict:
    """The fit t = t0 + bytes / rate of B8's kernel-alone times
    (``torch.profiler``), bytes the remote slabs a rank folds ((n - 1) x
    rows x pages x Hq x (D + 1) f32): the time the engine's modelled
    ``attn_fold_wait_us`` prices (``serving.sharded.FD_FIT``)."""
    pts = [((r["ranks"] - 1) * r["timed_rows"] * r["pages"] * HQ * (D + 1)
            * 4, r["kernel_device_ms"] * 1e3) for r in records
           if r.get("kernel_device_ms")]
    m = len(pts)
    sx = sum(b for b, _ in pts)
    sy = sum(t for _, t in pts)
    sxx = sum(b * b for b, _ in pts)
    sxy = sum(b * t for b, t in pts)
    slope = (m * sxy - sx * sy) / (m * sxx - sx * sx)
    fit = {"t0_us": (sy - slope * sx) / m,
           "gb_per_s": 1 / slope / 1e3 if slope > 0 else None,
           "points": pts}
    log("fd fold fit", json.dumps(fit))
    return fit


def check_sp_kernels(device, card: str) -> dict:
    """Phase 17a: B8, B6 and B23 against their plain versions and timed
    (on a card with no model weights held)."""
    import torch

    from triton_dist_tpu_torch.models.llama import LlamaConfig

    t0 = time.perf_counter()
    fd_dist = check_fd_dist_kernels(device)
    fit = fd_fold_fit(fd_dist)
    torch.cuda.empty_cache()
    pool_ag = check_pool_ag(device)
    migrate = check_page_migrate(device, LlamaConfig.llama3_8b())
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 17a took {seconds:.1f} s")
    return {"fd_fold_dist": fd_dist, "fd_fit": fit,
            "pool_ag_start_local": pool_ag, "paged_transport": migrate,
            "seconds": seconds}


# phase 17c: phase 5's trace through the disaggregated engine, at ENGINE's
# slots, chunk and horizon (every GEMM of both roles at the colocated
# engine's shapes), with pools a decode worker never outgrows (8 slots of
# a whole block-table row), so every prompt page migrates once
DISAGG = dict(ENGINE, num_pages=ENGINE["num_slots"] * PPS,
              num_prefill_slots=2)


def serve_disagg(make, device, trace, preempt: bool) -> tuple:
    """Serve ``trace`` on a fresh ``make()`` engine, arrivals as ``run``
    takes them; with ``preempt`` evict the youngest prefill once, the first
    step it is part-way through its prompt (``force_preempt_prefill``).
    Returns (tokens by rid, engine, wall s, launches of B23 and B1 in the
    run, the evicted rid)."""
    from collections import deque

    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.ops import page_migrate as pm

    eng = make()
    kernels = (pm.paged_transport, fd.gqa_decode_paged)
    if device.type == "cuda":
        torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    pending, evicted, i = deque(trace), None, 0
    t0 = time.perf_counter()
    while i < 10_000:
        while pending and pending[0][0] <= i:
            eng.submit(*pending.popleft()[1:])
        victim = eng.sched_p.pick_victim() if preempt and evicted is None \
            else None
        if victim is not None:
            req = eng.sched_p.slots[victim]
            if 0 < req.prefill_cursor < len(req.prompt):
                evicted = req.rid
                eng.force_preempt_prefill()
        if not eng.step() and not pending:
            break
        i += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ({r.rid: list(r.generated) for r in eng._finished}, eng, wall,
            {k.__name__: k.launches for k in kernels}, evicted)


def profile_disagg_step(eng, device, trace) -> dict:
    """Once the decode worker has active slots while prompts still
    prefill: one step of both roles timed (host clock to a synchronize),
    then the next under ``torch.profiler``, its device time by family (B1,
    B23, cuBLAS, the rest) and device ops; the idle share is 1 - that
    device time / the first step's wall time."""
    import torch

    from triton_dist_tpu_torch.serving import RequestState

    for _, prompt, new in trace[:2 * eng.num_slots]:
        eng.submit(prompt, new)
    for _ in range(200):
        eng.step()
        active = sum(r is not None and r.state is RequestState.ACTIVE
                     for r in eng.sched_d.slots)
        if active >= eng.num_slots // 2 and not eng.sched_p.idle:
            break
    card = device.type == "cuda"
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fams, ops = device_time_by_family(
        eng.step, card, (("attention", ("decode_paged_kernel",)),
                         ("transport", ("transport_kernel",))))
    busy = sum(fams.values())
    rec = {"wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1 - busy / wall if busy else None,
           "device_s_by_family": fams, "device_ops": ops}
    log("profile disagg step", json.dumps(rec))
    return rec


def check_disagg(params, cfg, device, card: str, trace, golden: dict,
                 engine_kw=DISAGG) -> dict:
    """Phase 17c: ``trace`` (phase 5's) through ``DisaggServingEngine``
    twice, each run with a forced prefill preemption: every request
    finishes with its full budget and its tokens bitwise ``golden`` (the
    colocated engine's, phase 5), the reruns bitwise; the decode worker
    processes no prompt token and never preempts; the pages migrated are
    the prompts' pages, each once; B23 launched once a migrated chunk and
    B1 once a layer of every decode step and chunk. tok/s, TTFT p50, B23's
    launches and pages; one step under the profiler. The colocated engine
    also serves the trace once with a pool as large as one role's (phase
    5's golden ran a smaller pool and preempts), bitwise ``golden``: the
    comparison of tok/s and TTFT at the same pages. Raises on any
    failure."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.serving import (DisaggServingEngine,
                                               ServingEngine)
    from triton_dist_tpu_torch.shmem import check_errors

    t0 = time.perf_counter()

    def make():
        return DisaggServingEngine(params, cfg, device=device, **engine_kw)

    colo_kw = {k: v for k, v in engine_kw.items()
               if k != "num_prefill_slots"}
    res, eng, wall, _ = serve(
        lambda: ServingEngine(params, cfg, device=device, **colo_kw), device,
        trace, (fd.gqa_decode_paged,))
    c = eng.metrics.counters
    colocated = {"num_pages": colo_kw["num_pages"],
                 "bitwise_golden": res == golden,
                 "first_difference": _first_difference(golden, res),
                 "preemptions": c["preemptions"], "wall_s": wall,
                 "tok_per_s": c["tokens_generated"] / wall,
                 "ttft_p50_s": eng.metrics.hist["ttft_s"].percentile(50)}
    log("colocated engine at one role's pool", json.dumps(colocated))
    del eng, res
    if not colocated["bitwise_golden"]:
        raise AssertionError(f"the colocated engine at {colo_kw['num_pages']}"
                             f" pages departs from its golden: {colocated}")

    runs = []
    on_card = device.type == "cuda"
    for run in range(2):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        res, eng, wall, launches, evicted = serve_disagg(make, device, trace,
                                                         preempt=True)
        check_errors(eng.ctx)
        c, d = eng.metrics.counters, eng.metrics_decode.counters
        pages = sum(-(-len(p) // eng.page_size) for _, p, _ in trace)
        tokens = c["tokens_generated"] + d["tokens_generated"]
        rec = {"card": card, "run": run, "requests": len(trace),
               "finished": d["requests_finished"], "failed": len(eng.failed),
               "tokens_generated": tokens,
               "tokens_expected": sum(m for _, _, m in trace),
               "bitwise_colocated": res == golden,
               "first_difference": _first_difference(golden, res),
               "prefill_preemptions": c["preemptions"],
               "evicted_rid": evicted,
               "decode_preemptions": d["preemptions"],
               "decode_prefill_tokens_max":
                   eng.metrics_decode.hist["step_prefill_tokens"].max,
               "handoffs": c["handoffs"], "pages_migrated":
                   c["pages_migrated"], "prompt_pages": pages,
               "migrate_chunks": c["migrate_chunks"],
               "pages_per_chunk_mean":
                   eng.metrics.hist["migrate_pages_per_chunk"].mean,
               "migrate_s_mean": eng.metrics.hist["migrate_s"].mean,
               "launches": launches, "launches_expected": {
                   "paged_transport": c["migrate_chunks"],
                   "gqa_decode_paged": cfg.n_layers * (
                       eng.decode_horizon * d["dispatches"]
                       + c["prefill_chunks"])},
               "wall_s": wall, "tok_per_s": tokens / wall,
               "ttft_p50_s": eng.metrics.hist["ttft_s"].percentile(50),
               "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                if on_card else None)}
        log("disagg engine", json.dumps(rec))
        ok = (rec["finished"] == len(trace) and not rec["failed"]
              and rec["bitwise_colocated"]
              and all(len(res[i]) == m for i, (_, _, m) in enumerate(trace))
              and rec["prefill_preemptions"] == 1 and evicted is not None
              and rec["decode_preemptions"] == 0
              and rec["decode_prefill_tokens_max"] == 0
              and rec["handoffs"] == len(trace) and rec["pages_migrated"]
              == pages
              and (not on_card or launches == rec["launches_expected"]))
        del eng
        if not ok:
            raise AssertionError(f"the disaggregated engine fails its "
                                 f"checks: {rec}")
        runs.append(rec)
    eng = make()
    profile = profile_disagg_step(eng, device, trace)
    del eng
    if on_card:
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 17c (disaggregated serving) took {seconds:.1f} s")
    return {"runs": runs, "profile": profile, "colocated": colocated,
            "seconds": seconds}


def sp_modes_kernels(sp17: dict, moe: dict, disagg: dict) -> list[dict]:
    """The ``kernels`` line's entries of B8, B6 and B23 (phase 17): the
    main cases are B8 at 4 ranks at the long prompt's decode rows, B6 at 4
    ranks on one layer of the engine's pools, B23's 17-page chunk; the
    launches are the main path's runs' (17b's long-context legs, 16c's
    ``overlap="ep+sp"`` meshes, 17c's first disaggregated run)."""
    def main_rec(records, **match):
        return next(r for r in records
                    if all(r.get(k) == v for k, v in match.items()))

    keys = ("ms", "kernel_device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "case")
    fd_main = main_rec(sp17["fd_fold_dist"], ranks=4, shape="decode")
    ag_main = main_rec(sp17["pool_ag_start_local"], ranks=4, mesh="4")
    tr_main = sp17["paged_transport"][0]
    return [{
        "name": "fd_fold_dist", "route": "cuda",
        "source": "triton_dist_tpu_torch/csrc/flash_decode_dist.cu",
        "replaces": "triton_dist_tpu/ops/flash_decode.py:1023",
        "launches": sum(r["launches"]["fd_fold_dist"]
                        for r in moe["long"]["sp"]),
        "max_abs_err": max(r["max_abs_err"] for r in sp17["fd_fold_dist"]),
        **{k: fd_main.get(k) for k in keys},
        "library_none_because": fd_main["library_none_because"],
        "cases": sp17["fd_fold_dist"]}, {
        "name": "pool_ag_start_local", "route": "cuda",
        "source": "triton_dist_tpu_torch/csrc/pool_ag.cu",
        "replaces": "triton_dist_tpu/ops/flash_decode.py:597",
        "launches": moe["ep"]["engines"]["launches"]["pool_ag_start_local"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in sp17["pool_ag_start_local"]),
        **{k: ag_main.get(k) for k in keys},
        "library": ag_main["library"],
        "cases": sp17["pool_ag_start_local"]}, {
        "name": "paged_transport", "route": "cuda",
        "source": "triton_dist_tpu_torch/csrc/page_migrate.cu",
        "replaces": "triton_dist_tpu/ops/page_migrate.py:238",
        "launches": disagg["runs"][0]["launches"]["paged_transport"],
        "max_abs_err": tr_main["max_abs_err"],
        **{k: tr_main.get(k) for k in keys},
        "library": tr_main["library"],
        "cases": sp17["paged_transport"]}]


# ---------------------------------------------------------------------------
# phase 19: the collectives in full across ranks (B10, B11, B12; B13 and B5
# over groups; ring_2d) and SP decode over a 2-D mesh
# ---------------------------------------------------------------------------

# the 2-D meshes of B11 and ring_2d, (axes, shape), outer axis first
MESHES_2D = {"2x2": (("a", "b"), (2, 2)), "2x4": (("a", "b"), (2, 4)),
             "2x2x2": (("a", "b", "c"), (2, 2, 2))}
# B10: f32 x 128 lanes of 4, 16 and 64 KiB a rank (bench.py's LL sizes) at
# these rank counts, and the B = 1 SP wire; calls through one AgLLContext
# (each parity three times), a barriered B9 push after the third
LL_RANKS = (2, 4, 8)
LL_KIB = (4, 16, 64)
LL_CALLS = 6
# B12: roots 0 and n - 1 at these rank counts, a block of each size
BCAST_RANKS = (2, 4, 8)
BCAST_BYTES = (4 << 10, 32 << 20)
# B13 over each axis's groups and as ring_2d, f32 on these meshes, bf16 on
# the first
RS_2D_MESHES = ("2x2", "2x4")
# the main path: G-long (one prompt of 7936 tokens in 8192 slots) on phase
# 5's params, greedy steps of decode_step_sp on (2, 2) over both axes and
# over b's two groups; the 1-D runs at 4 and 2 ranks are the references
SP_2D = dict(B=1, prompt=7936, max_seq=8192, steps=16)
SP_2D_RUNS = ((("a", "b"), "push_2d"), (("a", "b"), "ring_2d"),
              (("a", "b"), "auto"), ("b", "fused"), ("b", "push"),
              ("b", "ring"))
COLL_2D_NOTE = ("every rank of the mesh shares the one card: times are the "
                "kernels and their protocol on shared SMs and one HBM, not "
                "NVLink transfers")


def _mesh_2d(name: str, device):
    from triton_dist_tpu_torch.shmem import initialize_distributed

    return initialize_distributed(*MESHES_2D[name], device=device)


def kernel_device_ms_per_call(fn, match: str, calls: int = 10) -> float:
    """The device time a call of ``fn`` spends in the kernels whose name
    holds ``match``, summed over its launches (``ring_2d``: one an axis),
    over ``calls`` calls under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and match in e.name) / calls


def _check_calls(name: str, ctx, call, plain, make, case: str,
                 timed: bool, match: str | None = None, bound=None,
                 library=None, library_call: str | None = None,
                 extra=None, launches: int = 1) -> dict:
    """One case of a collective against its plain version: ``call(x)`` on
    ``make()``'s input, bitwise ``plain(x)`` on a rerun and on
    ``FRESH_CALLS`` fresh inputs, every pad zero after each call; timed
    beside its bound, plain version and ``library`` call (the kernel alone
    summed over a call's ``launches``)."""
    import torch

    from triton_dist_tpu_torch.shmem import check_errors
    from triton_dist_tpu_torch.utils.perf import perf_func

    x = make()
    got, got2 = call(x), call(x)
    check_errors(ctx)
    want = plain(x)
    pads = _pads_zero(ctx)
    fresh = []
    for _ in range(FRESH_CALLS):
        xi = make()
        fresh.append(bool(torch.equal(call(xi), plain(xi))))
        pads &= _pads_zero(ctx)
    check_errors(ctx)
    rec = {"kernel": name, "case": case, "exact": bool(torch.equal(got, want)),
           "bitwise_repeat": bool(torch.equal(got, got2)),
           "fresh_calls_exact": all(fresh), "pads_zero_after": pads,
           "max_abs_err": (got.float() - want.float()).abs().max().item()}
    if extra is not None:
        rec.update(extra(x, got))
    if timed and ctx.device.type == "cuda":
        rec["ms"] = perf_func(lambda: call(x))[1]
        if match:
            rec["kernel_device_ms"] = (
                kernel_device_ms(lambda: call(x), match) if launches == 1
                else kernel_device_ms_per_call(lambda: call(x), match))
        rec["plain_ms"] = perf_func(lambda: plain(x))[1]
        rec["bound_ms"], rec["bound_by"] = bound(x)
        rec["library_ms"] = (perf_func(lambda: library(x))[1]
                             if library is not None else None)
        rec["library_call"] = library_call
        rec["note"] = COLL_2D_NOTE
    log(f"kernel {name}", json.dumps(rec))
    failed = [k for k, v in rec.items() if v is False]
    if failed:
        raise AssertionError(f"{name} {case} failed {failed}: {rec}")
    return rec


def _hang_2d(name: str, ctx, call, want) -> dict:
    """A call whose rank 1 never signals must raise ``ShmemError`` within
    ``HANG_LIMIT_S``; the next call is bitwise ``want`` and the pads zero."""
    import torch

    from triton_dist_tpu_torch.shmem import ShmemError, check_errors

    t0 = time.perf_counter()
    raised = None
    try:
        call(silent_rank=1)
        check_errors(ctx)
    except ShmemError as e:
        raised = str(e)
    seconds = time.perf_counter() - t0
    after = bool(torch.equal(call(), want))
    check_errors(ctx)
    rec = {"kernel": name, "raised": raised, "seconds": seconds,
           "limit_s": HANG_LIMIT_S, "next_call_bitwise": after,
           "pads_zero_after": _pads_zero(ctx)}
    log("collectives 2-D hang check", json.dumps(rec))
    if not (raised and seconds < HANG_LIMIT_S and after
            and rec["pads_zero_after"]):
        raise AssertionError(f"a starved {name} did not raise in time: {rec}")
    return rec


def check_gathers_2d(device, timed: bool = True, meshes=MESHES_2D,
                     ag_shape=TP_AG, wire_rows: int = 8,
                     seed: int = 19) -> list[dict]:
    """B11 (``push_2d``) and ``ring_2d`` on each 2-D mesh at AG-GEMM's input
    (``ag_shape`` bf16 in all) and the SP wire at ``wire_rows``: every
    replica bitwise the plain version on a rerun and fresh calls, pads zero;
    timed beside the bound, the plain version, ``Tensor.repeat`` and the
    flat 1-D B9 push over the same ranks and bytes."""
    import torch

    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.utils.perf import perf_func

    gen = torch.Generator(device=device).manual_seed(seed)
    recs = []
    for mesh in meshes:
        ctx = _mesh_2d(mesh, device)
        N = ctx.num_ranks
        flat = _mesh(N, device)
        for label, shape, dtype in (
                ("AG-GEMM input", ag_shape, torch.bfloat16),
                ("SP wire", (N, wire_rows, HQ, D + 1), torch.float32)):
            def make(shape=shape, dtype=dtype):
                return torch.randn(shape, generator=gen,
                                   device=device).to(dtype)

            def bound(x, N=N):
                nbytes = x.numel() * x.element_size()
                return collective_bound(nbytes, N * nbytes)

            for method in ("push_2d", "ring_2d"):
                def call(x, method=method, ctx=ctx):
                    return ag.all_gather(ctx, x, method=method)

                def flat_push(x, flat=flat):
                    return ag.all_gather(flat, x, axis="x", method="push")

                def extra(x, got, flat_push=flat_push, method=method):
                    out = {}
                    if timed and device.type == "cuda" \
                            and method == "push_2d":
                        out["flat_push_ms"] = perf_func(
                            lambda: flat_push(x))[1]
                        out["flat_push_kernel_device_ms"] = kernel_device_ms(
                            lambda: flat_push(x), "ag_push_kernel")
                    return out

                recs.append(_check_calls(
                    "all_gather_push_2d" if method == "push_2d"
                    else "all_gather", ctx, call,
                    lambda x, N=N: ag.all_gather_plain(x, N), make,
                    f"{str(dtype).split('.')[-1]} {method} {mesh} {label} "
                    f"{list(shape)}", timed,
                    "ag_push_2d_kernel" if method == "push_2d"
                    else "ag_ring_kernel", bound,
                    lambda x, N=N: x.repeat((N,) + (1,) * x.dim()),
                    "Tensor.repeat", extra,
                    1 if method == "push_2d" else len(MESHES_2D[mesh][0])))
    return recs


def check_ll_gather(device, timed: bool = True, ranks=LL_RANKS,
                    kib=LL_KIB, seed: int = 20) -> list[dict]:
    """B10 through one ``AgLLContext`` a case: ``LL_CALLS`` consecutive calls
    with fresh data (each parity three times), a barriered B9 push after
    the third, every output bitwise the plain version, the workspace's
    slots of each call's parity holding the foreign shards, a rerun
    bitwise, pads zero; timed beside B9's push at the same payload (the
    latency B10 exists to cut), the bound and ``Tensor.repeat``."""
    import torch

    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.shmem import check_errors
    from triton_dist_tpu_torch.utils.perf import perf_func

    gen = torch.Generator(device=device).manual_seed(seed)
    recs = []
    cases = [(n, f"{k} KiB a rank", (n * k * 1024 // 512, 128))
             for n in ranks for k in kib]
    cases += [(n, "SP wire B=1", (n, 1, HQ, D + 1)) for n in ranks]
    for n, label, shape in cases:
        ctx = _mesh(n, device)
        m = shape[0] // n
        agc = ag.AgLLContext(ctx, m, shape[1:], torch.float32)

        def make(shape=shape):
            return torch.randn(shape, generator=gen, device=device)

        outs, slots, barriered = [], [], None
        for i in range(LL_CALLS):
            x = make()
            out = agc(x)
            phase = i % 2
            shards = x.view((n, m) + tuple(shape[1:]))
            outs.append(bool(torch.equal(out, ag.all_gather_plain(x, n))))
            slots.append(all(torch.equal(agc.ws[r, phase, s], shards[s])
                             for r in range(n) for s in range(n) if s != r))
            if i == 2:
                barriered = bool(torch.equal(
                    ag.all_gather(ctx, x, method="push"),
                    ag.all_gather_plain(x, n)))
        check_errors(ctx)
        x = make()
        rerun = bool(torch.equal(agc(x), agc(x)))
        check_errors(ctx)
        want = ag.all_gather_plain(x, n)
        rec = {"kernel": "all_gather_ll", "case": f"float32 n={n} {label} "
               f"{list(shape)}", "calls": LL_CALLS + 2,
               "calls_exact": all(outs), "workspace_slots_exact": all(slots),
               "barriered_b9_between_exact": barriered,
               "bitwise_repeat": rerun, "pads_zero_after": _pads_zero(ctx),
               "max_abs_err": 0.0}
        if timed and device.type == "cuda":
            rec["ms"] = perf_func(lambda: agc(x))[1]
            rec["kernel_device_ms"] = kernel_device_ms(lambda: agc(x),
                                                       "ag_ll_kernel")
            rec["b9_push_ms"] = perf_func(
                lambda: ag.all_gather(ctx, x, method="push"))[1]
            rec["b9_push_kernel_device_ms"] = kernel_device_ms(
                lambda: ag.all_gather(ctx, x, method="push"),
                "ag_push_kernel")
            rec["plain_ms"] = perf_func(lambda: ag.all_gather_plain(x, n))[1]
            nbytes = x.numel() * x.element_size()
            rec["bound_ms"], rec["bound_by"] = collective_bound(
                nbytes, n * nbytes)
            rec["library_ms"] = perf_func(
                lambda: x.repeat((n,) + (1,) * x.dim()))[1]
            rec["library_call"] = "Tensor.repeat"
            rec["note"] = COLL_2D_NOTE
        log("kernel all_gather_ll", json.dumps(rec))
        if not all(rec[k] for k in ("calls_exact", "workspace_slots_exact",
                                    "barriered_b9_between_exact",
                                    "bitwise_repeat", "pads_zero_after")):
            raise AssertionError(f"all_gather_ll failed: {rec}")
        recs.append(rec)
        if n == 4 and label.startswith("16") and device.type == "cuda":
            recs.append(_hang_2d("all_gather_ll", ctx,
                                 lambda silent_rank=None: agc(
                                     x, silent_rank=silent_rank), want))
    return recs


def check_broadcast(device, timed: bool = True, ranks=BCAST_RANKS,
                    sizes=BCAST_BYTES, seed: int = 21) -> list[dict]:
    """B12 at each rank count, roots 0 and n - 1, and over the groups of a
    (2, 2) mesh's two axes: every rank's copy bitwise ``x[root]`` on a
    rerun and fresh calls, pads zero; timed (root 0) beside the bound, the
    plain version and ``x[root].expand(N, ...).clone()``."""
    import torch

    from triton_dist_tpu_torch.ops import allgather as ag

    gen = torch.Generator(device=device).manual_seed(seed)
    recs = []
    meshes = [(str(n), _mesh(n, device), "x") for n in ranks]
    meshes += [("2x2", _mesh_2d("2x2", device), a) for a in ("a", "b")]
    for label, ctx, axis in meshes:
        n, N = ctx.axis_size(axis), ctx.num_ranks
        for nbytes in sizes:
            shape = (n, nbytes // 4 // 1024, 1024) if nbytes >= 1 << 20 \
                else (n, nbytes // 4)
            for root in (0, n - 1):
                def make(shape=shape):
                    return torch.randn(shape, generator=gen, device=device)

                def call(x, root=root, ctx=ctx, axis=axis, silent_rank=None):
                    return ag.broadcast(ctx, x, axis=axis, root=root,
                                        silent_rank=silent_rank)

                def plain(x, root=root, N=N):
                    return ag.broadcast_plain(x, root, N)

                def library(x, root=root, N=N):
                    return x[root].expand((N,) + tuple(x.shape[1:])).clone()

                recs.append(_check_calls(
                    "broadcast", ctx, call, plain, make,
                    f"float32 {label} over {axis} root {root} {nbytes} bytes",
                    timed and root == 0, "bcast_kernel",
                    lambda x, N=N: collective_bound(
                        x[0].numel() * 4, N * x[0].numel() * 4),
                    library, "x[root].expand(N, ...).clone()"))
        if label == "4" and device.type == "cuda":
            x = torch.randn((n, 1024), generator=gen, device=device)
            recs.append(_hang_2d(
                "broadcast", ctx,
                lambda silent_rank=None, x=x, ctx=ctx: ag.broadcast(
                    ctx, x, root=1, silent_rank=silent_rank),
                ag.broadcast_plain(x, 1, n)))
    return recs


def check_rs_2d(device, timed: bool = True, meshes=RS_2D_MESHES,
                rs_shape=TP_RS, seed: int = 22) -> list[dict]:
    """B13 over each axis's groups and as ``ring_2d`` on each mesh, GEMM-RS's
    f32 partial (``rs_shape`` a rank; bf16 too on the first mesh): bitwise
    the plain version (the rings' order, stage by stage for ``ring_2d``) on
    a rerun and fresh calls, every group's segments too, pads zero; timed
    beside the bound, the plain version and ``torch.sum`` over the
    ranks."""
    import importlib

    import torch

    from triton_dist_tpu_torch.shmem import device as shd

    rs = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")
    gen = torch.Generator(device=device).manual_seed(seed)
    recs = []
    M, W = rs_shape
    for mesh in meshes:
        ctx = _mesh_2d(mesh, device)
        N = ctx.num_ranks
        for dtype in ((torch.float32, torch.bfloat16) if mesh == meshes[0]
                      else (torch.float32,)):
            name = str(dtype).split(".")[-1]
            for axis in MESHES_2D[mesh][0] + (None,):
                n = ctx.axis_size(axis)

                def make(n=n, dtype=dtype):
                    return torch.randn((n * M, W), generator=gen,
                                       device=device).to(dtype)

                def call(x, axis=axis, ctx=ctx, silent_rank=None):
                    return rs.reduce_scatter(ctx, x, axis=axis,
                                             silent_rank=silent_rank)

                def plain(x, axis=axis, n=n, ctx=ctx):
                    if axis is None:
                        return rs.reduce_scatter_2d_plain(ctx, x)
                    return rs.reduce_scatter_plain(x, n)

                def bound(x, n=n, N=N):
                    es = x.element_size()
                    return collective_bound(N * M * W * es,
                                            N * (M // n) * W * es)

                def every_group(x, got, axis=axis, ctx=ctx, n=n):
                    if axis is None or ctx.device.type != "cuda":
                        return {}
                    segs = rs._ring(ctx, shd.group_table(
                        ctx, x.view(n, -1), axis), x.numel() // (n * n), x,
                        axis, None)
                    ref = rs.reduce_scatter_plain(x, n).view(n, -1)
                    idx = shd.group_plan(ctx, axis)[2]
                    return {"every_group_exact": all(
                        torch.equal(segs[r], ref[idx[r]])
                        for r in range(ctx.num_ranks))}

                recs.append(_check_calls(
                    "reduce_scatter", ctx, call, plain, make,
                    f"{name} {'ring_2d' if axis is None else 'ring over ' + axis}"
                    f" {mesh} [{M}, {W}] a rank", timed, "rs_ring_kernel",
                    bound, lambda x, n=n: torch.sum(x.view(n, M, W), 0),
                    "torch.sum over the ranks", every_group,
                    1 if axis is not None else len(MESHES_2D[mesh][0])))
        if mesh == meshes[0] and device.type == "cuda":
            x = torch.randn((2 * 64, 128), generator=gen, device=device)
            recs.append(_hang_2d(
                "reduce_scatter", ctx,
                lambda silent_rank=None, x=x, ctx=ctx: rs.reduce_scatter(
                    ctx, x, axis="b", silent_rank=silent_rank),
                rs.reduce_scatter_plain(x, 2)))
    return recs


def check_ll_ag_merge_groups(device, timed: bool = True,
                             rows=(("G-batch", 8), ("G-long", 1)),
                             seed: int = 23) -> list[dict]:
    """B5 over the ``a`` and ``b`` groups of a (2, 2) mesh at the SP decode's
    partials (one shard of row 0 empty): every rank's replica bitwise
    ``ll_merge`` of its group's partials on a rerun and fresh calls, pads
    zero; bf16 and f32 outputs, timed beside the bound and the plain
    version."""
    import torch

    from triton_dist_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=device).manual_seed(seed)
    ctx = _mesh_2d("2x2", device)
    recs = []
    for label, B in rows:
        for axis in ("a", "b"):
            for out_dtype in (torch.bfloat16, torch.float32):
                name = str(out_dtype).split(".")[-1]

                def make(B=B):
                    outs = torch.randn((2, B, HQ, D), generator=gen,
                                       device=device)
                    lses = torch.randn((2, B, HQ), generator=gen,
                                       device=device) * 3
                    outs[1, 0] = 0.0
                    lses[1, 0] = fd.NEG_INF
                    return torch.cat([outs, lses[..., None]], -1)

                def call(x, axis=axis, out_dtype=out_dtype, silent_rank=None):
                    return fd.ll_ag_merge(ctx, x[..., :D].contiguous(),
                                          x[..., D].contiguous(), out_dtype,
                                          axis, silent_rank=silent_rank)

                def plain(x, out_dtype=out_dtype):
                    merged = fd.ll_merge(x[..., :D].contiguous(),
                                         x[..., D].contiguous(), out_dtype)
                    return merged.unsqueeze(0).expand(
                        (4,) + tuple(merged.shape)).clone()

                def extra(x, got, out_dtype=out_dtype, name=name):
                    ref = fd.ll_merge_plain(x[..., :D], x[..., D], out_dtype)
                    return {"rel_err": _rel(got[0], ref),
                            "within_atol": _rel(got[0], ref) <= OUT_ATOL[name]}

                def bound(x, out_dtype=out_dtype):
                    # every rank reads its group's two partials once and
                    # writes its replica
                    return collective_bound(
                        2 * x.numel() * 4, 4 * x[0, ..., :D].numel()
                        * torch.finfo(out_dtype).bits // 8)

                recs.append(_check_calls(
                    "ll_ag_merge", ctx, call, plain, make,
                    f"float32 -> {name} {label} over {axis} of 2x2 rows={B}x"
                    f"{HQ} D={D}", timed, "ll_ag_merge_kernel", bound,
                    None, None, extra))
    if device.type == "cuda":
        x = torch.randn((2, 8, HQ, D + 1), generator=gen, device=device)
        recs.append(_hang_2d(
            "ll_ag_merge", ctx,
            lambda silent_rank=None: fd.ll_ag_merge(
                ctx, x[..., :D].contiguous(), x[..., D].contiguous(),
                torch.float32, "b", silent_rank=silent_rank),
            fd.ll_merge(x[..., :D].contiguous(), x[..., D].contiguous())
            .unsqueeze(0).expand(4, 8, HQ, D)))
    return recs


def hang_push_2d(device) -> dict:
    """B11's hang check on (2, 2)."""
    import torch

    from triton_dist_tpu_torch.ops import allgather as ag

    ctx = _mesh_2d("2x2", device)
    x = torch.randn((4 * 64, 128), device=device)
    return _hang_2d("all_gather_push_2d", ctx,
                    lambda silent_rank=None: ag.all_gather(
                        ctx, x, method="push_2d", silent_rank=silent_rank),
                    ag.all_gather_plain(x, 4))


def _sp_launch_counters():
    import importlib

    from triton_dist_tpu_torch.ops import allgather, flash_decode

    rs = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")
    return {"all_gather_push_2d": allgather.all_gather_push_2d,
            "all_gather": allgather.all_gather,
            "all_gather_ll": allgather.all_gather_ll,
            "broadcast": allgather.broadcast,
            "reduce_scatter": rs.reduce_scatter,
            "ll_ag_merge": flash_decode.ll_ag_merge,
            "gqa_decode_partial": flash_decode.gqa_decode_partial,
            "decode_combine": flash_decode.decode_combine}


def _sp_2d_ctx(axis, device):
    """The mesh of a run: (2, 2) for the 2-D runs, ("x",) of n for the 1-D
    references."""
    if axis == "x2":
        return _mesh(2, device), "x"
    if axis == "x4":
        return _mesh(4, device), "x"
    return _mesh_2d("2x2", device), axis


def _sp_2d_want(axis, method: str, L: int, steps: int) -> dict:
    """Each kernel's launches in ``steps`` SP steps of ``L`` layers: one B3
    (and its combine of the split partials) a layer-step; B11 once for
    ``push_2d`` (and ``auto`` at this wire), B9 twice for ``ring_2d`` (one
    ring an axis) and once for ``push``/``ring``, B5 once (covering every
    group) for ``fused``; the wire's merge one more combine."""
    per = {k: 0 for k in _sp_launch_counters()}
    per["gqa_decode_partial"] = 1
    per["decode_combine"] = 1 + (method != "fused")
    if method in ("push_2d", "auto"):
        per["all_gather_push_2d"] = 1
    elif method == "ring_2d":
        per["all_gather"] = 2
    elif method == "fused":
        per["ll_ag_merge"] = 1
    else:
        per["all_gather"] = 1
    return {k: v * L * steps for k, v in per.items()}


def run_sp_decode_2d(params, cfg, device, card: str, spec=SP_2D,
                     runs=SP_2D_RUNS, seed: int = 16) -> dict:
    """The main path of phase 19: ``prefill`` of G-long's prompt, ``steps``
    greedy ``decode_step``s at one rank, then ``decode_step_sp`` on (2, 2)
    over ("a", "b") and over b's groups for each of ``runs`` (the last run
    twice), and the 1-D references at 4 ranks (push) and 2 (each of b's
    methods). Raises unless every layer's replicas agreed, each run's
    logits are bitwise its 1-D reference's (over both axes the 4-rank
    push, over b the 2-rank run of its method), the rerun was bitwise, the
    tokens equal one rank's up to each row's first near-tie, and each
    kernel ran its exact count a layer-step."""
    import torch

    from triton_dist_tpu_torch.models import llama

    B, prompt, max_seq, steps = (spec[k] for k in ("B", "prompt", "max_seq",
                                                   "steps"))
    gen = torch.Generator(device=device).manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (B, prompt), generator=gen,
                            device=device)
    cache = llama.init_kv_cache(cfg, B, max_seq, device=device)
    logits, cache = llama.prefill(params, prompts, cfg, cache)
    first = logits.argmax(-1).to(torch.int32)
    del logits
    sharded = {n: llama.shard_kv_cache(cache, n) for n in (2, 4)}
    counters = _sp_launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    one = _greedy(params, cfg, cache, first, prompt, steps)
    one_launches = {k: f.launches - before[k] for k, f in counters.items()}
    del cache
    clear = _near_tie_steps(one["logits"])
    refs = [("x4", "push")] + [("x2", m) for a, m in runs if a == "b"]
    order = refs + list(runs) + [runs[-1]]
    out = {"card": card, "B": B, "prompt": prompt, "max_seq": max_seq,
           "steps": steps, "compared_until": clear,
           "n1": {"decode_ms_per_step": one["seconds"] / steps * 1e3,
                  "launches": one_launches},
           "runs": {}}
    got = {}
    for i, (axis, method) in enumerate(order):
        ctx, ax = _sp_2d_ctx(axis, device)
        n = ctx.axis_size(ax)
        before = {k: f.launches for k, f in counters.items()}
        r = _greedy_axis(params, cfg, sharded[n], first, prompt, steps, ctx,
                         ax, method)
        launches = {k: f.launches - before[k] for k, f in counters.items()}
        want = _sp_2d_want(ax, method, cfg.n_layers, steps)
        label = f"{axis if isinstance(axis, str) else '+'.join(axis)} {method}"
        if i == len(order) - 1:
            label += " rerun"
        got[label] = r
        ref = ("x4 push" if isinstance(axis, tuple)
               else f"x2 {method}" if axis == "b" else None)
        rec = {"decode_ms_per_step": r["seconds"] / steps * 1e3,
               "replicas_equal": r["replicas_equal"],
               "launches": launches,
               "launches_exact": launches == want if device.type == "cuda"
               else None,
               "first_divergence": _first_divergence(r["tokens"],
                                                     one["tokens"]),
               "tokens_equal_n1_until_near_tie": all(
                   torch.equal(r["tokens"][b, :clear[b]],
                               one["tokens"][b, :clear[b]])
                   for b in range(B)),
               "step0_logit_rel_diff": _rel(r["logits"][0],
                                            one["logits"][0])}
        if ref is not None:
            rec["bitwise_1d_reference"] = all(
                torch.equal(a, b) for a, b in zip(r["logits"],
                                                  got[ref]["logits"]))
        if label.endswith("rerun"):
            prev = label[:-len(" rerun")]
            rec["rerun_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(r["logits"],
                                                  got[prev]["logits"]))
        out["runs"][label] = rec
        log(f"sp decode 2-D {label}", json.dumps(rec))
        bad = [k for k, v in rec.items() if v is False]
        if bad:
            raise AssertionError(f"sp decode 2-D {label} failed {bad}: {rec}")
    out["first_tokens"] = one["tokens"][:, :8].tolist()
    del sharded, got
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _greedy_axis(params, cfg, cache, token, pos0: int, steps: int, ctx,
                 axis, method: str) -> dict:
    """``_greedy`` over ``axis`` (every layer's replicas compared at every
    step)."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    toks, logits_all, checks = [], [], []
    sync = torch.cuda.synchronize if token.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = llama.decode_step_sp(
            ctx, params, token, pos0 + i, cfg, cache, axis=axis,
            ag_method=method, replica_checks=checks)
        token = logits.argmax(-1).to(torch.int32)
        toks.append(token)
        logits_all.append(logits)
    sync()
    seconds = time.perf_counter() - t0
    check_errors(ctx)
    return {"tokens": torch.stack(toks, 1), "logits": logits_all,
            "seconds": seconds,
            "replicas_equal": bool(torch.stack(checks).all())}


def check_sp_decode_2d_f32(params, cfg, device, spec=SP_F32,
                           runs=SP_2D_RUNS, seed: int = 17) -> dict:
    """``decode_step_sp`` on (2, 2) over both axes and over b's groups, each
    of ``runs``, against ``decode_step`` in f32 (``check_sp_decode_f32``'s
    prompt and steps: over both axes the keys sit on ranks 0-2 of 4): fed
    one rank's greedy tokens, the logits within
    ``SP_F32_TOL`` of one rank's logit scale at every step, every replica
    bitwise equal. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    B, prompt_len, steps, max_seq = (spec[k] for k in ("B", "prompt",
                                                       "steps", "max_seq"))
    gen = torch.Generator(device=device).manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (B, prompt_len),
                            generator=gen, device=device)
    cache = llama.init_kv_cache(cfg, B, max_seq, device=device)
    logits, cache = llama.prefill(params, prompts, cfg, cache)
    ctx = _mesh_2d("2x2", device)
    sharded = {run: llama.shard_kv_cache(cache, ctx.axis_size(run[0]))
               for run in runs}
    token = logits.argmax(-1).to(torch.int32)
    worst, replicas_ok = {}, True
    for i in range(steps):
        pos = prompt_len + i
        ref, cache = llama.decode_step(params, token, pos, cfg, cache)
        scale = ref.abs().max()
        for run in runs:
            checks = []
            got, sharded[run] = llama.decode_step_sp(
                ctx, params, token, pos, cfg, sharded[run], axis=run[0],
                ag_method=run[1], replica_checks=checks)
            replicas_ok &= bool(torch.stack(checks).all())
            key = f"{'+'.join(run[0])} {run[1]}"
            worst[key] = max(worst.get(key, 0.0),
                             ((got - ref).abs().max() / scale).item())
        check_errors(ctx)
        token = ref.argmax(-1).to(torch.int32)
    rec = {"dtype": str(cfg.dtype), "layers": cfg.n_layers, "B": B,
           "prompt": prompt_len, "steps": steps, "mesh": "2x2",
           "max_rel_logit_diff": worst, "tol": SP_F32_TOL,
           "replicas_equal": replicas_ok}
    log("sp decode 2-D f32", json.dumps(rec))
    if not (replicas_ok and all(v <= SP_F32_TOL for v in worst.values())):
        raise AssertionError(f"SP decode over 2-D meshes in f32 disagrees "
                             f"with one rank: {rec}")
    return rec


def collectives_2d_path(device, ag_shape=TP_AG, rs_shape=TP_RS) -> None:
    """The collectives of phase 19 off the SP step, once each through their
    entry points: B10 through an ``AgLLContext`` on the B = 1 SP wire at 4
    ranks (``LL_CALLS`` calls), B12 of AG-GEMM's input at 4 ranks and over
    b's groups of (2, 2), B13 over b's groups and as ``ring_2d`` on (2, 2)
    at TP width, B11 and ``ring_2d`` of AG-GEMM's input on (2, 2)."""
    import importlib

    import torch

    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.shmem import check_errors

    rs = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")
    ctx4, ctx = _mesh(4, device), _mesh_2d("2x2", device)
    agc = ag.AgLLContext(ctx4, 1, (1, HQ, D + 1), torch.float32)
    wire = torch.ones((4, 1, HQ, D + 1), device=device)
    for _ in range(LL_CALLS):
        agc(wire)
    x = torch.ones(ag_shape, dtype=torch.bfloat16, device=device)
    ag.broadcast(ctx4, x.view(4, -1), root=0)
    ag.broadcast(ctx, x.view(2, -1), axis="b", root=1)
    for method in ("push_2d", "ring_2d"):
        ag.all_gather(ctx, x, method=method)
    M, W = rs_shape
    rs.reduce_scatter(ctx, torch.ones((2 * M, W), device=device), axis="b")
    rs.reduce_scatter(ctx, torch.ones((4 * M, W), device=device))
    check_errors(ctx)
    check_errors(ctx4)


# the launches of collectives_2d_path
COLL_2D_PATH_LAUNCHES = {"all_gather_ll": LL_CALLS, "broadcast": 2,
                         "all_gather_push_2d": 1, "all_gather": 2,
                         "reduce_scatter": 3}


def profile_sp_step_2d(params, cfg, device, spec=SP_2D) -> dict:
    """One decode step at G-long's last position on (2, 2) over both axes
    (``push_2d``) and over b (``fused``): the median wall of three runs,
    then one under ``torch.profiler`` for the device time by family and the
    idle share."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    B, S = spec["B"], spec["max_seq"]
    kv = spec["prompt"] + spec["steps"]
    token = torch.ones(B, dtype=torch.int32, device=device)
    ctx = _mesh_2d("2x2", device)
    recs = {}
    for axis, method in ((("a", "b"), "push_2d"), ("b", "fused")):
        cache = llama.shard_kv_cache(
            llama.init_kv_cache(cfg, B, S, device=device),
            ctx.axis_size(axis))

        def step():
            lg = llama.decode_step_sp(ctx, params, token, kv - 1, cfg, cache,
                                      axis=axis, ag_method=method)[0]
            return lg.argmax(-1).cpu()

        step()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[1]
        fams, ops = device_time_by_family(
            step, True, (("decode_partial", ("decode_partial_kernel",)),
                         ("decode_combine", ("combine_kernel",)),
                         ("push_2d", ("ag_push_2d_kernel",)),
                         ("ll_ag_merge", ("ll_ag_merge_kernel",))))
        busy = sum(fams.values())
        key = f"{'+'.join(axis)} {method}"
        recs[key] = {"rows": B, "kv_len": kv, "max_seq": S, "wall_s": wall,
                     "device_busy_s": busy,
                     "device_idle_share": 1 - busy / wall if busy else None,
                     "device_s_by_family": fams, "device_ops": ops}
        check_errors(ctx)
        log(f"profile sp decode 2-D step {key}", json.dumps(recs[key]))
        del cache
    return recs


def check_collectives_2d(params, cfg, device, card: str) -> dict:
    """Phase 19 on the 32-layer bf16 params: B11 and ``ring_2d``, B10, B12,
    B13 and B5 over groups against their plain versions with their hang
    checks; then the main path with the launch counts set to 0 just before
    it and read just after: SP decode on (2, 2) and its 1-D references,
    and the collectives once each; then one step under the profiler."""
    import torch

    t0 = time.perf_counter()
    kernels = {"gathers": check_gathers_2d(device),
               "ll": check_ll_gather(device),
               "broadcast": check_broadcast(device),
               "rs": check_rs_2d(device),
               "ll_ag_merge": check_ll_ag_merge_groups(device),
               "hang_push_2d": hang_push_2d(device)}
    torch.cuda.empty_cache()
    log(f"phase 19 checks took {time.perf_counter() - t0:.1f} s")
    counters = _sp_launch_counters()
    for f in counters.values():
        f.launches = 0
    decode = run_sp_decode_2d(params, cfg, device, card)
    collectives_2d_path(device)
    launches = {k: f.launches for k, f in counters.items()}
    # the collectives once each, every SP run at its exact count (checked
    # run by run) and one rank's decode_step (B3 and its combine)
    expect = {k: COLL_2D_PATH_LAUNCHES.get(k, 0) for k in counters}
    for rec in list(decode["runs"].values()) + [decode["n1"]]:
        for k, v in rec["launches"].items():
            expect[k] += v
    log("phase 19 launches", json.dumps({"launches": launches,
                                         "expected": expect}))
    if launches != expect or not all(
            launches[k] for k in ("all_gather_push_2d", "all_gather_ll",
                                  "broadcast", "reduce_scatter",
                                  "ll_ag_merge")):
        raise AssertionError(f"phase 19 launches {launches} != {expect}")
    profile = profile_sp_step_2d(params, cfg, device)
    seconds = time.perf_counter() - t0
    log(f"phase 19 took {seconds:.1f} s")
    return {"kernels": kernels, "decode": decode, "profile": profile,
            "launches": launches, "seconds": seconds}


def collectives_2d_kernels(c2d: dict) -> list[dict]:
    """The ``kernels`` line's entries of phase 19: B10, B11 and B12, each
    headed by its main case (B11: AG-GEMM's input on (2, 2); B10: 16 KiB a
    rank at 4 ranks; B12: 32 MiB at 4 ranks, root 0)."""
    k = c2d["kernels"]
    entries = []
    for name, source, replaces, cases, prefix in (
            ("all_gather_push_2d", "allgather.cu",
             "triton_dist_tpu/ops/allgather.py:377",
             [r for r in k["gathers"] if r["kernel"] == "all_gather_push_2d"]
             + [k["hang_push_2d"]], "bfloat16 push_2d 2x2 AG-GEMM"),
            ("all_gather_ll", "allgather.cu",
             "triton_dist_tpu/ops/allgather.py:188", k["ll"],
             "float32 n=4 16 KiB"),
            ("broadcast", "allgather.cu",
             "triton_dist_tpu/ops/allgather.py:464", k["broadcast"],
             f"float32 4 over x root 0 {32 << 20}")):
        main = next(r for r in cases if r.get("case", "").startswith(prefix))
        entries.append({
            "name": name, "route": "cuda",
            "source": f"triton_dist_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": c2d["launches"][name],
            "max_abs_err": max(r.get("max_abs_err", 0.0) for r in cases),
            **{key: main.get(key) for key in (
                "ms", "kernel_device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "case")},
            "ranks_note": COLL_2D_NOTE, "cases": cases})
    return entries


# ---------------------------------------------------------------------------
# phase 20: TP overlap and the MoE-TP block over a group and over two tiers
# (B15 and B19 over the 2-tier relay, B16's and B20's 2-tier stages, the
# group forms of all four)
# ---------------------------------------------------------------------------

# the forms of B15 and B16 at TP_OPS's widths: (mesh of MESHES_2D, axis),
# the 2-tier relay over every axis of phase 19's meshes and b's groups of
# (2, 2); B19 and B20 at MOE_TP_TOKENS on the first and the last
TP_2D_FORMS = (("2x2", ("a", "b")), ("2x4", ("a", "b")),
               ("2x2x2", ("a", "b", "c")), ("2x2", "b"))
MOE_2D_FORMS = (("2x2", ("a", "b")), ("2x2", "b"))
# forward_tp_overlap at full width and depth on phase 15's tokens over
# these axes of (2, 2), each held against the one-axis run over as many
# ranks within TP_RANKS_GATE of its logit scale; in f32 at 2 layers (phase
# 4's params) within tol of the dense forward's scale
TP_2D_FWD = dict(B=TP_RANKS_FWD["B"], S=TP_RANKS_FWD["S"],
                 axes=(("a", "b"), "b"))
TP_2D_F32 = dict(B=2, S=512, layers=2, tol=1e-4)
# the sharded engine with tp_impl="ag_gemm" (B15 over the TP axis, a group
# inside the mesh at 2x1x2 and 2x2x2) on phase 16c's requests, fp8 wire;
# the 2x1x1 engine is the golden
AG_ENGINE_MESHES = ((2, 1, 1), (2, 1, 2), (2, 2, 2))
TP_2D_NOTE = ("every rank of the mesh shares the one card: times are the "
              "kernels and their protocol on shared SMs and one HBM, not "
              "NVLink; over two tiers a relayed segment waits behind the "
              "relay's GEMM of the segments before it")


def _axis_label(axis) -> str:
    return "+".join(axis) if isinstance(axis, tuple) else axis


def _outer_ring(ctx, red, seg_elems: int, outer):
    """B13's ring over the ``outer`` groups on every rank's f32 chunk
    ``red`` [R, ...] (its plain version on the CPU): [R, seg_elems]."""
    import importlib

    from triton_dist_tpu_torch.shmem import device as shd

    rs = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")
    R = ctx.num_ranks
    if red.device.type == "cpu":
        return rs._groups_plain(ctx, red.reshape(R, -1), outer)
    (ins,) = shd.tables(ctx, red)
    return rs._ring(ctx, ins, seg_elems, red, outer, None)


def rs_2d_composition(ctx, axis, a, b, out_dtype):
    """B16 over the tuple ``axis`` from the one-rank kernels and B13: B2's
    f32 partial (``matmul``) of every inner peer's strided chunk
    ``{(r, j) : r < no}`` over each index's K block, each rank's chunk the
    slot reduction (``slot_reduce``) of its inner peers' partials in inner
    slot order, then B13's ring over the outer groups on the f32 chunks,
    cast once. Returns (the global view, every rank's slots [R, ni, no *
    M/n, N])."""
    import torch

    from triton_dist_tpu_torch.ops import gemm as tg
    from triton_dist_tpu_torch.ops.gemm_reduce_scatter import _tiers
    from triton_dist_tpu_torch.shmem import device as shd

    outer, inner, no, ni = _tiers(ctx, axis)
    n = no * ni
    M, K = a.shape
    m, kl, N = M // n, K // n, b.shape[1]
    segs = a.view(no, ni, m, K)
    g_all = shd.group_plan(ctx, axis)[2]
    g_in = shd.group_plan(ctx, inner)[2]
    chunk = {(g, j): tg.matmul(
        segs[:, j, :, g * kl:(g + 1) * kl].reshape(no * m, kl).contiguous(),
        b[g * kl:(g + 1) * kl].contiguous(), out_dtype=torch.float32)
        for g in range(n) for j in range(ni)}
    R = ctx.num_ranks
    slots = torch.stack([torch.stack([chunk[g_all[p], g_in[q]]
                                      for p in ctx.group_members(q, inner)])
                         for q in range(R)])
    del chunk
    red = torch.stack([tg.slot_reduce(slots[q], torch.float32)
                       for q in range(R)])
    out = _outer_ring(ctx, red, m * N, outer) if no > 1 \
        else red.view(R, -1)
    members = list(shd.group_plan(ctx, axis)[3])
    return out[members].view(M, N).to(out_dtype), slots


def moe_rs_2d_composition(ctx, axis, h, ids, tw, wd, block_m: int):
    """B20 over the tuple ``axis`` from the one-rank kernels and B13: the
    segments aligned as the op aligns them; B17's bf16-to-f32 partial
    (``grouped_gemm``) of every segment over each index's K block; each
    rank's chunk of strided segments ``{(r, mi) : r < no}`` the slot
    reduction of its inner peers' partials, every row past a segment's used
    blocks zero; B13's ring over the outer groups; the unscramble and the
    top-k fold in f32 in k order, cast once. Returns [T, N]."""
    import torch

    from triton_dist_tpu_torch.ops import gemm as tg
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe as mo
    from triton_dist_tpu_torch.ops.gemm_reduce_scatter import _tiers
    from triton_dist_tpu_torch.shmem import device as shd

    outer, inner, no, ni = _tiers(ctx, axis)
    n = no * ni
    Tk, K = h.shape
    T, topk = tw.shape
    E, _, N = wd.shape
    kl, seg_rows = K // n, Tk // n
    bm = min(block_m, -(-seg_rows // 16) * 16)
    gi, rv, be, nb, dest = mo._segment_alignment(ids.view(n, seg_rows), E,
                                                 bm)
    x = mo._aligned_rows(h, gi, rv, seg_rows)
    P = x.shape[1]
    used = (nb.clamp(0, P // bm) * bm).tolist()
    part = {(g, s): gg.grouped_gemm(
        x[s, :, g * kl:(g + 1) * kl].contiguous(),
        wd[:, g * kl:(g + 1) * kl].contiguous(), be[s], block_m=bm,
        n_blocks_used=nb[s], masked=False, out_dtype=torch.float32)
        for g in range(n) for s in range(n)}
    g_all = shd.group_plan(ctx, axis)[2]
    g_in = shd.group_plan(ctx, inner)[2]
    R = ctx.num_ranks
    red = torch.zeros(R, no * P, N, dtype=torch.float32, device=h.device)
    for q in range(R):
        peers = [g_all[p] for p in ctx.group_members(q, inner)]
        for r in range(no):
            seg = r * ni + g_in[q]
            s = tg.slot_reduce(torch.stack([part[g, seg] for g in peers]),
                               torch.float32)
            red[q, r * P:r * P + used[seg]] = s[:used[seg]]
    del part
    y = _outer_ring(ctx, red, P * N, outer) if no > 1 \
        else red.view(R, -1)
    y = y[list(shd.group_plan(ctx, axis)[3])].view(n, P, N)
    rows = mo._unscramble(y, dest).view(T, topk, N)
    w = tw.float()
    folded = rows[:, 0] * w[:, 0:1]
    for j in range(1, topk):
        folded = folded + rows[:, j] * w[:, j:j + 1]
    return folded.to(h.dtype)


def _check_form(kname: str, ctx, call, want, plain, fresh_pair, case: str,
                tol: float, fresh: int, extra: dict) -> dict:
    """One form of an overlap op against its references: ``call()`` bitwise
    ``want`` on a rerun, every group's replica the same, bitwise on
    ``fresh`` calls (``fresh_pair(i)`` gives the call's result and its
    reference), within ``tol`` of the plain version, every pad zero after
    the calls. Raises on failure."""
    import torch

    from triton_dist_tpu_torch.shmem import check_errors

    got, again = call(), call()
    reps = call(replicas=True)
    check_errors(ctx)
    pads = _pads_zero(ctx)
    ref = plain()
    fresh_ok = []
    for i in range(fresh):
        g, w = fresh_pair(i)
        fresh_ok.append(bool(torch.equal(g, w)))
        del g, w
        pads &= _pads_zero(ctx)
    check_errors(ctx)
    rec = {"kernel": kname, "case": case,
           **_kernel_vs_plain(got, again, ref), "tol": tol,
           "bitwise_reference": bool(torch.equal(got, want)),
           "replicas": int(reps.shape[0]),
           "replicas_bitwise": all(bool(torch.equal(r, got)) for r in reps),
           "fresh_calls_bitwise": all(fresh_ok),
           "pads_zero_after": pads and _pads_zero(ctx), **extra}
    del reps, ref
    if not (rec["bitwise_reference"] and rec["bitwise_repeat"]
            and rec["replicas_bitwise"] and rec["fresh_calls_bitwise"]
            and rec["pads_zero_after"] and rec["rel_err"] <= tol
            and all(v is not False for v in extra.values())):
        log(f"kernel {kname}", json.dumps(rec))
        raise AssertionError(f"{kname} {case} failed: {rec}")
    return rec


def check_tp_2d_ops(device, timed: bool = True, forms=TP_2D_FORMS,
                    ops=TP_OPS, fresh: int = FRESH_CALLS,
                    seed: int = 21) -> list[dict]:
    """B15 (``ag_gemm``) and B16 (``gemm_rs``) in each of ``forms`` at each
    of ``ops``'s widths, bf16, through their persistent contexts. B15's
    2-tier and group forms bitwise the one-axis kernel over as many ranks
    (and its composition from B2); B16's group form bitwise the one-axis
    kernel, its 2-tier form bitwise ``rs_2d_composition`` (the inner stage
    from B2 and the slot reduction, then B13) and within ``TP_OPS_TOL`` of
    the one-axis kernel; each on a rerun, in every group's replica and on
    ``fresh`` calls, within ``TP_OPS_TOL`` of its plain version, the
    workspace slots as the protocol leaves them, every pad zero after.
    Timed beside the one-axis kernel over the same ranks (both alone under
    ``torch.profiler``), the bound, the plain version and ``torch.matmul``
    of the whole product. A starved call of each form raises within
    ``HANG_LIMIT_S``. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import allgather_gemm as agg
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.shmem import device as shd
    from triton_dist_tpu_torch.utils.perf import perf_func

    gen = torch.Generator(device=device).manual_seed(seed)
    card = device.type == "cuda"

    def operands(M, K, N):
        a = torch.randn(M, K, generator=gen, device=device).bfloat16()
        b = (torch.randn(K, N, generator=gen, device=device) * 0.02) \
            .bfloat16()
        return a, b

    records = []
    for mesh, axis in forms:
        ctx = _mesh_2d(mesh, device)
        n = ctx.axis_size(axis)
        flat = _mesh(n, device)
        two = isinstance(axis, tuple)
        label = f"{mesh} over {_axis_label(axis)}"
        index = shd.group_plan(ctx, axis)[2]
        for name, op, M, K, N in ops:
            m = M // n
            a, b = operands(M, K, N)
            if op == "ag_gemm":
                layer = agg.create_ag_gemm_context(ctx, m, K, torch.bfloat16,
                                                   axis=axis)
                one = agg.create_ag_gemm_context(flat, m, K, torch.bfloat16)

                def reference(a, b, one=one):
                    return one(a, b)
            else:
                layer = grs.create_gemm_rs_context(ctx, m, N, torch.bfloat16,
                                                   axis=axis)
                one = grs.create_gemm_rs_context(flat, m, N, torch.bfloat16)
                if two:
                    def reference(a, b, ctx=ctx, axis=axis):
                        return rs_2d_composition(ctx, axis, a, b,
                                                 torch.bfloat16)[0]
                else:
                    def reference(a, b, one=one):
                        return one(a, b)
            want = reference(a, b)
            opf = agg.ag_gemm if op == "ag_gemm" else grs.gemm_rs

            def call(replicas=False, a=a, b=b, layer=layer, opf=opf,
                     ctx=ctx, axis=axis):
                return (opf(ctx, a, b, axis=axis, replicas=True) if replicas
                        else layer(a, b))

            def fresh_pair(i, M=M, K=K, N=N, layer=layer, reference=reference):
                ai, bi = operands(M, K, N)
                return layer(ai, bi), reference(ai, bi)

            extra = {}
            if op == "ag_gemm":
                plain = (lambda a=a, b=b, n=n: agg.ag_gemm_plain(a, b, n))
                extra["bitwise_b2_composition"] = bool(torch.equal(
                    want, ag_composition(a, b, n)))
            else:
                plain = ((lambda a=a, b=b, ctx=ctx, axis=axis:
                          grs.gemm_rs_2d_plain(ctx, a, b, axis)[0]) if two
                         else (lambda a=a, b=b, n=n: grs.gemm_rs_plain(a, b,
                                                                       n)))
                if two:
                    flat_out = one(a, b)
                    extra["rel_err_vs_one_axis"] = _rel(want, flat_out)
                    extra["within_tol_of_one_axis"] = \
                        extra["rel_err_vs_one_axis"] <= TP_OPS_TOL
                    del flat_out
                else:
                    extra["bitwise_b2_composition"] = bool(torch.equal(
                        want, rs_composition(a, b, n)[0]))
            rec = _check_form(op, ctx, call, want, plain, fresh_pair,
                              f"{name} bfloat16 {label} {M}x{K}x{N}",
                              TP_OPS_TOL, fresh, extra)
            # the slots as the protocol leaves them, after the last call
            layer(a, b)
            if op == "ag_gemm":
                shards = a.view(n, m, K)
                rec["slots_as_the_protocol_leaves_them"] = all(
                    bool(torch.equal(layer.ws[q, s], shards[s]))
                    for q in range(ctx.num_ranks) for s in range(n)
                    if s != index[q])
            elif two:
                rec["slots_as_the_protocol_leaves_them"] = bool(torch.equal(
                    layer.ws, rs_2d_composition(ctx, axis, a, b,
                                                torch.bfloat16)[1]))
            else:
                parts = rs_composition(a, b, n)[1]
                rec["slots_as_the_protocol_leaves_them"] = all(
                    bool(torch.equal(layer.ws[q, s],
                                     parts[s][index[q] * m:
                                              (index[q] + 1) * m]))
                    for q in range(ctx.num_ranks) for s in range(n))
                del parts
            if timed and card:
                kern = ("ag_gemm_2d_kernel" if two else "ag_gemm_kernel") \
                    if op == "ag_gemm" else "gemm_rs_kernel"
                matches = (kern, "rs_ring_kernel") if two and \
                    op == "gemm_rs" else (kern,)
                rec.update(_timings(lambda: layer(a, b), plain,
                                    lambda: torch.matmul(a, b), matches,
                                    gemm_bound(M, K, N, 2, 2, "bfloat16")))
                rec["library_call"] = "torch.matmul of the whole product"
                rec["one_axis_ms"] = perf_func(lambda: one(a, b))[1]
                rec["one_axis_kernel_device_ms"] = kernel_device_ms(
                    lambda: one(a, b), "ag_gemm_kernel" if op == "ag_gemm"
                    else "gemm_rs_kernel")
                rec["note"] = TP_2D_NOTE
            log(f"kernel {op} {label}", json.dumps(rec))
            if not rec["slots_as_the_protocol_leaves_them"]:
                raise AssertionError(f"{op} {label} left its slots wrong: "
                                     f"{rec}")
            records.append(rec)
            del a, b, want, layer, one
            if card:
                torch.cuda.empty_cache()
        # the hang check of each form at the first case of each op
        for opf in (agg.ag_gemm, grs.gemm_rs) if card else ():
            M, K, N = next(c[2:] for c in ops if c[1] == opf.__name__)
            a, b = operands(M, K, N)
            want = opf(ctx, a, b, axis=axis)
            rec = _hang_2d(f"{opf.__name__} {label}", ctx,
                           lambda silent_rank=None, opf=opf, a=a, b=b:
                           opf(ctx, a, b, axis=axis,
                               silent_rank=silent_rank), want)
            rec["form"] = label
            records.append(rec)
            del a, b, want
    return records


def run_tp_2d_forward(params, cfg, device, card: str, B: int = TP_2D_FWD["B"],
                      S: int = TP_2D_FWD["S"], axes=TP_2D_FWD["axes"],
                      gate: float = TP_RANKS_GATE) -> dict:
    """The main path of phase 20b: ``forward_tp_overlap`` at full width and
    depth on phase 15's B x S tokens over each of ``axes`` of (2, 2) under
    ``torch.inference_mode``, twice (the launches set to 0 just before each
    run and read just after: over ("a", "b") B15's relay form and B16's
    2-tier stage two a layer each with B13's ring after each stage, over b
    B15 and B16 two a layer; the rerun bitwise), timed between device
    synchronisations with its peak memory, beside the one-axis run over as
    many ranks; the logits within ``gate`` of that run's scale. Raises on
    failure."""
    import importlib

    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    rsm = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")
    gen = torch.Generator(device=device).manual_seed(19)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    L = cfg.n_layers
    kernels = dict(_tp_kernels(), reduce_scatter=rsm.reduce_scatter)

    card = device.type == "cuda"

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        kernels["ag_gemm"].launches_2d = 0
        kernels["gemm_rs"].launches_2d = 0
        if card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v.launches for k, v in kernels.items()}
        launches["ag_gemm_2d"] = kernels["ag_gemm"].launches_2d
        launches["gemm_rs_2d"] = kernels["gemm_rs"].launches_2d
        return out, wall, launches

    rec = {"card": card, "dtype": str(cfg.dtype), "layers": L, "B": B,
           "S": S, "tokens": B * S, "gate": gate, "axes": {}}
    ok = True
    with torch.inference_mode():
        for axis in axes:
            ctx = _mesh_2d("2x2", device)
            n = ctx.axis_size(axis)
            two = isinstance(axis, tuple)
            if card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            runs = []
            first = None
            for _ in range(2):
                logits, wall, launches = counted(
                    lambda: llama.forward_tp_overlap(ctx, params, tokens, cfg,
                                                     axis=axis))
                check_errors(ctx)
                runs.append({"wall_s": wall, "launches": launches})
                if first is None:
                    first = logits
                else:
                    rerun = bool(torch.equal(first, logits))
                del logits
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 if card \
                else None
            want = {"matmul": 0, "ag_gemm": 2 * L, "gemm_rs": 2 * L,
                    "slot_reduce": 0, "all_gather": 0,
                    "reduce_scatter": 2 * L if two else 0,
                    "ag_gemm_2d": 2 * L if two else 0,
                    "gemm_rs_2d": 2 * L if two else 0}
            ref, ref_wall, _ = counted(lambda: llama.forward_tp_overlap(
                _mesh(n, device), params, tokens, cfg))
            fams, dev_ops = device_time_by_family(
                lambda: llama.forward_tp_overlap(ctx, params, tokens, cfg,
                                                 axis=axis), card,
                (("B15", ("ag_gemm_kernel", "ag_gemm_2d_kernel")),
                 ("B16", ("gemm_rs_kernel",)), ("B13", ("rs_ring_kernel",)),
                 ("softmax", ("softmax",))))
            check_errors(ctx)
            busy = sum(fams.values())
            r = {"axis": _axis_label(axis), "ranks": n, "runs": runs,
                 "reruns_bit_identical": rerun,
                 "finite": bool(torch.isfinite(first).all()),
                 "peak_mem_gib": peak, "launches_expected": want,
                 "one_axis_wall_s": ref_wall,
                 "logit_rel_diff_vs_one_axis": _logit_rel(first, ref),
                 "argmax_agree_with_one_axis": (first.argmax(-1) == ref.argmax(
                     -1)).float().mean().item(),
                 "device_busy_s": busy,
                 "device_idle_share": 1 - busy / runs[-1]["wall_s"]
                 if busy else None,
                 "device_s_by_family": fams, "device_ops": dev_ops,
                 "pads_zero_after": _pads_zero(ctx), "note": TP_2D_NOTE}
            del first, ref
            ok &= (r["finite"] and rerun and r["pads_zero_after"]
                   and r["logit_rel_diff_vs_one_axis"] <= gate
                   and (not card or all(x["launches"] == want
                                        for x in runs)))
            rec["axes"][r["axis"]] = r
            log(f"forward_tp_overlap over {r['axis']} of (2, 2)",
                json.dumps(r))
    if not ok:
        raise AssertionError(f"forward_tp_overlap over two tiers or a group "
                             f"failed its checks: {rec}")
    return rec


def check_tp_2d_forward_f32(params, cfg, device, B: int = TP_2D_F32["B"],
                            S: int = TP_2D_F32["S"],
                            layers: int = TP_2D_F32["layers"],
                            tol: float = TP_2D_F32["tol"],
                            axes=TP_2D_FWD["axes"]) -> dict:
    """``forward_tp_overlap`` in f32 at full width on the first ``layers``
    layers of ``params`` over each of ``axes`` of (2, 2): the logits within
    ``tol`` of the dense ``forward``'s scale. Raises on failure."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.shmem import check_errors

    cfg = dataclasses.replace(cfg, n_layers=layers)
    params = dict(params, blocks={k: v[:layers]
                                  for k, v in params["blocks"].items()})
    gen = torch.Generator(device=device).manual_seed(22)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    rec = {"layers": layers, "B": B, "S": S, "tol": tol, "axes": {}}
    with torch.inference_mode():
        ref = llama.forward(params, tokens, cfg)
        for axis in axes:
            ctx = _mesh_2d("2x2", device)
            got = llama.forward_tp_overlap(ctx, params, tokens, cfg,
                                           axis=axis)
            check_errors(ctx)
            rec["axes"][_axis_label(axis)] = _logit_rel(got, ref)
            del got
    log("model forward_tp_overlap f32 over (2, 2)", json.dumps(rec))
    if max(rec["axes"].values()) > tol:
        raise AssertionError(f"forward_tp_overlap over (2, 2) disagrees with "
                             f"the dense forward in f32: {rec}")
    return rec


def check_tp_2d(params, cfg, device, card: str) -> dict:
    """Phase 20a-b on the 32-layer bf16 params: B15 and B16 over a group and
    over two tiers at TP widths, then the main path (the forward over
    ("a", "b") and over b of (2, 2), launches counted)."""
    import torch

    t0 = time.perf_counter()
    ops = check_tp_2d_ops(device)
    torch.cuda.empty_cache()
    forward = run_tp_2d_forward(params, cfg, device, card)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 20a-b took {seconds:.1f} s")
    return {"ops": ops, "forward": forward, "seconds": seconds}


def check_moe_tp_2d(params, cfg, device, timed: bool = True,
                    forms=MOE_2D_FORMS, tokens=MOE_TP_TOKENS,
                    block_m: int = MOE_TP_BLOCK_M, fresh: int = FRESH_CALLS,
                    seed: int = 23) -> dict:
    """Phase 20a's MoE half and 20d on layer 0's experts of phase 9's
    weights: at each of ``forms`` and ``tokens``, B19 bitwise the one-axis
    op over as many ranks, B20 bitwise the one-axis op over a group and
    bitwise ``moe_rs_2d_composition`` over two tiers (within ``GG_TOL`` of
    the one-axis op), each on a rerun, in every group's replica and on
    ``fresh`` calls, within ``GG_TOL`` of its plain version, padding rows
    zero, every pad zero after; a starved call raising within
    ``HANG_LIMIT_S``; timed beside the one-axis op, the bound and
    ``torch._grouped_mm``. Then ``moe_mlp_tp_overlap`` over ("a", "b") at
    each token count against ``moe_tp_reference`` and the one-axis block,
    the launches counted (the main path). Raises on any failure."""
    import importlib

    import torch

    from triton_dist_tpu_torch.models.moe import moe_mlp_tp_overlap
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import moe as mo
    from triton_dist_tpu_torch.shmem import check_errors
    from triton_dist_tpu_torch.utils.perf import perf_func

    rsm = importlib.import_module("triton_dist_tpu_torch.ops.reduce_scatter")
    card = device.type == "cuda"
    t0 = time.perf_counter()
    p = {k: v[0] for k, v in params["blocks"].items()}
    wr, wu, wd = p["w_router"], p["we_up"], p["we_down"]
    E, Dm, F = wu.shape
    topk = cfg.topk
    dtype = cfg.base.dtype
    name = str(dtype).split(".")[-1]

    def inputs(T, g):
        x = torch.randn(T, Dm, generator=g, device=device,
                        dtype=torch.float32).to(dtype)
        tw, ids = _route(x, wr, topk)
        ids[[1, ids.numel() - 2]] = -1
        rep = x.repeat_interleave(topk, 0)
        h = torch.nn.functional.silu(torch.randn(
            T * topk, F, generator=g, device=device)).to(dtype)
        return x, tw, ids, rep, h

    records = {"ag_moe_group_gemm": [], "moe_reduce_rs": [], "hang": [],
               "block": []}
    for mesh, axis in forms:
        ctx = _mesh_2d(mesh, device)
        n = ctx.axis_size(axis)
        flat = _mesh(n, device)
        two = isinstance(axis, tuple)
        label = f"{mesh} over {_axis_label(axis)}"
        for T in tokens:
            gen = torch.Generator(device=device).manual_seed(seed + T + n)
            x, tw, ids, rep, h = inputs(T, gen)
            for kname in ("ag_moe_group_gemm", "moe_reduce_rs"):
                rs = kname == "moe_reduce_rs"
                if rs:
                    def op(h, ids, tw, c=ctx, ax=axis, **kw):
                        return mo.moe_reduce_rs(c, h, ids, tw, wd, axis=ax,
                                                block_m=block_m, **kw)

                    def one(h, ids, tw):
                        return mo.moe_reduce_rs(flat, h, ids, tw, wd,
                                                block_m=block_m)

                    def reference(h, ids, tw, c=ctx, ax=axis):
                        if two:
                            return moe_rs_2d_composition(c, ax, h, ids, tw,
                                                         wd, block_m)
                        return one(h, ids, tw)
                    args = (h, ids, tw)
                    plain = (lambda c=ctx, ax=axis: mo.moe_reduce_rs_plain(
                        c, h, ids, tw, wd, axis=ax, block_m=block_m))
                else:
                    def op(rep, ids, tw, c=ctx, ax=axis, **kw):
                        return mo.ag_moe_group_gemm(c, rep, ids, wu, axis=ax,
                                                    block_m=block_m, **kw)

                    def one(rep, ids, tw):
                        return mo.ag_moe_group_gemm(flat, rep, ids, wu,
                                                    block_m=block_m)
                    reference = one
                    args = (rep, ids, tw)
                    plain = (lambda c=ctx, ax=axis: mo.ag_moe_group_gemm_plain(
                        c, rep, ids, wu, axis=ax, block_m=block_m))
                want = reference(*args)

                def call(replicas=False, op=op, args=args):
                    return op(*args, replicas=replicas) if replicas \
                        else op(*args)

                def fresh_pair(i, T=T, rs=rs, op=op, reference=reference):
                    g = torch.Generator(device=device).manual_seed(
                        seed + 1000 * (i + 1) + T + n)
                    _, tw_i, ids_i, rep_i, h_i = inputs(T, g)
                    a = (h_i if rs else rep_i, ids_i, tw_i)
                    return op(*a), reference(*a)

                extra = {}
                if rs and two:
                    extra["rel_err_vs_one_axis"] = _rel(want, one(*args))
                    extra["within_tol_of_one_axis"] = \
                        extra["rel_err_vs_one_axis"] <= GG_TOL[name]
                    # a token whose every row routes nowhere stays zero
                    idz = ids.clone()
                    idz[:topk] = -1
                    extra["unrouted_token_zero"] = not bool(
                        op(h, idz, tw)[0].any())
                if not rs:
                    extra["padding_rows_zero"] = not bool(
                        want[ids < 0].any())
                rec = _check_form(
                    kname, ctx, call, want, plain, fresh_pair,
                    f"{name} {label} T={T} top-{topk} E={E} D={Dm} F={F} "
                    f"block_m={block_m} (2 padding rows)", GG_TOL[name],
                    fresh, extra)
                rec.update({"tokens": T, "form": label})
                if timed and card:
                    kern = ("moe_rs_kernel" if rs else
                            "ag_moe_2d_kernel" if two else "ag_moe_kernel")
                    matches = (kern, "rs_ring_kernel") if rs and two \
                        else (kern,)
                    routed = ids[ids >= 0]
                    rec.update(_timings(
                        call, plain, None, matches, moe_tp_ranks_bound(
                            ids, T, F if rs else Dm, Dm if rs else F, n, 2,
                            name, rs)))
                    rec["one_axis_ms"] = perf_func(lambda: one(*args))[1]
                    rec["one_axis_kernel_device_ms"] = kernel_device_ms(
                        lambda: one(*args),
                        "moe_rs_kernel" if rs else "ag_moe_kernel")
                    rows = h[ids >= 0] if rs else rep[ids >= 0]
                    fn, why = (grouped_mm_f32_call(rows, routed, wd) if rs
                               else grouped_mm_call(rows, routed, wu))
                    rec["library_ms"] = perf_func(fn)[1] if fn else None
                    rec["library_call"] = (
                        "torch._grouped_mm of the whole gathered product"
                        + (" into f32 (no top-k fold)" if rs else ""))
                    if why:
                        rec["library_none_because"] = why
                    rec["note"] = TP_2D_NOTE
                log(f"kernel {kname} {label}", json.dumps(rec))
                records[kname].append(rec)
                if T == MOE_TP_HANG_TOKENS and card:
                    hang = _hang_2d(f"{kname} {label}", ctx,
                                    lambda silent_rank=None, op=op,
                                    args=args: op(*args,
                                                  silent_rank=silent_rank),
                                    want)
                    hang["form"] = label
                    records["hang"].append(hang)
                del want
            del x, tw, ids, rep, h
            if card:
                torch.cuda.empty_cache()

    # 20d, the main path: the block over ("a", "b") and over b of (2, 2) at
    # each token count, counted, then each held against the plain
    # reference and the one-axis block over as many ranks
    ctx = _mesh_2d("2x2", device)
    axes = (("a", "b"), "b")
    counted = (mo.ag_moe_group_gemm, mo.moe_reduce_rs, rsm.reduce_scatter,
               ag.all_gather, ag.all_gather_push_2d)
    xs = [torch.randn(T, Dm, generator=torch.Generator(
        device=device).manual_seed(seed + T), device=device,
        dtype=torch.float32).to(dtype) for T in tokens]
    if card:
        torch.cuda.synchronize()
    for k in counted:
        k.launches = 0
    mo.ag_moe_group_gemm.launches_2d = mo.moe_reduce_rs.launches_2d = 0
    t1 = time.perf_counter()
    outs = {_axis_label(axis): [moe_mlp_tp_overlap(
        ctx, x, wr, wu, wd, topk, axis=axis, block_m=block_m) for x in xs]
        for axis in axes}
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    check_errors(ctx)
    launches = {k.__name__: k.launches for k in counted}
    launches["ag_moe_group_gemm_2d"] = mo.ag_moe_group_gemm.launches_2d
    launches["moe_reduce_rs_2d"] = mo.moe_reduce_rs.launches_2d
    c = len(tokens)
    want = {"ag_moe_group_gemm": 2 * c, "moe_reduce_rs": 2 * c,
            "reduce_scatter": c, "all_gather": 2 * c,
            "all_gather_push_2d": 2 * c, "ag_moe_group_gemm_2d": c,
            "moe_reduce_rs_2d": c}
    for axis in axes:
        flat = _mesh(ctx.axis_size(axis), device)
        for T, x, out in zip(tokens, xs, outs[_axis_label(axis)]):
            ref = moe_tp_reference(x, wr, wu, wd, topk)
            one = moe_mlp_tp_overlap(flat, x, wr, wu, wd, topk,
                                     block_m=block_m)
            rec = {"form": f"2x2 over {_axis_label(axis)}", "tokens": T,
                   "dtype": name, "rel_err": _rel(out, ref),
                   "rel_err_one_axis": _rel(out, one), "tol": GG_TOL[name],
                   "finite": bool(torch.isfinite(out).all())}
            if timed and card:
                rec["ms"] = perf_func(lambda: moe_mlp_tp_overlap(
                    ctx, x, wr, wu, wd, topk, axis=axis,
                    block_m=block_m))[1]
                rec["one_axis_ms"] = perf_func(lambda: moe_mlp_tp_overlap(
                    flat, x, wr, wu, wd, topk, block_m=block_m))[1]
                rec["note"] = TP_2D_NOTE
            log("moe-tp block over (2, 2) vs reference", json.dumps(rec))
            if not (rec["finite"] and rec["rel_err"] <= rec["tol"]
                    and rec["rel_err_one_axis"] <= rec["tol"]):
                raise AssertionError(f"moe_mlp_tp_overlap over "
                                     f"{_axis_label(axis)} disagrees: {rec}")
            records["block"].append(rec)
            del ref, one
    check_errors(ctx)
    records["launches"] = launches
    records["launches_expected"] = want
    records["main_path_wall_s"] = wall
    log("moe-tp 2-D main path launches", json.dumps(
        {"launches": launches, "expected": want, "wall_s": wall}))
    if card and launches != want:
        raise AssertionError(f"the MoE-TP block over two tiers did not "
                             f"launch its kernels: {launches} != {want}")
    records["seconds"] = time.perf_counter() - t0
    log(f"phase 20a (MoE) and 20d took {records['seconds']:.1f} s")
    return records


def check_ag_gemm_engines(params, cfg, device, card: str,
                          meshes=AG_ENGINE_MESHES,
                          prefix: int = EP_PREFIX) -> dict:
    """Phase 20c: the first ``prefix`` requests of phase 9's trace through
    ``ShardedServingEngine(tp_impl="ag_gemm")`` on each of ``meshes`` with
    the fp8 wire: every mesh's streams bitwise the first's (2x1x1, B15 over
    the whole mesh; 2x1x2 and 2x2x2 run it over the TP axis's groups), every
    request finishing, the launches counted (each projection one B15 and
    one B9 gather at tp > 1, no B2). Reports tok/s and TTFT p50."""
    import torch

    from triton_dist_tpu_torch.ops import allgather_gemm as agg
    from triton_dist_tpu_torch.serving import (ShardedServingEngine,
                                               serving_mesh)
    from triton_dist_tpu_torch.shmem import check_errors

    t0 = time.perf_counter()
    card_run = device.type == "cuda"
    trace = make_trace(cfg.base, N_REQUESTS, 0)[:prefix]
    kernels = engine_kernels() + (agg.ag_gemm,)
    fp8 = torch.float8_e4m3fn
    golden, records = None, []
    for tp, sp, ep in meshes:
        def make():
            return ShardedServingEngine(params, cfg, serving_mesh(tp, sp, ep),
                                        device=device, wire_dtype=fp8,
                                        tp_impl="ag_gemm", **ENGINE)
        res, eng, wall, launches = serve(make, device, trace, kernels)
        check_errors(eng.ctx)
        c, hist = eng.metrics.counters, eng.metrics.hist
        want = engine_launches(eng)
        proj = want["matmul"] // tp
        want.update(matmul=0, ag_gemm=proj)
        golden = res if golden is None else golden
        rec = {"mesh": eng.mesh_desc, "tp_impl": "ag_gemm",
               "wire": "float8_e4m3fn", "requests": len(trace),
               "finished": c["requests_finished"],
               "tokens_generated": c["tokens_generated"],
               "preemptions": c["preemptions"], "dispatches": c["dispatches"],
               "prefill_chunks": c["prefill_chunks"], "wall_s": wall,
               "tok_per_s": c["tokens_generated"] / wall,
               "ttft_p50_s": hist["ttft_s"].percentile(50),
               "launches": launches, "launches_expected": want,
               "bitwise_2x1x1": res == golden,
               "first_difference": _first_difference(golden, res),
               "note": TP_2D_NOTE}
        log("ag_gemm engine", json.dumps(rec))
        ok = (rec["finished"] == len(trace)
              and all(len(res[i]) == m for i, (_, _, m) in enumerate(trace))
              and rec["bitwise_2x1x1"] and (not card_run
                                            or launches == want))
        del eng
        torch.cuda.empty_cache()
        records.append(rec)
        if not ok:
            raise AssertionError(f"the ag_gemm engine at {rec['mesh']} "
                                 f"failed its checks: {rec}")
    seconds = time.perf_counter() - t0
    log(f"phase 20c took {seconds:.1f} s")
    return {"runs": records, "seconds": seconds}


def tp_2d_kernels(tp2d: dict, moe: dict) -> list[dict]:
    """The ``kernels`` line's entries of phase 20: the 2-tier and group forms
    of B15 and B16 (headed by gate‖up / down over ("a", "b") of (2, 2), or
    over b), launched as the forward over that axis launched them, and of
    B19 and B20 (headed by the 4096-token case), launched as the 2-D main
    path and the ag_gemm engines launched them."""
    fwd = tp2d["forward"]["axes"]
    m20 = moe["moe_tp_2d"]
    engines = moe["ep"]["ag_gemm_engines"]["runs"]
    entries = []
    for op, replaces, kern in (
            ("ag_gemm", "triton_dist_tpu/ops/allgather_gemm.py:255",
             "ag_gemm"),
            ("gemm_rs", "triton_dist_tpu/ops/gemm_reduce_scatter.py:245",
             "gemm_rs")):
        for form, axis, main_mesh in (("2d", "a+b", "2x2 over a+b"),
                                      ("group", "b", "2x2 over b")):
            cases = [r for r in tp2d["ops"] if r.get("kernel") == op
                     and ((" over " + axis) in r["case"]
                          if form == "group" else "+" in r["case"])]
            main = next(r for r in cases if r["case"].startswith(
                TP_OPS_MAIN[op] + " ") and main_mesh in r["case"])
            launches = fwd[axis]["runs"][0]["launches"][
                f"{kern}_2d" if form == "2d" else kern]
            if op == "ag_gemm" and form == "group":
                launches += sum(r["launches"]["ag_gemm"] for r in engines)
            hangs = [r for r in tp2d["ops"] if "raised" in r
                     and r["kernel"].startswith(op)
                     and (("+" in r["form"]) == (form == "2d"))]
            entries.append({
                "name": f"{op} ({'2-tier' if form == '2d' else 'groups'})",
                "route": "cuda",
                "source": "triton_dist_tpu_torch/csrc/tp_overlap.cu",
                "with": ({"ag_gemm": "triton_dist_tpu_torch/csrc/"
                          "ag_relay_2d.cuh",
                          "gemm_rs": "triton_dist_tpu_torch/csrc/"
                          "reduce_scatter.cu"}[op] if form == "2d"
                         else None),
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in cases),
                **{k: main.get(k) for k in (
                    "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "one_axis_ms",
                    "one_axis_kernel_device_ms", "case")},
                "ranks_note": TP_2D_NOTE, "cases": cases + hangs})
    for kname, replaces in (("ag_moe_group_gemm",
                             "triton_dist_tpu/ops/moe.py:215"),
                            ("moe_reduce_rs",
                             "triton_dist_tpu/ops/moe.py:405")):
        for form, label in (("2d", "2x2 over a+b"), ("group", "2x2 over b")):
            cases = [r for r in m20[kname] if r["form"] == label]
            main = max(cases, key=lambda r: r["tokens"])
            hangs = [r for r in m20["hang"] if r["form"] == label
                     and r["kernel"].startswith(kname)]
            entries.append({
                "name": f"{kname} ({'2-tier' if form == '2d' else 'groups'})",
                "route": "cuda",
                "source": "triton_dist_tpu_torch/csrc/moe_tp.cu",
                "with": ({"ag_moe_group_gemm": "triton_dist_tpu_torch/csrc/"
                          "ag_relay_2d.cuh",
                          "moe_reduce_rs": "triton_dist_tpu_torch/csrc/"
                          "reduce_scatter.cu"}[kname] if form == "2d"
                         else None),
                "replaces": replaces,
                "launches": (m20["launches"][f"{kname}_2d"] if form == "2d"
                             else m20["launches"][kname]
                             - m20["launches"][f"{kname}_2d"]),
                "max_abs_err": max(r["max_abs_err"] for r in cases),
                **{k: main.get(k) for k in (
                    "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "one_axis_ms",
                    "one_axis_kernel_device_ms", "case")},
                "ranks_note": TP_2D_NOTE, "cases": cases + hangs})
    return entries


# ---------------------------------------------------------------------------
# phase 21: the EP MoE block in its deployed form at DeepSeek-infer width
# ---------------------------------------------------------------------------

# DeepSeek-infer's widths (d_model 7168, 64 experts of width 2048, top-8,
# 56 / 8 heads, vocab 129280) at the preset's own 4 layers, bf16, random
# weights from seed 21: 22.5 GB of experts, 3.7 GB of embeddings, the packed
# gate|up copy of layer 0 (3.8 GB) beside them
DEPLOYED_SEED = 21
# (a) the grouped GEMMs' forms on the block's aligned rows: T tokens top-8
# (one rank's 128, four ranks' 512) at the block's block_m there
DEPLOYED_GG = ((128, 16), (512, 64))
DEPLOYED_BLOCK_K = (256, 1024)
# (b) the block at n ranks, T = 128 token rows a rank, each form through
# the default (drop-proof) capacity T x top-8
DEPLOYED_BLOCK = dict(T=128, ranks=(1, 2, 4, 8), block_n=128)
# (c) the 2-tier layer on (major, minor) against the flat one-axis layer
DEPLOYED_2D = ((2, 2), (2, 4))
# (e) the fold of the expert edge's one-byte rows with their scales, at the
# deployed layer's rows at one and four ranks
DEPLOYED_COMBINE_RANKS = (1, 4)
# the fp8 forms of the block against the bf16 golden and against each
# other: max |diff| over the golden's max |value|. A row is quantised to
# fp8 e4m3fn (3 mantissa bits: up to 2^-4 of a value) on its way to the
# experts and its result on the way back; two such roundings of the
# largest values bound it
FP8_BLOCK_TOL = 0.125
# the fp8 expert edge's block against fp8_expert_block_reference (the same
# semantics written out plainly; only the order of the f32 sums differs):
# relative L2 over the block's rows. On an H100 sound blocks read
# 0.23-0.29% at 1-8 ranks; the post edge, another rounding of the same
# fp8 rows, reads 1.5% and the bf16 golden 4.7%, both outside
FP8_REF_L2_TOL = 0.01
# (d) moe_decode_step_sp with the deployed layer: B = 8 token rows a rank,
# a prompt teacher-forced, then greedy steps; bitwise its fp8 rank-major
# twin; step 0's logits within DEPLOYED_SP_TOL of the reference step's
# (decode_step_sp over fp8_expert_block_reference: the same fp8 semantics
# written out plainly) in phase 18's metric, max |diff| over max |logit|,
# and a control (the cache shard that holds the prompt zeroed, as phase
# 14's) outside. The limit is phase 18's SP_STEP0_TOL
DEPLOYED_SP = dict(B=8, prompt=8, steps=32, max_seq=64, ranks=(1, 2, 4))
DEPLOYED_SP_TOL = SP_STEP0_TOL
DEPLOYED_FORMS = (
    ("rank-major bf16", {}, False),
    ("expert-major bf16", dict(expert_major=True), False),
    ("fp8 post", dict(wire_dtype="fp8"), False),
    ("fp8 expert", dict(wire_dtype="fp8", dequant_edge="expert"), False),
    ("fp8 expert, expert-major", dict(wire_dtype="fp8", dequant_edge="expert",
                                      expert_major=True), False),
    ("deployed", dict(wire_dtype="fp8", dequant_edge="expert",
                      expert_major=True), True))
DEPLOYED_NOTE = ("every rank of the EP mesh shares the one card: times are "
                 "the kernels and their protocol on shared SMs and one HBM, "
                 "not NVLink")


def _deployed_counters():
    from triton_dist_tpu_torch.ops import all_to_all as ea
    from triton_dist_tpu_torch.ops import group_gemm as gg

    return (ea.all_to_all_push, ea.ep_dispatch, ea.ep_combine,
            gg.grouped_gemm_gated, gg.grouped_gemm)


def _zero_counters(counters) -> None:
    for k in counters:
        k.launches = 0
        if hasattr(k, "launches_by_form"):
            k.launches_by_form = {}


def _read_counters(counters) -> dict:
    out = {k.__name__: k.launches for k in counters}
    for k in counters:
        if hasattr(k, "launches_by_form"):
            out.update({f"{k.__name__}[{f}]": v
                        for f, v in k.launches_by_form.items()})
    return out


def deployed_bound(ids, H: int, N: int, n_w: int, x_esize: int,
                   n_blocks: int, scaled: bool) -> tuple[float, str]:
    """Least time of a grouped GEMM form: the used experts' ``n_w`` bf16
    weight matrices, the routed rows in at ``x_esize`` bytes a value (one
    byte on a quantised wire) and their bf16 results out, the scales, the
    block table and the bound each read or written once, against 2 * H * N
    bf16 tensor-core operations per routed row and weight matrix (one-byte
    rows are converted to bf16 for them)."""
    routed = ids[ids >= 0]
    rows, used = int(routed.numel()), int(routed.unique().numel())
    nbytes = (n_w * used * H * N * 2 + rows * H * x_esize + rows * N * 2
              + (4 * rows if scaled else 0) + 4 * n_blocks + 4)
    ops = 2 * n_w * rows * H * N
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS["bfloat16"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_deployed_kernels(device, w_gate, w_up, w_down, packed,
                           timed: bool = True, shapes=DEPLOYED_GG,
                           block_ks=DEPLOYED_BLOCK_K, seed: int = 21
                           ) -> list[dict]:
    """Phase 21a: B18 (``grouped_gemm_gated``) and B17 (``grouped_gemm``)
    in each option's form on the deployed block's aligned rows (T tokens
    top-8 from a seeded draw, rows bf16 and quantised per row to fp8 e4m3fn
    and int8 as the EP wire does): every form against its plain version at
    ``GG_TOL`` and bitwise on a second launch; the packed stream bitwise the
    two streams, every ring depth and every ``block_k`` bitwise the plain
    form. ``packed`` is ``pack_gated_weights(w_gate, w_up, 128)``. Timed
    (one call between CUDA events; the kernel alone from 20 back-to-back
    calls, ``batched_device_ms``) beside the plain versions, the bound,
    which no time may beat, and, where one call computes the same
    function, ``torch._grouped_mm``. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.ops import all_to_all as ea
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.utils.perf import perf_func

    E, H, F = w_gate.shape
    records = []
    for T, bm in shapes:
        gen = torch.Generator(device=device).manual_seed(seed + T)
        ids = torch.rand(T, E, generator=gen, device=device) \
            .topk(8, -1).indices.reshape(-1).to(torch.int32)
        g, valid, be, nb = gg.align_tokens_by_expert(ids, E, bm,
                                                     with_used_count=True)
        rows = torch.randn(T, H, generator=gen, device=device).to(
            torch.bfloat16).repeat_interleave(8, 0)
        x = torch.where(valid[:, None], rows[g.long()],
                        torch.zeros((), dtype=torch.bfloat16, device=device))
        quant = {}
        for wname, wdt in (("float8_e4m3fn", torch.float8_e4m3fn),
                           ("int8", torch.int8)):
            q, s = ea._quant(x, wdt)
            quant[wname] = (q.contiguous(), s.contiguous())
        used = int(nb) * bm
        h = gg.grouped_gemm_gated_plain(x, w_gate, w_up, be, bm, nb)
        hq = {w: ea._quant(h, dt) for w, dt in (
            ("float8_e4m3fn", torch.float8_e4m3fn), ("int8", torch.int8))}
        # (form, call args, keywords, the form whose bits it must equal)
        gated = [("bf16", (x, w_gate, w_up), {}, None)]
        for wname, (q, s) in quant.items():
            gated.append((f"{wname} row_scale", (q, w_gate, w_up),
                          dict(row_scale=s), None))
        q8, s8 = quant["float8_e4m3fn"]
        gated += [
            ("bf16 packed", (x, packed, None), dict(packed=True), "bf16"),
            ("float8_e4m3fn row_scale packed", (q8, packed, None),
             dict(row_scale=s8, packed=True), "float8_e4m3fn row_scale")]
        gated += [(f"bf16 block_k={bk}", (x, w_gate, w_up),
                   dict(block_k=bk), "bf16") for bk in block_ks]
        gated += [(f"bf16 depth={d}", (x, w_gate, w_up),
                   dict(prefetch_depth=d), "bf16") for d in (2, 3)]
        gated += [(f"float8_e4m3fn row_scale packed depth={d}",
                   (q8, packed, None), dict(row_scale=s8, packed=True,
                                        prefetch_depth=d),
                   "float8_e4m3fn row_scale packed") for d in (2, 3)]
        plain_forms = [("bf16", (h, w_down), {}, None)]
        for wname, (q, s) in hq.items():
            plain_forms.append((f"{wname} row_scale", (q, w_down),
                                dict(row_scale=s), None))
        plain_forms += [(f"bf16 block_k={bk}", (h, w_down),
                         dict(block_k=bk), "bf16") for bk in block_ks]
        outs = {}
        for kname, fn, plain, forms, N, n_w in (
                ("grouped_gemm_gated", gg.grouped_gemm_gated,
                 gg.grouped_gemm_gated_plain, gated, F, 2),
                ("grouped_gemm", gg.grouped_gemm, gg.grouped_gemm_plain,
                 plain_forms, H, 1)):
            for form, args, kw, partner in forms:
                call = functools.partial(fn, *args, be, block_m=bm,
                                         n_blocks_used=nb, masked=False,
                                         **kw)
                out, out2 = call(), call()
                pkw = {k: v for k, v in kw.items() if k != "prefetch_depth"}
                ref = plain(*args, be, block_m=bm, n_blocks_used=nb, **pkw)
                outs[kname, form] = out
                rec = {"kernel": kname, "form": form, "T": T,
                       "case": f"{form}: T={T} top-8 E={E} K={args[0].shape[1]}"
                               f" N={N} block_m={bm}",
                       "rows": int(valid.sum()), "aligned_rows": x.shape[0],
                       "used_blocks": int(nb),
                       "rel_err": _rel(out[:used], ref[:used]),
                       "max_abs_err": (out[:used].float() - ref[:used]
                                       .float()).abs().max().item(),
                       "tol": GG_TOL["bfloat16"],
                       "bitwise_repeat": bool(torch.equal(out[:used],
                                                          out2[:used]))}
                if partner is not None:
                    rec["bitwise_as"] = partner
                    rec["bitwise_partner"] = bool(torch.equal(
                        out[:used], outs[kname, partner][:used]))
                if timed:
                    rec["ms"] = perf_func(call, iters=10)[1]
                    rec["bound_ms"], rec["bound_by"] = deployed_bound(
                        ids, args[0].shape[1], N, n_w,
                        args[0].element_size(), be.numel(),
                        "row_scale" in kw)
                    rec["kernel_device_ms"] = batched_device_ms(call)
                    rec["plain_ms"] = perf_func(lambda: plain(
                        *args, be, block_m=bm, n_blocks_used=nb, **pkw),
                        iters=2, warmup_iters=1)[1]
                    if n_w == 1 and form.startswith("bf16"):
                        routed = args[0][valid]
                        lib, why = grouped_mm_call(
                            routed, ids[ids >= 0].sort(stable=True).values,
                            w_down)
                        rec["library_ms"] = perf_func(lib)[1] if lib else None
                    else:
                        rec["library_ms"], why = None, (
                            "no single PyTorch call computes silu(x@Wg) * "
                            "(x@Wu)" if n_w == 2 else "no single PyTorch "
                            "call scales one-byte rows by a row scale "
                            "through bf16 grouped weights")
                    if why:
                        rec["library_none_because"] = why
                    # no time may beat the least the card can take
                    rec["at_or_above_bound"] = min(
                        rec["ms"], rec["kernel_device_ms"]) >= rec["bound_ms"]
                log(f"kernel {kname} [{form}]", json.dumps(rec))
                if not (rec["rel_err"] <= rec["tol"] and rec["bitwise_repeat"]
                        and rec.get("bitwise_partner", True)
                        and rec.get("at_or_above_bound", True)):
                    raise AssertionError(f"{kname} [{form}] disagrees: {rec}")
                records.append(rec)
        del outs, h, hq, quant, x
    return records


def _fp8_rows(x):
    """Per-row fp8 e4m3fn rows and their f32 scales, written out plainly:
    the scale is the row's max |value| times the f32 reciprocal of 448 (1
    for a zero row), the rows divided by it and rounded to fp8."""
    import torch

    xf = x.float()
    amax = xf.abs().amax(-1)
    inv = torch.ones((), dtype=torch.float32, device=x.device) / 448.0
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    return (xf / scale[:, None]).to(torch.float8_e4m3fn), scale


def fp8_expert_block_reference(x, router_w, we_gate, we_up, we_down,
                               topk: int, sums=None):
    """The MoE block over the fp8 expert edge written out plainly, sharing
    no code with the port's: the f32 router, softmax and renormalised
    top-k; each token row quantised to fp8 with its scale; for each expert
    its routed rows as f32, silu(s * (q @ Wg)) * (s * (q @ Wu)) in f32,
    cast, then @ Wd in f32, cast; each result row quantised to fp8 again;
    then the weighted sum over k in k order in f32 of the rows times their
    scales, cast once. The semantics of ``dequant_edge="expert"`` on a
    drop-free capacity; only the order of the f32 sums differs from the
    kernels'. ``sums=torch.float64`` takes the expert products in f64
    (rounded to f32 before the scale): the same function summed at another
    precision, the floor of what the order of the sums alone moves."""
    import torch

    sums = sums or torch.float32

    T, D = x.shape
    probs = torch.softmax(x.float() @ router_w, -1)
    vals, ids = probs.topk(topk, -1)
    vals = vals / vals.sum(-1, keepdim=True)
    q, s = _fp8_rows(x)
    y = torch.zeros(T, topk, D, dtype=torch.float32, device=x.device)
    for e in range(we_gate.shape[0]):
        t_idx, j_idx = (ids == e).nonzero(as_tuple=True)
        if t_idx.numel() == 0:
            continue
        xe, se = q[t_idx].to(sums), s[t_idx, None]
        g = (xe @ we_gate[e].to(sums)).float() * se
        u = (xe @ we_up[e].to(sums)).float() * se
        h = (torch.nn.functional.silu(g) * u).to(x.dtype)
        ye = (h.to(sums) @ we_down[e].to(sums)).to(x.dtype)
        yq, ys = _fp8_rows(ye)
        y[t_idx, j_idx] = yq.float() * ys[:, None]
    acc = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for j in range(topk):
        acc = acc + y[:, j] * vals[:, j:j + 1]
    return acc.to(x.dtype)


def check_deployed_combine(params, cfg, device, timed: bool = True,
                           ranks=DEPLOYED_COMBINE_RANKS,
                           T: int = DEPLOYED_BLOCK["T"], seed: int = 25
                           ) -> list[dict]:
    """Phase 21e: ``ep_combine`` with a scale (``ep_combine_scaled_kernel``,
    the fold of the expert edge's return trip) against ``ep_combine_plain``
    on the same card tensors, at the deployed layer's shapes at n ranks:
    one-byte rows (fp8 e4m3fn and int8, each row quantised with its scale
    as the wire does) [n * n * cap, d_model] of the expert-major fp8 layer,
    the positions of layer 0's router's top-8 on seeded rows as ``combine``
    computes them (drops included) and its weights, into bf16. The kernel
    and the plain version take the same f32 products and sums in the same
    order, so bitwise, and bitwise on a second launch. Timed beside the
    plain version and the bound (bytes). Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.models.moe import router_topk
    from triton_dist_tpu_torch.ops import all_to_all as ea
    from triton_dist_tpu_torch.utils.perf import perf_func

    router_w = params["blocks"]["w_router"][0]
    D, k = cfg.base.d_model, cfg.topk
    card = device.type == "cuda"
    records = []
    for n in ranks:
        lay = _deployed_layer(_mesh(n, device), T, cfg, dict(
            wire_dtype="fp8", dequant_edge="expert", expert_major=True))
        cap = lay.a2a.capacity
        P = n * n * cap
        gen = torch.Generator(device=device).manual_seed(seed + n)
        x = torch.randn(n * T, D, generator=gen, device=device).to(
            cfg.base.dtype)
        w, ids = router_topk(x, router_w, k)
        dest, slot, valid = lay.preprocess(ids.to(torch.int32))
        base = (torch.arange(n, device=device) * (n * cap)) \
            .repeat_interleave(T)
        pos = torch.where(valid, base[:, None] + dest.long() * cap
                          + slot.long(), torch.full_like(slot, -1,
                                                         dtype=torch.long)) \
            .to(torch.int32).reshape(-1).contiguous()
        w = w.float().contiguous()
        rows = torch.randn(P, D, generator=gen, device=device).to(
            torch.bfloat16)
        pairs = int(valid.sum())
        for wname, wdt in (("float8_e4m3fn", torch.float8_e4m3fn),
                           ("int8", torch.int8)):
            q, sc = ea._quant(rows, wdt)
            q, sc = q.contiguous(), sc.float().reshape(P).contiguous()

            def call(q=q, sc=sc):
                return ea.ep_combine(q, pos, w, scale=sc,
                                     out_dtype=torch.bfloat16)

            def plain(q=q, sc=sc):
                return ea.ep_combine_plain(q, pos, w, scale=sc,
                                           out_dtype=torch.bfloat16)

            out, out2, ref = call(), call(), plain()
            rec = {"kernel": "ep_combine", "form": f"{wname} scaled",
                   "ranks": n,
                   "case": f"{wname} scaled: {n} ranks x T={T} top-{k}, "
                           f"P={P} (n * n * cap {cap}), D={D}, "
                           f"{n * T * k - pairs} of {n * T * k} pairs "
                           f"dropped, into bf16",
                   "pairs": pairs,
                   "max_abs_err": (out.float() - ref.float()).abs().max()
                   .item(),
                   "tol": EP_TOL,
                   "bitwise_plain": bool(torch.equal(out, ref)),
                   "bitwise_repeat": bool(torch.equal(out, out2)),
                   "finite": bool(torch.isfinite(out.float()).all())}
            if timed and card:
                rec["ms"] = perf_func(call)[1]
                # the named rows once (one byte a value) with their scales,
                # positions and weights in, the tokens' bf16 rows out
                rec["bound_ms"], rec["bound_by"] = ep_rows_bound(
                    pairs * (D + 4) + n * T * k * 8 + n * T * D * 2)
                rec["kernel_device_ms"] = kernel_device_ms(
                    call, "ep_combine_scaled_kernel", calls=5, per_call=1,
                    floor_ms=rec["bound_ms"])
                rec["plain_ms"] = perf_func(plain, iters=5)[1]
                rec["library_ms"] = None
                rec["library_none_because"] = (
                    "no PyTorch call gathers fp8 or int8 rows by position "
                    "and folds them with a row scale and a weight")
                rec["at_or_above_bound"] = min(
                    rec["ms"], rec["kernel_device_ms"]) >= rec["bound_ms"]
            log(f"kernel ep_combine [{wname} scaled]", json.dumps(rec))
            records.append(rec)
            if not (rec["bitwise_plain"] and rec["bitwise_repeat"]
                    and rec["finite"] and rec.get("at_or_above_bound", True)):
                raise AssertionError(f"ep_combine [{wname} scaled] "
                                     f"disagrees: {rec}")
        del rows, x
    return records


def _deployed_layer(ctx, T: int, cfg, form_kw: dict, axis="x"):
    import torch

    from triton_dist_tpu_torch.layers import EPAll2AllLayer

    kw = dict(form_kw)
    if kw.get("wire_dtype") == "fp8":
        kw["wire_dtype"] = torch.float8_e4m3fn
    return EPAll2AllLayer.create(ctx, T, cfg.base.d_model, cfg.topk,
                                 cfg.num_experts, axis=axis,
                                 dtype=cfg.base.dtype, **kw)


def _block_ms(call, card: bool) -> dict:
    """ms a block (CUDA events over 5 calls) and one call's device time
    and idle share under the profiler."""
    import torch

    from triton_dist_tpu_torch.utils.perf import perf_func

    if not card:
        return {}
    ms = perf_func(call, iters=5, warmup_iters=1)[1]
    fams, ops = device_time_by_family(
        call, True, (("grouped_gemm", ("grouped_gemm",)),
                     ("ep_wire", ("a2a",)),
                     ("ep_slots", ("ep_dispatch", "ep_combine"))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = sum(fams.values())
    return {"ms": ms, "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall,
            "device_s_by_family": fams, "device_ops": ops}


def _block_m_for(layers) -> int:
    """The largest of 64, 32, 16 that divides every expert-major layer's
    per-expert budget (so each takes the fast path)."""
    caps = [lay.a2a.capacity_per_expert for lay in layers
            if not lay.is_2d and lay.a2a.expert_major]
    return next(bm for bm in (64, 32, 16) if all(c % bm == 0 for c in caps))


def _routed_ok(layer, x, router_w):
    """Per token, whether none of its k rows drops in ``layer``'s routing."""
    return layer.preprocess(_router_ids(x, router_w,
                                        layer.a2a.topk))[2].all(-1)


def check_deployed_block(params, cfg, device, packed, timed: bool = True,
                         spec=DEPLOYED_BLOCK, seed: int = 22,
                         counts: dict | None = None) -> list[dict]:
    """Phase 21b: ``moe_mlp_ep_overlap`` on layer 0 at n ranks of the one
    card, T rows a rank, in the forms of ``DEPLOYED_FORMS``: rank-major
    bf16 (the golden), expert-major bf16 (bitwise the golden on every token
    none of whose rows drops; drops counted), the fp8 wire post and expert
    (within ``FP8_BLOCK_TOL`` of the golden and of each other), the expert
    edge on expert-major slots, and the deployed form (that plus the packed
    gate|up stream, bitwise it). The fp8 expert edge and the deployed form
    (on the tokens none of whose rows drops) within ``FP8_REF_L2_TOL`` in
    relative L2 of ``fp8_expert_block_reference``, the same fp8 semantics
    written out plainly; the post edge's and the golden's distances from it
    reported. ``block_m`` divides every per-expert
    budget. ms a block, idle share, the path (``em_fast`` or align) and
    launches per form; the deployed form's launches add to ``counts``.
    Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.models.moe import moe_mlp_ep_overlap
    from triton_dist_tpu_torch.shmem import check_errors

    p = {k: v[0] for k, v in params["blocks"].items()}
    ws = (p["w_router"], p["we_gate"], p["we_up"], p["we_down"])
    D, T = cfg.base.d_model, spec["T"]
    card = device.type == "cuda"
    counters = _deployed_counters()
    records = []
    for n in spec["ranks"]:
        ctx = _mesh(n, device)
        gen = torch.Generator(device=device).manual_seed(seed + n)
        x = torch.randn(n * T, D, generator=gen, device=device).to(
            cfg.base.dtype)
        layers = {name: _deployed_layer(ctx, T, cfg, kw)
                  for name, kw, _ in DEPLOYED_FORMS}
        bm = _block_m_for(layers.values())
        outs, rec = {}, {"ranks": n, "T": T, "block_m": bm, "forms": {},
                         "note": DEPLOYED_NOTE if n > 1 else None}
        for name, _, pack in DEPLOYED_FORMS:
            lay = layers[name]
            kw = dict(block_m=bm, block_n=spec["block_n"],
                      we_gate_up_packed=packed if pack else None)

            def call(lay=lay, kw=kw):
                return moe_mlp_ep_overlap(ctx, lay, x, *ws, **kw)

            _zero_counters(counters)
            outs[name] = call()
            if card:
                torch.cuda.synchronize()
            launches = _read_counters(counters)
            if name == "deployed" and counts is not None:
                for k, v in launches.items():
                    counts[k] = counts.get(k, 0) + v
            a = lay.a2a
            f = {"path": ("em_fast" if a.expert_major
                          and a.capacity_per_expert % bm == 0 else "align"),
                 "capacity": a.capacity, "launches": launches,
                 "launches_as_expected": (not card or all(
                     launches[k] == v for k, v in (
                         ("grouped_gemm_gated", 1), ("grouped_gemm", 1),
                         ("all_to_all_push", 2), ("ep_dispatch", 1),
                         ("ep_combine", 1))))}
            if a.expert_major:
                f["capacity_per_expert"] = a.capacity_per_expert
                ok = _routed_ok(lay, x, ws[0])
                f["dropped_tokens"] = int((~ok).sum())
                f["dropped_rows"] = int((~lay.preprocess(
                    _router_ids(x, ws[0], cfg.topk))[2]).sum())
            f.update(_block_ms(call, card) if timed else {})
            rec["forms"][name] = f
        gold = outs["rank-major bf16"]
        ok_em = _routed_ok(layers["expert-major bf16"], x, ws[0])
        ok_fp8 = _routed_ok(layers["deployed"], x, ws[0])
        scale = gold.float().abs().max().clamp(min=1e-30)
        ref = fp8_expert_block_reference(x, *ws, cfg.topk)
        rec["vs_fp8_reference"] = {
            name: {"rel_l2": _rel_l2(outs[name][ok], ref[ok]),
                   "rel_diff": _logit_rel(outs[name][ok].float(),
                                          ref[ok].float())}
            for name, ok in (("fp8 expert", slice(None)),
                             ("deployed", ok_fp8), ("fp8 post", slice(None)),
                             ("rank-major bf16", slice(None)))}
        rec["checks"] = {
            "finite": all(bool(torch.isfinite(o.float()).all())
                          for o in outs.values()),
            "expert_major_bitwise_where_no_drop": bool(torch.equal(
                outs["expert-major bf16"][ok_em], gold[ok_em])),
            "fp8_post_vs_golden": ((outs["fp8 post"].float() - gold.float())
                                   .abs().max() / scale).item(),
            "fp8_expert_vs_golden": ((outs["fp8 expert"].float()
                                      - gold.float()).abs().max()
                                     / scale).item(),
            "fp8_expert_vs_post": ((outs["fp8 expert"].float()
                                    - outs["fp8 post"].float()).abs().max()
                                   / scale).item(),
            "tol": FP8_BLOCK_TOL,
            "expert_major_fp8_bitwise_where_no_drop": bool(torch.equal(
                outs["fp8 expert, expert-major"][ok_fp8],
                outs["fp8 expert"][ok_fp8])),
            "packed_bitwise_two_streams": bool(torch.equal(
                outs["deployed"], outs["fp8 expert, expert-major"]))}
        c = rec["checks"]
        log(f"deployed EP block n={n}", json.dumps(rec))
        check_errors(ctx)
        records.append(rec)
        if not (c["finite"] and c["expert_major_bitwise_where_no_drop"]
                and c["expert_major_fp8_bitwise_where_no_drop"]
                and c["packed_bitwise_two_streams"]
                and max(c["fp8_post_vs_golden"], c["fp8_expert_vs_golden"],
                        c["fp8_expert_vs_post"]) <= FP8_BLOCK_TOL
                and all(rec["vs_fp8_reference"][k]["rel_l2"]
                        <= FP8_REF_L2_TOL for k in ("fp8 expert",
                                                    "deployed"))
                and all(f["launches_as_expected"]
                        for f in rec["forms"].values())):
            raise AssertionError(f"the deployed EP block failed at n={n}: "
                                 f"{rec}")
        del outs, x, layers
    return records


def _router_ids(x, router_w, topk: int):
    import torch

    from triton_dist_tpu_torch.models.moe import router_topk

    return router_topk(x, router_w, topk)[1].to(torch.int32)


def check_deployed_2d(params, cfg, device, timed: bool = True,
                      meshes=DEPLOYED_2D, T: int = DEPLOYED_BLOCK["T"],
                      seed: int = 23) -> list[dict]:
    """Phase 21c: ``moe_mlp_ep_overlap`` on layer 0 over a 2-tier layer on
    (major, minor) meshes, with the bf16 wire and the fp8 wire on the expert
    edge, against the flat one-axis layer over as many ranks with the same
    wire: the bf16 block bitwise the flat one (each row's experts see the
    same rows; the fold sums the same k rows in the same order), the fp8
    one within ``FP8_BLOCK_TOL`` and reported bitwise or not (each row is
    quantised once at its source and its result once at the expert, on both
    paths). ms a block beside the flat layer's. Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.models.moe import moe_mlp_ep_overlap
    from triton_dist_tpu_torch.shmem import (check_errors,
                                             initialize_distributed)

    p = {k: v[0] for k, v in params["blocks"].items()}
    ws = (p["w_router"], p["we_gate"], p["we_up"], p["we_down"])
    D = cfg.base.d_model
    card = device.type == "cuda"
    records = []
    for shape in meshes:
        n = shape[0] * shape[1]
        ctx2 = initialize_distributed(("a", "b"), shape, device=device)
        ctx1 = _mesh(n, device)
        gen = torch.Generator(device=device).manual_seed(seed + n)
        x = torch.randn(n * T, D, generator=gen, device=device).to(
            cfg.base.dtype)
        for wire, kw in (("bf16", {}), ("fp8 expert", dict(
                wire_dtype="fp8", dequant_edge="expert"))):
            lay2 = _deployed_layer(ctx2, T, cfg, kw, axis=("a", "b"))
            lay1 = _deployed_layer(ctx1, T, cfg, kw)

            def two(lay2=lay2):
                return moe_mlp_ep_overlap(ctx2, lay2, x, *ws, block_m=64)

            def flat(lay1=lay1):
                return moe_mlp_ep_overlap(ctx1, lay1, x, *ws, block_m=64)

            got, ref = two(), flat()
            rel = ((got.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            rec = {"mesh": list(shape), "wire": wire, "T": T,
                   "cap1": lay2.a2a.cap1, "cap2": lay2.a2a.cap2,
                   "bitwise_flat": bool(torch.equal(got, ref)),
                   "rel_vs_flat": rel,
                   "tol": 0.0 if wire == "bf16" else FP8_BLOCK_TOL,
                   "note": DEPLOYED_NOTE}
            if timed and card:
                rec["two_tier"] = _block_ms(two, True)
                rec["flat"] = _block_ms(flat, True)
            log("deployed EP block 2-tier", json.dumps(rec))
            check_errors(ctx2)
            records.append(rec)
            if not ((rec["bitwise_flat"] if wire == "bf16"
                     else rel <= FP8_BLOCK_TOL)
                    and bool(torch.isfinite(got.float()).all())):
                raise AssertionError(f"the 2-tier EP block disagrees with "
                                     f"the flat one: {rec}")
    return records


def _deployed_sp_run(params, cfg, device, n: int, kw: dict, prompt,
                     steps: int, max_seq: int, teacher=None,
                     zero_rank: int | None = None, ffn=None) -> dict:
    """``moe_decode_step_sp`` at n ranks with the layer of ``kw``: the
    prompt teacher-forced, then ``steps`` greedy steps (or the tokens of
    ``teacher``). Returns each step's logits, the tokens, ms a step and
    the stepped part's launches. ``zero_rank`` zeroes that rank's shard of
    the cache in every layer before the prompt's last token (the
    control). With ``ffn(h, p)`` the step is ``decode_step_sp`` with that
    MoE block in place of the EP layer's."""
    import torch

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models.moe import moe_decode_step_sp
    from triton_dist_tpu_torch.shmem import check_errors

    B, P = prompt.shape
    ctx = _mesh(n, device)
    layer = _deployed_layer(ctx, B // n, cfg, kw)
    cache = llama.init_kv_cache(cfg.base, B, max_seq, device=device)
    if n > 1:
        cache = llama.shard_kv_cache(cache, n)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)

    def step(tok, pos):
        if ffn is not None:
            return llama.decode_step_sp(ctx, params, tok, pos, cfg.base,
                                        cache, axis="x", ffn=ffn)[0]
        return moe_decode_step_sp(ctx, layer, params, tok, pos, cfg, cache,
                                  sp_axis="x")[0]

    for i in range(P):
        if i == P - 1 and zero_rank is not None:
            cache["k"][:, zero_rank].zero_()
            cache["v"][:, zero_rank].zero_()
        logits = step(prompt[:, i].contiguous(), i)
    counters = _moe_sp_launch_counters()
    sync()
    _zero_counters(counters)
    toks, logits_all = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        token = (teacher[:, i] if teacher is not None
                 else logits.argmax(-1).to(torch.int32)).contiguous()
        toks.append(token)
        logits_all.append(logits)
        logits = step(token, P + i)
    sync()
    seconds = time.perf_counter() - t0
    check_errors(ctx)
    return {"logits": logits_all, "tokens": torch.stack(toks, 1),
            "ms_per_step": seconds / steps * 1e3,
            "launches": _read_counters(counters)}


def check_deployed_decode(params, cfg, device, card: str,
                          spec=DEPLOYED_SP, seed: int = 24,
                          counts: dict | None = None) -> dict:
    """Phase 21d: ``moe_decode_step_sp`` at the preset's depth with the
    deployed layer (expert-major slots, the fp8 wire on the expert edge)
    at 1, 2 and 4 ranks, B rows a rank: a seeded prompt teacher-forced,
    then greedy steps. Fed the same tokens: its rank-major twin (the fp8
    expert edge on rank-major slots; a per-expert budget of 32 never drops
    a decode row, so every step bitwise); the reference, ``decode_step_sp``
    with ``fp8_expert_block_reference`` as its MoE block (the same fp8
    semantics written out plainly, the same attention); the fp8 "post"
    layer (the same wire, the rows dequantised to bf16 before bf16 GEMMs:
    another rounding of the same quantised rows) and the rank-major bf16
    layer. The gate holds step 0's logits against the reference's in
    phase 18's metric (max |diff| over the reference's max |logit|) within
    ``DEPLOYED_SP_TOL``, phase 18's limit, and a control (the cache shard
    that holds the prompt zeroed in every layer before its last token, at
    the largest rank count, as phase 14's) outside it; the distances from
    the post and the bf16 layers are reported beside it, and the floor:
    the reference summed in f64 against the reference. Every kernel of
    the path launched its count a layer-step; ms a step. The deployed
    runs' launches add to ``counts``. Raises on any failure."""
    import torch

    L = cfg.base.n_layers
    rec = {"card": card, "B_per_rank": spec["B"], "prompt": spec["prompt"],
           "steps": spec["steps"], "layers": L, "step0_tol": DEPLOYED_SP_TOL,
           "ranks": {}}
    deployed = dict(wire_dtype="fp8", dequant_edge="expert",
                    expert_major=True)
    twin = dict(wire_dtype="fp8", dequant_edge="expert")
    post = dict(wire_dtype="fp8")

    def reference(h, p, sums=None):
        return fp8_expert_block_reference(h, p["w_router"], p["we_gate"],
                                          p["we_up"], p["we_down"], cfg.topk,
                                          sums)

    def reference_f64(h, p):
        return reference(h, p, torch.float64)

    def dist(a, b):
        return {"step0_rel_diff": _logit_rel(a[0].float(), b[0].float()),
                "step0_rel_l2": _rel_l2(a[0], b[0]),
                "max_step_rel_diff": max(_logit_rel(x.float(), y.float())
                                         for x, y in zip(a, b)),
                "max_step_rel_l2": max(_rel_l2(x, y) for x, y in zip(a, b))}

    def agree(logits, tokens):
        return float((torch.stack([g.argmax(-1) for g in logits], 1)
                      == tokens).float().mean())

    ok = True
    for n in spec["ranks"]:
        B = spec["B"] * n
        gen = torch.Generator(device=device).manual_seed(seed + n)
        prompt = torch.randint(1, cfg.base.vocab_size, (B, spec["prompt"]),
                               generator=gen, device=device,
                               dtype=torch.int32)
        run = _deployed_sp_run(params, cfg, device, n, deployed, prompt,
                               spec["steps"], spec["max_seq"])
        if counts is not None:
            for k, v in run["launches"].items():
                counts[k] = counts.get(k, 0) + v
        runs = {name: _deployed_sp_run(params, cfg, device, n, kw, prompt,
                                       spec["steps"], spec["max_seq"],
                                       teacher=run["tokens"], ffn=ffn)
                for name, kw, ffn in (("twin", twin, None),
                                      ("reference", {}, reference),
                                      ("reference_f64", {}, reference_f64),
                                      ("post", post, None),
                                      ("bf16", {}, None))}
        ref = runs["reference"]["logits"]
        r = {"deployed_ms_per_step": run["ms_per_step"],
             "fp8_rank_major_ms_per_step": runs["twin"]["ms_per_step"],
             "fp8_post_ms_per_step": runs["post"]["ms_per_step"],
             "bf16_rank_major_ms_per_step": runs["bf16"]["ms_per_step"],
             "bitwise_fp8_rank_major": all(
                 torch.equal(a, b) for a, b in zip(run["logits"],
                                                   runs["twin"]["logits"])),
             "deployed_vs_reference": dist(run["logits"], ref),
             "reference_f64_vs_reference": dist(
                 runs["reference_f64"]["logits"], ref),
             "post_vs_reference": dist(runs["post"]["logits"], ref),
             "deployed_vs_post": dist(run["logits"],
                                      runs["post"]["logits"]),
             "deployed_vs_bf16": dist(run["logits"], runs["bf16"]["logits"]),
             "post_vs_bf16": dist(runs["post"]["logits"],
                                  runs["bf16"]["logits"]),
             "greedy_tokens_equal_argmax_of_reference": agree(
                 ref, run["tokens"]),
             "greedy_tokens_equal_argmax_of_post": agree(
                 runs["post"]["logits"], run["tokens"]),
             "greedy_tokens_equal_argmax_of_bf16": agree(
                 runs["bf16"]["logits"], run["tokens"]),
             "launches": run["launches"],
             "launches_as_expected": (
                 device.type != "cuda" or all(
                     run["launches"][k] == v for k, v in _moe_sp_want(
                         L, spec["steps"], n).items())),
             "note": DEPLOYED_NOTE if n > 1 else None}
        if n == max(spec["ranks"]):
            zeroed = (spec["prompt"] - 1) // (spec["max_seq"] // n)
            ctl = _deployed_sp_run(params, cfg, device, n, deployed, prompt,
                                   1, spec["max_seq"], zero_rank=zeroed)
            r["control"] = {"zeroed_rank": zeroed,
                            "vs_reference_step0_rel_diff": _logit_rel(
                                ctl["logits"][0].float(), ref[0].float()),
                            "vs_reference_step0_rel_l2": _rel_l2(
                                ctl["logits"][0], ref[0])}
            ok &= (r["control"]["vs_reference_step0_rel_diff"]
                   > DEPLOYED_SP_TOL)
        ok &= (r["deployed_vs_reference"]["step0_rel_diff"] <= DEPLOYED_SP_TOL
               and r["bitwise_fp8_rank_major"] and r["launches_as_expected"])
        rec["ranks"][n] = r
        log(f"deployed moe sp decode n={n}", json.dumps(r))
        del run, runs
    if not ok:
        raise AssertionError(f"moe_decode_step_sp with the deployed layer "
                             f"failed its checks: {rec}")
    return rec


def check_deployed(device, card: str) -> dict:
    """Phase 21: DeepSeek-infer's widths at the preset's 4 layers, random
    bf16 weights (seed ``DEPLOYED_SEED``): the grouped GEMMs' forms (21a),
    the scaled fold of one-byte rows (21e), the EP block in its forms at
    1-8 ranks (21b), the 2-tier block (21c) and the decode step with the
    deployed layer (21d). Frees its weights before it returns."""
    import torch

    from triton_dist_tpu_torch.models.moe import MoEConfig, init_moe_params
    from triton_dist_tpu_torch.ops.group_gemm import pack_gated_weights

    t0 = time.perf_counter()
    cfg = MoEConfig.deepseek_infer()
    params = init_moe_params(cfg, seed=DEPLOYED_SEED, device=device)
    blocks = params["blocks"]
    packed = pack_gated_weights(blocks["we_gate"][0], blocks["we_up"][0],
                                DEPLOYED_BLOCK["block_n"])
    torch.cuda.synchronize()
    log(f"phase 21 params {cfg.base.n_layers} layers x d_model "
        f"{cfg.base.d_model}, {cfg.num_experts} experts x d_ff "
        f"{cfg.moe_d_ff}, top-{cfg.topk}, made in "
        f"{time.perf_counter() - t0:.1f} s; memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    counts: dict = {}
    rec = {"kernels": check_deployed_kernels(
        device, blocks["we_gate"][0], blocks["we_up"][0],
        blocks["we_down"][0], packed)}
    torch.cuda.empty_cache()
    rec["combine"] = check_deployed_combine(params, cfg, device)
    rec["block"] = check_deployed_block(params, cfg, device, packed,
                                        counts=counts)
    del packed
    torch.cuda.empty_cache()
    rec["two_tier"] = check_deployed_2d(params, cfg, device)
    torch.cuda.empty_cache()
    rec["decode"] = check_deployed_decode(params, cfg, device, card,
                                          counts=counts)
    rec["launches"] = counts
    del params, blocks
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    log("phase 21 launches", json.dumps(counts))
    log(f"phase 21 took {rec['seconds']:.1f} s")
    return rec


def deployed_kernels(dep: dict) -> list[dict]:
    """The kernels line's entries of phase 21's new kernel forms on its main
    path (the deployed block and the decode step): B18 on the expert edge's
    fp8 rows with their row scales over two streams and over the packed
    stream, each headed by its four-rank case (T = 512), and the fold of
    the fp8 return rows with their scales (``ep_combine`` scaled, headed by
    its four-rank case); B17's and B18's other option forms (kernel checks
    only) ride in ``cases``."""
    out = []
    for form in ("float8_e4m3fn row_scale",
                 "float8_e4m3fn row_scale packed"):
        cases = [r for r in dep["kernels"]
                 if r["kernel"] == "grouped_gemm_gated"
                 and r["form"].startswith(form)]
        main_rec = next(r for r in cases if r["form"] == form
                        and r["T"] == DEPLOYED_GG[-1][0])
        out.append({
            "name": f"grouped_gemm_gated[{form}]", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/group_gemm.cu",
            "replaces": "triton_dist_tpu/ops/group_gemm.py:779",
            "launches": dep["launches"].get(f"grouped_gemm_gated[{form}]",
                                            0),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            **{k: main_rec[k] for k in ("ms", "kernel_device_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "case")},
            "cases": cases})
    cases = dep["combine"]
    main_rec = next(r for r in cases if r["form"] == "float8_e4m3fn scaled"
                    and r["ranks"] == max(DEPLOYED_COMBINE_RANKS))
    out.append({
        "name": "ep_combine[float8_e4m3fn scaled]", "route": "cuda",
        "source": "triton_dist_tpu_torch/csrc/all_to_all.cu",
        "replaces": "triton_dist_tpu/ops/all_to_all.py:347",
        "launches": dep["launches"].get("ep_combine[float8_e4m3fn scaled]",
                                        0),
        "max_abs_err": max(r["max_abs_err"] for r in cases),
        **{k: main_rec[k] for k in ("ms", "kernel_device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "case")},
        "cases": cases})
    return out


# ---------------------------------------------------------------------------
# phase 22: context-parallel training across ranks, B24/B25's ring
# ---------------------------------------------------------------------------

RING_RANKS = (2, 4)
# (ranks, mesh, B, dtype, layout, causal) at the training shape, global
# S = 4096: every rank of the mesh on the one card. "cp" is a ring of n
# ranks; "dp x cp" a (2, 2) mesh with the batch over dp (two rings)
RING_RANK_CASES = tuple(
    (n, "cp", 1, dtype, layout, True) for n in RING_RANKS
    for dtype in ("bfloat16", "float32")
    for layout in ("contiguous", "zigzag")) + (
    (4, "cp", 1, "bfloat16", "contiguous", False),
    (2, "dp x cp", 2, "bfloat16", "contiguous", True))
RING_RANKS_NOTE = ("every rank of the ring on the one card: times are the "
                   "kernels and their protocol on shared SMs and one HBM, "
                   "not NVLink")


def _ring_ctx(n: int, mesh: str, device):
    from triton_dist_tpu_torch.parallel import make_mesh

    if mesh == "cp":
        return make_mesh({"cp": n}, device), None
    return make_mesh({"dp": 2, "cp": n}, device), "dp"


def check_ring_ranks(device, timed: bool = True, cases=RING_RANK_CASES,
                     dims=RING, S: int = TRAIN["seq"], fresh: int = FRESH_CALLS,
                     hang: bool = True) -> list[dict]:
    """B24 and B25 across ranks (``ring_attention_fwd``/``_bwd`` with a
    context; one cooperative launch a call, ``csrc/ring_attention.cu``) at
    each case: against their plain versions on the same global inputs
    within ``RING_TOL`` and ``LSE_ATOL`` (the backward on the kernel
    forward's out and lse), bitwise on a rerun and, on ``fresh`` calls with
    fresh data, each bitwise its rerun and within tolerance; one ring
    launch a call; every signal pad zero after the calls. Timed beside the
    bound over every rank's work and the ring's transport, the one-rank
    kernel on the whole sequence, the plain version and
    ``scaled_dot_product_attention``. With ``hang``, a forward and a
    backward whose rank 1 never signals its puts raise ``ShmemError``
    within ``HANG_LIMIT_S`` and the next call is bitwise. Raises on any
    failure."""
    import torch

    from triton_dist_tpu_torch.ops.ring_attention import (
        ring_attention_bwd, ring_attention_bwd_plain, ring_attention_fwd,
        ring_attention_fwd_plain)
    from triton_dist_tpu_torch.shmem import ShmemError, check_errors
    from triton_dist_tpu_torch.utils.perf import perf_func

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    def absmax(a, b):
        return (a.float() - b.float()).abs().max().item()

    Hq, Hkv, D = dims["Hq"], dims["Hkv"], dims["D"]
    on_card = device.type == "cuda"
    records = []
    for n, mesh, B, name, layout, causal in cases:
        dtype = getattr(torch, name)
        ctx, batch_axis = _ring_ctx(n, mesh, device)
        kw = dict(axis="cp", causal=causal, batch_axis=batch_axis,
                  layout=layout)
        gen = torch.Generator(device=device).manual_seed(22 + n)

        def inputs():
            def randn(*shape):
                return (torch.randn(shape, generator=gen, device=device,
                                    dtype=torch.float32) * 0.5).to(dtype)
            return (randn(B, Hq, S, D), randn(B, Hkv, S, D),
                    randn(B, Hkv, S, D), randn(B, Hq, S, D))

        def run(q, k, v, do):
            out, lse = ring_attention_fwd(ctx, q, k, v, **kw)
            return (out, lse) + ring_attention_bwd(ctx, q, k, v, out, lse,
                                                   do, **kw)

        def errors(got, q, k, v, do):
            out, lse = got[:2]
            ref_out, ref_lse = ring_attention_fwd_plain(
                q, k, v, causal, None, layout, n)
            ref = (ref_out, ref_lse) + ring_attention_bwd_plain(
                q, k, v, out, lse, do, causal, None, layout, n)
            return {"out_rel_err": rel(out, ref_out),
                    "lse_max_abs_err": absmax(lse, ref_lse),
                    **{f"{g}_rel_err": rel(a, b) for g, a, b in
                       zip(("out", "dq", "dk", "dv"), got[:1] + got[2:],
                           ref[:1] + ref[2:])},
                    **{f"{g}_max_abs_err": absmax(a, b) for g, a, b in
                       zip(("out", "dq", "dk", "dv"), got[:1] + got[2:],
                           ref[:1] + ref[2:])}}

        tol = RING_TOL[name]

        def within(e):
            return e["lse_max_abs_err"] <= LSE_ATOL and all(
                e[f"{g}_rel_err"] <= tol for g in ("out", "dq", "dk", "dv"))

        q, k, v, do = inputs()
        before = (ring_attention_fwd.launches_ring,
                  ring_attention_bwd.launches_ring)
        got, again = run(q, k, v, do), run(q, k, v, do)
        launches = (ring_attention_fwd.launches_ring - before[0],
                    ring_attention_bwd.launches_ring - before[1])
        check_errors(ctx)
        pads_zero = _pads_zero(ctx)
        rec = {"case": f"{name} n={n} {mesh} B={B} S={S} {layout} "
                       f"{'causal' if causal else 'full'}",
               "n": n, "mesh": mesh, "dtype": name, "layout": layout,
               "tol": tol, "lse_atol": LSE_ATOL, **errors(got, q, k, v, do),
               "bitwise_repeat": all(torch.equal(a, b)
                                     for a, b in zip(got, again)),
               "launches_per_call": [x / 2 for x in launches]}
        fresh_ok = []
        for _ in range(fresh):
            fq, fk, fv, fdo = inputs()
            f1, f2 = run(fq, fk, fv, fdo), run(fq, fk, fv, fdo)
            fresh_ok.append(all(torch.equal(a, b) for a, b in zip(f1, f2))
                            and within(errors(f1, fq, fk, fv, fdo)))
            del fq, fk, fv, fdo, f1, f2
        check_errors(ctx)
        rec["fresh_calls_bitwise"] = all(fresh_ok)
        rec["pads_zero_after"] = pads_zero and _pads_zero(ctx)
        if hang and on_card and n == RING_RANKS[0] and mesh == "cp" \
                and name == "bfloat16" and layout == "contiguous":
            rec["hang"] = {}
            for half, call in (
                    ("fwd", lambda **s: ring_attention_fwd(
                        ctx, q, k, v, **kw, **s)[0]),
                    ("bwd", lambda **s: ring_attention_bwd(
                        ctx, q, k, v, got[0], got[1], do, **kw, **s)[0])):
                want = call()
                t0 = time.perf_counter()
                raised = None
                try:
                    call(silent_rank=1)
                    check_errors(ctx)
                except ShmemError as e:
                    raised = str(e)
                seconds = time.perf_counter() - t0
                after = bool(torch.equal(call(), want))
                check_errors(ctx)
                rec["hang"][half] = {"raised": raised, "seconds": seconds,
                                     "limit_s": HANG_LIMIT_S,
                                     "next_call_bitwise": after,
                                     "pads_zero_after": _pads_zero(ctx)}
        if timed:
            esize = q.element_size()
            rec["fwd_ms"] = perf_func(
                lambda: ring_attention_fwd(ctx, q, k, v, **kw))[1]
            rec["bwd_ms"] = perf_func(lambda: ring_attention_bwd(
                ctx, q, k, v, got[0], got[1], do, **kw), iters=10)[1]
            rec["one_rank_fwd_ms"] = perf_func(lambda: ring_attention_fwd(
                None, q, k, v, causal=causal))[1]
            rec["one_rank_bwd_ms"] = perf_func(lambda: ring_attention_bwd(
                None, q, k, v, got[0], got[1], do, causal=causal),
                iters=10)[1]
            rec["fwd_plain_ms"] = perf_func(lambda: ring_attention_fwd_plain(
                q, k, v, causal, None, layout, n), iters=5)[1]
            rec["bwd_plain_ms"] = perf_func(lambda: ring_attention_bwd_plain(
                q, k, v, got[0], got[1], do, causal, None, layout, n),
                iters=5)[1]
            s_fwd, s_bwd, _ = sdpa_calls(q, k, v, do, causal)
            rec["fwd_sdpa_ms"] = perf_func(s_fwd)[1]
            rec["bwd_sdpa_ms"] = perf_func(s_bwd)[1]
            bdims = dict(dims, B=B)
            rec["fwd_bound_ms"], rec["fwd_bound_by"] = ring_bound(
                S, causal, esize, name, False, bdims, n)
            rec["bwd_bound_ms"], rec["bwd_bound_by"] = ring_bound(
                S, causal, esize, name, True, bdims, n)
            rec["note"] = RING_RANKS_NOTE
        log("kernel ring_attention across ranks", json.dumps(rec))
        hang_ok = all(h["raised"] and h["seconds"] < HANG_LIMIT_S
                      and h["next_call_bitwise"] and h["pads_zero_after"]
                      for h in rec.get("hang", {}).values())
        if not (within(rec) and rec["bitwise_repeat"]
                and rec["fresh_calls_bitwise"] and rec["pads_zero_after"]
                and hang_ok and (not on_card
                                 or rec["launches_per_call"] == [1, 1])):
            raise AssertionError(f"ring attention across ranks failed: "
                                 f"{rec}")
        records.append(rec)
        del q, k, v, do, got, again
        if on_card:
            torch.cuda.empty_cache()
    return records


def check_train_ranks_f32(device, cfg, seq: int = TRAIN_F32["seq"],
                          ranks=RING_RANKS) -> dict:
    """Loss and gradients of the cp plan over a ("cp",) mesh of each of
    ``ranks`` (the ring kernels in every layer) against the cp plan on one
    rank (the one-rank kernels), on the same params and tokens; raises
    outside ``TRAIN_F32``'s tolerances or unless each layer launched one
    ring forward and one ring backward."""
    import torch

    from triton_dist_tpu_torch.models.llama import init_params
    from triton_dist_tpu_torch.ops.ring_attention import (ring_attention_bwd,
                                                          ring_attention_fwd)
    from triton_dist_tpu_torch.parallel import (ParallelPlan, make_loss_fn,
                                                make_mesh)

    params = init_params(cfg, seed=2, device=device)
    leaves = [t.requires_grad_(True) for _, t in _flat(params)]
    names = [n for n, _ in _flat(params)]
    gen = torch.Generator(device=device).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                           device=device)
    plan = ParallelPlan(dp=None, tp=None, cp="cp", sp=False)

    def loss_and_grads(mesh):
        loss = make_loss_fn(cfg, plan, mesh)(params, tokens)
        return loss.item(), torch.autograd.grad(loss, leaves)

    loss_ref, g_ref = loss_and_grads(None)
    rec = {"dtype": "float32", "layers": cfg.n_layers, "seq": seq,
           "loss_one_rank": loss_ref, "loss_rtol": TRAIN_F32["loss_rtol"],
           "grad_rtol": TRAIN_F32["grad_rtol"], "ranks": {}}
    ok = True
    for n in ranks:
        before = (ring_attention_fwd.launches_ring,
                  ring_attention_bwd.launches_ring)
        loss, g = loss_and_grads(make_mesh({"cp": n}, device))
        launches = [ring_attention_fwd.launches_ring - before[0],
                    ring_attention_bwd.launches_ring - before[1]]
        grad_rel = {nm: ((a - b).abs().max() / b.abs().max()).item()
                    for nm, a, b in zip(names, g, g_ref)}
        r = {"loss": loss, "loss_rel_err": abs(loss - loss_ref)
             / abs(loss_ref), "grad_rel_err_max": max(grad_rel.values()),
             "ring_launches": launches}
        rec["ranks"][str(n)] = r
        ok = ok and r["loss_rel_err"] <= rec["loss_rtol"] \
            and r["grad_rel_err_max"] <= rec["grad_rtol"] \
            and (device.type != "cuda" or launches == [cfg.n_layers] * 2)
        del g
    log("train f32 cp across ranks vs one rank", json.dumps(rec))
    del params, leaves, g_ref
    if not ok:
        raise AssertionError(f"the cp step across ranks disagrees with one "
                             f"rank: {rec}")
    return rec


def check_cp_ranks(device, card: str) -> dict:
    """Phase 22: the ring kernels (a), the f32 step across ranks (b) and
    the bf16 trainer at 2 and 4 ranks (c)."""
    import torch

    from triton_dist_tpu_torch.models.llama import LlamaConfig

    t0 = time.perf_counter()
    kernels = check_ring_ranks(device)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(LlamaConfig.llama3_8b(),
                                n_layers=TRAIN_F32["layers"],
                                dtype=torch.float32)
    f32 = check_train_ranks_f32(device, cfg32)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              n_layers=TRAIN["layers"])
    train = {}
    for n in RING_RANKS:
        train[n] = check_train(device, cfg, card, ranks=n)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 22 took {seconds:.1f} s")
    return {"kernels": kernels, "f32": f32, "train": train,
            "seconds": seconds}


def cp_ranks_kernels(cp: dict) -> list[dict]:
    """The kernels-line entries of B24 and B25 across ranks: the main
    path's shape is the trainer's (bf16, contiguous, causal) at 4 ranks;
    every case in ``cases``; launches the ring launches of phase 22c's runs
    at 2 and 4 ranks."""
    main = next(r for r in cp["kernels"] if r["n"] == RING_RANKS[-1]
                and r["mesh"] == "cp" and r["dtype"] == "bfloat16"
                and r["layout"] == "contiguous" and "causal" in r["case"])
    source = "triton_dist_tpu_torch/csrc/ring_attention.cu"
    out = []
    for half, name, replaces, errs in (
            ("fwd", "ring_attention_fwd_ranks",
             "triton_dist_tpu/ops/ring_attention.py:407", ("out",)),
            ("bwd", "ring_attention_bwd_ranks",
             "triton_dist_tpu/ops/ring_attention.py:900",
             ("dq", "dk", "dv"))):
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(t["launches"][f"ring_attention_{half}"]
                            for t in cp["train"].values()),
            "max_abs_err": max(r[f"{e}_max_abs_err"] for r in cp["kernels"]
                               for e in errs),
            "ms": main[f"{half}_ms"], "plain_ms": main[f"{half}_plain_ms"],
            "bound_ms": main[f"{half}_bound_ms"],
            "bound_by": main[f"{half}_bound_by"],
            "library_ms": main[f"{half}_sdpa_ms"],
            "one_rank_ms": main[f"one_rank_{half}_ms"],
            "case": main["case"], "note": RING_RANKS_NOTE,
            "cases": [{k: r[k] for k in (
                "case", f"{half}_ms", f"one_rank_{half}_ms",
                f"{half}_plain_ms", f"{half}_sdpa_ms", f"{half}_bound_ms")
                if k in r} for r in cp["kernels"]]})
    return out


# ---------------------------------------------------------------------------
# phase 23: sigcheck on the card (B26's gallery, the traced build, the
# registry) and ring attention at head dim 256
# ---------------------------------------------------------------------------

# Gemma-7B's attention: 16 query and 16 kv heads of 256
RING_D256 = dict(B=1, Hq=16, Hkv=16, D=256)
RING_D256_CASES = [("bfloat16", 4096, True), ("float32", 4096, True)]
RING_D256_RANK_CASES = tuple(
    (n, "cp", 1, dtype, layout, True) for dtype in ("bfloat16", "float32")
    for n in RING_RANKS for layout in ("contiguous", "zigzag"))
GALLERY_N = 2
# the pallas_call each reference specimen runs under
GALLERY_CALL = {"missing_wait": 222, "swapped_sem": 222}


def gallery_bytes(name: str, n: int) -> int:
    """The bytes specimen ``name`` must move at n ranks: every put read and
    written once, every marked read and write, 4 bytes a signal or wait,
    and the flag specimens' copy of each rank's shard."""
    from triton_dist_tpu_torch.analysis import gallery

    total = 0
    for events in gallery.plain_streams(name, n).values():
        for e in events:
            if e.kind == "put":
                total += 2 * e.value
            elif e.kind in ("read", "write"):
                region = e.src if e.kind == "read" else e.dst
                total += region.intervals[0][1] - region.intervals[0][0]
            else:
                total += 4
    if name not in GALLERY_CALL:
        total += 2 * n * gallery.SHARD_BYTES
    return total


def check_gallery_traced(device) -> dict:
    """23b: each specimen traced (``capture_op``) at its meshes, flagged
    with its expected kind by the checker, and each rank's decoded protocol
    equal to the plain version's; the host time of one traced call and of
    the plain version. Raises on any miss."""
    from triton_dist_tpu_torch.analysis import api, capture, gallery

    out = {}
    for name, (expected, rep) in api.check_gallery(device).items():
        entry = gallery.GALLERY[name]
        rec = {"expected": expected, "kinds": rep.finding_kinds,
               "ns": rep.ns, "findings": [str(f) for f in rep.findings],
               "protocol_equal": {}}
        for mesh in entry.meshes:
            n = mesh["x"]
            t0 = time.perf_counter()
            launches = capture.capture_op(
                lambda ctx: gallery.run_specimen(ctx, name), mesh, device)
            rec.setdefault("traced_call_ms", (time.perf_counter() - t0) * 1e3)
            got = gallery.protocol_of(capture.merge_launches(launches))
            t0 = time.perf_counter()
            plain = gallery.plain_streams(name, n)
            rec.setdefault("plain_ms", (time.perf_counter() - t0) * 1e3)
            rec["protocol_equal"][str(n)] = got == gallery.protocol_of(plain)
        # every event's (kind, word, peer, value) equal: nothing differs
        rec["max_abs_err"] = 0.0 if all(rec["protocol_equal"].values()) \
            else None
        log(f"gallery traced {name}", json.dumps(rec))
        out[name] = rec
        if expected not in rep.finding_kinds or \
                not all(rec["protocol_equal"].values()):
            raise AssertionError(f"gallery specimen {name} traced: {rec}")
    return out


def check_gallery_untraced(device) -> dict:
    """23c: each specimen run untraced at ``GALLERY_N`` ranks, the launch
    counts from 0: a starved one raises ``ShmemError`` within
    ``HANG_LIMIT_S`` naming the gallery kernel, a rank and its word;
    ``over_signal`` leaves n - 1 on word 0 of every rank; after each, every
    pad zeroed and a B14 barrier clean. Times each call that finishes
    between CUDA events (a starved call: its wall time to the raise).
    Raises on any failure."""
    import torch

    from triton_dist_tpu_torch.analysis import gallery
    from triton_dist_tpu_torch.ops import barrier_all_op
    from triton_dist_tpu_torch.shmem import (ShmemError, check_errors,
                                             initialize_distributed)
    from triton_dist_tpu_torch.utils.perf import perf_func

    n = GALLERY_N
    ctx = initialize_distributed(("x",), (n,), device)
    barrier = barrier_all_op(ctx)
    for name in gallery.SPECIMENS:
        gallery.run_specimen.launches[name] = 0
    out = {}
    for name in gallery.SPECIMENS:
        rec = {"n": n}
        t0 = time.perf_counter()
        raised = None
        try:
            gallery.run_specimen(ctx, name)
            torch.cuda.synchronize(device)
            if name == "over_signal":
                rec["residue"] = ctx._pads[gallery.family(name)][:, 0] \
                    .tolist()
            check_errors(ctx)
        except ShmemError as e:
            raised = str(e)
        rec["untraced_call_ms"] = (time.perf_counter() - t0) * 1e3
        rec["raised"] = raised
        rec["launches"] = gallery.run_specimen.launches[name]
        ctx.clear_signal_pads()
        rec["barrier_after"] = barrier().tolist() == [1] * n
        check_errors(ctx)
        rec["pads_zero_after"] = _pads_zero(ctx)
        starved = name in gallery.STARVED
        ok = rec["barrier_after"] and rec["pads_zero_after"]
        if starved:
            ok = ok and raised is not None \
                and rec["untraced_call_ms"] < HANG_LIMIT_S * 1e3 \
                and raised.startswith("sigcheck gallery: rank ") \
                and "signal word" in raised
        else:
            ok = ok and raised is None
            rec["ms"] = perf_func(lambda: gallery.run_specimen(ctx, name),
                                  iters=10)[1]
            ctx.clear_signal_pads()
        if name == "over_signal":
            ok = ok and rec["residue"] == [n - 1] * n
        log(f"gallery untraced {name}", json.dumps(rec))
        out[name] = rec
        if not ok or rec["launches"] != 1:
            raise AssertionError(f"gallery specimen {name} untraced: {rec}")
    return out


def check_registry_clean(device) -> dict:
    """23d: ``check_registry()`` at every entry's meshes: zero findings on
    every checked op and events logged at every n. Raises otherwise."""
    from triton_dist_tpu_torch.analysis import api

    t0 = time.perf_counter()
    reports = api.check_registry()
    checked = {k: r for k, r in reports.items() if r.skipped is None}
    rec = {"ops": len(reports), "checked": len(checked),
           "skipped": len(reports) - len(checked),
           "n_findings": sum(len(r.findings) for r in checked.values()),
           "events": {k: r.event_counts for k, r in checked.items()},
           "findings": [str(f) for r in checked.values()
                        for f in r.findings][:20],
           "seconds": time.perf_counter() - t0}
    log("sigcheck registry", json.dumps(rec))
    silent = [k for k, r in checked.items()
              if not r.event_counts or not all(r.event_counts.values())]
    if rec["n_findings"] or silent:
        raise AssertionError(f"sigcheck registry: {rec['n_findings']} "
                             f"findings, no events for {silent}: {rec}")
    return rec


def check_ring_d256(device) -> dict:
    """23e: B24 and B25 at head dim 256 (``RING_D256``) at one rank and
    across ranks, then the f32 cp step at that head dim at 2 ranks."""
    import torch

    from triton_dist_tpu_torch.models.llama import LlamaConfig

    one = check_ring_attention(device, cases=RING_D256_CASES, dims=RING_D256)
    torch.cuda.empty_cache()
    ranks = []
    for dtype in ("bfloat16", "float32"):
        ranks += check_ring_ranks(
            device, timed=dtype == "bfloat16",
            cases=[c for c in RING_D256_RANK_CASES if c[3] == dtype],
            dims=RING_D256, fresh=1, hang=False)
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_heads=16,
                              n_kv_heads=16, n_layers=TRAIN_F32["layers"],
                              dtype=torch.float32)
    f32 = check_train_ranks_f32(device, cfg, ranks=(2,))
    torch.cuda.empty_cache()
    return {"one_rank": one, "ranks": ranks, "f32": f32}


def check_sigcheck(device) -> dict:
    """Phase 23 (b-e), its cost logged."""
    t0 = time.perf_counter()
    traced = check_gallery_traced(device)
    untraced = check_gallery_untraced(device)
    registry = check_registry_clean(device)
    t_sig = time.perf_counter() - t0
    ring = check_ring_d256(device)
    seconds = time.perf_counter() - t0
    log(f"phase 23 took {seconds:.1f} s (23b-d {t_sig:.1f} s)")
    return {"traced": traced, "untraced": untraced, "registry": registry,
            "ring": ring, "seconds": seconds}


def sigcheck_kernels(sig: dict) -> list[dict]:
    """The kernels-line entries of phase 23: B26's eight specimens
    (launches: 23c's untraced run, one each; ms: that call, a starved one's
    to its raise; plain_ms: the plain streams on the host) and B24/B25 at
    head dim 256 (the bf16 4-rank contiguous case; launches: 23e's f32 cp
    step at 2 ranks)."""
    from triton_dist_tpu_torch.analysis import gallery

    out = []
    for name in gallery.SPECIMENS:
        tr, un = sig["traced"][name], sig["untraced"][name]
        bound = gallery_bytes(name, GALLERY_N) / HBM_BYTES_PER_S * 1e3
        out.append({
            "name": f"sigcheck_gallery.{name}", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/sigcheck_gallery.cu",
            "replaces": "triton_dist_tpu/analysis/gallery.py:"
                        f"{GALLERY_CALL.get(name, 248)}",
            "launches": un["launches"], "max_abs_err": tr["max_abs_err"],
            "ms": un.get("ms", un["untraced_call_ms"]),
            "plain_ms": tr["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None,
            "traced_call_ms": tr["traced_call_ms"],
            "untraced_call_ms": un["untraced_call_ms"],
            "kinds": tr["kinds"], "raised": un["raised"],
            "note": "max_abs_err: the traced protocol against the plain "
                    "streams, (kind, word, peer, value) for each event"})
    ring = sig["ring"]
    main = next(r for r in ring["ranks"] if r["n"] == RING_RANKS[-1]
                and r["dtype"] == "bfloat16" and r["layout"] == "contiguous")
    launches = ring["f32"]["ranks"]["2"]["ring_launches"]
    for i, (half, errs) in enumerate((("fwd", ("out",)),
                                      ("bwd", ("dq", "dk", "dv")))):
        out.append({
            "name": f"ring_attention_{half}_ranks_d256", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/ring_attention.cu",
            "replaces": "triton_dist_tpu/ops/ring_attention.py:"
                        + ("407" if half == "fwd" else "900"),
            "launches": launches[i],
            "max_abs_err": max(r[f"{e}_max_abs_err"] for r in
                               ring["ranks"] + ring["one_rank"]
                               for e in errs),
            "ms": main[f"{half}_ms"], "plain_ms": main[f"{half}_plain_ms"],
            "bound_ms": main[f"{half}_bound_ms"],
            "bound_by": main[f"{half}_bound_by"],
            "library_ms": main[f"{half}_sdpa_ms"],
            "one_rank_ms": main[f"one_rank_{half}_ms"],
            "case": main["case"], "dims": RING_D256,
            "cases": [{k: r[k] for k in (
                "case", f"{half}_ms", f"one_rank_{half}_ms",
                f"{half}_plain_ms", f"{half}_sdpa_ms", f"{half}_bound_ms")
                if k in r} for r in ring["ranks"] + ring["one_rank"]]})
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "triton_dist_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from triton_dist_tpu_torch import csrc
    from triton_dist_tpu_torch.models.llama import LlamaConfig, init_params
    from triton_dist_tpu_torch.utils.env import set_tf32

    t_start = time.perf_counter()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
        f"cuda {torch.version.cuda}; tf32 {set_tf32(False)}")

    # phase 23a: the traced libraries are built beside the untraced ones
    report = csrc.build(traced=True)
    for name, r in report.items():
        log(f"build {name}.cu: {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas", line.strip())

    attention = check_attention(device)

    # f32 at full width, depth cut to 4 layers: the tight checks of the
    # paged decode step and (phase 10b) of the contiguous one
    cfg32 = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=4,
                                dtype=torch.float32)
    params32 = init_params(cfg32, seed=1, device=device)
    check_model(params32, cfg32, device)
    decode_step_rec = check_decode_step(params32, cfg32, device)
    check_sp_decode_f32(params32, cfg32, device)
    check_sp_decode_2d_f32(params32, cfg32, device)
    check_tp_forward_f32(params32, cfg32, device)
    check_tp_ranks_f32(params32, cfg32, device)
    t20 = time.perf_counter()
    tp2d_f32 = check_tp_2d_forward_f32(params32, cfg32, device)
    tp2d_f32["seconds"] = time.perf_counter() - t20
    del params32
    torch.cuda.empty_cache()

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["blocks"].values()) \
        + 2 * cfg.vocab_size * cfg.d_model
    log(f"params {cfg.n_layers} layers x d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B, made in {time.perf_counter() - t0:.1f} s")
    check_model(params, cfg, device)
    trace = make_trace(cfg, N_REQUESTS, 0)
    engine = check_engine(params, cfg, device, trace, ENGINE, card)

    profile_dispatch(params, cfg, device)
    generation = check_generation(params, cfg, device, card)
    tp = check_tp_overlap(params, cfg, device, card)
    sp = check_sp_and_collectives(params, cfg, device, card)
    coll2d = check_collectives_2d(params, cfg, device, card)
    tp_ranks = check_tp_ranks(params, cfg, device, card)
    tp2d = check_tp_2d(params, cfg, device, card)
    disagg = check_disagg(params, cfg, device, card, trace,
                          engine.pop("tokens"))
    del params                        # the trainer needs the card's memory
    torch.cuda.empty_cache()

    ring = check_ring_attention(device)
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(LlamaConfig.llama3_8b(),
                                n_layers=TRAIN_F32["layers"],
                                dtype=torch.float32)
    check_train_f32(device, cfg32)
    torch.cuda.empty_cache()
    train = check_train(device, dataclasses.replace(
        LlamaConfig.llama3_8b(), n_layers=TRAIN["layers"]), card)
    torch.cuda.empty_cache()
    cp = check_cp_ranks(device, card)
    torch.cuda.empty_cache()
    sig = check_sigcheck(device)
    torch.cuda.empty_cache()           # the MoE model needs 47 GB of it
    moe = check_moe(device, card)
    sp17 = check_sp_kernels(device, card)
    torch.cuda.empty_cache()           # DeepSeek's weights need 42 GB of it
    deployed = check_deployed(device, card)
    moe_cases = moe["grouped"] + moe["ep_rows"]
    gg_main = {r["kernel"]: r for r in moe_cases
               if r["dtype"] == "bfloat16" and r["shape"] == "decode"}

    main_case = attention[0]          # bf16 decode, the hot shape
    fd_source = "triton_dist_tpu_torch/csrc/flash_decode.cu"
    dec = generation["kernels"]
    # the main path's shapes: B3 at G-batch's bf16 decode; B4 over 8 of its
    # split partials in f32 (the type B3 hands it); B5's merge over one
    # rank's partial; B9's one-rank gather of phase 10b's push wire
    fd_main = {"gqa_decode_partial": dec["gqa_decode_partial"][0],
               "decode_combine": next(r for r in dec["decode_combine"]
                                      if r["case"].startswith("float32 R=8")),
               "ll_merge": next(r for r in dec["ll_merge"]
                                if r["case"].startswith("float32 R=1"))}
    fd_launches = {"gqa_decode_partial": generation["batch"]["runs"][0]
                   ["launches"]["gqa_decode_partial"],
                   "decode_combine": generation["batch"]["runs"][0]
                   ["launches"]["decode_combine"],
                   "ll_merge": decode_step_rec["launches"]["ll_merge"]}
    slice7 = sp_kernels(sp, dec["all_gather"],
                        decode_step_rec["launches"]["all_gather"])
    # phase 19's group and ring_2d cases and main-path launches of B9, B5
    # and B13
    k19 = coll2d["kernels"]
    for entry in slice7:
        name = entry["name"]
        more = {"all_gather": [r for r in k19["gathers"]
                               if r["kernel"] == "all_gather"],
                "ll_ag_merge": k19["ll_ag_merge"],
                "reduce_scatter": k19["rs"]}.get(name)
        if more is not None:
            entry["cases"] = entry["cases"] + more
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [
                r["max_abs_err"] for r in more if "max_abs_err" in r])
            entry["launches"] += coll2d["launches"][name]
    slice6 = long_moe_tp_kernels(moe) + moe_tp_ranks_kernels(
        moe["moe_tp_ranks"])
    phase20 = (tp2d_f32["seconds"] + tp2d["seconds"]
               + moe["moe_tp_2d"]["seconds"]
               + moe["ep"]["ag_gemm_engines"]["seconds"])
    log(f"phase 20 took {phase20:.1f} s")
    ring_main = ring[0]               # bf16 S=4096 causal, the training shape
    ring_source = "triton_dist_tpu_torch/csrc/ring_attention.cu"
    log(json.dumps({"kernels": [{
        "name": "gqa_decode_paged", "route": "cuda",
        "source": "triton_dist_tpu_torch/csrc/flash_decode_paged.cu",
        "replaces": "triton_dist_tpu/ops/flash_decode.py:231",
        "launches": engine["gqa_decode_paged_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in attention),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"], "case": main_case["case"],
        "cases": attention}, {
        "name": "ring_attention_fwd", "route": "cuda", "source": ring_source,
        "replaces": "triton_dist_tpu/ops/ring_attention.py:621",
        "launches": train["launches"]["ring_attention_fwd"],
        "max_abs_err": max(r["out_max_abs_err"] for r in ring),
        "ms": ring_main["fwd_ms"], "plain_ms": ring_main["fwd_plain_ms"],
        "bound_ms": ring_main["fwd_bound_ms"],
        "bound_by": ring_main["fwd_bound_by"],
        "library_ms": ring_main["fwd_sdpa_ms"], "case": ring_main["case"]}, {
        "name": "ring_attention_bwd", "route": "cuda", "source": ring_source,
        "replaces": "triton_dist_tpu/ops/ring_attention.py:1067",
        "launches": train["launches"]["ring_attention_bwd"],
        "max_abs_err": max(r[f"{n}_max_abs_err"] for r in ring
                           for n in ("dq", "dk", "dv")),
        "ms": ring_main["bwd_ms"], "plain_ms": ring_main["bwd_plain_ms"],
        "bound_ms": ring_main["bwd_bound_ms"],
        "bound_by": ring_main["bwd_bound_by"],
        "library_ms": ring_main["bwd_sdpa_ms"],
        "case": ring_main["case"]}] + [{
        "name": name, "route": "cuda",
        "source": f"triton_dist_tpu_torch/csrc/{source}.cu",
        "replaces": replaces,
        "launches": moe["engine"]["launches"][name],
        "max_abs_err": max(r["max_abs_err"] for r in moe_cases
                           if r["kernel"] == name),
        **{k: gg_main[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "case")},
        "cases": [r for r in moe_cases if r["kernel"] == name]
        + [r for r in deployed["kernels"] if r["kernel"] == name]}
        for name, source, replaces in (
            ("ep_dispatch", "all_to_all",
             "triton_dist_tpu/ops/all_to_all.py:347"),
            ("grouped_gemm_gated", "group_gemm",
             "triton_dist_tpu/ops/group_gemm.py:779"),
            ("grouped_gemm", "group_gemm",
             "triton_dist_tpu/ops/group_gemm.py:391"),
            ("ep_combine", "all_to_all",
             "triton_dist_tpu/ops/all_to_all.py:347"))] + [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "wrapper": wrapper,
        "launches": fd_launches[wrapper],
        "max_abs_err": max(r["max_abs_err"] for r in dec[wrapper]),
        **{k: fd_main[wrapper][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "case")},
        "cases": dec[wrapper]}
        for name, wrapper, source, replaces in (
            ("gqa_decode_partial", "gqa_decode_partial", fd_source,
             "triton_dist_tpu/ops/flash_decode.py:150"),
            ("decode_combine", "decode_combine", fd_source,
             "triton_dist_tpu/ops/flash_decode.py:319"),
            ("ll_merge", "ll_merge", fd_source,
             "triton_dist_tpu/ops/flash_decode.py:431"))] + [{
        "name": name, "route": "cuda",
        "source": "triton_dist_tpu_torch/csrc/gemm.cu", "replaces": replaces,
        "launches": tp["forward"]["runs"][0]["launches"][name],
        "max_abs_err": max(r["max_abs_err"] for r in cases),
        **{k: main_rec[k] for k in ("ms", "kernel_device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "case")},
        "cases": cases}
        for name, replaces, main_rec, cases in (
            ("matmul", "triton_dist_tpu/ops/gemm.py:190",
             next(r for r in tp["gemm"]
                  if r["case"].startswith(GEMM_MAIN + " ")), tp["gemm"]),
            ("ag_gemm", "triton_dist_tpu/ops/allgather_gemm.py:255",
             tp["layers"]["ag_gemm"], [tp["layers"]["ag_gemm"]]),
            ("gemm_rs", "triton_dist_tpu/ops/gemm_reduce_scatter.py:343",
             tp["layers"]["gemm_rs"], [tp["layers"]["gemm_rs"]]),
            ("slot_reduce", "triton_dist_tpu/ops/gemm_reduce_scatter.py:88",
             tp["layers"]["slot_reduce"], [tp["layers"]["slot_reduce"]]))]
        + slice6 + slice7 + collectives_2d_kernels(coll2d)
        + tp_ranks_kernels(tp_ranks) + tp_2d_kernels(tp2d, moe)
        + ep_kernels(moe["ep"]) + sp_modes_kernels(sp17, moe, disagg)
        + deployed_kernels(deployed) + cp_ranks_kernels(cp)
        + sigcheck_kernels(sig)}))
    log(f"{card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
