"""Disaggregated prefill/decode serving: KV pages handed from a prefill
role to a decode role over the page transport.

Counterpart of ``triton_dist_tpu/serving/disagg.py``. The colocated
``ServingEngine`` time-slices one worker between chunked prefill and
decode. Here the two roles are the two ranks of a ``role`` axis:

- role 0, the **prefill worker**, owns the prompt queue and runs
  ``prefill_chunk_paged`` over its own pool, at most one chunk a step. As a
  chunk finalises pages (the cursor has passed their last token, or the
  prompt ends), ``ops.page_migrate.migrate_pages`` (B23) puts them into the
  decode worker's pool at destination ids reserved at admission, and the
  consumer's landed report feeds the ``ChunkSignalLedger``. A prefill
  preemptee keeps its filled and its migrated pages (``free_tail``) and
  resumes at its chunk cursor: nothing is sent twice.
- role 1, the **decode worker**, never sees a prompt token. Its block-table
  rows expose only the landed prefix of a request's pages
  (``KVPagePool.landed_row``); a slot turns ACTIVE the step every page of
  its prompt is covered by landed reports (signal-gated admission), and
  runs ``decode_multistep_paged`` over its own pool. Only the first token,
  argmaxed by the prefill worker's last chunk, crosses on the host.

The roles run in one process on the one card: each role's program runs on
its own pool and its own rows only (the reference's parked off-role twin
is an artefact of its SPMD program). The pools are one symmetric pair
``[2, L, P + 1, Hkv, page_size, D]`` (``ctx.create_symm_tensor``), page 0
of each role its scratch page. Migration is an exact page copy and each
role runs the colocated engine's programs at its shapes, so every
request's tokens are bitwise the colocated chunked engine's (configured
with the same ``num_slots``, ``prefill_chunk`` and ``decode_horizon``),
across preemptions on either worker.

The recovery ladder: a MIGRATING request waits for its covering reports
against a ``Deadline`` of ``signal_deadline_steps``; on expiry the
incomplete chunks are sent again with a bumped tag (the prefill worker
retains the source pages for this), with exponential backoff over
``max_retries`` rungs; a report of a superseded attempt is discarded as
stale. When the rungs run out the request degrades to a local re-prefill
on the decode worker (its own pool, the same chunk program), at most
once, and only then fails with a typed reason that carries the ledger dump,
while the engine and every other request run on. A transport whose
consumer wait starves (``ShmemError``) counts as a report of no pages, so
it too walks the ladder instead of stopping the engine.

Not here yet (each raises ``NotImplementedError`` naming its ROADMAP.md
Queue A item): ``fault_plan`` (the engine tier of ``shmem/faults.py``),
``journal``, ``checkpoint_every``, ``queue_cap``, ``ttl_steps``,
``prefix_cache`` and ``slo`` (item 10); ``artifact`` (item 12).
"""

from __future__ import annotations

import json
import time
from collections import deque

import numpy as np
import torch

from triton_dist_tpu_torch.models.llama import (LlamaConfig,
                                                decode_multistep_paged,
                                                prefill_chunk_paged)
from triton_dist_tpu_torch.ops.page_migrate import migrate_pages
from triton_dist_tpu_torch.serving.deadline import (Backoff, Deadline,
                                                    EngineStallError)
from triton_dist_tpu_torch.serving.kv_pool import (KVPagePool,
                                                   PageLedgerError)
from triton_dist_tpu_torch.serving.metrics import ServingMetrics
from triton_dist_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler, Request, RequestState)
from triton_dist_tpu_torch.shmem import device as shd
from triton_dist_tpu_torch.shmem.context import (ShmemContext,
                                                 initialize_distributed)
from triton_dist_tpu_torch.utils.env import default_device

PREFILL_ROLE = 0
DECODE_ROLE = 1
# local re-prefills a request may take before it fails
MAX_DEGRADATIONS = 1

_SERVING = 'item 10 "the rest of the single-device serving tier"'
_TOOLING = 'item 12 "tooling"'


class MigrationSignalTimeout(RuntimeError):
    """A completed prefill's covering reports never arrived within the
    whole recovery ladder (deadline and every retry rung): the transport
    lost reports or pages repeatedly, or a chunk was never sent. The
    message names the request and carries the ledger dump. A per-request
    failure reason (``Request.failure``), not an engine crash."""


class SignalProtocolError(RuntimeError):
    """Over-signal: a chunk's landed count exceeded the pages it was
    expected to deliver. It voids exactly the affected request's coverage
    (degrade or fail), never the engine. Carries the ledger dump."""


class ChunkSignalLedger:
    """The host mirror of the per-chunk signal protocol.

    The landed counts come from the transport's consumer-side report, which
    the kernel writes only after every covered page has landed; the ledger
    aggregates them per (request, chunk). Coverage is the union over
    complete chunks (landed >= expected), in whatever order they completed.
    ``expect`` again (a preemption restart or a retry) resets the chunk's
    count and records its new generation; a report of an older generation
    is discarded as stale. Over-signal raises ``SignalProtocolError``."""

    def __init__(self):
        # rid -> {chunk: [dst ids, landed count, src ids, generation]}
        self._chunks: dict[int, dict[int, list]] = {}

    def expect(self, rid: int, chunk_idx: int, dst_ids, src_ids=(),
               generation: int = 0) -> None:
        self._chunks.setdefault(rid, {})[chunk_idx] = [
            tuple(int(p) for p in dst_ids), 0,
            tuple(int(p) for p in src_ids), int(generation)]

    def landed(self, rid: int, chunk_idx: int, count: int,
               generation: int = 0) -> bool:
        """Feed one reported landed count. Returns False, counting nothing,
        for a stale generation; raises ``KeyError`` for a chunk nobody
        expected and ``SignalProtocolError`` on over-signal."""
        ent = self._chunks.get(rid, {}).get(chunk_idx)
        if ent is None:
            raise KeyError(
                f"signal for unknown chunk {chunk_idx} of request {rid}")
        if int(generation) != ent[3]:
            return False
        ent[1] += int(count)
        if ent[1] > len(ent[0]):
            raise SignalProtocolError(
                f"over-signal on chunk {chunk_idx} of request {rid}: "
                f"{ent[1]} landed signals for {len(ent[0])} expected pages "
                f"(generation {ent[3]}): a signal increment was duplicated "
                f"or forged. Ledger: {self.describe(rid)}")
        return True

    def chunk_complete(self, rid: int, chunk_idx: int) -> bool:
        ent = self._chunks.get(rid, {}).get(chunk_idx)
        return ent is not None and ent[1] >= len(ent[0])

    def covered(self, rid: int) -> set[int]:
        """Page ids whose delivery is wholly reported: the union over
        complete chunks (a chunk at 2 of 3 covers nothing)."""
        out: set[int] = set()
        for ids, got, *_ in self._chunks.get(rid, {}).values():
            if got >= len(ids):
                out.update(ids)
        return out

    def expected(self, rid: int) -> set[int]:
        out: set[int] = set()
        for ids, *_ in self._chunks.get(rid, {}).values():
            out.update(ids)
        return out

    def complete(self, rid: int) -> bool:
        return all(got >= len(ids)
                   for ids, got, *_ in self._chunks.get(rid, {}).values())

    def incomplete_chunks(self, rid: int) -> list[tuple[int, tuple, tuple]]:
        """(chunk, src ids, dst ids) of every chunk short of coverage: the
        retry list."""
        return [(ci, ent[2], ent[0])
                for ci, ent in sorted(self._chunks.get(rid, {}).items())
                if ent[1] < len(ent[0])]

    def generation(self, rid: int, chunk_idx: int) -> int | None:
        ent = self._chunks.get(rid, {}).get(chunk_idx)
        return None if ent is None else ent[3]

    def reset(self, rid: int) -> None:
        self._chunks.pop(rid, None)

    def describe(self, rid: int) -> str:
        """The ledger dump every typed failure carries: each chunk's
        expected and landed counts, and the covered and missing pages."""
        chunks = self._chunks.get(rid, {})
        if not chunks:
            return "no chunks recorded"
        per_chunk = ", ".join(
            f"chunk {ci}: {got}/{len(ids)} signals gen {gen} "
            f"(pages {list(ids)})"
            for ci, (ids, got, _src, gen) in sorted(chunks.items()))
        covered = self.covered(rid)
        missing = sorted(self.expected(rid) - covered)
        return (f"{per_chunk}; covered pages {sorted(covered)}, "
                f"missing {missing}")


class PageMigrationChannel:
    """The prefill worker's sending half: it refuses scratch pages, stamps
    each attempt of a chunk with a growing tag, launches the transport and
    feeds the ledger from the consumer's landed report.

    ``launch(src_ids, dst_ids, n, tag)`` moves the pages (``pmax``-entry id
    lists, padding never read) and returns the landed report ``[ranks, 2]``
    (count, tag) on the host. A launch that raises ``ShmemError`` (the
    consumer's wait ran out of its spin budget) lands no pages: the chunk
    stays short of coverage and the engine's deadline takes over."""

    def __init__(self, launch, pmax: int, reserved: int,
                 metrics: ServingMetrics, consumer: int = DECODE_ROLE):
        self.ledger = ChunkSignalLedger()
        self._launch = launch
        self.pmax = pmax
        self.reserved = reserved
        self.metrics = metrics
        self.consumer = consumer
        self._attempt: dict[tuple[int, int], int] = {}

    def forget(self, rid: int) -> None:
        """Drop the attempt counters of a request leaving the system."""
        for key in [k for k in self._attempt if k[0] == rid]:
            del self._attempt[key]

    def send_chunk(self, rid: int, chunk_idx: int, src_ids,
                   dst_ids) -> None:
        """Push one chunk's pages; a re-send (preemption restart or retry)
        bumps the chunk's attempt and so its generation. A report whose tag
        is not this attempt's is a protocol fault and raises."""
        n = len(src_ids)
        if n != len(dst_ids) or not 0 < n <= self.pmax:
            raise ValueError(f"a chunk sends 1..{self.pmax} pages, one "
                             f"destination each: {src_ids} -> {dst_ids}")
        for p in (*src_ids, *dst_ids):
            if p < self.reserved:
                raise PageLedgerError(
                    f"refusing to migrate reserved scratch page {p} "
                    f"(request {rid}): scratch is engine-local parking")
        attempt = self._attempt.get((rid, chunk_idx), -1) + 1
        self._attempt[(rid, chunk_idx)] = attempt
        self.ledger.expect(rid, chunk_idx, dst_ids, src_ids=src_ids,
                           generation=attempt)
        src = [0] * self.pmax
        dst = [0] * self.pmax
        src[:n] = src_ids
        dst[:n] = dst_ids
        t0 = time.perf_counter()
        try:
            landed = np.asarray(self._launch(src, dst, n, attempt))
            got, echoed = int(landed[self.consumer, 0]), \
                int(landed[self.consumer, 1])
        except shd.ShmemError:
            got, echoed = 0, attempt
        if echoed != attempt:
            raise SignalProtocolError(
                f"the transport echoed tag {echoed} for attempt {attempt} "
                f"(request {rid}, chunk {chunk_idx})")
        self.metrics.inc("migrate_chunks")
        self.metrics.observe("migrate_s", time.perf_counter() - t0)
        if self.ledger.landed(rid, chunk_idx, got, generation=attempt):
            self.metrics.inc("pages_migrated", min(got, n))
            self.metrics.observe("migrate_pages_per_chunk", min(got, n))


def _later(what: str, item: str):
    raise NotImplementedError(f"DisaggServingEngine: {what} is not ported "
                              f"yet: ROADMAP.md Queue A, {item}")


class DisaggServingEngine:
    """Continuous-batching serving with prefill and decode on the two ranks
    of a ``role`` axis, KV handed over by page migration (see the module
    docstring).

    ``num_pages`` and ``page_size`` size each role's pool (plus one scratch
    page each). ``num_slots`` is the decode batch; ``num_prefill_slots``
    bounds the prefills in flight; ``prefill_chunk`` is the chunk and the
    migration unit. ``signal_deadline_steps``, ``max_retries`` and
    ``allow_degradation`` set the recovery ladder; the progress watchdog of
    ``run`` sits above the whole ladder's wait. The pools and the params
    live on ``device``, ``cuda`` unless the caller asks for the CPU."""

    def __init__(self, params: dict, cfg: LlamaConfig,
                 ctx: ShmemContext | None = None, axis: str = "role",
                 num_slots: int = 4, num_prefill_slots: int = 2,
                 page_size: int = 16, num_pages: int = 64,
                 pages_per_seq: int = 8, prefill_chunk: int = 16,
                 decode_horizon: int = 1, eos_id: int | None = None,
                 signal_deadline_steps: int = 16, max_retries: int = 3,
                 allow_degradation: bool = True, fault_plan=None,
                 metrics: ServingMetrics | None = None, journal=None, checkpoint_every: int | None = None,
                 queue_cap: int | None = None, ttl_steps: int | None = None,
                 prefix_cache: bool = False, slo=None, artifact=None,
                 artifact_key: str | None = None, device="cuda"):
        for what, value, item in (
                ("fault_plan (the engine tier of shmem/faults.py)",
                 fault_plan, _SERVING),
                ("the journal", journal, _SERVING),
                ("checkpoint_every", checkpoint_every, _SERVING),
                ("queue_cap", queue_cap, _SERVING),
                ("ttl_steps", ttl_steps, _SERVING),
                ("the prefix cache", prefix_cache or None, _SERVING),
                ("the SLO policy", slo, _SERVING),
                ("the AOT artifact", artifact or artifact_key, _TOOLING)):
            if value is not None:
                _later(what, item)
        if prefill_chunk < 1 or decode_horizon < 1:
            raise ValueError("prefill_chunk and decode_horizon must be >= 1")
        if signal_deadline_steps < 1 or max_retries < 0:
            raise ValueError("signal_deadline_steps >= 1 and max_retries "
                             ">= 0")
        dev = default_device(device)
        if params["embed"].device.type != dev.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {dev}")
        if ctx is None:
            ctx = initialize_distributed((axis,), (2,), device=dev)
        if ctx.axis_size(axis) != 2 or ctx.num_ranks != 2:
            raise ValueError(f"disaggregation runs on a mesh of exactly 2 "
                             f"ranks on axis {axis!r}, got "
                             f"{dict(zip(ctx.axis_names, ctx.mesh_shape))}")
        if ctx.device != dev:
            ctx = initialize_distributed(ctx.axis_names, ctx.mesh_shape,
                                         device=dev)
        self.ctx = ctx
        self.axis = axis
        self.device = dev
        self.params = params
        self.cfg = cfg
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.decode_horizon = decode_horizon
        self.eos_id = eos_id
        self.signal_deadline_steps = signal_deadline_steps
        self.max_retries = max_retries
        self.allow_degradation = allow_degradation
        # the stall watchdog sits above the whole ladder's longest wait
        ladder = signal_deadline_steps * (2 ** (max_retries + 1) - 1)
        self._stall_steps = max(256, 4 * ladder)
        # TTFT lives on the prefill worker's panel, ITL on the decode
        # worker's
        self.metrics = metrics or ServingMetrics()
        self.metrics_decode = ServingMetrics()

        # one symmetric pool pair: each role's [L, P + 1, Hkv, ps, D], page
        # 0 its scratch page
        local = (cfg.n_layers, num_pages + 1, cfg.n_kv_heads, page_size,
                 cfg.head_dim)
        self.pool_k = ctx.create_symm_tensor(local, cfg.dtype)
        self.pool_v = ctx.create_symm_tensor(local, cfg.dtype)
        self.pages = [{"k": self.pool_k[r], "v": self.pool_v[r]}
                      for r in (PREFILL_ROLE, DECODE_ROLE)]
        self.alloc_p = KVPagePool(num_pages + 1, page_size, reserved=1)
        self.alloc_d = KVPagePool(num_pages + 1, page_size, reserved=1)
        self.sched_p = ContinuousBatchingScheduler(num_prefill_slots)
        self.sched_d = ContinuousBatchingScheduler(num_slots)
        self._handoff: deque[Request] = deque()   # MIGRATING, no slot yet
        self._dslot: dict[int, int] = {}          # rid -> decode slot
        self._wait_steps: dict[int, int] = {}     # rid -> signal-wait steps
        self._recovery: dict[int, tuple[Deadline, Backoff]] = {}
        self._poisoned: dict[int, Exception] = {}
        self._local_prefill: set[int] = set()
        self._finished: list[Request] = []
        self._failed: list[Request] = []
        self._next_rid = 0
        self._steps = 0

        # the decode worker's slot mirrors; the device copies are
        # authoritative between dispatches
        B = num_slots
        self._token = np.zeros(B, np.int32)
        self._pos = np.zeros(B, np.int32)
        self._bt = np.zeros((B, pages_per_seq), np.int32)
        self._sync_mirrors()
        self._dirty = False

        # the widest migration: a chunk finalises at most C / ps whole
        # pages, the straddle page and the last partial one; a retry may
        # re-send a whole prompt's pages
        pmax = max(prefill_chunk // page_size + 2, pages_per_seq)

        def launch(src, dst, n, tag):
            _, _, landed = migrate_pages(
                ctx, self.pool_k, self.pool_v, src, dst, n, axis=axis,
                producer=PREFILL_ROLE, consumer=DECODE_ROLE, tag=tag)
            landed = landed.cpu()          # waits for the transport
            shd.raise_pending(ctx)
            return landed

        self.channel = PageMigrationChannel(launch, pmax, reserved=1,
                                            metrics=self.metrics,
                                            consumer=DECODE_ROLE)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sync_mirrors(self) -> None:
        self._token_dev = self._upload(self._token)
        self._pos_dev = self._upload(self._pos)
        self._bt_dev = self._upload(self._bt)

    # -- request intake (prefill worker) ----------------------------------
    def submit(self, prompt, max_new_tokens: int,
               rid: int | None = None) -> int:
        """Queue a request on the prefill worker; returns its id."""
        prompt = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        if not prompt or max_new_tokens < 1:
            raise ValueError("a request needs a prompt and "
                             "max_new_tokens >= 1")
        total = len(prompt) + max_new_tokens - 1
        need = -(-total // self.page_size)
        if need > min(self.pages_per_seq,
                      self.alloc_d.num_pages - self.alloc_d.reserved):
            raise ValueError(
                f"request needs {need} pages; pages_per_seq is "
                f"{self.pages_per_seq} and the decode pool holds "
                f"{self.alloc_d.num_pages - self.alloc_d.reserved}")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_token=self.eos_id, submit_step=self._steps,
                      submit_time=time.perf_counter())
        self.metrics.inc("requests_submitted")
        self.sched_p.submit(req)
        return rid

    # -- prefill worker ----------------------------------------------------
    def _can_hold(self, req: Request) -> bool:
        """Admission needs prefill pages to compute into (a preemptee kept
        its filled ones) and the decode-side reservation (kept across
        prefill preemptions)."""
        need = -(-len(req.prompt) // self.page_size)
        need_p = need - len(self.alloc_p.pages_of(req.rid))
        need_d = need - len(self.alloc_d.pages_of(req.rid))
        return (self.alloc_p.free_pages >= max(need_p, 0)
                and self.alloc_d.free_pages >= max(need_d, 0))

    def _admit_prefill(self, slot: int, req: Request) -> None:
        need = -(-len(req.prompt) // self.page_size)
        for alloc in (self.alloc_p, self.alloc_d):
            # the decode-side reservation is fixed now, so every chunk knows
            # its destinations, and landed KV survives a prefill preemption
            have = len(alloc.pages_of(req.rid))
            if need > have:
                got = alloc.alloc(req.rid, need - have)
                assert got is not None, "admissible() guaranteed the pages"
        self.sched_p.activate(slot, req)
        req.state = RequestState.PREFILLING
        if req.prefill_start_time is None:
            req.prefill_start_step = self._steps
            req.prefill_start_time = time.perf_counter()
            self.metrics.observe("ttft_queue_s",
                                 req.prefill_start_time - req.submit_time)
        self.metrics.inc("prefills")

    def _migrate_finalized(self, req: Request, start: int,
                           cursor_new: int) -> None:
        """Send exactly the pages this chunk finalised: whole pages whose
        last token the cursor just passed, and on the last chunk the partial
        last page. Derived from the cursor, so a cursor-resumed preemptee
        never re-sends what it migrated before."""
        ps = self.page_size
        sp = len(req.prompt)
        done_before = start // ps
        done_after = -(-sp // ps) if cursor_new >= sp else cursor_new // ps
        if done_after <= done_before:
            return
        src = self.alloc_p.pages_of(req.rid)[done_before:done_after]
        dst = self.alloc_d.pages_of(req.rid)[done_before:done_after]
        self.alloc_p.check_migratable(req.rid, src)
        self.alloc_d.check_migratable(req.rid, dst)
        self.channel.send_chunk(req.rid, start // self.prefill_chunk, src,
                                dst)

    def _oldest_local_prefill(self) -> tuple[int, Request] | None:
        """The oldest degraded request re-prefilling on the decode
        worker."""
        best = None
        for rid in self._local_prefill:
            slot = self._dslot[rid]
            r = self.sched_d.slots[slot]
            if r is not None and (best is None
                                  or r.admitted_seq < best[1].admitted_seq):
                best = (slot, r)
        return best

    def _chunk(self, role: int, req: Request, alloc: KVPagePool) -> int:
        """One prefill chunk of ``req`` on ``role``'s pool; returns the
        chunk's greedy token (the first token on the prompt's last
        chunk)."""
        C = self.prefill_chunk
        start = req.prefill_cursor
        end = min(start + C, len(req.prompt))
        toks = np.zeros(C, np.int32)
        toks[:end - start] = req.prompt[start:end]
        row = np.asarray(alloc.block_table_row(req.rid, self.pages_per_seq),
                         np.int32)
        tok, _ = prefill_chunk_paged(self.params, self._upload(toks), start,
                                     end, self.cfg, self.pages[role],
                                     self._upload(row))
        return int(tok)

    def _dispatch_chunks(self) -> int:
        """At most one chunk a worker a step: the prefill worker advances its
        oldest PREFILLING slot; the decode worker, in healthy operation
        idle here, advances a degraded request's local re-prefill. The
        prefill worker's last chunk hands its request off as MIGRATING with
        the first token on the host; its prefill pages stay owned as the
        retry source until the decode side confirms coverage. Returns the
        prefill worker's prompt tokens processed."""
        slot_p, req_p = None, None
        for i, r in enumerate(self.sched_p.slots):
            if (r is not None and r.state is RequestState.PREFILLING
                    and (req_p is None
                         or r.admitted_seq < req_p.admitted_seq)):
                slot_p, req_p = i, r
        local = self._oldest_local_prefill()
        C = self.prefill_chunk
        ptoks = 0
        if req_p is not None:
            sp = len(req_p.prompt)
            start = req_p.prefill_cursor
            t0 = time.perf_counter()
            tok0 = self._chunk(PREFILL_ROLE, req_p, self.alloc_p)
            self.metrics.observe("prefill_stall_s", time.perf_counter() - t0)
            ptoks = min(C, sp - start)
            cursor_new = min(start + C, sp)
            req_p.prefill_cursor = cursor_new
            self.metrics.inc("prefill_chunks")
            try:
                self._migrate_finalized(req_p, start, cursor_new)
            except SignalProtocolError as e:
                self._poison(slot_p, req_p, e)
            if req_p.state is RequestState.PREFILLING and cursor_new >= sp:
                req_p.first_token = tok0
                if req_p.first_token_time is None:
                    req_p.first_token_step = self._steps
                    req_p.first_token_time = time.perf_counter()
                    self.metrics.observe(
                        "ttft_s", req_p.first_token_time - req_p.submit_time)
                    self.metrics.observe(
                        "ttft_prefill_s", req_p.first_token_time
                        - req_p.prefill_start_time)
                self.metrics.inc("tokens_generated")
                self.metrics.inc("handoffs")
                self.sched_p.remove(slot_p)
                req_p.state = RequestState.MIGRATING
                if req_p.rid not in self._dslot:
                    self._handoff.append(req_p)
        if local is not None:
            slot_d, req_d = local
            sp_d = len(req_d.prompt)
            start_d = req_d.prefill_cursor
            tok_d = self._chunk(DECODE_ROLE, req_d, self.alloc_d)
            req_d.prefill_cursor = min(start_d + C, sp_d)
            self.metrics_decode.observe("degraded_prefill_tokens",
                                        min(C, sp_d - start_d))
            if req_d.prefill_cursor >= sp_d:
                self._complete_local_prefill(slot_d, req_d, tok_d)
        return ptoks

    def _complete_local_prefill(self, slot: int, req: Request,
                                tok0: int) -> None:
        """A degraded request's local re-prefill finished: it turns ACTIVE
        with the recomputed first token (bitwise the remote one)."""
        self._local_prefill.discard(req.rid)
        self.metrics_decode.observe("degraded_ttft_s",
                                    time.perf_counter() - req.submit_time)
        req.state = RequestState.ACTIVE
        req.generated.append(tok0)
        self.metrics_decode.inc("tokens_generated")
        self._seat(slot, req, tok0)

    def _seat(self, slot: int, req: Request, tok0: int) -> None:
        self._token[slot] = tok0
        self._pos[slot] = len(req.prompt)
        self._bt[slot] = np.asarray(self.alloc_d.block_table_row(
            req.rid, self.pages_per_seq), np.int32)
        self._dirty = True
        if req.done:          # max_new_tokens == 1 or tok0 == eos_id
            self._finish_decode(slot)

    def force_preempt_prefill(self) -> int | None:
        """Evict the youngest prefill slot (a test and operations hook). Its
        filled prefill pages survive (``free_tail``, cursor resume), and
        its decode-side reservation and migrated pages are untouched: the
        resumed prefill migrates only what it newly finalises. Returns the
        evicted slot, or None when nothing is prefilling."""
        victim = self.sched_p.pick_victim()
        if victim is None:
            return None
        self._preempt_prefill(victim)
        return victim

    def _preempt_prefill(self, slot: int) -> None:
        req = self.sched_p.slots[slot]
        filled = -(-req.prefill_cursor // self.page_size)
        if req.prefill_cursor > 0 \
                and filled < len(self.alloc_p.pages_of(req.rid)):
            self.alloc_p.free_tail(req.rid, keep=filled)
        else:
            # no unfilled tail: a full restart; the decode reservation keeps
            # its ids, so the restart migrates to the same destinations
            self.alloc_p.free_seq(req.rid)
            req.prefill_cursor = 0
        self.sched_p.evict(slot)
        self.metrics.inc("preemptions")

    # -- decode worker -----------------------------------------------------
    def _seat_decode_slots(self) -> None:
        while self._handoff:
            slot = self.sched_d.free_slot()
            if slot is None:
                return
            req = self._handoff.popleft()
            self.sched_d.place(slot, req)
            self._dslot[req.rid] = slot

    def _check_signal_gate(self, slot: int, covered: set[int]) -> None:
        """A MIGRATING slot's row may expose only pages whose delivery was
        reported (``landed_row`` makes it so; this makes a regression
        loud)."""
        for p in self._bt[slot]:
            p = int(p)
            if p >= self.alloc_d.reserved and p not in covered:
                raise RuntimeError(
                    f"signal-gate violation: decode block table exposes "
                    f"page {p} before its delivery signal fired")

    def _patch_and_admit(self) -> None:
        """Block-table patching and signal-gated admission, in slot order:
        a MIGRATING slot's row tracks its landed prefix, and the slot turns
        ACTIVE the step its prompt pages are covered. The wait runs against
        a deadline whose expiry walks the recovery ladder."""
        for slot in range(self.num_slots):
            req = self.sched_d.slots[slot]
            if req is None or req.state is not RequestState.MIGRATING:
                continue
            rid = req.rid
            if rid in self._poisoned:
                self._degrade_or_fail(slot, req, self._poisoned.pop(rid))
                continue
            covered = self.channel.ledger.covered(rid)
            row = np.asarray(self.alloc_d.landed_row(
                rid, covered, self.pages_per_seq), np.int32)
            if not np.array_equal(row, self._bt[slot]):
                self._bt[slot] = row
                self._dirty = True
            self._check_signal_gate(slot, covered)
            sp = len(req.prompt)
            need = set(self.alloc_d.pages_of(rid)[:-(-sp // self.page_size)])
            if req.first_token is not None and need <= covered:
                self.metrics_decode.observe("migrate_wait_steps",
                                            self._wait_steps.pop(rid, 0))
                if req.retries:
                    self.metrics_decode.observe(
                        "recovered_ttft_s",
                        time.perf_counter() - req.submit_time)
                self._recovery.pop(rid, None)
                if self.alloc_p.holds(rid):
                    # coverage confirmed: release the retry source
                    self.alloc_p.free_seq(rid)
                req.state = RequestState.ACTIVE
                req.generated.append(req.first_token)
                self.metrics_decode.inc("handoffs")
                self._seat(slot, req, req.first_token)
                continue
            self._wait_steps[rid] = self._wait_steps.get(rid, 0) + 1
            rec = self._recovery.get(rid)
            if rec is None:
                rec = (Deadline(self.signal_deadline_steps, self._steps),
                       Backoff(self.signal_deadline_steps,
                               max_retries=self.max_retries))
                self._recovery[rid] = rec
            deadline, backoff = rec
            if not deadline.expired(self._steps):
                continue
            budget = backoff.next_budget()
            retried = False
            if budget is not None:
                try:
                    retried = self._retry_migration(req)
                except SignalProtocolError as e:
                    self._degrade_or_fail(slot, req, e)
                    continue
            if retried:
                deadline.rearm(budget, self._steps)
                continue
            self._degrade_or_fail(slot, req, MigrationSignalTimeout(
                f"request {rid} waited {self._wait_steps.get(rid, 0)} "
                f"decode steps (deadline {self.signal_deadline_steps}, "
                f"{backoff.attempt} retry rung(s) spent) for migration "
                f"signals covering pages {sorted(need - covered)}; ledger: "
                f"{self.channel.ledger.describe(rid)}. A signal or page "
                "delivery was lost (or a chunk was never sent)."))

    # -- the recovery ladder -----------------------------------------------
    def _retry_migration(self, req: Request) -> bool:
        """Rung 1: send every chunk still short of coverage again, possible
        while the prefill-side sources survive and every missing page
        belongs to a chunk that was sent. True when a re-send went out."""
        rid = req.rid
        if not self.alloc_p.holds(rid):
            return False
        incomplete = self.channel.ledger.incomplete_chunks(rid)
        if not incomplete:
            return False          # a chunk was never sent: nothing to redo
        owned = set(self.alloc_p.pages_of(rid))
        if any(not src or not set(src) <= owned for _, src, _ in incomplete):
            return False
        for ci, src, dst in incomplete:
            self.channel.send_chunk(rid, ci, list(src), list(dst))
        req.retries += 1
        self.metrics_decode.inc("retries")
        return True

    def _degrade_or_fail(self, slot: int, req: Request,
                         exc: Exception) -> None:
        """Rung 2 (a local re-prefill) while the budget allows, else the
        typed per-request failure."""
        if (self.allow_degradation
                and req.degradations < MAX_DEGRADATIONS):
            self._degrade(slot, req)
        else:
            self._fail_decode(slot, req, exc)

    def _drop_recovery(self, rid: int) -> None:
        self._recovery.pop(rid, None)
        self._wait_steps.pop(rid, None)
        self._poisoned.pop(rid, None)

    def _degrade(self, slot: int, req: Request) -> None:
        """Rung 2: the decode worker re-prefills the prompt into its own
        reserved pages with the same chunk program, keeping its slot; all
        migrated coverage is void."""
        rid = req.rid
        req.degradations += 1
        self.metrics_decode.inc("degradations")
        self.channel.ledger.reset(rid)
        self._drop_recovery(rid)
        if self.alloc_p.holds(rid):
            self.alloc_p.free_seq(rid)
        req.state = RequestState.PREFILLING
        req.prefill_cursor = 0
        self._local_prefill.add(rid)
        self._park(slot)

    def _fail_decode(self, slot: int, req: Request, exc: Exception) -> None:
        """The ladder's end: this request fails, typed, and everything else
        runs on."""
        rid = req.rid
        self.sched_d.remove(slot)
        req.state = RequestState.FAILED
        req.failure = exc
        self._release(rid)
        self._park(slot)
        self._failed.append(req)
        self.metrics_decode.inc("failed_requests")

    def _release(self, rid: int, forget: bool = True) -> None:
        """Free both roles' pages and the request's ledger and ladder state;
        a request leaving the system (``forget``) also drops its attempt
        counters."""
        if self.alloc_p.holds(rid):
            self.alloc_p.free_seq(rid)
        if self.alloc_d.holds(rid):
            self.alloc_d.free_seq(rid)
        self.channel.ledger.reset(rid)
        if forget:
            self.channel.forget(rid)
        self._drop_recovery(rid)
        self._local_prefill.discard(rid)
        self._dslot.pop(rid, None)

    def _poison(self, slot: int, req: Request, exc: Exception) -> None:
        """A protocol error while the request is still on the prefill
        worker: void its coverage; the ladder decides at its decode slot,
        unless it cannot degrade, in which case it fails now."""
        self.channel.ledger.reset(req.rid)
        if (self.allow_degradation
                and req.degradations < MAX_DEGRADATIONS):
            self._poisoned[req.rid] = exc
            return
        self.sched_p.remove(slot)
        req.state = RequestState.FAILED
        req.failure = exc
        self._release(req.rid)
        self._failed.append(req)
        self.metrics_decode.inc("failed_requests")

    def _finish_decode(self, slot: int) -> None:
        req = self.sched_d.finish(slot)
        self._release(req.rid)
        req.finish_step = self._steps
        self._park(slot)
        self._finished.append(req)
        self.metrics_decode.inc("requests_finished")

    def _preempt_decode(self, slot: int) -> None:
        """A decode-side victim loses its migrated KV with its pages: it
        restarts as a fresh prefill at the front of the prefill queue
        (greedy decode regenerates the same tokens)."""
        req = self.sched_d.remove(slot)
        req.state = RequestState.QUEUED
        req.preemptions += 1
        req.generated.clear()
        req.prefill_cursor = 0
        req.first_token = None
        self._release(req.rid, forget=False)
        self.sched_p.submit(req, front=True)
        self._park(slot)
        self.metrics_decode.inc("preemptions")

    def _park(self, slot: int) -> None:
        self._token[slot] = 0
        self._pos[slot] = 0
        self._bt[slot] = 0
        self._dirty = True

    # -- one iteration of both workers -------------------------------------
    @property
    def idle(self) -> bool:
        return (self.sched_p.idle and not self._handoff
                and all(s is None for s in self.sched_d.slots))

    def step(self) -> bool:
        """One step of both workers: the prefill worker's admissions, one
        chunk and its migration; the decode worker's seating, patching,
        gated admission and one decode dispatch. Returns False when
        idle."""
        if self.idle:
            return False
        while (adm := self.sched_p.admissible(self._can_hold)) is not None:
            self._admit_prefill(*adm)
        ptoks = self._dispatch_chunks()
        self.metrics.observe("step_prefill_tokens", ptoks)

        t_d = time.perf_counter()
        self._seat_decode_slots()
        self._patch_and_admit()
        limits = np.zeros(self.num_slots, np.int32)
        for slot in range(self.num_slots):
            req = self.sched_d.slots[slot]
            if req is None or req.state is not RequestState.ACTIVE:
                continue
            pos = int(self._pos[slot])
            while not self.alloc_d.ensure(req.rid, pos + 1):
                victim = self.sched_d.pick_victim(exclude_slot=slot)
                if victim is None:
                    raise RuntimeError(
                        f"decode KV pool too small: request {req.rid} "
                        "needs a page with no preemptible peer left")
                self._preempt_decode(victim)
            want = min(self.decode_horizon, req.remaining)
            lim = 1
            while lim < want and self.alloc_d.ensure(req.rid, pos + lim + 1):
                lim += 1
            limits[slot] = lim
            row = np.asarray(self.alloc_d.block_table_row(
                req.rid, self.pages_per_seq), np.int32)
            if not np.array_equal(row, self._bt[slot]):
                self._bt[slot] = row
                self._dirty = True
        for slot in range(self.num_slots):
            r = self.sched_d.slots[slot]
            if r is None or r.state is not RequestState.ACTIVE:
                limits[slot] = 0
        # the decode worker never runs a prefill chunk in healthy operation
        self.metrics_decode.observe("decode_stall_s",
                                    time.perf_counter() - t_d)
        self.metrics_decode.observe("step_prefill_tokens", 0)

        active = [(s, r) for s, r in self.sched_d.active
                  if r.state is RequestState.ACTIVE]
        if not active:
            self._steps += 1
            return True
        if self._dirty:
            self._sync_mirrors()
            self._dirty = False
            self.metrics_decode.inc("host_syncs")

        t_disp = time.perf_counter()
        toks, self._token_dev, self._pos_dev, _ = decode_multistep_paged(
            self.params, self._token_dev, self._pos_dev, self.cfg,
            self.pages[DECODE_ROLE], self._bt_dev, self._upload(limits),
            horizon=self.decode_horizon, eos_id=self.eos_id)
        slab = toks.cpu().numpy()          # [horizon, B]; waits for the card
        t_done = time.perf_counter()

        self._steps += 1
        self.metrics_decode.inc("dispatches")
        self.metrics_decode.inc("decode_steps", int(limits.max()))
        self.metrics_decode.observe("queue_depth", len(self._handoff))
        self.metrics_decode.observe("pool_occupancy",
                                    self.alloc_d.occupancy())
        self.metrics_decode.observe("active_slots", len(active))
        n_tokens = 0
        for slot, req in active:
            emitted = 0
            for i in range(int(limits[slot])):
                req.generated.append(int(slab[i, slot]))
                emitted += 1
                self.metrics_decode.inc("tokens_generated")
                if req.done:
                    break
            self._token[slot] = slab[emitted - 1, slot]
            self._pos[slot] += emitted
            n_tokens += emitted
            if req.done:
                self._finish_decode(slot)
        dev_dt = t_done - t_disp
        host_dt = (t_disp - t_d) + (time.perf_counter() - t_done)
        self.metrics_decode.observe("step_device_s", dev_dt)
        self.metrics_decode.observe("step_host_s", host_dt)
        per_tok = (dev_dt + host_dt) / max(n_tokens, 1)
        for _ in range(n_tokens):
            self.metrics_decode.observe("tok_latency_s", per_tok)
        return True

    def run(self, max_steps: int | None = None,
            arrivals=None) -> dict[int, list[int]]:
        """Drive ``step()`` until idle (or ``max_steps``). ``arrivals`` is
        an optional iterable of (step_index, prompt, max_new_tokens), sorted
        by step. Returns {rid: tokens} of the FINISHED requests (``failed``
        has the others). A progress watchdog raises ``EngineStallError``
        when nothing moves for longer than any wait of the ladder."""
        pending = deque(arrivals or [])
        i = 0
        marker, since = self._progress_marker(), 0
        while max_steps is None or i < max_steps:
            while pending and pending[0][0] <= i:
                _, prompt, max_new_tokens = pending.popleft()
                self.submit(prompt, max_new_tokens)
            if not self.step() and not pending:
                break
            i += 1
            m = self._progress_marker()
            if m != marker:
                marker, since = m, 0
                continue
            since += 1
            if since >= self._stall_steps and not self.idle:
                raise EngineStallError(self._stall_report(since))
        return {req.rid: list(req.generated) for req in self._finished}

    def _progress_marker(self) -> tuple:
        """What moves while the engine makes progress: tokens, chunks,
        migrations and every rung of the ladder."""
        c, d = self.metrics.counters, self.metrics_decode.counters
        return (c["prefill_chunks"], c["pages_migrated"], c["migrate_chunks"],
                d["tokens_generated"], d["handoffs"], d["retries"],
                d["degradations"], d["failed_requests"], d["preemptions"],
                len(self._finished), len(self._failed),
                self.metrics_decode.hist["degraded_prefill_tokens"].count)

    def _stall_report(self, since: int) -> str:
        rows = [f"{name}[{slot}]: rid={req.rid} {req.state.value} "
                f"cursor={req.prefill_cursor} retries={req.retries} "
                f"degradations={req.degradations}"
                for name, sched in (("prefill", self.sched_p),
                                    ("decode", self.sched_d))
                for slot, req in sched.active]
        counters = {k: v for k, v in self.metrics.counters.items() if v}
        counters_d = {k: v for k, v in self.metrics_decode.counters.items()
                      if v}
        return (f"engine made no progress for {since} steps (stall deadline "
                f"{self._stall_steps}, step {self._steps}); queues: "
                f"prefill={self.sched_p.queue_depth} "
                f"handoff={len(self._handoff)} "
                f"local_prefill={sorted(self._local_prefill)} "
                f"recovering={sorted(self._recovery)} "
                f"poisoned={sorted(self._poisoned)}; slots: "
                + ("; ".join(rows) if rows else "<none>")
                + "\ncounters: " + json.dumps(counters)
                + "\ncounters_decode: " + json.dumps(counters_d))

    @property
    def failed(self) -> list[Request]:
        """The requests the ladder could not save, in failure order; each
        carries its typed reason in ``req.failure``."""
        return list(self._failed)


__all__ = ["ChunkSignalLedger", "DECODE_ROLE", "DisaggServingEngine",
           "MigrationSignalTimeout", "PREFILL_ROLE", "PageMigrationChannel",
           "SignalProtocolError"]
