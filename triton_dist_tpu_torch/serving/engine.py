"""The continuous-batching serving engine over the paged decode step.

Counterpart of ``triton_dist_tpu/serving/engine.py::ServingEngine`` (its core
loop). One dispatch runs ``models.llama.decode_multistep_paged`` over
``num_slots`` fixed rows and advances every live slot up to
``decode_horizon`` tokens:

- a request holds one slot from admission to finish. Parked rows point at
  the reserved scratch page 0 with pos 0; their writes land there and their
  tokens are ignored, so the batch never changes shape.
- the page pool is updated in place by every dispatch (the JAX engine
  donates it to its jitted step, to the same effect).
- admission is either bucketed inline prefill (the prompt padded to a
  bucket, a contiguous cache, then ``cache_to_pages``) or, with
  ``prefill_chunk`` set, chunked paged prefill: at most one chunk per step
  (``prefill_chunk_paged``), co-scheduled with the decode dispatch, writing
  straight into pages.

Host and device: ``token``, ``pos`` and ``block_table`` live on the device
between dispatches; the host keeps numpy mirrors for its decisions (growth,
finishes, preemption) and uploads them again only after such a change
(counted as ``host_syncs``). The only download per dispatch is the
``[horizon, num_slots]`` token slab; a chunk downloads its one token.

Determinism: greedy decode and deterministic allocation make a request's
tokens a function of (params, prompt) alone, so a preempted and restarted
request regenerates exactly the tokens it lost, and a contended run equals
an uncontended one request by request.

Ledger ids and device rows: the allocator hands out page ids; the device
pool is indexed by rows (``KVPagePool.device_row``, the identity under the
default "blocked" layout). Every id that goes to the device goes through
``_device_rows``; the ledger never sees rows.

Left for later slices: the journal and checkpoints, the prefix cache, SLO
policies and chunk budgets, bounded queues and TTLs, speculation, the AOT
artifact, fault injection and the sigcheck lint.
"""

from __future__ import annotations

import json
import time
from collections import deque

import numpy as np
import torch

from triton_dist_tpu_torch.models.llama import (LlamaConfig,
                                                decode_multistep_paged,
                                                init_kv_cache,
                                                init_page_pool, prefill,
                                                prefill_chunk_paged)
from triton_dist_tpu_torch.serving.deadline import EngineStallError
from triton_dist_tpu_torch.serving.kv_pool import (KVPagePool, _fnv1a,
                                                   cache_to_pages)
from triton_dist_tpu_torch.serving.metrics import ServingMetrics
from triton_dist_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler, Request, RequestState)
from triton_dist_tpu_torch.utils.env import default_device


class ServingEngine:
    """Continuous-batching serving engine over the paged decode step.

    ``num_pages`` counts usable pages; one more scratch page (id 0) is
    allocated for parked rows. ``pages_per_seq`` bounds one sequence's pages
    (the block-table width). ``decode_horizon`` is K, the decode steps per
    dispatch. ``prefill_buckets`` is ``"pow2"`` (pad prompts to the next
    power of two, at least 8), an ascending tuple of bucket lengths, or
    ``None`` for exact-length prefill. ``eos_id`` ends a request early.
    ``prefill_chunk`` switches admission to chunked paged prefill (one
    chunk per step; ``prefill_buckets`` is then unused). ``ffn(h, p)``
    replaces every layer's dense FFN in the decode dispatch and, unless
    ``ffn_chunk`` is given, in the prefill chunks (the MoE engine,
    ``serving.sharded``). ``attn_io`` and ``linear`` hook every layer's KV
    write and attention pair and its projections in both programs
    (``models.llama.decode_step_paged``). A hooked engine needs
    ``prefill_chunk``, since the bucketed inline prefill takes no hook. A
    subclass may set ``_pool_sp_ranks`` and ``_pool_layout`` before calling
    this constructor; they shape the ledger's device layout. The params and
    the pool live on ``device``, ``cuda`` unless the caller asks for the CPU.
    """

    def __init__(self, params: dict, cfg: LlamaConfig, num_slots: int = 4,
                 page_size: int = 16, num_pages: int = 64,
                 pages_per_seq: int = 8, decode_horizon: int = 1,
                 prefill_buckets="pow2", eos_id: int | None = None,
                 prefill_chunk: int | None = None,
                 stall_deadline_steps: int = 256, ffn=None, ffn_chunk=None,
                 attn_io=None, linear=None, device="cuda"):
        assert decode_horizon >= 1
        hooked = any(h is not None for h in (ffn, ffn_chunk, attn_io,
                                             linear))
        if hooked and prefill_chunk is None:
            raise ValueError("an ffn, attn_io or linear hook needs "
                             "prefill_chunk set: the bucketed inline prefill "
                             "takes no hook")
        assert prefill_chunk is None or prefill_chunk >= 1
        assert stall_deadline_steps >= 1
        self.device = default_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.num_slots = num_slots
        self.metrics = ServingMetrics()
        self.decode_horizon = decode_horizon
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self.ffn = ffn
        self.ffn_chunk = ffn_chunk or ffn
        self.attn_io = attn_io
        self.linear = linear
        self._stall_steps = stall_deadline_steps
        if prefill_buckets is not None and prefill_buckets != "pow2":
            prefill_buckets = tuple(sorted(int(b) for b in prefill_buckets))
            assert prefill_buckets, "bucket list must be non-empty"
        self.prefill_buckets = prefill_buckets

        self.alloc = KVPagePool(num_pages + 1, page_size, reserved=1,
                                sp_ranks=getattr(self, "_pool_sp_ranks", 1),
                                layout=getattr(self, "_pool_layout",
                                               "blocked"))
        self.pool = init_page_pool(cfg, self.alloc.device_pages, page_size,
                                   device=self.device)
        self.sched = ContinuousBatchingScheduler(num_slots)
        self._next_rid = 0
        self._steps = 0
        self._finished: list[Request] = []

        # host mirrors of the per-slot device state; the device copies are
        # authoritative between dispatches
        self._token = np.zeros(num_slots, np.int32)
        self._pos = np.zeros(num_slots, np.int32)
        self._bt = np.zeros((num_slots, pages_per_seq), np.int32)
        self._sync_mirrors()
        self._dirty = False

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sync_mirrors(self) -> None:
        """Upload the host slot mirrors to the device copies."""
        self._token_dev = self._upload(self._token)
        self._pos_dev = self._upload(self._pos)
        self._bt_dev = self._upload(self._bt)

    def _device_rows(self, ids) -> np.ndarray:
        """Ledger page ids as rows of the device pool."""
        return np.asarray([self.alloc.device_row(int(p)) for p in ids],
                          np.int32)

    def _bt_row(self, rid) -> np.ndarray:
        """The request's block-table row, in device rows."""
        return self._device_rows(
            self.alloc.block_table_row(rid, self.pages_per_seq))

    # -- request intake ---------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue a request; returns its id (ids count up from 0)."""
        prompt = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        if not prompt or max_new_tokens < 1:
            raise ValueError("a request needs a prompt and "
                             "max_new_tokens >= 1")
        total = len(prompt) + max_new_tokens - 1   # KV the request may hold
        need = -(-total // self.page_size)
        if need > min(self.pages_per_seq,
                      self.alloc.num_pages - self.alloc.reserved):
            raise ValueError(
                f"request needs {need} pages; pages_per_seq is "
                f"{self.pages_per_seq} and the pool holds "
                f"{self.alloc.num_pages - self.alloc.reserved}, so it could "
                "never run")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_token=self.eos_id, submit_step=self._steps,
                      submit_time=time.perf_counter())
        self.metrics.inc("requests_submitted")
        self.sched.submit(req)
        return rid

    # -- prefill + admission ----------------------------------------------
    def _bucket_len(self, prompt_len: int) -> int:
        """Bucket (padded) length for a prompt."""
        if self.prefill_buckets is None:
            return prompt_len
        if self.prefill_buckets == "pow2":
            b = 8
            while b < prompt_len:
                b *= 2
            return b
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket {self.prefill_buckets[-1]}")

    def _mark_prefill_start(self, req: Request) -> None:
        """Queue time ends at the FIRST admission (a re-admission after
        preemption keeps the original clock)."""
        if req.prefill_start_time is None:
            req.prefill_start_step = self._steps
            req.prefill_start_time = time.perf_counter()
            self.metrics.observe("ttft_queue_s",
                                 req.prefill_start_time - req.submit_time)

    def _record_first_token(self, req: Request) -> None:
        if req.first_token_time is None:
            req.first_token_step = self._steps
            req.first_token_time = time.perf_counter()
            self.metrics.observe("ttft_s",
                                 req.first_token_time - req.submit_time)
            self.metrics.observe("ttft_prefill_s",
                                 req.first_token_time - req.prefill_start_time)

    def _start_decoding(self, slot: int, req: Request, tok0: int,
                        row: np.ndarray) -> None:
        """The prompt's KV is in pages and its first token known: seat the
        slot's mirrors for the next decode dispatch."""
        req.generated.append(tok0)
        self.metrics.inc("tokens_generated")
        self._record_first_token(req)
        self._token[slot] = tok0
        self._pos[slot] = len(req.prompt)
        self._bt[slot] = row
        self._dirty = True
        if req.done:            # max_new_tokens == 1 or tok0 == eos_id
            self._finish(slot)

    def _admit(self, slot: int, req: Request) -> None:
        if self.prefill_chunk is not None:
            self._admit_chunked(slot, req)
            return
        sp = len(req.prompt)
        bucket = self._bucket_len(sp)
        self._mark_prefill_start(req)
        pages = self.alloc.alloc(req.rid, -(-sp // self.page_size))
        assert pages is not None, "admissible() guaranteed the pages"
        cache_len = -(-bucket // self.page_size) * self.page_size
        cache = init_kv_cache(self.cfg, 1, cache_len, device=self.device)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :sp] = req.prompt
        length = None if self.prefill_buckets is None else \
            self._upload(np.asarray([sp], np.int32))
        logits, cache = prefill(self.params, self._upload(toks), self.cfg,
                                cache, length=length)
        # only the prompt's pages are handed off; the padded rows of the
        # last page are overwritten by decode before any read reaches them
        bt_row = self._upload(self._device_rows(pages)[None])
        cache_to_pages(cache["k"], self.pool["k"], bt_row)
        cache_to_pages(cache["v"], self.pool["v"], bt_row)
        tok0 = int(logits[0].argmax())
        self.sched.activate(slot, req)
        self.metrics.inc("prefills")
        self._start_decoding(slot, req, tok0, self._bt_row(req.rid))

    def _admit_chunked(self, slot: int, req: Request) -> None:
        """Chunked admission does no prefill math: allocate the prompt's
        pages (a mid-prefill preemptee already owns its filled ones and
        resumes at its cursor) and seat the slot in PREFILLING. The chunks
        run one per step, co-scheduled with decode."""
        n_pages = -(-len(req.prompt) // self.page_size)
        have = len(self.alloc.pages_of(req.rid))
        if n_pages > have:
            got = self.alloc.alloc(req.rid, n_pages - have)
            assert got is not None, "admissible() guaranteed the pages"
        self.sched.activate(slot, req)
        req.state = RequestState.PREFILLING
        self._mark_prefill_start(req)
        self.metrics.inc("prefills")
        # the slot's mirrors stay parked until the last chunk lands: the
        # chunk carries its own block-table row

    def _dispatch_prefill_chunk(self) -> int:
        """Run at most one prefill chunk: the oldest PREFILLING slot
        advances its cursor by one chunk. The last chunk's token is the
        first generated token and the slot starts decoding this very step.
        Returns the prompt tokens processed (0 = no prefill work)."""
        slot, req = None, None
        for i, r in enumerate(self.sched.slots):
            if (r is not None and r.state is RequestState.PREFILLING
                    and (req is None or r.admitted_seq < req.admitted_seq)):
                slot, req = i, r
        if slot is None:
            return 0
        C = self.prefill_chunk
        sp = len(req.prompt)
        start = req.prefill_cursor
        end = min(start + C, sp)
        toks = np.zeros(C, np.int32)
        toks[:end - start] = req.prompt[start:end]
        row = self._bt_row(req.rid)
        t0 = time.perf_counter()
        tok_dev, self.pool = prefill_chunk_paged(
            self.params, self._upload(toks), start, end, self.cfg, self.pool,
            self._upload(row), ffn=self.ffn_chunk, attn_io=self.attn_io,
            linear=self.linear)
        # one int32 download: it fences the chunk for the stall timing and,
        # on the last chunk, is the first token
        tok0 = int(tok_dev)
        self.metrics.observe("prefill_stall_s", time.perf_counter() - t0)
        req.prefill_cursor = end
        self.metrics.inc("prefill_chunks")
        if end == sp:
            req.state = RequestState.ACTIVE
            self._start_decoding(slot, req, tok0, row)
        return end - start

    # -- slot teardown ----------------------------------------------------
    def _finish(self, slot: int) -> None:
        req = self.sched.finish(slot)
        self.alloc.free_seq(req.rid)
        req.finish_step = self._steps
        self._park(slot)
        self._finished.append(req)
        self.metrics.inc("requests_finished")

    def _preempt(self, slot: int) -> None:
        req = self.sched.slots[slot]
        filled = -(-req.prefill_cursor // self.page_size)
        if (req.state is RequestState.PREFILLING and req.prefill_cursor > 0
                and filled < len(self.alloc.pages_of(req.rid))):
            # mid-prefill victim with an unfilled tail: keep the pages that
            # hold computed KV, requeue at the chunk cursor
            self.alloc.free_tail(req.rid, keep=filled)
        else:
            # a decoding victim (or a prefill with no tail to reclaim)
            # restarts from its prompt
            self.alloc.free_seq(req.rid)
            req.prefill_cursor = 0
        self.sched.evict(slot)
        self._park(slot)
        self.metrics.inc("preemptions")

    def _park(self, slot: int) -> None:
        """Point an empty slot at the scratch page: its writes land on page
        0 (reserved, never a live sequence's) and its reads mask out."""
        self._token[slot] = 0
        self._pos[slot] = 0
        self._bt[slot] = 0
        self._dirty = True

    # -- one engine iteration ---------------------------------------------
    def step(self) -> bool:
        """Admissions (prefill) and one batched decode dispatch (up to
        ``decode_horizon`` tokens per slot), then ``_post_step`` after a
        productive step. Returns False when idle."""
        progressed = self._step_impl()
        if progressed:
            self._post_step()
        return progressed

    def _post_step(self) -> None:
        """Called after every productive step (the sharded engine checks
        its replicated decisions here)."""

    def control_digest(self) -> int:
        """FNV-1a digest of the host control plane (allocator and
        scheduler): the word the sharded engine compares across ranks."""
        return _fnv1a(0x811C9DC5, self.alloc.digest(), self.sched.digest())

    def _step_impl(self) -> bool:
        t_begin = time.perf_counter()
        if self.sched.idle:
            return False

        def can_hold(req: Request) -> bool:
            need = -(-len(req.prompt) // self.page_size)
            if self.prefill_chunk is not None:
                need -= len(self.alloc.pages_of(req.rid))
            return self.alloc.free_pages >= need

        prefilled_tokens = 0
        while (adm := self.sched.admissible(can_hold)) is not None:
            if self.prefill_chunk is None:
                prefilled_tokens += len(adm[1].prompt)
            self._admit(*adm)
        if self.prefill_chunk is not None:
            prefilled_tokens = self._dispatch_prefill_chunk()
        self.metrics.observe("decode_stall_s", time.perf_counter() - t_begin)
        self.metrics.observe("step_prefill_tokens", prefilled_tokens)

        # allocate-on-decode growth in slot order, preempting the youngest
        # when the pool is dry. The first step of the horizon is guaranteed;
        # the rest grow page by page without preempting, and the slot's
        # limit stops where growth stops, so no row outgrows its pages.
        limits = np.zeros(self.num_slots, np.int32)
        for slot in range(self.num_slots):
            req = self.sched.slots[slot]
            if req is None or req.state is not RequestState.ACTIVE:
                continue
            pos = int(self._pos[slot])
            while not self.alloc.ensure(req.rid, pos + 1):
                victim = self.sched.pick_victim(exclude_slot=slot)
                if victim is None:
                    raise RuntimeError(
                        f"KV pool too small: request {req.rid} needs a page "
                        "with no preemptible peer left")
                self._preempt(victim)
            want = min(self.decode_horizon, req.remaining)
            lim = 1
            while lim < want and self.alloc.ensure(req.rid, pos + lim + 1):
                lim += 1
            limits[slot] = lim
            row = self._bt_row(req.rid)
            if not np.array_equal(row, self._bt[slot]):
                self._bt[slot] = row
                self._dirty = True
        # a slot preempted while a later slot grew already has a limit
        for slot in range(self.num_slots):
            r = self.sched.slots[slot]
            if r is None or r.state is not RequestState.ACTIVE:
                limits[slot] = 0

        active = [(s, r) for s, r in self.sched.active
                  if r.state is RequestState.ACTIVE]
        if not active:
            if not prefilled_tokens and self.sched.idle:
                return False
            # a prefill chunk ran, or queued work is blocked: the step
            # still counts, so the clock moves
            self._steps += 1
            return True

        if self._dirty:
            self._sync_mirrors()
            self._dirty = False
            self.metrics.inc("host_syncs")

        t_disp = time.perf_counter()
        toks, self._token_dev, self._pos_dev, self.pool = \
            decode_multistep_paged(self.params, self._token_dev,
                                   self._pos_dev, self.cfg, self.pool,
                                   self._bt_dev, self._upload(limits),
                                   horizon=self.decode_horizon,
                                   eos_id=self.eos_id, ffn=self.ffn,
                                   attn_io=self.attn_io, linear=self.linear)
        slab = toks.cpu().numpy()          # [horizon, B]; waits for the card
        t_done = time.perf_counter()

        self._steps += 1
        self.metrics.inc("dispatches")
        self.metrics.inc("decode_steps", int(limits.max()))
        self.metrics.observe("queue_depth", self.sched.queue_depth)
        self.metrics.observe("pool_occupancy", self.alloc.occupancy())
        self.metrics.observe("active_slots", len(active))

        n_tokens = 0
        for slot, req in active:
            emitted = 0
            for i in range(int(limits[slot])):
                req.generated.append(int(slab[i, slot]))
                emitted += 1
                self.metrics.inc("tokens_generated")
                if req.done:               # budget exhausted or EOS
                    break
            # the device froze this row after the same ``emitted`` steps, so
            # the mirrors stay equal to the device carry
            self._token[slot] = slab[emitted - 1, slot]
            self._pos[slot] += emitted
            n_tokens += emitted
            if req.done:
                self._finish(slot)

        dev_dt = t_done - t_disp
        host_dt = (t_disp - t_begin) + (time.perf_counter() - t_done)
        self.metrics.observe("step_device_s", dev_dt)
        self.metrics.observe("step_host_s", host_dt)
        per_tok = (dev_dt + host_dt) / max(n_tokens, 1)
        for _ in range(n_tokens):
            self.metrics.observe("tok_latency_s", per_tok)
        return True

    def run(self, max_steps: int | None = None,
            arrivals=None) -> dict[int, list[int]]:
        """Drive ``step()`` until idle (or ``max_steps``). ``arrivals`` is an
        optional iterable of (step_index, prompt, max_new_tokens) tuples,
        sorted by step. Returns {rid: generated tokens} for finished
        requests.

        A progress watchdog raises ``EngineStallError`` after
        ``stall_deadline_steps`` consecutive non-idle steps with no counter
        movement, instead of spinning forever."""
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
            if since >= self._stall_steps and not self.sched.idle:
                slots = "; ".join(
                    f"[{s}] rid={r.rid} {r.state.value} "
                    f"cursor={r.prefill_cursor}"
                    for s, r in self.sched.active)
                counters = {k: v for k, v in self.metrics.counters.items()
                            if v}
                raise EngineStallError(
                    f"engine made no progress for {since} steps (stall "
                    f"deadline {self._stall_steps}); queue="
                    f"{self.sched.queue_depth}, slots: {slots or '<none>'}"
                    f"\ncounters: {json.dumps(counters)}")
        return {req.rid: list(req.generated) for req in self._finished}

    def _progress_marker(self) -> tuple:
        c = self.metrics.counters
        return (c["tokens_generated"], c["prefills"], c["prefill_chunks"],
                c["preemptions"], c["requests_finished"])


__all__ = ["ServingEngine"]
