"""Serving metrics: counters + histograms, emitted as JSON lines.

A copy of ``triton_dist_tpu/serving/metrics.py`` with the same counter and
histogram names, so the metrics JSON line reads the same. The port's engine
moves the core counters; the rest stay 0 until their features are ported.

One ``ServingMetrics`` per engine. Everything is host-side and O(1) per
event; histograms keep (count, sum, min, max) plus a bounded reservoir so
percentiles stay cheap and memory stays flat over million-request runs.
``json_line()`` is the wire format — one self-contained JSON object per
call, the shape the JAX package's ``scripts/serve_sim.py`` prints.
"""

from __future__ import annotations

import json
import time


class Histogram:
    """Streaming histogram: exact count/sum/min/max + a bounded sample
    reservoir (deterministic stride thinning, no RNG — replays emit
    identical metrics) for approximate percentiles."""

    def __init__(self, max_samples: int = 512):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples: list[float] = []
        self._max_samples = max_samples
        self._stride = 1

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        if (self.count - 1) % self._stride == 0:
            self._samples.append(value)
            if len(self._samples) >= self._max_samples:
                # thin deterministically: keep every other sample, double
                # the stride — the reservoir stays size-bounded and replay-
                # stable (random eviction would jitter the percentiles)
                self._samples = self._samples[::2]
                self._stride *= 2

    def percentile(self, q: float) -> float | None:
        if not self._samples:
            return None
        s = sorted(self._samples)
        idx = min(int(q / 100.0 * len(s)), len(s) - 1)
        return s[idx]

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class ServingMetrics:
    """The engine's instrument panel:

    counters — tokens generated, requests submitted/finished, prefills,
    preemptions, decode steps (inner device steps: += horizon per
    dispatch), dispatches (host→device decode launches — at horizon K one
    dispatch covers up to K steps, so dispatches ≲ decode_steps / K),
    host_syncs (dispatches that had to re-upload host slot state after a
    control-plane change — admission, finish, preemption, growth; a quiet
    dispatch reuses the device-resident carry and uploads nothing);
    histograms — TTFT (s), per-token latency (s), queue depth (sampled
    per step), pool occupancy (fraction, sampled per step), batch
    occupancy (active slots per step), per-dispatch device time and host
    overhead (s) — the device/host split bench.py reports.
    """

    def __init__(self):
        self.counters = {
            "requests_submitted": 0,
            "requests_finished": 0,
            "prefills": 0,
            "preemptions": 0,
            "decode_steps": 0,
            "dispatches": 0,
            "host_syncs": 0,
            "tokens_generated": 0,
            # chunked-prefill dispatches: with chunking on,
            # EVERY prompt token enters pages through a chunk program —
            # the contiguous-cache converters and the host argmax never
            # run (tests assert this via prefill_chunks > 0)
            "prefill_chunks": 0,
            # sharded serving: replicated-decision digest
            # cross-checks run (each one all-gathered the control-plane
            # digest over the mesh and compared every rank to rank 0)
            "digest_checks": 0,
            # disaggregated serving: pages pushed over the
            # one-sided shmem layer, migration kernel launches (one per
            # finished chunk with at least one finalized page), and
            # completed prefill→decode handoffs
            "pages_migrated": 0,
            "migrate_chunks": 0,
            "handoffs": 0,
            # robustness ladder: signal-deadline expiries that
            # re-issued a chunk's migrate send, requests rescued by
            # decode-local re-prefill after retries ran out, requests
            # that exhausted the whole ladder and were failed (typed,
            # per-request — the engine keeps running), landed reports
            # discarded because their generation tag was stale (they
            # arrived after a retry re-armed the chunk), and host-tier
            # fault-plan injections actually applied to this engine
            "retries": 0,
            "degradations": 0,
            "failed_requests": 0,
            "stale_signals": 0,
            "faults_injected": 0,
            # crash consistency: control-plane checkpoints
            # captured into the journal, restores completed (from a
            # checkpoint + journal-suffix replay), digest divergences
            # absorbed by the sharded restore rung instead of raised,
            # and the overload terminals — submits rejected at a full
            # bounded queue, queued requests expired past their TTL
            "checkpoints": 0,
            "restores": 0,
            "digest_recoveries": 0,
            "rejections": 0,
            "expirations": 0,
            # prefix caching: admissions that adopted at least
            # one cached page vs admissions that matched nothing, total
            # prompt tokens served straight from adopted pages (never
            # recomputed), copy-on-write page copies (a writer diverged
            # from a shared page), and cached pages reclaimed by LRU
            # eviction to refill the free list
            "prefix_hits": 0,
            "prefix_misses": 0,
            "prefix_hit_tokens": 0,
            "cow_copies": 0,
            "prefix_evictions": 0,
            "prefix_skipped_chunks": 0,
            "router_radix_hits": 0,
            "router_radix_misses": 0,
            # multi-tenant SLO policy: admission-scan skips of
            # a class head whose tenant token bucket was dry (mirrored
            # from the scheduler's cumulative count each step), and
            # prefill chunks shrunk below prefill_chunk because a
            # stall-budgeted class was decoding (deadline-aware sizing)
            "quota_throttled": 0,
            "chunk_shrinks": 0,
            # cluster prefix lending: completed lends (one per
            # borrowed prefix), pages and prompt tokens delivered through
            # them, lend attempts that degraded to local re-prefill (dead
            # or slow lender — the request proceeds cold, never stalls),
            # and prefixes a restored replica re-warmed from peers
            # instead of cold re-prefilling
            "lends": 0,
            "lent_pages": 0,
            "lend_tokens": 0,
            "lend_degradations": 0,
            "rewarmed_prefixes": 0,
            # elastic autoscaling: fleet membership changes
            # (replicas added / drains begun / drains reaching quiescence
            # / replicas retired), queued requests a draining replica
            # handed back through its journal cursor for re-placement on
            # a peer, total replica-steps actually run (the counterfactual
            # bench row divides this by static-peak provisioning), drain-
            # time lend-ahead pushes (one per prefix landed on its
            # rendezvous successor, plus the pages they carried), and
            # lend-ahead attempts that degraded to a typed no-op because
            # an engine lacked the lend surface (mixed fleets)
            "scale_ups": 0,
            "drains_begun": 0,
            "drains_done": 0,
            "retires": 0,
            "requeues": 0,
            "replica_steps": 0,
            "lend_aheads": 0,
            "lend_ahead_pages": 0,
            "lend_ahead_noops": 0,
            # speculative decoding: verify dispatches run with
            # speculation on, draft positions those dispatches scored
            # (position 0 consumes the authentic last token, so a
            # K-horizon dispatch drafts K-1), drafts that committed
            # (draft == verified argmax — ``draft_hit_rate`` in
            # ``snapshot()`` is accepted/drafted), and dispatches that
            # rejected a suffix and rewound its KV past the accepted
            # cursor
            "spec_dispatches": 0,
            "draft_tokens": 0,
            "draft_accepted": 0,
            "spec_rewinds": 0,
        }
        self.hist = {
            "ttft_s": Histogram(),
            # TTFT split: queue wait (submit → first admission) vs
            # prefill latency (first admission → first token) — the two
            # levers chunked prefill trades between
            "ttft_queue_s": Histogram(),
            "ttft_prefill_s": Histogram(),
            "tok_latency_s": Histogram(),
            "queue_depth": Histogram(),
            "pool_occupancy": Histogram(),
            "active_slots": Histogram(),
            "step_device_s": Histogram(),
            "step_host_s": Histogram(),
            # per-chunk dispatch latency (one prefill chunk per step max)
            "prefill_stall_s": Histogram(),
            # per-step decode stall: time the step spent on admission +
            # prefill work before the decode dispatch could launch —
            # bounded by one chunk when chunking is on, by the whole
            # prompt (inline prefill) when it is off
            "decode_stall_s": Histogram(),
            # prompt tokens prefilled in the step (the token-space stall
            # bound the simulator regression test asserts: max ≤ chunk)
            "step_prefill_tokens": Histogram(),
            # disaggregated serving: per-chunk migration launch
            # latency (s), pages per migrated chunk, and how many decode-
            # worker steps a completed prefill waited for its covering
            # signals (0 = admitted the very step the last chunk landed)
            "migrate_s": Histogram(),
            "migrate_pages_per_chunk": Histogram(),
            "migrate_wait_steps": Histogram(),
            # robustness ladder: TTFT of requests that needed
            # at least one retry but still handed off (recovered), TTFT
            # of requests rescued by decode-local re-prefill (degraded;
            # measured at local prefill completion), and prompt tokens
            # re-prefilled locally per degraded chunk — kept OUT of
            # step_prefill_tokens so the decode-cadence isolation
            # invariant (max == 0 on the decode panel in fault-free
            # runs) stays pinned
            "recovered_ttft_s": Histogram(),
            "degraded_ttft_s": Histogram(),
            "degraded_prefill_tokens": Histogram(),
            # crash consistency: wall time per checkpoint
            # capture, per restore (snapshot rebuild + journal-suffix
            # replay — host-only, zero dispatches), and per absorbed
            # digest divergence (the sharded restore rung end-to-end)
            "checkpoint_s": Histogram(),
            "restore_s": Histogram(),
            "digest_recovery_s": Histogram(),
            # prefix caching: the TTFT split the cache exists
            # to move — first-token latency of admissions that adopted
            # cached pages vs ones that prefilled from scratch
            "ttft_cached_s": Histogram(),
            "ttft_cold_s": Histogram(),
            # overlapped serving: per-decode-step EP wire time
            # split by the wire-fit model — comm the schedule still
            # exposes on the critical path vs comm hidden behind expert
            # FFN compute by the microbatch pipeline. MODELED (t = t0 +
            # bytes/BW per a2a round), not wall clock: CPU test runs
            # serialize ranks and can never exhibit real overlap, so the
            # honest number is the model, labeled as such (docs/
            # serving.md). overlap=off exposes everything; n_ep=1 has no
            # wire and observes zeros.
            "exposed_comm_us": Histogram(),
            "overlapped_comm_us": Histogram(),
            # long-context serving: per-decode-step attention
            # split under ``flash_decode_dist`` — the local per-page
            # partial walk (∝ this rank's OWN slice of the block-table
            # pages: the half that shrinks as the SP mesh grows) vs the
            # fixed-order fold's wait on the remote partial slabs.
            # MODELED on the same wire fit as exposed/overlapped_comm_us
            # (CPU runs serialize ranks and cannot exhibit the real
            # overlap), labeled as such in docs/serving.md; zeros outside
            # long_context mode.
            "attn_local_us": Histogram(),
            "attn_fold_wait_us": Histogram(),
            # cluster prefix lending: the kill/restore TTFT
            # split — cold (no cached pages), cached (locally cached
            # pages adopted), re-warmed (adopted pages arrived via the
            # lending tier: a peer's lend or a post-restore re-warm).
            # The ``_steps`` trio is the deterministic engine-step-space
            # twin the SimEngine/cluster_sim panels report (wall TTFT is
            # meaningless for a host-only engine); ``ttft_rewarmed_s``
            # extends the cached/cold wall-clock pair for device engines.
            "ttft_rewarmed_s": Histogram(),
            "ttft_cold_steps": Histogram(),
            "ttft_cached_steps": Histogram(),
            "ttft_rewarmed_steps": Histogram(),
            # lend wall time per page (µs) — the bench row
            "lend_us_per_page": Histogram(),
            # elastic autoscaling: deterministic step-space
            # TTFT/ITL (the series the per-class SLO attainment windows
            # sample — wall clock would make scale decisions replay-
            # unstable), fleet size sampled once per cluster step, and
            # the wall seconds each scale-up spent building its engine
            # (artifact load dominates when an AOT artifact is threaded —
            # the scale-up-to-first-token split cluster_sim reports)
            "ttft_steps": Histogram(),
            "itl_steps": Histogram(),
            "fleet_size": Histogram(),
            "scale_up_build_s": Histogram(),
            # speculative decoding: tokens COMMITTED per slot
            # per verify dispatch (1 = speculation earned nothing over
            # greedy that dispatch; mean > 1 is the whole win — the bench
            # gate asserts it on the repetitive workload)
            "accepted_per_dispatch": Histogram(),
        }
        self._t0 = time.perf_counter()

    def inc(self, name: str, by: int = 1) -> None:
        self.counters[name] += by

    def observe(self, name: str, value: float) -> None:
        self.hist[name].observe(value)

    # -- per-class labels --------------------------------------
    # Labeled series live in the SAME flat dicts under Prometheus-style
    # keys (``ttft_s{class=chat}``), created lazily on first touch so an
    # unpoliced engine emits exactly the unlabeled panel. ``itl_s`` is
    # the per-class twin of ``tok_latency_s`` (inter-token latency).
    @staticmethod
    def class_key(name: str, cls: str) -> str:
        return f"{name}{{class={cls}}}"

    def inc_class(self, name: str, cls: str | None, by: int = 1) -> None:
        if cls is None:
            return
        key = self.class_key(name, cls)
        self.counters[key] = self.counters.get(key, 0) + by

    def observe_class(self, name: str, cls: str | None,
                      value: float) -> None:
        if cls is None:
            return
        key = self.class_key(name, cls)
        if key not in self.hist:
            self.hist[key] = Histogram()
        self.hist[key].observe(value)

    def classes(self) -> list[str]:
        """Class labels seen so far (sorted — deterministic panels)."""
        out = set()
        for d in (self.counters, self.hist):
            for k in d:
                if "{class=" in k:
                    out.add(k.split("{class=", 1)[1].rstrip("}"))
        return sorted(out)

    def per_class(self) -> dict:
        """The two-panel serve_sim summary's per-class block: TTFT/ITL
        p50/p99 plus the shed/throttle counts, one entry per class."""
        out = {}
        for cls in self.classes():
            ttft = self.hist.get(self.class_key("ttft_s", cls))
            itl = self.hist.get(self.class_key("itl_s", cls))
            out[cls] = {
                "ttft_p50_s": ttft.percentile(50) if ttft else None,
                "ttft_p99_s": ttft.percentile(99) if ttft else None,
                "itl_p50_s": itl.percentile(50) if itl else None,
                "itl_p99_s": itl.percentile(99) if itl else None,
                "finished": self.counters.get(
                    self.class_key("requests_finished", cls), 0),
                "rejections": self.counters.get(
                    self.class_key("rejections", cls), 0),
                "expirations": self.counters.get(
                    self.class_key("expirations", cls), 0),
            }
        return out

    def snapshot(self) -> dict:
        wall = time.perf_counter() - self._t0
        toks = self.counters["tokens_generated"]
        drafted = self.counters["draft_tokens"]
        return {
            "wall_s": round(wall, 4),
            "tok_per_s": round(toks / wall, 2) if wall > 0 else None,
            # derived: fraction of draft positions whose token committed
            #; None when speculation never drafted
            "draft_hit_rate": round(
                self.counters["draft_accepted"] / drafted, 4)
                if drafted else None,
            **self.counters,
            **{k: v.summary() for k, v in self.hist.items()},
        }

    def json_line(self) -> str:
        return json.dumps(self.snapshot())

    def emit(self, file=None) -> None:
        """Print one JSON line (the serve_sim / log-scraper format)."""
        print(self.json_line(), file=file)


__all__ = ["Histogram", "ServingMetrics"]
