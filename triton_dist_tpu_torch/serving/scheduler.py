"""Continuous-batching scheduler: FIFO admission into fixed batch slots,
prefill/decode interleaving, preemption-by-eviction when the KV pool runs
dry.

A copy of ``triton_dist_tpu/serving/scheduler.py`` (pure Python).

Fixed-shape by construction: the engine's decode step is ONE program
over ``num_slots`` batch rows, so the scheduler never changes
shapes — it only decides which request occupies which slot and which
slots are active this step (inactive rows are masked by parking them on
the engine's scratch page). Policy lives here; mechanics (page
allocation, prefill handoff, the decode step) live in ``engine.py``.

Policies (all deterministic — bit-identical replay is a test invariant):

- **admission**: strict FIFO. A request is admitted when a slot is free
  AND the pool can hold its whole prompt; admission stops at the first
  request that does not fit (no reordering — small requests cannot
  starve a big head-of-line request).
- **preemption**: when decode growth finds the pool dry, evict the
  YOUNGEST active request (latest admission wins the victim lottery —
  it has the least sunk prefill+decode work), free its pages, requeue it
  at the FRONT of the queue so it reclaims a slot as soon as pressure
  clears. A preempted request restarts from its prompt: greedy decode is
  deterministic, so the regenerated tokens are identical to the lost
  ones (tests assert bit-equality against uncontended runs).

Multi-tenant SLO policy — all still host-integer-deterministic:

- **classes** (``ClassSpec``): every request carries a class name; the
  policy orders classes by WEIGHTED FAIR QUEUEING over integer
  virtual-service counters (service += prompt + budget tokens at
  admission; the backlogged class with the smallest service/weight goes
  first, compared by cross-multiplication so no floats ever enter the
  control plane). FIFO is preserved WITHIN a class — head-of-line
  blocking is per class, so a big batch request cannot block chat.
- **quotas** (``SLOPolicy.quotas``): per-tenant integer token buckets
  (rate tokens/step, burst cap) refilled by ``tick(now)``. A dry bucket
  skips that head in the WFQ scan (counted in ``quota_throttled``);
  admission debits the full request cost — the level may go negative
  (deficit), which enforces the long-run rate exactly.
- **degradation order**: ``pick_victim`` evicts the youngest WITHIN the
  least-important (highest ``level``) class first, so overload pressure
  lands on batch tiers before chat; with no policy every request is
  level 0 and the plain youngest-first order is bit-identical.

``SLOPolicy=None`` (the default) keeps every decision bit-for-bit
identical to strict FIFO — the policy machinery is pay-for-play.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Mapping

from triton_dist_tpu_torch.serving.deadline import Deadline


class AdmissionRejected(RuntimeError):
    """Typed overload terminal: the bounded admission queue was
    at capacity when the request arrived. The request never held a slot or
    a page — rejecting it is free and keeps queue wait bounded, which the
    TTL below turns into a hard latency contract."""


class TtlExpired(AdmissionRejected):
    """Typed overload terminal: the request sat in the admission
    queue past its ``Deadline`` without ever being admitted. Only
    never-admitted requests expire — once a request is admitted it is
    carried to completion (possibly through preemptions), so 'every
    admitted request finishes bit-identically' stays an invariant under
    overload."""


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One priority class of the multi-tenant policy.

    ``weight`` is the WFQ share (integer ≥ 1 — a weight-3 class gets 3×
    the admission bandwidth of a weight-1 class under contention).
    ``level`` is the degradation rank: 0 is the MOST protected tier;
    preemption and shedding hit the highest level first. ``queue_cap`` /
    ``ttl_steps`` override the engine-global bounds for this class
    (None = inherit), so a batch tier can run a tight queue while chat
    keeps a deep one. ``stall_budget`` caps the prefill tokens
    co-scheduled per step WHILE a request of this class is decoding —
    the deadline-aware chunk-sizing control (None = no cap).
    ``chunk_budget`` is the dual knob on the PREFILL side: it
    caps the prompt tokens one of THIS class's own prefills may consume
    per step, so a 64k-token ``long`` prompt drips through admission
    without monopolizing the co-scheduled chunk slot (None = the engine's
    full ``prefill_chunk``). Both are runtime scalars into the one
    compiled chunk program — never a shape."""
    name: str
    weight: int = 1
    level: int = 0
    queue_cap: int | None = None
    ttl_steps: int | None = None
    stall_budget: int | None = None
    chunk_budget: int | None = None

    def __post_init__(self):
        assert self.name, "class name must be non-empty"
        assert self.weight >= 1, f"class {self.name}: weight must be >= 1"
        assert self.level >= 0, f"class {self.name}: level must be >= 0"
        assert self.queue_cap is None or self.queue_cap >= 1
        assert self.ttl_steps is None or self.ttl_steps >= 1
        assert self.stall_budget is None or self.stall_budget >= 1
        assert self.chunk_budget is None or self.chunk_budget >= 1


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """The whole multi-tenant scheduling policy: an ordered tuple of
    classes (declaration order is the deterministic WFQ tie-break; the
    FIRST class is the default for unclassed submissions) plus per-tenant
    token-bucket quotas ``{tenant: (rate_tokens_per_step, burst_cap)}``.
    Frozen — policy is configuration, all mutable state (service
    counters, bucket levels) lives in the scheduler where it is folded
    into the control digest and captured by checkpoints."""
    classes: tuple[ClassSpec, ...]
    quotas: Mapping[str, tuple[int, int]] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        assert self.classes, "policy needs at least one class"
        names = [c.name for c in self.classes]
        assert len(set(names)) == len(names), f"duplicate class in {names}"
        for tenant, (rate, burst) in dict(self.quotas).items():
            assert rate >= 1 and burst >= 1, (
                f"tenant {tenant!r}: quota (rate={rate}, burst={burst}) "
                "must be positive integers")

    @property
    def default(self) -> str:
        return self.classes[0].name

    def spec(self, name: str) -> ClassSpec:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(f"unknown class {name!r} — policy has "
                       f"{[c.name for c in self.classes]}")

    def index(self, name: str) -> int:
        for i, c in enumerate(self.classes):
            if c.name == name:
                return i
        raise KeyError(f"unknown class {name!r}")

    @classmethod
    def chat_batch(cls, chat_weight: int = 4, batch_weight: int = 1,
                   batch_queue_cap: int | None = None,
                   batch_ttl_steps: int | None = None,
                   chat_stall_budget: int | None = None,
                   quotas: Mapping[str, tuple[int, int]] | None = None,
                   long_weight: int | None = None,
                   long_chunk_budget: int | None = None,
                   long_stall_budget: int | None = None,
                   long_queue_cap: int | None = None,
                   long_ttl_steps: int | None = None) -> "SLOPolicy":
        """The canonical two-tier policy the sims/tests/bench use: a
        protected ``chat`` tier (level 0) and a best-effort ``batch``
        tier (level 1) that absorbs shedding and preemption first.

        Any ``long_*`` kwarg set inserts the long-context
        tier between them — ``chat`` L0, ``long`` L1, ``batch`` L2 — so
        overload pressure still evicts batch before a half-prefilled 64k
        prompt, and chat ITL stays protected from long prefill via the
        tier's ``chunk_budget``/``stall_budget``. With every ``long_*``
        kwarg None the returned policy is the two-class one, bit-for-bit
        (the third class is pay-for-play)."""
        long_kw = (long_weight, long_chunk_budget, long_stall_budget,
                   long_queue_cap, long_ttl_steps)
        if all(v is None for v in long_kw):
            return cls(classes=(
                ClassSpec("chat", weight=chat_weight, level=0,
                          stall_budget=chat_stall_budget),
                ClassSpec("batch", weight=batch_weight, level=1,
                          queue_cap=batch_queue_cap,
                          ttl_steps=batch_ttl_steps),
            ), quotas=quotas or {})
        return cls(classes=(
            ClassSpec("chat", weight=chat_weight, level=0,
                      stall_budget=chat_stall_budget),
            ClassSpec("long", weight=long_weight or 1, level=1,
                      chunk_budget=long_chunk_budget,
                      stall_budget=long_stall_budget,
                      queue_cap=long_queue_cap,
                      ttl_steps=long_ttl_steps),
            ClassSpec("batch", weight=batch_weight, level=2,
                      queue_cap=batch_queue_cap,
                      ttl_steps=batch_ttl_steps),
        ), quotas=quotas or {})


def _str_fnv(s: str) -> int:
    """32-bit FNV-1a over a string's UTF-8 bytes — folds class/tenant
    NAMES into the integer-only control digest."""
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"          # holds a slot + pages, chunk cursor
    # disaggregated handoff: prefill is DONE (first token known,
    # prefill-side pages freed) but the request sits on the decode worker
    # waiting for the signals covering its migrated pages to fire —
    # signal-gated admission flips it to ACTIVE, never the host clock
    MIGRATING = "migrating"
    ACTIVE = "active"
    FINISHED = "finished"
    # per-request failure domain: the recovery ladder (deadline
    # -> bounded retry -> local re-prefill degradation) ran dry for THIS
    # request. Its pages are freed, ``failure`` carries the typed reason
    # (with the ledger dump), and the engine keeps serving everyone else —
    # a failed request never takes the engine down with it.
    FAILED = "failed"
    # overload terminal: rejected at submit (bounded admission
    # queue at capacity) or expired in the queue past its TTL deadline —
    # the request never held a slot or a page. ``failure`` carries the
    # typed AdmissionRejected/TtlExpired reason. Appended AFTER the
    # pre-existing states so their digest indices are unchanged.
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    """One serving request plus its runtime bookkeeping."""
    rid: int
    prompt: tuple[int, ...]            # token ids
    max_new_tokens: int
    eos_token: int | None = None       # finish early when generated
    state: RequestState = RequestState.QUEUED
    generated: list[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    admitted_seq: int = -1             # admission ticket (victim ordering)
    submit_step: int = -1              # engine step counters for metrics
    first_token_step: int = -1
    finish_step: int = -1
    submit_time: float | None = None   # wall clocks for TTFT
    first_token_time: float | None = None
    # chunked-prefill state (engine's PREFILLING state machine): prompt
    # tokens whose KV is already in pages. Survives mid-prefill eviction —
    # the request requeues AT ITS CURSOR (with its filled pages) and
    # resumes there, not at the prompt start. The TTFT split clocks ride
    # along: queue time = submit → first admission, prefill time = first
    # admission → first token.
    prefill_cursor: int = 0
    prefill_start_step: int = -1
    prefill_start_time: float | None = None
    # disaggregated handoff: the first token rides the HOST
    # control plane from the prefill worker (it was argmaxed on the
    # prefill device by the final chunk); everything bulky — the KV pages
    # — moves device-to-device through the migration kernel instead.
    # None until the final prefill chunk lands; reset on decode-side
    # preemption (full re-prefill recomputes it bit-identically).
    first_token: int | None = None
    # recovery ladder bookkeeping: how many times this request's
    # migration was re-sent after a signal deadline expired, how many
    # times it fell back to decode-local re-prefill, and — terminal —
    # the typed exception that FAILED it (None while alive). The per-
    # request twins of the engine-level retries/degradations counters.
    retries: int = 0
    degradations: int = 0
    failure: Exception | None = None
    # bounded-queue TTL: armed by the engine at submit when
    # ``ttl_steps`` is configured; ``expire()`` sweeps never-admitted
    # queued requests whose deadline has passed. None = no TTL.
    deadline: Deadline | None = None
    # prefix cache: prompt tokens served by adopting cached
    # pages at first admission (0 = cold). Drives the cached-vs-cold
    # TTFT split; re-admissions after preemption keep the original value
    # (the clock, like the hit, belongs to the first admission).
    cache_hit_tokens: int = 0
    # multi-tenant SLO policy: the submitting tenant, the
    # priority class, and the class's degradation level stamped at
    # submit (``shed_level`` is denormalized from the ClassSpec so
    # victim ordering never needs a policy lookup). Defaults make an
    # unclassed request indistinguishable from policy-free behavior.
    tenant: str = "default"
    cls: str = "default"
    shed_level: int = 0
    # speculative decoding: draft positions this request's
    # verify rows consumed and how many of them committed — per-request
    # observability only (NOT folded into the control digest, NOT
    # checkpointed: the token trace is bit-identical spec-on/off, so
    # acceptance bookkeeping must never perturb recovery or replay).
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def cost(self) -> int:
        """WFQ service / quota debit unit: the tokens this request may
        consume end to end (prompt KV + generation budget)."""
        return len(self.prompt) + self.max_new_tokens

    @property
    def kv_len(self) -> int:
        """Tokens holding KV right now: prompt + all but the newest
        generated token (the newest one's KV is written by the step that
        consumes it)."""
        return len(self.prompt) + max(len(self.generated) - 1, 0)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (self.eos_token is not None and bool(self.generated)
                and self.generated[-1] == self.eos_token)

    @property
    def remaining(self) -> int:
        """Token budget left (0 once done — EOS or max_new_tokens)."""
        return 0 if self.done else self.max_new_tokens - len(self.generated)


class ContinuousBatchingScheduler:
    """Slot + queue state machine. The engine calls, in step order:
    ``admissible()`` → prefill each admitted request → ``activate()``,
    then ``pick_victim()`` whenever growth fails, then ``finish()`` as
    slots complete."""

    def __init__(self, num_slots: int, queue_cap: int | None = None,
                 policy: SLOPolicy | None = None):
        assert num_slots >= 1
        self.num_slots = num_slots
        self.queue_cap = queue_cap
        self.policy = policy
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * num_slots
        self._admit_ticket = 0
        # WFQ state — integers only, folded into digest():
        # per-class virtual service, a monotone global virtual-time floor
        # (num/den rational — newly-backlogged classes snap UP to it so an
        # idle class cannot bank service and monopolize later), per-tenant
        # token buckets [level, last_refill_step], and the cumulative
        # quota-skip count the engine mirrors into metrics.
        self._service: dict[str, int] = \
            {c.name: 0 for c in policy.classes} if policy else {}
        self._vfloor = (0, 1)
        self._bucket: dict[str, list[int]] = {
            t: [burst, 0] for t, (_, burst) in
            (dict(policy.quotas).items() if policy else ())}
        self.quota_throttled = 0

    # -- multi-tenant policy -----------------------------------
    def stamp(self, req: Request, tenant: str | None = None,
              cls: str | None = None) -> Request:
        """Stamp class/tenant onto a fresh request (engine submit path):
        validates the class against the policy, fills the default class,
        and denormalizes the degradation level. No-op classification
        without a policy (everything stays the level-0 default)."""
        if tenant is not None:
            req.tenant = tenant
        if self.policy is None:
            if cls is not None:
                req.cls = cls
            return req
        req.cls = cls if cls is not None else self.policy.default
        if req.cls == "default" and not any(
                c.name == "default" for c in self.policy.classes):
            # v1-journal backfill value replayed into a policied engine:
            # "default" means "the policy's default class"
            req.cls = self.policy.default
        req.shed_level = self.policy.spec(req.cls).level
        return req

    def class_spec(self, req: Request) -> ClassSpec | None:
        return None if self.policy is None else self.policy.spec(req.cls)

    def tick(self, now: int) -> None:
        """Refill every tenant's token bucket up to step ``now`` (engine
        calls once per step, before admission). Integer refill: rate
        tokens per elapsed step, clamped at burst. Deterministic —
        iteration order is the policy's quota declaration order."""
        if self.policy is None:
            return
        for tenant, (rate, burst) in dict(self.policy.quotas).items():
            b = self._bucket[tenant]
            if now > b[1]:
                b[0] = min(burst, b[0] + rate * (now - b[1]))
                b[1] = now

    def _quota_ok(self, req: Request) -> bool:
        b = self._bucket.get(req.tenant)
        return b is None or b[0] > 0

    def _wfq_order(self) -> list[str]:
        """Backlogged classes ordered by virtual time (service/weight,
        ascending) — compared by cross-multiplication so the control
        plane stays integer-only; ties break on class declaration order.
        """
        heads = []
        for r in self.queue:
            if r.cls not in (c for c, _, _ in heads):
                w = self.policy.spec(r.cls).weight
                heads.append((r.cls, self._service[r.cls], w))
        out = []
        while heads:
            best = 0
            for i in range(1, len(heads)):
                _, s_b, w_b = heads[best]
                _, s_i, w_i = heads[i]
                if s_i * w_b < s_b * w_i or (
                        s_i * w_b == s_b * w_i
                        and self.policy.index(heads[i][0])
                        < self.policy.index(heads[best][0])):
                    best = i
            out.append(heads.pop(best)[0])
        return out

    def _class_head(self, cls: str) -> Request:
        for r in self.queue:
            if r.cls == cls:
                return r
        raise AssertionError(f"no queued request of class {cls!r}")

    # -- queue ------------------------------------------------------------
    def submit(self, req: Request, front: bool = False) -> None:
        if self.policy is not None and req.cls not in self._service:
            # lenient for restored pre-policy requests: unknown classes
            # ride the default class's books but keep their stamp
            self._service.setdefault(req.cls, 0)
        if (self.policy is not None
                and not any(q.cls == req.cls for q in self.queue)):
            # newly-backlogged class: snap its virtual time UP to the
            # global floor (max — never down) so idle time cannot be
            # banked as future burst right-of-way
            num, den = self._vfloor
            w = (self.policy.spec(req.cls).weight
                 if any(c.name == req.cls for c in self.policy.classes)
                 else 1)
            self._service[req.cls] = max(self._service[req.cls],
                                         (num * w) // den)
        (self.queue.appendleft if front else self.queue.append)(req)

    # -- bounded admission --------------------------------------
    @property
    def at_capacity(self) -> bool:
        """True when a NEW submission must be rejected. Preemption requeues
        (``front=True``) are exempt — an admitted request always keeps its
        place in line, only fresh arrivals are shed."""
        return self.queue_cap is not None and len(self.queue) >= self.queue_cap

    def at_capacity_for(self, cls: str | None) -> bool:
        """Per-class bounded admission: the class's own
        ``queue_cap`` (when the policy sets one) bounds the count of
        QUEUED requests of that class, composing with the global cap —
        so a batch flood fills the batch budget and is shed there while
        the chat tier keeps admitting."""
        if self.at_capacity:
            return True
        if self.policy is None or cls is None:
            return False
        spec = self.policy.spec(cls)
        if spec.queue_cap is None:
            return False
        return sum(1 for r in self.queue if r.cls == cls) >= spec.queue_cap

    def expire(self, now: int) -> list[Request]:
        """Sweep never-admitted queued requests whose TTL ``Deadline`` has
        passed at step ``now``. Expired requests are removed from the queue
        and flipped to REJECTED; the engine attaches the typed failure and
        counts them. Requests that have ever been admitted
        (``admitted_seq >= 0``, i.e. preemption requeues) never expire —
        their work is carried to completion."""
        expired = [r for r in self.queue
                   if r.admitted_seq < 0 and r.deadline is not None
                   and r.deadline.expired(now)]
        for r in expired:
            self.queue.remove(r)
            r.state = RequestState.REJECTED
        return expired

    def digest(self) -> int:
        """Order-sensitive 32-bit FNV-1a digest of the WHOLE scheduling
        state: queue order (with each request's resume-relevant cursors),
        slot seating, and the admission ticket. The scheduler half of the
        replicated-decision guard (see ``KVPagePool.digest``): sharded
        serving runs one scheduler instance per rank and asserts the
        digests match every step — a forked admission or victim choice is
        caught before its block tables diverge, not after."""
        from triton_dist_tpu_torch.serving.kv_pool import _fnv1a
        h = _fnv1a(0x811C9DC5, self.num_slots, self._admit_ticket,
                   len(self.queue))
        for r in self.queue:
            h = _fnv1a(h, r.rid, r.prefill_cursor, r.preemptions,
                       len(r.generated))
        for r in self.slots:
            if r is None:
                h = _fnv1a(h, 0xFFFFFFFF)
            else:
                h = _fnv1a(h, r.rid, list(RequestState).index(r.state),
                           r.admitted_seq, r.prefill_cursor,
                           len(r.generated))
        # multi-tenant policy fold: PER-CLASS queue order (the
        # same rids regrouped by class — a class-reorder changes the
        # digest even when the flat queue order is a permutation), class/
        # tenant stamps, WFQ service counters, the virtual-time floor and
        # every token bucket. Unconditional for the stamps (forked
        # classification must fork the digest even without a policy).
        for r in self.queue:
            h = _fnv1a(h, _str_fnv(r.cls), _str_fnv(r.tenant),
                       r.shed_level)
        if self.policy is not None:
            for cls in sorted(self._service):
                h = _fnv1a(h, _str_fnv(cls), self._service[cls])
                h = _fnv1a(h, len([0 for r in self.queue if r.cls == cls]))
                for r in self.queue:
                    if r.cls == cls:
                        h = _fnv1a(h, r.rid)
            h = _fnv1a(h, *self._vfloor, self.quota_throttled)
            for tenant in sorted(self._bucket):
                lvl, last = self._bucket[tenant]
                h = _fnv1a(h, _str_fnv(tenant), lvl & 0xFFFFFFFF, last)
        return h

    def policy_state(self) -> dict | None:
        """JSON-able snapshot of the mutable policy books (checkpoint
        capture half); None without a policy."""
        if self.policy is None:
            return None
        return {"service": dict(self._service),
                "vfloor": list(self._vfloor),
                "buckets": {t: list(b) for t, b in self._bucket.items()},
                "quota_throttled": self.quota_throttled}

    def restore_policy_state(self, state: dict | None) -> None:
        if state is None or self.policy is None:
            return
        self._service.update({k: int(v)
                              for k, v in state["service"].items()})
        self._vfloor = tuple(int(v) for v in state["vfloor"])
        for t, b in state["buckets"].items():
            if t in self._bucket:
                self._bucket[t] = [int(b[0]), int(b[1])]
        self.quota_throttled = int(state["quota_throttled"])

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def active(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    # -- admission --------------------------------------------------------
    def admissible(self, pool_can_hold) -> tuple[int, Request] | None:
        """Next (slot, request) to admit, or None. ``pool_can_hold(req)``
        is the engine's pages-available check.

        Without a policy: strict FIFO — a head-of-line request that does
        not fit blocks admission (it will fit once finishes/preemptions
        release pages).

        With a policy: weighted fair queueing over classes.
        Classes are scanned in ascending virtual-time order and each
        class's own FIFO head is the candidate; a head blocked by pages
        or a dry tenant bucket only blocks ITS class — the scan moves on,
        which is exactly the isolation a flooded batch tier must not
        break. Quota skips are counted in ``quota_throttled``."""
        slot = self.free_slot()
        if slot is None or not self.queue:
            return None
        if self.policy is None:
            req = self.queue[0]
            if not pool_can_hold(req):
                return None
            return slot, req
        for cls in self._wfq_order():
            req = self._class_head(cls)
            if not self._quota_ok(req):
                self.quota_throttled += 1
                continue
            if not pool_can_hold(req):
                continue            # per-class head-of-line blocking only
            return slot, req
        return None

    def activate(self, slot: int, req: Request) -> None:
        assert self.slots[slot] is None and req in self.queue
        if self.queue[0] is req:
            self.queue.popleft()
        else:
            assert self.policy is not None, \
                "mid-queue admission requires a policy"
            self.queue.remove(req)
        req.state = RequestState.ACTIVE
        req.admitted_seq = self._admit_ticket
        self._admit_ticket += 1
        self.slots[slot] = req
        if self.policy is not None:
            # WFQ service charge + virtual-time floor advance + quota
            # debit (deficit allowed — enforces the long-run rate)
            self._service[req.cls] = \
                self._service.get(req.cls, 0) + req.cost
            w = (self.policy.spec(req.cls).weight
                 if any(c.name == req.cls for c in self.policy.classes)
                 else 1)
            s = self._service[req.cls]
            num, den = self._vfloor
            if s * den > num * w:          # s/w > floor: advance it
                self._vfloor = (s, w)
            b = self._bucket.get(req.tenant)
            if b is not None:
                b[0] -= req.cost

    # -- disaggregated handoff ----------------------------------
    def place(self, slot: int, req: Request) -> None:
        """Seat a request arriving from the PEER role's scheduler (the
        decode worker seating a prefilling/migrating request). Unlike
        ``activate`` it does not touch the queue and does not change
        ``req.state`` — the disagg engine drives the PREFILLING →
        MIGRATING → ACTIVE handoff states itself — but it DOES take an
        admission ticket so victim ordering stays uniform across
        colocated and handed-off requests."""
        assert self.slots[slot] is None
        req.admitted_seq = self._admit_ticket
        self._admit_ticket += 1
        self.slots[slot] = req

    def remove(self, slot: int) -> Request:
        """Unseat WITHOUT requeue — the other half of the handoff verbs:
        a completed prefill leaves the prefill scheduler through here (it
        continues on the DECODE worker, not in this queue), and a decode-
        side victim is routed back to the PREFILL role's queue by the
        engine. State/cursor/requeue policy is entirely the caller's
        (contrast ``evict``, which requeues locally)."""
        req = self.slots[slot]
        assert req is not None
        self.slots[slot] = None
        return req

    # -- preemption -------------------------------------------------------
    def pick_victim(self, exclude_slot: int | None = None) -> int | None:
        """Youngest-within-lowest-class victim: among seated
        requests the one with the HIGHEST (shed_level, admitted_seq) —
        i.e. the least-protected class first, youngest admission within
        it. Without a policy every request is level 0 and this is the
        plain youngest-first order bit-for-bit. ``exclude_slot``
        protects the grower (evicting self frees its own pages but
        forfeits more progress than evicting the youngest)."""
        best, best_key = None, (-1, -1)
        for i, r in enumerate(self.slots):
            if r is None or i == exclude_slot:
                continue
            key = (r.shed_level, r.admitted_seq)
            if key > best_key:
                best, best_key = i, key
        return best

    def evict(self, slot: int) -> Request:
        """Remove the slot's request and requeue it at the FRONT. A
        decoding request restarts from its prompt (greedy decode is
        deterministic — the regenerated tokens are bit-identical); a
        mid-prefill request keeps ``prefill_cursor`` — the ENGINE decides
        whether the cursor (and the pages behind it) survives or resets
        (engine._preempt: kept when there is an unfilled page tail to
        reclaim, reset to 0 otherwise)."""
        req = self.slots[slot]
        assert req is not None
        self.slots[slot] = None
        req.state = RequestState.QUEUED
        req.preemptions += 1
        req.generated.clear()
        self.submit(req, front=True)
        return req

    # -- completion -------------------------------------------------------
    def finish(self, slot: int) -> Request:
        req = self.slots[slot]
        assert req is not None and req.done
        self.slots[slot] = None
        req.state = RequestState.FINISHED
        return req


__all__ = ["Request", "RequestState", "ContinuousBatchingScheduler",
           "AdmissionRejected", "TtlExpired", "ClassSpec", "SLOPolicy"]
