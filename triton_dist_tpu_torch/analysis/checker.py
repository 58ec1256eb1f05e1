"""Cross-actor verification over captured event streams.

Counterpart of ``triton_dist_tpu/analysis/checker.py``: a copy, extended
for the card. The reference replays a rank's grid one position after
another, as a TPU core runs it; on the H100 the blocks (lanes) of one rank
run at once, so here

- **actors are lanes**: streams are keyed by ``(rank, lane)``, the vector
  clocks have one component an actor, and ``Event.rank`` stays the owning
  rank, so a semaphore cell is keyed by the rank whose pad holds it (a
  wait on another rank's word carries that rank in ``dst_rank``);
- **a blocking wait that does not consume** (``wait_peek``): many lanes
  wait on one count and the rank's last lane consumes it (``finish_block``
  in ``csrc/shmem.cuh``). A peek blocks until the cell holds its value,
  joins the clocks of the credits that make it up, and takes nothing;
- **puts are stores** (``sem`` None): no credit, and a read that overlaps
  one is ordered only if one of the two happens before the other by the
  vector clocks (signal, then wait), whatever actor reads.

With one lane a rank and the reference's event kinds it gives the
reference's findings, field for field. Given the per-actor streams at a
concrete rank count n, the checker:

1. **simulates** the streams against counting-semaphore semantics (signals
   and put deliveries credit, waits consume; semaphores are monotone, so
   greedy round-robin saturation reaches completion iff ANY schedule does);
2. classifies a stuck simulation as **under-signal** (static supply on some
   blocked semaphore is less than its demand — the wait can never be paid)
   or **deadlock** (supply suffices globally but every order leaves a
   wait-before-signal cycle);
3. flags **over-signal** residue: credits left on any semaphore after a
   completed run (a later call on the same pad inherits the stale count);
4. flags **unordered reads**: a read overlapping a put's destination that
   is neither dominated by the wait covering that delivery nor provably
   happens-before the put's issuance (vector clocks carried through
   signal/put credits);
5. fits **peer patterns** per put/signal site — ``(me+k)%n`` or constant —
   purely as a protocol summary for the JSON report.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

from .events import Event, Region, SemId

# finding kinds (the taxonomy docs/debugging.md tabulates)
UNDER_SIGNAL = "under_signal"
OVER_SIGNAL = "over_signal"
DEADLOCK = "deadlock"
UNORDERED_READ = "unordered_read"
NONDETERMINISM = "nondeterminism"
CAPTURE_ERROR = "capture_error"


@dataclasses.dataclass
class Finding:
    kind: str
    op: str
    n: Optional[int]
    detail: str
    events: List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return {"kind": self.kind, "op": self.op, "n": self.n,
                "detail": self.detail, "events": self.events}

    def __str__(self) -> str:
        where = f" n={self.n}" if self.n is not None else ""
        return f"[{self.kind}] {self.op}{where}: {self.detail}"


class _Clock:
    """Vector clock over actors: component a = highest seq of actor a known
    to happen-before this point."""

    __slots__ = ("v",)

    def __init__(self, n: int):
        self.v = [-1] * n

    def copy(self) -> "_Clock":
        c = _Clock(len(self.v))
        c.v = list(self.v)
        return c

    def join(self, other: "_Clock") -> None:
        self.v = [max(a, b) for a, b in zip(self.v, other.v)]

    def dominates(self, rank: int, seq: int) -> bool:
        return self.v[rank] >= seq


@dataclasses.dataclass
class _Credit:
    amount: int
    clock: _Clock
    delivery: Optional["_Delivery"] = None


@dataclasses.dataclass
class _Delivery:
    """One put landing at a consumer: region + issuance clock; filled in
    with the covering wait (if any) during simulation."""
    src_rank: int
    put: Event
    issue_clock: _Clock
    wait_seq: Optional[int] = None       # consumer seq of the covering wait
    consumed: int = 0
    wait_actor: Optional[Tuple[int, int]] = None   # the actor that waited


def _sem_key(rank: int, sem: SemId) -> Tuple[int, str, Tuple[int, ...]]:
    return (rank, sem.alloc, sem.cell)


_WAITS = ("wait", "wait_recv", "wait_peek")


def _owner(e: Event) -> int:
    """The rank whose pad holds the cell a wait reads: its own, unless the
    event names another."""
    return e.rank if e.dst_rank is None else e.dst_rank


def _actor_streams(streams) -> Dict[Tuple[int, int], List[Event]]:
    """Streams keyed by (rank, lane); a plain rank key is lane 0."""
    return {(k if isinstance(k, tuple) else (k, 0)): v
            for k, v in streams.items()}


def check_events(op: str, streams: Dict, n: int) -> List[Finding]:
    """Run all cross-actor checks over one captured instantiation.
    ``streams`` maps each actor ``(rank, lane)`` (or a rank: lane 0) to its
    events in program order."""
    findings: List[Finding] = []
    streams = _actor_streams(streams)
    actors = sorted(streams)
    ranks = sorted({a[0] for a in actors})
    if len(ranks) != n:
        findings.append(Finding(CAPTURE_ERROR, op, n,
                                f"captured {len(ranks)} rank streams, "
                                f"expected {n}"))
        return findings
    index = {a: i for i, a in enumerate(actors)}

    # ---- static supply/demand per (rank, sem-cell)
    supply: Dict[Tuple, int] = defaultdict(int)
    demand: Dict[Tuple, int] = defaultdict(int)
    for a in actors:
        for e in streams[a]:
            if e.kind == "signal":
                supply[_sem_key(e.dst_rank, e.sem)] += e.value
            elif e.kind == "put" and e.sem is not None:
                supply[_sem_key(e.dst_rank, e.sem)] += e.value
                if e.send_sem is not None:
                    # send completion credits the SOURCE-side send sem — the
                    # standard quiet-by-same-ref-wait drains it as a wait_recv
                    supply[_sem_key(e.rank, e.send_sem)] += e.value
            elif e.kind in ("wait", "wait_recv"):
                demand[_sem_key(_owner(e), e.sem)] += e.value
            elif e.kind == "wait_send" and e.sem is not None:
                demand[_sem_key(e.rank, e.sem)] += e.value

    for key in sorted(set(supply) | set(demand),
                      key=lambda k: (k[0], k[1], k[2])):
        s, d = supply.get(key, 0), demand.get(key, 0)
        rank, alloc, cell = key
        sem_str = f"{alloc}{list(cell)}" if cell else alloc
        if s > d:
            findings.append(Finding(
                OVER_SIGNAL, op, n,
                f"semaphore {sem_str} at rank {rank} accumulates {s} but "
                f"only {d} is ever consumed — {s - d} left behind poisons "
                f"the next call on this scratch"))

    # ---- simulation
    queues: Dict[Tuple, deque] = defaultdict(deque)
    deliveries: List[_Delivery] = []
    clocks = {a: _Clock(len(actors)) for a in actors}
    read_clocks: Dict[Tuple, _Clock] = {}
    pos = {a: 0 for a in actors}

    def _is_wait(e: Event) -> bool:
        if e.kind in _WAITS:
            return True
        return e.kind == "wait_send" and e.sem is not None

    def _wait_key(e: Event) -> Tuple:
        return _sem_key(e.rank if e.kind == "wait_send" else _owner(e),
                        e.sem)

    def executable(e: Event) -> bool:
        if _is_wait(e):
            q = queues[_wait_key(e)]
            return sum(c.amount for c in q) >= e.value
        return True

    def execute(a, e: Event) -> None:
        clk = clocks[a]
        if e.kind == "wait_peek":
            # observe the credits that make up `value`, take none
            need = e.value
            for c in queues[_wait_key(e)]:
                if need <= 0:
                    break
                clk.join(c.clock)
                need -= c.amount
        elif _is_wait(e):
            q = queues[_wait_key(e)]
            need = e.value
            while need > 0:
                c = q[0]
                take = min(need, c.amount)
                c.amount -= take
                need -= take
                clk.join(c.clock)
                if c.delivery is not None:
                    c.delivery.consumed += take
                    # a wait_send that happens to drain a delivery credit
                    # (shared sem cell) proves nothing about arrival — never
                    # let it stand in as the covering wait
                    if c.delivery.wait_seq is None and e.kind != "wait_send":
                        c.delivery.wait_seq = e.seq
                        c.delivery.wait_actor = a
                if c.amount == 0:
                    q.popleft()
        clk.v[index[a]] = e.seq
        if e.kind == "signal":
            queues[_sem_key(e.dst_rank, e.sem)].append(
                _Credit(e.value, clk.copy()))
        elif e.kind == "put":
            d = _Delivery(e.rank, e, clk.copy())
            deliveries.append(d)
            read_clocks[(a, e.seq)] = d.issue_clock
            if e.sem is not None:
                queues[_sem_key(e.dst_rank, e.sem)].append(
                    _Credit(e.value, clk.copy(), d))
            if e.send_sem is not None:
                # no delivery attached: draining the send sem proves the
                # source buffer is reusable, NOT that the remote write landed
                queues[_sem_key(e.rank, e.send_sem)].append(
                    _Credit(e.value, clk.copy()))
        elif e.kind == "read":
            read_clocks[(a, e.seq)] = clk.copy()

    progressed = True
    while progressed:
        progressed = False
        for a in actors:
            while pos[a] < len(streams[a]) and executable(streams[a][pos[a]]):
                execute(a, streams[a][pos[a]])
                pos[a] += 1
                progressed = True

    stuck = {a: pos[a] for a in actors if pos[a] < len(streams[a])}
    if stuck:
        blocked = [streams[a][pos[a]] for a in sorted(stuck)]

        def need(e: Event) -> int:
            return e.value if e.kind == "wait_peek" else \
                demand.get(_wait_key(e), 0)

        starved = [e for e in blocked
                   if supply.get(_wait_key(e), 0) < need(e)]
        if starved:
            e = starved[0]
            key = _wait_key(e)
            findings.append(Finding(
                UNDER_SIGNAL, op, n,
                f"rank {e.rank} waits {need(e)} on {e.sem} but total "
                f"signal supply is {supply.get(key, 0)} — static deadlock "
                "(missing/dropped signal)",
                [e.describe() for e in blocked]))
        else:
            findings.append(Finding(
                DEADLOCK, op, n,
                "no execution order exists: every rank is blocked on a "
                "wait whose signals sit behind other blocked waits "
                "(wait-before-signal cycle)",
                [e.describe() for e in blocked]))
        # hazard analysis below would double-report on a half-run protocol
        return findings

    # ---- unordered-read hazards (completed runs only)
    reads: List[Tuple[Tuple[int, int], int, Region]] = []
    for a in actors:
        for e in streams[a]:
            if e.kind == "read" and e.src is not None:
                reads.append((a, e.seq, e.src))
            elif e.kind == "put" and e.src is not None:
                # a put reads its source region (ring forwarding)
                reads.append((a, e.seq, e.src))

    reported = set()
    for d in deliveries:
        region = d.put.dst
        if region is None:
            continue
        put_actor = (d.put.rank, d.put.grid[0] if d.put.grid else 0)
        for a, seq, rregion in reads:
            if not region.overlaps(rregion):
                continue
            if d.put.sem is not None:
                # the reference's rule: the consumer rank's reads, after the
                # wait that took this delivery's credit
                cons_rank = d.put.dst_rank
                if a[0] != cons_rank:
                    continue
                if d.wait_seq is not None and a == d.wait_actor \
                        and seq > d.wait_seq:
                    continue  # dominated by the covering wait
                if d.issue_clock.dominates(index[a], seq):
                    continue  # read happens-before the put was even issued
                covering = ("no wait ever covers this delivery"
                            if d.wait_seq is None else
                            f"the covering wait runs at seq {d.wait_seq}, "
                            "after the read")
            else:
                if a == put_actor and seq == d.put.seq:
                    continue
                rc = read_clocks.get((a, seq))
                if rc is not None and put_actor in index and \
                        rc.dominates(index[put_actor], d.put.seq):
                    continue  # the put happens-before the read
                if d.issue_clock.dominates(index[a], seq):
                    continue  # the read happens-before the put
                cons_rank = a[0]
                covering = ("no wait orders the read after the put, nor "
                            "the put after the read")
            key = (a, region.buffer, seq)
            if key in reported:
                continue
            reported.add(key)
            findings.append(Finding(
                UNORDERED_READ, op, n,
                f"rank {cons_rank} reads {rregion} (seq {seq}) which "
                f"overlaps the destination of a put from rank "
                f"{d.src_rank}; {covering}",
                [d.put.describe()]))

    return findings


# -- peer-pattern fitting (informational) ------------------------------------

def fit_peer_patterns(streams_by_n: Dict[int, Dict]) -> Dict[str, str]:
    """Best-effort symbolic summary: for each put/signal site (aligned by
    per-rank occurrence index), fit ``dst = (me+k)%n`` or ``dst = c``
    consistent across every rank and every captured n. Asymmetric protocols
    (root broadcast, ring-position-dependent counts) report ``asymmetric``.
    """
    # site key -> {n: {rank: [dst,...]}}
    table: Dict[str, Dict[int, Dict[int, List[int]]]] = defaultdict(
        lambda: defaultdict(dict))
    for n, streams in streams_by_n.items():
        by_rank: Dict[int, List[Event]] = defaultdict(list)
        for a, evs in sorted(_actor_streams(streams).items()):
            by_rank[a[0]].extend(evs)
        for r, evs in by_rank.items():
            per_site: Dict[str, List[int]] = defaultdict(list)
            for e in evs:
                if e.kind in ("put", "signal") and e.dst_rank is not None:
                    site = f"{e.site}:{e.kind}:{e.sem.alloc if e.sem else ''}"
                    per_site[site].append(e.dst_rank)
            for site, dsts in per_site.items():
                table[site][n][r] = dsts

    out: Dict[str, str] = {}
    for site, by_n in table.items():
        shifts: set = set()
        consts: set = set()
        ok = True
        for n, by_rank in by_n.items():
            counts = {len(v) for v in by_rank.values()}
            if len(by_rank) != n or len(counts) != 1:
                ok = False
                break
            m = counts.pop()
            for i in range(m):
                k0 = {(by_rank[r][i] - r) % n for r in by_rank}
                c0 = {by_rank[r][i] for r in by_rank}
                if len(k0) == 1:
                    shifts.add((i, k0.pop()))
                elif len(c0) == 1:
                    consts.add((i, c0.pop()))
                else:
                    ok = False
        if not ok:
            out[site] = "asymmetric"
        elif shifts and not consts:
            ks = sorted({k for _, k in shifts})
            out[site] = ("dst=(me+k)%n, k in " + repr(ks)) if len(ks) > 1 \
                else f"dst=(me+{ks[0]})%n"
        elif consts and not shifts:
            cs = sorted({c for _, c in consts})
            out[site] = f"dst=const {cs}"
        else:
            out[site] = "mixed"
    return out
