"""Concurrent query serving: admission control, priority queues, shared
scans, and pipelined async dispatch (paper §7 "workload management").

Everything below this module executes ONE query at a time; Vertica
presents a classical relational interface at web scale by putting a
workload-management layer in front of that engine.  This is that layer:
a bounded, prioritized, memory-budgeted front door that turns the
single-query executor into a multi-tenant service.

Mechanisms (DESIGN.md §16, §18):

* **Admission control** -- a bounded session pool and two priority
  queues (``interactive`` served ahead of ``batch``, with an
  anti-starvation boost so a saturating interactive stream cannot starve
  batch forever).  Queue-depth caps and queued-past-timeout expiry
  reject with the typed ``QueryRejectedError`` -- the same
  refusal-over-wrong-answer contract the failover path uses.  Every
  admission decision fires the ``serving.admit`` injection point, so
  chaos schedules cover the front door too.
* **Cost-based admission** -- a ticket is priced from its projection's
  SMA block statistics and its predicate's bounds (the same pruning
  math the scan itself runs), NOT from raw row counts: a heavily-pruned
  scan over a huge table is cheap, an unpredicated scan over a
  fragmented store is expensive (tail-block padding included).  The
  SMA price feeds the memory-budget reservation, the optional
  ``max_cost_bytes`` hard ceiling, and the ``boost_cost_bytes``
  priority boost that lets a provably-cheap batch query jump into the
  interactive queue.  This is the "exploit the column store's own
  metadata" argument of *Teaching an Old Elephant New Tricks*
  (arxiv 0909.1758) applied to workload management.
* **Shared scans** -- queued queries over the same projection whose
  pinned snapshots clamp to the same effective epoch coalesce into ONE
  cache-resident scan (no SMA pruning, no predicate pushdown: the scan
  is shared), with each member applying its own predicate mask +
  aggregation as a plan-cached closure
  (executor.execute_shared_fused_deferred).  The plan cache is thereby
  exploited *across* concurrent queries, not only across repeats of one
  query; a coalesced group charges the memory budget once.  A
  differential test (tests/test_torch_serving.py) proves coalesced
  results byte-identical to independent execution on the CPU -- see
  ``_shared_once_async`` for why that holds.  On the card
  ``seg_preagg``'s atomics may order f32 sums differently from one run
  to the next, so coalesced f32 sums equal independent ones within
  float rounding, ints and counts exactly.
* **Pipelined dispatch / drain** -- CUDA launches are asynchronous: a
  fused closure returns device tensors as soon as its kernels are
  queued on the current stream, while the card computes.  Dispatch
  therefore parks a unit's device results in an in-flight queue,
  records a ``torch.cuda.Event`` on the stream after the unit's last
  launch, and returns to admission, so the NEXT unit's planning and
  launches overlap the previous unit's device compute.  A separate
  drain stage harvests flights whose event has completed
  (``event.query()``, never a synchronize) and performs ONE batched
  device-to-host copy per unit (``executor.to_host`` over the whole
  flight) -- there are no per-column host syncs on the serving path.
  The copy runs on the current stream: a flight forced out before its
  event completed waits for the launches queued behind it as well.  Work that
  the fused subset cannot express (WOS side-scans, segmented meshes,
  RLE-direct shapes) falls back to synchronous execution inside
  dispatch, preserving exact single-query semantics.  On the CPU every
  flight is ready as soon as it is parked.
* **Bulkheads** -- ``max_in_flight`` bounds how many tickets of each
  priority class may be in flight (dispatched, not yet drained) at
  once, so a batch flood cannot exhaust the device memory and future
  slots that interactive sessions rely on.  Admission simply skips a
  class at its cap; its queue drains as flights are harvested.
* **Rate limiting** -- each session may carry a token bucket
  (``rate_limit=(rate_per_s, burst)``); an over-rate submit is refused
  with a typed ``QueryRejectedError`` whose reason starts with
  ``rate_limited`` BEFORE any snapshot epoch is pinned, so abusive
  clients cannot stall the AHM by being refused.
* **Memory budget** -- each dispatch unit reserves its SMA-priced
  working set against the block-cache budget (``BlockCache.take``);
  under the pipelined core a reservation is held from dispatch until
  drain, so overlapping units' reservations accumulate and admission
  stops opening new work when the pool is exhausted, bounding the
  concurrent working set to what HBM holds.

Concurrency model: cooperative and deterministic, like the rest of the
simulated cluster.  ``submit()`` pins the query's snapshot epoch and
enqueues; ``step()`` runs one scheduler round (expire timed-out tickets
-> harvest ready flights in arrival order -> admit up to
``max_concurrent`` units under budget + bulkheads -> dispatch them,
parking async results); ``drain()`` steps until idle.  The service
takes an injectable ``clock`` -- ``VirtualClock`` replaces wall time in
tests so overlap, rate-limit refill and bulkhead schedules replay
byte-identically with no sleeps (FaultInjector.Hang sleeps on this
clock at the ``serving.dispatch``/``serving.drain`` points).

The load-bearing invariant is the epoch-pin lifecycle: a pin taken at
submit is released on EXACTLY ONE of completion / timeout / fault
rejection (queue-full and rate-limit rejections happen before pinning),
so no rejected or abandoned query can stall the AHM.
tests/test_torch_serving.py floods the queue and asserts
``EpochManager.n_pinned() == 0`` afterward; the drain stage's failure
matrix (crash/transient between dispatch and harvest) is in
DESIGN.md §18.

Mirrors ``src/repro/engine/serving.py``: the same classes, names,
counters and scheduling decisions; the jax futures, ``is_ready`` probes
and ``jax.device_get`` become CUDA events and one ``to_host`` copy.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.block_cache import KIND_UNION
from ..core.database import AvailabilityError, QueryRejectedError, VerticaDB
from ..core.encodings import device_bytes
from ..core.faults import (NodeCrashError, TransientFaultError,
                           fire_with_retries)
from .logical import as_ir
from . import executor as fused_exec
from . import operators as ops
from .pipeline import (ExecStats, _empty_result, _finalize, _np,
                       _run_groupby, execute, rle_direct_eligible,
                       wos_scan_results)

PRIORITIES = ("interactive", "batch")

# Module-wide device->host transfer odometer: bumped once per batched
# ``to_host`` copy the drain stage performs.  The transfer-counting
# test fixture (tests/test_torch_serving.py) snapshots it around a
# serving run to assert the collect path does ONE transfer per unit --
# no stray per-column syncs.
_DEVICE_TRANSFERS = 0


def device_transfer_count() -> int:
    """Total batched device->host transfers the serving drain stage has
    performed in this process (monotonic; diff across a run)."""
    return _DEVICE_TRANSFERS


# ---------------------------------------------------------------------------
# clocks: wall by default, virtual for deterministic schedules
# ---------------------------------------------------------------------------

class WallClock:
    """Real time (the default service clock)."""

    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


_WALL = WallClock()


class VirtualClock:
    """Deterministic scheduler clock: ``now()`` only moves when
    something calls ``sleep``/``advance``, so timeout expiry, token
    refill and injected Hangs replay identically run-over-run with no
    wall-clock sleeps.  Pass to ``db.serve(clock=VirtualClock())``;
    FaultInjector.Hang sleeps on this clock when the firing context
    carries one (``serving.dispatch``/``serving.drain``/
    ``serving.rate_limit`` pass it)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self._now += float(seconds)

    # alias: tests advancing time explicitly read better with this name
    advance = sleep


class TokenBucket:
    """Per-session rate limiter: ``burst`` tokens capacity refilled at
    ``rate`` tokens/second on the given clock.  ``try_consume`` is the
    whole protocol -- deterministic given the clock, which is what the
    property test exercises under a VirtualClock."""

    def __init__(self, rate: float, burst: float, *, clock=None):
        assert rate > 0 and burst > 0
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock if clock is not None else _WALL
        self.tokens = float(burst)
        self._last = self.clock.now()

    def try_consume(self, n: float = 1.0) -> bool:
        now = self.clock.now()
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens + 1e-9 >= n:
            self.tokens -= n
            return True
        return False


@dataclasses.dataclass
class ServingStats:
    """Per-query serving telemetry, one per Ticket (the serving-layer
    analog of pipeline.ExecStats, which rides along in ``exec_stats``)."""
    priority: str = "interactive"
    admitted: bool = False
    rejected_reason: str = ""       # "queue_full"/"timeout"/"admission"/
    #                                 "unavailable"/"cost" ("" = not rejected)
    queue_wait_s: float = 0.0       # submit -> dispatch
    exec_s: float = 0.0             # dispatch -> result
    total_s: float = 0.0            # submit -> done (closed-loop latency)
    shared_scan: str = ""           # "leader"/"member" when coalesced
    share_group: int = 1            # tickets in this dispatch unit
    dispatch_seq: int = -1          # global dispatch order (priority tests)
    snapshot_epoch: int = 0         # the pinned epoch this query read
    reserved_bytes: int = 0         # working set charged at admission
    cost_bytes: int = 0             # SMA-priced admission cost
    cost_boosted: bool = False      # cheap batch query ran interactive
    oversized: bool = False         # working set alone exceeds the budget
    async_dispatch: bool = False    # parked in flight (vs sync fallback)
    failovers: int = 0              # mid-dispatch node crashes absorbed
    exec_stats: Optional[ExecStats] = None


@dataclasses.dataclass
class ServiceStats:
    """Service-wide counters (benchmarks/serving.py reads these)."""
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    rejected_queue_full: int = 0
    rejected_timeout: int = 0
    rejected_admission: int = 0
    rejected_unavailable: int = 0
    rejected_rate_limited: int = 0
    rejected_cost: int = 0          # SMA price above max_cost_bytes
    dispatches: int = 0             # dispatch units executed
    shared_scans: int = 0           # units that coalesced >= 2 queries
    shared_hits: int = 0            # completed queries served coalesced
    coalesced_max: int = 0
    batch_boosts: int = 0           # anti-starvation picks of batch
    cost_boosts: int = 0            # cheap batch queries run interactive
    async_units: int = 0            # units parked in flight at dispatch
    deduped: int = 0                # identical in-group queries collapsed
    drains: int = 0                 # flights harvested by the drain stage
    device_transfers: int = 0       # batched device->host gets performed
    peak_in_flight: Dict[str, int] = dataclasses.field(default_factory=dict)

    def shared_hit_rate(self) -> float:
        return self.shared_hits / self.completed if self.completed else 0.0


class Ticket:
    """A submitted query's handle: state machine
    ``queued -> running -> done|rejected``, its pinned snapshot epoch,
    and its ServingStats.  ``result()`` cooperatively drives the service
    until this ticket settles."""

    def __init__(self, service: "QueryService", q, priority: str,
                 timeout_s: Optional[float], seq: int):
        self.service = service
        self.q = q
        self.priority = priority
        self.timeout_s = timeout_s
        self.id = seq
        self.submitted_at = service.clock.now()
        self.pinned: Optional[int] = None
        self.state = "queued"
        self.stats = ServingStats(priority=priority)
        self._result: Optional[Dict[str, np.ndarray]] = None
        self._error: Optional[Exception] = None
        # dispatch-time physical choices (set at admission)
        self.plan = None
        self.scan_need: Tuple[str, ...] = ()

    @property
    def done(self) -> bool:
        return self.state in ("done", "rejected")

    @property
    def error(self) -> Optional[Exception]:
        return self._error

    def result(self) -> Dict[str, np.ndarray]:
        """Block (cooperatively) until this query settles; returns its
        rows or raises its typed rejection error."""
        guard = 0
        while not self.done:
            self.service.step(waiting_on=self)
            guard += 1
            if guard > 1_000_000:   # pragma: no cover - defensive
                raise RuntimeError("serving made no progress")
        if self._error is not None:
            raise self._error
        return self._result


class Session:
    """One client's bounded handle on the service (the session pool is
    the paper's connection limit): carries a default priority/timeout
    and optionally a token-bucket rate limit, counts against
    ``max_sessions`` until closed."""

    def __init__(self, service: "QueryService", priority: str,
                 timeout_s: Optional[float] = None,
                 rate_limit: Optional[Tuple[float, float]] = None):
        self.service = service
        self.priority = priority
        self.timeout_s = timeout_s
        self.bucket = (TokenBucket(*rate_limit, clock=service.clock)
                       if rate_limit else None)
        self.closed = False

    def submit(self, q, *, priority: Optional[str] = None,
               timeout_s: Optional[float] = None) -> Ticket:
        if self.closed:
            raise QueryRejectedError("session is closed")
        svc = self.service
        if self.bucket is not None and not self.bucket.try_consume():
            # over rate: refuse BEFORE anything pins an epoch -- a
            # throttled client must never stall the AHM
            svc.stats.submitted += 1
            svc.stats.rejected += 1
            svc.stats.rejected_rate_limited += 1
            try:
                fire_with_retries(svc.db, "serving.rate_limit",
                                  priority=priority or self.priority,
                                  clock=svc.clock)
            except (NodeCrashError, TransientFaultError):
                pass   # the refusal stands regardless of injected noise
            raise QueryRejectedError(
                f"rate_limited: session over {self.bucket.rate:g}/s "
                f"(burst {self.bucket.burst:g})",
                epoch=svc.db.epochs.latest_queryable())
        return svc.submit(
            q, priority=priority or self.priority,
            timeout_s=timeout_s if timeout_s is not None else self.timeout_s)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.service._sessions.discard(self)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass
class _Unit:
    """One dispatch unit: a single query or a coalesced shared-scan
    group, with its plan, effective snapshot epoch and reservation
    token (held from dispatch until the drain stage harvests it)."""
    tickets: List[Ticket]
    plan: object
    epoch: int
    reserved: int
    res: object                     # block_cache.Reservation (idempotent)
    oversized: bool


@dataclasses.dataclass
class _Member:
    """One ticket's parked work inside a flight.  ``mode``:

    * ``ready``        -- materialized at dispatch (WOS side-scans,
                          non-fused groupbys); ``out`` holds the final
                          host result.
    * ``fused_solo``    -- a dedicated fused closure's device result is
                          in the flight's fetch slot; ``finish`` shapes
                          the harvested host arrays.
    * ``fused_shared``  -- same, for a shared-scan member program;
                          ``cols``/``valid`` retain the device scan for
                          the rare sort-overflow fallback at drain.
    * ``select``        -- projection-only member: fetch slot holds
                          ``(valid, cols)`` device refs, drain applies
                          the mask host-side.
    * ``dup``           -- identical (query object, effective epoch) to
                          an earlier member of the SAME group: no
                          program of its own, drain reuses member
                          ``ref``'s completed result (common-query
                          elimination inside one scan pass).
    """
    ticket: Ticket
    mode: str
    es: ExecStats
    out: Optional[Dict[str, np.ndarray]] = None
    finish: Optional[object] = None
    cols: Optional[dict] = None
    valid: Optional[object] = None
    ref: int = -1


@dataclasses.dataclass
class _Flight:
    """A dispatched unit whose device results are parked in the
    in-flight queue awaiting the drain stage.  ``event`` is recorded on
    the compute stream after the unit's last launch (None on the CPU,
    where a parked result is already computed)."""
    unit: _Unit
    t0: float                       # dispatch time (exec_s baseline)
    members: List[_Member]
    fetch: list                     # per-member device payloads (or None)
    event: Optional[torch.cuda.Event] = None

    def ready(self) -> bool:
        """True when every parked device tensor has been computed (the
        drain stage can harvest without blocking).  A query of the
        event, never a synchronize: a flight still computing answers
        False at once."""
        return self.event is None or self.event.query()


def _record_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event on ``device``'s current stream after every launch queued
    so far, or None off the card."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class QueryService:
    """The serving front door (module docstring has the full design).

    Construct via ``db.serve(...)``.  Knobs:

    * ``max_concurrent`` -- dispatch units admitted per step (the
      concurrency the memory budget is sized against).
    * ``queue_depth`` -- per-priority-class cap; beyond it ``submit``
      rejects typed *before* pinning anything.
    * ``max_sessions`` -- session-pool bound.
    * ``max_coalesce`` -- shared-scan group size cap (1 disables
      coalescing entirely).
    * ``memory_budget_bytes`` -- concurrent-working-set bound, default
      the block cache's byte budget (reservations and cached blocks
      answer to the same HBM).
    * ``max_in_flight`` -- bulkhead: max tickets of a priority class in
      flight (dispatched, not yet drained) at once.  An int applies to
      both classes; a dict sets them separately; None (default) leaves
      the class unbounded.
    * ``rate_limit`` -- default ``(rate_per_s, burst)`` token bucket for
      new sessions (per-session override in ``session()``); None
      disables.
    * ``max_cost_bytes`` -- hard ceiling on a leader ticket's SMA-priced
      scan cost; above it the ticket is rejected typed (``"cost"``).
      Queries riding a shared scan are not re-priced: their marginal
      cost IS the point of coalescing.
    * ``boost_cost_bytes`` -- a batch submit priced at or under this is
      enqueued on the interactive queue (its class, bulkhead and stats
      identity stay ``batch``): provably-cheap batch work shouldn't
      wait behind expensive batch work.
    * ``batch_boost_after`` -- after N consecutive interactive picks
      with batch waiting, pick batch once (anti-starvation).
    * ``default_timeout_s`` -- queued-past-this => typed rejection
      (per-submit override available).
    * ``clock`` -- scheduler clock; pass ``VirtualClock()`` for
      deterministic no-sleep schedules in tests.
    """

    def __init__(self, db: VerticaDB, *, max_concurrent: int = 4,
                 queue_depth: int = 32, max_sessions: int = 64,
                 max_coalesce: int = 8,
                 memory_budget_bytes: Optional[int] = None,
                 max_in_flight: Union[int, Dict[str, int], None] = None,
                 rate_limit: Optional[Tuple[float, float]] = None,
                 max_cost_bytes: Optional[int] = None,
                 boost_cost_bytes: Optional[int] = None,
                 batch_boost_after: int = 4,
                 default_timeout_s: Optional[float] = None,
                 clock=None):
        self.db = db
        self.max_concurrent = int(max_concurrent)
        self.queue_depth = int(queue_depth)
        self.max_sessions = int(max_sessions)
        self.max_coalesce = int(max_coalesce)
        self.memory_budget_bytes = int(
            memory_budget_bytes if memory_budget_bytes is not None
            else db.block_cache.budget_bytes)
        if max_in_flight is None:
            self.max_in_flight: Dict[str, int] = {}
        elif isinstance(max_in_flight, dict):
            self.max_in_flight = {p: int(v) for p, v in max_in_flight.items()}
        else:
            self.max_in_flight = {p: int(max_in_flight) for p in PRIORITIES}
        self.rate_limit = rate_limit
        self.max_cost_bytes = max_cost_bytes
        self.boost_cost_bytes = boost_cost_bytes
        self.batch_boost_after = int(batch_boost_after)
        self.default_timeout_s = default_timeout_s
        self.clock = clock if clock is not None else _WALL
        self.stats = ServiceStats()
        self._queues: Dict[str, deque] = {p: deque() for p in PRIORITIES}
        self._sessions: set = set()
        self._consec_interactive = 0
        self._seq = itertools.count(1)
        self._dispatch_seq = itertools.count(0)
        # the in-flight queue: dispatched units whose device results are
        # parked until the drain stage harvests them (arrival order)
        self._inflight: deque = deque()
        self._inflight_by_class: Dict[str, int] = {p: 0 for p in PRIORITIES}

    # -------------------------------------------------------- front door --

    def session(self, priority: str = "interactive", *,
                timeout_s: Optional[float] = None,
                rate_limit: Optional[Tuple[float, float]] = None) -> Session:
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}")
        if len(self._sessions) >= self.max_sessions:
            raise QueryRejectedError(
                f"session pool exhausted ({self.max_sessions} active)")
        s = Session(self, priority, timeout_s,
                    rate_limit if rate_limit is not None else self.rate_limit)
        self._sessions.add(s)
        return s

    def submit(self, q, *, priority: str = "interactive",
               timeout_s: Optional[float] = None) -> Ticket:
        """Admit a query: fire the admission injection point, enforce the
        queue-depth cap, then pin its snapshot epoch and enqueue.  Order
        matters -- every rejection here happens BEFORE the pin, so a
        refused query cannot stall the AHM."""
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}")
        q = as_ir(q)
        self.stats.submitted += 1
        try:
            fire_with_retries(self.db, "serving.admit", priority=priority,
                              clock=self.clock)
        except NodeCrashError:
            pass   # a node died during admission; dispatch replans around it
        except TransientFaultError as e:
            self.stats.rejected += 1
            self.stats.rejected_admission += 1
            raise QueryRejectedError(f"admission failed: {e}") from e
        target = priority
        boosted = False
        if priority == "batch" and self.boost_cost_bytes is not None:
            price = self._price_query(q)
            if price is not None and price <= self.boost_cost_bytes:
                target, boosted = "interactive", True
        queue = self._queues[target]
        if len(queue) >= self.queue_depth:
            self.stats.rejected += 1
            self.stats.rejected_queue_full += 1
            raise QueryRejectedError(
                f"{target} queue full ({self.queue_depth} deep)",
                epoch=self.db.epochs.latest_queryable())
        t = Ticket(self, q, priority,
                   timeout_s if timeout_s is not None
                   else self.default_timeout_s, next(self._seq))
        if boosted:
            t.stats.cost_boosted = True
            self.stats.cost_boosts += 1
        # pin at SUBMISSION: trickle commits while this query waits in
        # the queue can never shift what it sees (§5 snapshot isolation)
        t.pinned = self.db.epochs.pin()
        t.stats.snapshot_epoch = t.pinned
        queue.append(t)
        return t

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def in_flight(self, priority: Optional[str] = None) -> int:
        """Tickets dispatched and not yet drained (per class or total)."""
        if priority is None:
            return sum(self._inflight_by_class.values())
        return self._inflight_by_class[priority]

    def step(self, waiting_on: Optional[Ticket] = None) -> int:
        """One scheduler round: expire timeouts, harvest ready flights
        (arrival order), admit + dispatch new units.  If nothing settled
        and nothing could be admitted while flights are parked, force-
        harvest a flight so cooperative callers always make progress --
        the flight carrying ``waiting_on`` when given (``result()``
        passes its own ticket so an interactive waiter never pays for a
        batch unit's drain), the oldest otherwise.  Returns how many
        tickets settled."""
        settled0 = self.stats.completed + self.stats.rejected
        self._expire_timeouts()
        self._harvest(waiter=waiting_on)
        # an interactive waiter's cooperative steps never LEAD batch
        # rounds either -- batch admission (host-side scan assembly)
        # happens on neutral steps (``drain()``, bare ``step()``) or a
        # batch waiter's own; this is the single-threaded analog of
        # batch work never running on the interactive thread
        hold = (frozenset({"batch"})
                if waiting_on is not None
                and waiting_on.priority == "interactive"
                else frozenset())
        units = self._admit_round(hold)
        for unit in units:
            self._dispatch(unit)
        settled = self.stats.completed + self.stats.rejected - settled0
        if settled == 0 and not units and self._inflight:
            self._harvest(force=True, prefer=waiting_on)
            settled = self.stats.completed + self.stats.rejected - settled0
        return settled

    def drain(self) -> "QueryService":
        """Step until every queued ticket has settled and every flight
        has been harvested."""
        while self.pending() or self._inflight:
            if self.step() == 0 and not self._inflight:
                # pragma: no cover - defensive
                raise RuntimeError("serving stalled with queued tickets")
        return self

    # --------------------------------------------------- ticket lifecycle --

    def _reject(self, t: Ticket, err: Exception, kind: str) -> None:
        if t.pinned is not None:
            self.db.epochs.unpin(t.pinned)
            t.pinned = None
        t.state = "rejected"
        t._error = err
        t.stats.rejected_reason = kind
        t.stats.total_s = self.clock.now() - t.submitted_at
        self.stats.rejected += 1
        if kind == "timeout":
            self.stats.rejected_timeout += 1
        elif kind == "unavailable":
            self.stats.rejected_unavailable += 1
        elif kind == "cost":
            self.stats.rejected_cost += 1

    def _complete(self, t: Ticket, out, es: ExecStats) -> None:
        self.db.epochs.unpin(t.pinned)
        t.pinned = None
        t.state = "done"
        t._result = out
        t.stats.admitted = True
        t.stats.exec_stats = es
        t.stats.total_s = self.clock.now() - t.submitted_at
        self.stats.completed += 1
        if t.stats.shared_scan:
            self.stats.shared_hits += 1

    def _expire_timeouts(self) -> None:
        now = self.clock.now()
        for pr in PRIORITIES:
            queue = self._queues[pr]
            keep: deque = deque()
            while queue:
                t = queue.popleft()
                if t.timeout_s is not None and \
                        now - t.submitted_at > t.timeout_s:
                    self._reject(t, QueryRejectedError(
                        f"queued past timeout ({t.timeout_s:.3f}s)",
                        epoch=t.pinned), kind="timeout")
                else:
                    keep.append(t)
            self._queues[pr] = keep

    # -------------------------------------------------------- admission --

    def _class_headroom(self, cls: str, round_new: Dict[str, int]
                        ) -> Optional[int]:
        """Bulkhead headroom for a class this round (None = unbounded):
        cap minus tickets already in flight minus tickets admitted into
        units this round (they dispatch immediately after)."""
        cap = self.max_in_flight.get(cls)
        if cap is None:
            return None
        return cap - self._inflight_by_class[cls] - round_new[cls]

    def _pick_queue(self, blocked=frozenset()) -> Optional[str]:
        inter_ok = ("interactive" not in blocked
                    and bool(self._queues["interactive"]))
        batch_ok = "batch" not in blocked and bool(self._queues["batch"])
        if inter_ok and batch_ok and \
                self._consec_interactive >= self.batch_boost_after:
            self.stats.batch_boosts += 1
            return "batch"
        if inter_ok:
            return "interactive"
        if batch_ok:
            return "batch"
        return None

    def _plan(self, t: Ticket):
        """Plan a ticket, converting planner refusals (lost redundancy,
        no covering projection) into a typed per-ticket rejection rather
        than letting them crash the admission round."""
        from ..planner.planner import plan_query
        try:
            return plan_query(self.db, t.q)
        except (AvailabilityError, ValueError) as e:
            self._reject(t, e, kind="unavailable")
            return None

    def _effective_epoch(self, t: Ticket) -> int:
        """The ticket's pin clamped to its table's epoch ceiling: two
        queries pinned at different cluster epochs still read IDENTICAL
        table snapshots when no commit touched the table in between, so
        they may share one scan (the same clamp the block cache uses to
        keep entries warm across unrelated trickle commits)."""
        return min(t.pinned, self.db.table_epoch_ceiling(t.q.table))

    def _shareable(self, q) -> bool:
        """Single-table query shapes a shared scan can serve: joins need
        build sides + SIP pushdown that are per-query by construction."""
        return not q.joins and bool(q.aggs or q.group_by or q.columns
                                    or q.derived)

    # ------------------------------------------------------- cost model --

    def _raw_working_set_bytes(self, plan, need) -> int:
        """The pre-cost-model price: rows behind the plan's sources x
        (8-byte device lanes per needed column + 1 mask byte).  Kept as
        the comparison baseline the cost-model differential test prices
        against -- raw row counts ignore both SMA pruning (overcharges
        selective scans) and tail-block padding (undercharges fragmented
        stores)."""
        rows = 0
        for host, owner in plan.sources:
            store = self.db.nodes[host].stores[owner]
            rows += store.ros_rows() + store.wos.n_rows
        return rows * (8 * max(len(need), 1) + 1)

    def _sma_cost_bytes(self, plan, need, bounds: Dict) -> int:
        """SMA-priced working set: the bytes the scan will actually open.
        Two terms, matching what really lands in device memory:

        * decoded lanes for surviving ROS blocks -- counted with the same
          per-container SMA keep-mask the scan's pruning runs
          (``ColumnSMA.prune_blocks`` against the predicate's bounds), at
          FULL block granularity (a decoded block is ``block_rows`` lanes
          whether or not its tail is padding) -- plus unpruned WOS rows;
        * the REAL packed payload bytes of every needed column
          (``EncodedColumn.packed_bytes``, the actual uint32 word streams
          of DESIGN §9): that is the footprint the block cache holds
          resident, whole-container, regardless of pruning.

        Pass empty bounds for a shared group: its one scan is unpruned
        by construction, so the union price carries no predicate."""
        db = self.db
        lane = 8 * max(len(need), 1) + 1
        rows = 0
        packed = 0.0
        for host, owner in plan.sources:
            store = db.nodes[host].stores[owner]
            rows += store.wos.n_rows
            for c in store.containers:
                col = next(iter(c.columns.values()), None)
                if col is None:
                    continue
                keep = np.ones(col.n_blocks, dtype=bool)
                for colname, (lo, hi) in bounds.items():
                    if colname in c.smas:
                        keep &= c.smas[colname].prune_blocks(lo, hi)
                rows += int(keep.sum()) * db.block_rows
                for name in need:
                    if name in c.columns:
                        packed += c.columns[name].packed_bytes
        return int(rows * lane + packed)

    def _scan_bounds(self, q, proj) -> Dict:
        sp = q.scan_predicate(proj.columns)
        return sp.bounds() if sp is not None else {}

    def _price_query(self, q) -> Optional[int]:
        """Best-effort SMA price of a query at submit time (used only by
        the ``boost_cost_bytes`` decision; admission re-prices with the
        ticket's actual plan)."""
        from ..planner.planner import plan_query
        try:
            plan = plan_query(self.db, q)
            proj = self.db.catalog.projections[plan.projection]
            need = tuple(sorted(q.scan_columns(proj)))
            return self._sma_cost_bytes(plan, need,
                                        self._scan_bounds(q, proj))
        except Exception:
            return None   # unplannable here; admission rejects it typed

    # ------------------------------------------------------- admit round --

    def _admit_round(self, hold: frozenset = frozenset()) -> List[_Unit]:
        """Admit up to ``max_concurrent`` dispatch units under the memory
        budget and per-class bulkheads: pick an unblocked priority class,
        pop its head as unit leader, price it from SMA statistics, then
        coalesce compatible queued queries (any class) into its scan up
        to ``max_coalesce``.  The first unit always admits when NOTHING
        is in flight -- otherwise an oversized query could wedge the
        queue -- and its reservation marks it ``oversized`` instead;
        with flights parked, admission defers instead (their release at
        drain is guaranteed progress)."""
        cache = self.db.block_cache
        budget = self.memory_budget_bytes
        units: List[_Unit] = []
        round_new = {p: 0 for p in PRIORITIES}
        round_cls: Optional[str] = None
        while len(units) < self.max_concurrent:
            blocked = {p for p in PRIORITIES
                       if (lambda h: h is not None and h <= 0)(
                           self._class_headroom(p, round_new))}
            blocked |= hold
            if round_cls is not None:
                # rounds are class-homogeneous: once an interactive unit
                # leads the round, batch leaders wait for the next round
                # (their host-side scan assembly would ride ahead of the
                # interactive unit's drain) -- batch queries still join
                # this round as shared-scan mates, which costs nothing
                blocked |= {p for p in PRIORITIES if p != round_cls}
            cls = self._pick_queue(blocked)
            if cls is None:
                break
            queue = self._queues[cls]
            leader = queue.popleft()
            plan = self._plan(leader)
            if plan is None:
                continue   # rejected typed; try the next head
            proj = self.db.catalog.projections[plan.projection]
            leader.plan = plan
            leader.scan_need = tuple(sorted(leader.q.scan_columns(proj)))
            need_union = set(leader.scan_need)
            cost = self._sma_cost_bytes(plan, leader.scan_need,
                                        self._scan_bounds(leader.q, proj))
            leader.stats.cost_bytes = cost
            if self.max_cost_bytes is not None and cost > self.max_cost_bytes:
                self._reject(leader, QueryRejectedError(
                    f"admission cost {cost}B exceeds max_cost_bytes "
                    f"({self.max_cost_bytes}B)", epoch=leader.pinned),
                    kind="cost")
                continue
            ws = cost
            if (units or self._inflight) \
                    and cache.stats.reserved_bytes + ws > budget:
                queue.appendleft(leader)   # no headroom: close the round
                break
            if cls == "interactive":
                self._consec_interactive += 1
            else:
                self._consec_interactive = 0
            round_cls = cls
            round_new[leader.priority] += 1
            group = [leader]
            eff = self._effective_epoch(leader)
            if self.max_coalesce > 1 and self._shareable(leader.q) \
                    and self.db.mesh is None and leader.scan_need:
                ws = self._gather_mates(group, plan, eff, need_union, ws,
                                        round_new, hold)
            oversized = ws > budget
            units.append(_Unit(group, plan, eff, ws, cache.take(ws),
                               oversized))
        return units

    def _gather_mates(self, group: List[Ticket], plan, eff: int,
                      need_union: set, ws: int,
                      round_new: Dict[str, int],
                      hold: frozenset = frozenset()) -> int:
        """Pull queued queries compatible with the leader's scan into its
        group: same table, same projection + sources, same effective
        epoch, shareable shape, bulkhead headroom in the mate's class,
        and the enlarged column union still fits the memory budget (a
        GROUP's price is the unpruned union scan -- sharing forfeits
        pruning).  Scans both classes -- a batch query riding an
        interactive scan is the cheapest batch query there is -- EXCEPT
        classes in ``hold``: an interactive waiter's round must not pay
        for piggybacked batch members' programs and materialization."""
        cache = self.db.block_cache
        budget = self.memory_budget_bytes
        leader = group[0]
        for cls in PRIORITIES:
            if cls in hold:
                continue
            queue = self._queues[cls]
            kept: deque = deque()
            while queue and len(group) < self.max_coalesce:
                t = queue.popleft()
                q = t.q
                if q.table != leader.q.table or not self._shareable(q) \
                        or self._effective_epoch(t) != eff:
                    kept.append(t)
                    continue
                headroom = self._class_headroom(t.priority, round_new)
                if headroom is not None and headroom <= 0:
                    kept.append(t)   # mate's bulkhead is full
                    continue
                mplan = self._plan(t)
                if mplan is None:
                    continue   # rejected typed
                if mplan.projection != plan.projection \
                        or mplan.sources != plan.sources:
                    kept.append(t)
                    continue
                mproj = self.db.catalog.projections[mplan.projection]
                mneed = tuple(sorted(q.scan_columns(mproj)))
                if not mneed:
                    kept.append(t)
                    continue
                new_union = need_union | set(mneed)
                nws = self._sma_cost_bytes(plan, new_union, {})
                if cache.stats.reserved_bytes + nws > budget:
                    kept.append(t)   # the widened unit won't fit: an
                    continue         # over-budget scan gathers no mates
                t.plan, t.scan_need = mplan, mneed
                need_union |= set(mneed)
                ws = nws
                round_new[t.priority] += 1
                group.append(t)
            kept.extend(queue)
            self._queues[cls] = kept
        return ws

    # --------------------------------------------------------- dispatch --

    def _dispatch(self, unit: _Unit) -> None:
        """Dispatch one unit.  The async paths park device results in
        the in-flight queue (the reservation rides along until drain);
        shapes the fused subset cannot express run synchronously here
        with exact single-query semantics, releasing on the spot."""
        seq = next(self._dispatch_seq)
        self.stats.dispatches += 1
        now = self.clock.now()
        for t in unit.tickets:
            t.state = "running"
            t.stats.dispatch_seq = seq
            t.stats.queue_wait_s = now - t.submitted_at
            t.stats.reserved_bytes = unit.reserved
            t.stats.oversized = unit.oversized
            t.stats.share_group = len(unit.tickets)
        try:
            fire_with_retries(self.db, "serving.dispatch",
                              group=len(unit.tickets), clock=self.clock)
        except NodeCrashError:
            pass   # execution replans around the dead node below
        except TransientFaultError as e:
            err = QueryRejectedError(f"dispatch failed: {e}",
                                     epoch=unit.epoch)
            for t in unit.tickets:
                self._reject(t, err, kind="unavailable")
            unit.res.release()
            return
        flight = None
        try:
            if len(unit.tickets) == 1:
                flight = self._dispatch_solo(unit)
            else:
                flight = self._dispatch_shared(unit)
        finally:
            if flight is None:
                unit.res.release()   # sync path done (or all rejected)
        if flight is not None:
            flight.event = _record_event(self.db.device)
            self._park(flight)

    def _park(self, flight: _Flight) -> None:
        self._inflight.append(flight)
        self.stats.async_units += 1
        for t in flight.unit.tickets:
            t.stats.async_dispatch = True
            self._inflight_by_class[t.priority] += 1
        for p in PRIORITIES:
            cur = self._inflight_by_class[p]
            if cur > self.stats.peak_in_flight.get(p, 0):
                self.stats.peak_in_flight[p] = cur

    def _dispatch_solo(self, unit: _Unit) -> Optional[_Flight]:
        """Un-coalesced dispatch.  Fused-subset shapes dispatch their
        cached program and park the device result (no host sync);
        everything else -- segmented meshes, RLE-direct shapes, WOS
        side-scans, non-fused queries -- falls through to the ordinary
        synchronous pipeline, which carries its own failover loop."""
        t, plan, db = unit.tickets[0], unit.plan, self.db
        t0 = self.clock.now()
        if db.mesh is None and not plan.scalar_rle \
                and not rle_direct_eligible(t.q, plan):
            es = ExecStats(projection=plan.projection,
                           groupby_algorithm=plan.groupby_algorithm,
                           join_strategy=plan.join_strategy)
            es.snapshot_epoch = t.pinned
            bc = db.block_cache.stats
            h0, m0 = bc.hits, bc.misses
            try:
                d = fused_exec.execute_fused_deferred(db, t.q, plan,
                                                      t.pinned, es)
            except NodeCrashError:
                # a node died under the deferred scan: the sync fallback
                # replans with its own (fresh) failover budget
                t.stats.failovers += 1
                d = None
            except TransientFaultError:
                d = None   # sync fallback re-runs with per-point retries
            if d is not None:
                res, finish = d
                es.block_cache_hits = bc.hits - h0
                es.block_cache_misses = bc.misses - m0
                member = _Member(t, "fused_solo", es, finish=finish)
                return _Flight(unit, t0, [member], [res])
        self._run_solo(t, plan)
        return None

    def _run_solo(self, t: Ticket, plan) -> None:
        """Synchronous single-query execution at the ticket's pinned
        epoch (the ordinary pipeline, which carries its own failover
        loop).  ``plan=None`` replans -- the drain-failover path uses
        that to route around a node that died while the ticket's device
        results were parked."""
        t0 = self.clock.now()
        try:
            out, es = execute(self.db, t.q, as_of=t.pinned, plan=plan)
        except (QueryRejectedError, AvailabilityError) as e:
            self._reject(t, e, kind="unavailable")
            return
        t.stats.exec_s = self.clock.now() - t0
        t.stats.failovers += es.failovers
        self._complete(t, out, es)

    def _dispatch_shared(self, unit: _Unit) -> Optional[_Flight]:
        """Coalesced dispatch with group-level failover: a node crash at
        the ``serving.shared_scan`` point replans the whole group at the
        SAME effective epoch (buddies hold identical rows, §4.3); if the
        replanned group no longer co-plans, members fall back to solo
        execution; exhausted budgets reject every member typed.  On
        success the group's device programs are parked as ONE flight."""
        db = self.db
        tickets, plan, eff = unit.tickets, unit.plan, unit.epoch
        retries_left = int(getattr(db, "max_failover_retries", 2))
        t0 = self.clock.now()
        while True:
            try:
                fire_with_retries(db, "serving.shared_scan",
                                  projection=plan.projection,
                                  group=len(tickets), clock=self.clock)
                flight = self._shared_once_async(unit, t0)
                break
            except NodeCrashError as e:
                for t in tickets:
                    t.stats.failovers += 1
                if retries_left <= 0:
                    err = QueryRejectedError(
                        f"failover budget exhausted (node {e.node} "
                        f"crashed at {e.point})", epoch=eff,
                        attempts=tickets[0].stats.failovers)
                    for t in tickets:
                        self._reject(t, err, kind="unavailable")
                    return None
                retries_left -= 1
                plan, eff = self._replan_group(unit)
                if plan is None:
                    # the group diverged after the crash: each survivor
                    # finishes solo (with its own failover budget)
                    for t in unit.tickets:
                        if t.state == "running":
                            self._run_solo(t, t.plan)
                    return None
            except TransientFaultError as e:
                err = QueryRejectedError(
                    f"shared scan transient budget exhausted: {e}",
                    epoch=eff)
                for t in tickets:
                    self._reject(t, err, kind="unavailable")
                return None
        self.stats.shared_scans += 1
        self.stats.coalesced_max = max(self.stats.coalesced_max,
                                       len(tickets))
        return flight

    def _replan_group(self, unit: _Unit):
        """Replan every group member after a mid-scan crash.  Returns the
        new (plan, effective epoch) when the group still co-plans onto
        identical sources, else (None, None) to trigger solo fallback."""
        leader = unit.tickets[0]
        plan = self._plan(leader)
        if plan is None:
            return None, None
        proj = self.db.catalog.projections[plan.projection]
        leader.plan = plan
        leader.scan_need = tuple(sorted(leader.q.scan_columns(proj)))
        eff = self._effective_epoch(leader)
        ok = True
        for t in unit.tickets[1:]:
            mplan = self._plan(t)
            if mplan is None:
                ok = False
                continue
            t.plan = mplan
            mproj = self.db.catalog.projections[mplan.projection]
            t.scan_need = tuple(sorted(t.q.scan_columns(mproj)))
            if mplan.projection != plan.projection \
                    or mplan.sources != plan.sources \
                    or self._effective_epoch(t) != eff:
                ok = False
        if not ok:
            return None, None
        unit.plan, unit.epoch = plan, eff
        return plan, eff

    # ------------------------------------------------------ shared scan --

    def _scan_would_be_empty(self, t: Ticket) -> bool:
        """Would this query's OWN scan -- with its SMA pruning pushed
        down -- yield no blocks and no WOS rows?  Independent execution
        returns the structured ``_empty_result`` in that case, which is
        NOT always bitwise-equal to aggregating an all-false mask (a
        fully-pruned scalar min is 0-length-empty, a fully-masked one is
        a sentinel), so the coalesced path must detect it explicitly to
        stay byte-identical.  Host-side and cheap: reads only SMA
        arrays, exactly like the pruning it mirrors."""
        db, q, plan = self.db, t.q, t.plan
        proj = db.catalog.projections[plan.projection]
        scan_pred = q.scan_predicate(proj.columns)
        if scan_pred is None:
            bounds = {}
        else:
            bounds = scan_pred.bounds()
        need = t.scan_need
        for host, owner in plan.sources:
            store = db.nodes[host].stores[owner]
            if store.wos.n_rows:
                return False
            for c in store.containers:
                if not need:
                    continue
                nb = c.columns[need[0]].n_blocks
                keep = np.ones(nb, dtype=bool)
                for colname, (lo, hi) in bounds.items():
                    if colname in c.smas:
                        keep &= c.smas[colname].prune_blocks(lo, hi)
                if keep.any():
                    return False
        return True

    def _shared_once_async(self, unit: _Unit, t0: float) -> _Flight:
        """ONE unpruned scan of the group's column union at the effective
        epoch, then one DISPATCHED (not materialized) mask->aggregate
        program per member, parked as a single flight.

        Why results are byte-identical to independent execution: the only
        rows present here and absent from a member's own scan are rows of
        blocks its SMA pruning would have dropped -- every such row fails
        the member's predicate, so it enters aggregation masked-invalid,
        and the aggregation kernels give invalid rows exactly-zero /
        sentinel contributions (operators._prep_agg).  Adding exact zeros
        changes no sum bitwise; group ordering is by key value, identical
        under packing either way; and the per-member programs make the
        same algorithm/domain choices as the dedicated path
        (executor.fused_plan_params).  The one asymmetry -- a scan pruned
        to NOTHING returns the structured empty result -- is mirrored by
        ``_scan_would_be_empty``.  Members outside the fused subset (WOS
        side-scans pending, non-fused groupbys) materialize here at
        dispatch, exactly the code the solo pipeline runs; select-only
        members park their (mask, columns) device refs for the drain
        stage's one batched transfer."""
        db = self.db
        tickets, plan, eff = unit.tickets, unit.plan, unit.epoch
        need_union = sorted(set().union(*(set(t.scan_need)
                                          for t in tickets)))
        scan_stats = ExecStats(projection=plan.projection)
        bc = db.block_cache.stats
        bc_h0, bc_m0 = bc.hits, bc.misses
        scans = []
        ros = self._ros_union_scan(plan, need_union, eff, scan_stats)
        if ros is not None:
            scans.append(ros)
        wos_parts = wos_scan_results(db, plan, need_union, None, None, eff)
        scans.extend(wos_parts)
        merged = ops.concat_scans(scans)
        has_wos = bool(wos_parts)

        members: List[_Member] = []
        fetch: list = []
        seen: Dict[int, int] = {}     # id(query IR) -> primary member idx
        for i, t in enumerate(tickets):
            q = t.q
            es = ExecStats(projection=plan.projection,
                           groupby_algorithm=t.plan.groupby_algorithm)
            es.snapshot_epoch = t.pinned
            es.containers_scanned = scan_stats.containers_scanned
            es.blocks_total = scan_stats.blocks_total
            t.stats.shared_scan = "leader" if i == 0 else "member"
            prim = seen.get(id(q))
            if prim is not None:
                # identical query at the group's one effective epoch:
                # its result is the primary's, bitwise -- don't build a
                # second program (the ticket objects stay distinct)
                members.append(_Member(t, "dup", es, ref=prim))
                fetch.append(None)
                self.stats.deduped += 1
                continue
            seen[id(q)] = i
            if merged is None or self._scan_would_be_empty(t):
                members.append(_Member(t, "ready", es,
                                       out=_finalize(q, _empty_result(q))))
                fetch.append(None)
                continue
            es.rows_scanned = int(merged.valid.shape[0])
            es.block_cache_hits = bc.hits - bc_h0
            es.block_cache_misses = bc.misses - bc_m0
            cols = {c: merged.columns[c] for c in t.scan_need}
            valid = merged.valid
            if not has_wos:
                # same eligibility gate as the dedicated fused path: WOS
                # rows ride an unencoded side-scan the program can't take
                d = fused_exec.execute_shared_fused_deferred(
                    db, q, t.plan, cols, valid, es)
                if d is not None:
                    res, finish = d
                    members.append(_Member(t, "fused_shared", es,
                                           finish=finish, cols=cols,
                                           valid=valid))
                    fetch.append(res)
                    continue
            if q.group_by or q.aggs:
                # general (untraced) operators -- the same code the solo
                # pipeline runs after its scan; materializes at dispatch
                out = self._shared_general(q, t.plan, cols, valid, es)
                members.append(_Member(t, "ready", es,
                                       out=_finalize(q, out)))
                fetch.append(None)
            else:
                # select-only member: apply derived/predicate on device,
                # park the (mask, columns) refs -- the drain stage slices
                # them host-side after its one batched transfer
                dcols = dict(cols)
                for name, e in q.derived:
                    dcols[name] = e(dcols)
                v = valid
                if q.predicate is not None:
                    v = v & fused_exec.as_mask(q.predicate(dcols), v)
                keep = set(q.columns) | {n for n, _ in q.derived}
                sel = {c: cv for c, cv in dcols.items()
                       if (c in keep) or (not keep and c != "_matched")}
                members.append(_Member(t, "select", es))
                fetch.append((v, sel))
        return _Flight(unit, t0, members, fetch)

    def _ros_union_scan(self, plan, need_union, eff: int, scan_stats):
        """The group's assembled ROS union scan, cached in the block
        cache across groups (and services sharing the db).  A shared
        scan is unpruned -- no per-query predicate reaches it -- so the
        assembled columns depend only on (column union, exact source
        container ids, per-container effective visibility epochs), which
        IS the cache key: ROS containers are immutable, a mergeout that
        retires one changes the id tuple, a delete moves that
        container's visibility ceiling -- stale entries become
        unreachable LRU garbage exactly like §17's WOS device buffers.
        This is the serving tier's warm-scan story: concurrent queries
        share one scan within a group (space) and across groups (time);
        the solo pipeline can't reuse assemblies because its per-query
        SMA pruning makes each scan predicate-shaped."""
        db = self.db
        cache = getattr(db, "block_cache", None)
        if cache is None:
            return fused_exec.scan_stores_batched(
                db, plan, need_union, None, None, eff, scan_stats)
        cids: List[int] = []
        effs: List[int] = []
        for host, owner in plan.sources:
            store = db.nodes[host].stores[owner]
            for c in store.containers:
                cids.append(c.id)
                effs.append(min(eff,
                                fused_exec._container_ceiling(store, c)))
        ns = f"scan:{plan.projection}"
        key = (tuple(need_union), tuple(cids), tuple(effs))
        hit = cache.get(ns, key, KIND_UNION)
        if hit is not None:
            ros, n_containers, n_blocks = hit
            scan_stats.containers_scanned += n_containers
            scan_stats.blocks_total += n_blocks
            return ros
        c0, b0 = scan_stats.containers_scanned, scan_stats.blocks_total
        ros = fused_exec.scan_stores_batched(
            db, plan, need_union, None, None, eff, scan_stats)
        value = (ros, scan_stats.containers_scanned - c0,
                 scan_stats.blocks_total - b0)
        nbytes = 0
        if ros is not None:
            nbytes = sum(device_bytes(v) for v in ros.columns.values())
            nbytes += device_bytes(ros.valid)
        cache.put(ns, key, KIND_UNION, value, nbytes)
        return ros

    def _shared_general(self, q, plan, cols, valid, es: ExecStats
                        ) -> Dict[str, np.ndarray]:
        """The untraced per-member path over an already-merged scan --
        the byte-identity reference the fused member programs are tested
        against, and the fallback when a member's shape (or a sort-cap
        overflow at drain) exits the fused subset."""
        cols = dict(cols)
        for name, e in q.derived:
            cols[name] = e(cols)
        if q.predicate is not None:
            valid = valid & fused_exec.as_mask(q.predicate(cols), valid)
        if q.group_by or q.aggs:
            return _run_groupby(q, plan, cols, valid, es)
        mask = _np(valid)
        keep = set(q.columns) | {n for n, _ in q.derived}
        return {c: _np(v)[mask] for c, v in cols.items()
                if (c in keep) or (not keep and c != "_matched")}

    # ------------------------------------------------------ drain stage --

    def _harvest(self, *, force: bool = False,
                 prefer: Optional[Ticket] = None,
                 waiter: Optional[Ticket] = None) -> int:
        """Harvest every flight whose device arrays report ready, in
        arrival order among themselves; an unready flight never blocks a
        ready one behind it (head-of-line blocking would let a slow
        batch unit hold an already-finished interactive probe hostage in
        the drain stage).  An interactive ``waiter``'s sweep leaves
        all-batch flights parked -- their host materialization waits for
        a neutral or batch-driven step.  ``force`` additionally drains
        ONE flight unconditionally regardless of class -- the one
        carrying ``prefer`` if it is parked, else the oldest -- the
        progress guarantee behind ``Ticket.result()``/``drain()``;
        its copy waits for the launches queued before it."""
        settled = 0
        if force and self._inflight:
            at = 0
            if prefer is not None:
                for j, fl in enumerate(self._inflight):
                    if prefer in fl.unit.tickets:
                        at = j
                        break
            settled += self._harvest_at(at)
        skip_batch = (waiter is not None
                      and waiter.priority == "interactive")
        i = 0
        while i < len(self._inflight):
            fl = self._inflight[i]
            if skip_batch and waiter not in fl.unit.tickets and \
                    all(t.priority == "batch" for t in fl.unit.tickets):
                i += 1
            elif fl.ready():
                settled += self._harvest_at(i)
            else:
                i += 1
        return settled

    def _harvest_at(self, i: int) -> int:
        fl = self._inflight[i]
        del self._inflight[i]
        for t in fl.unit.tickets:
            self._inflight_by_class[t.priority] -= 1
        return self._harvest_one(fl)

    def _fetch(self, fl: _Flight):
        """ONE batched device->host copy for a whole flight
        (engine/executor.to_host)."""
        global _DEVICE_TRANSFERS
        _DEVICE_TRANSFERS += 1
        self.stats.device_transfers += 1
        return fused_exec.to_host(fl.fetch)

    def _harvest_one(self, fl: _Flight) -> int:
        """Drain one flight: fire ``serving.drain`` (the failure matrix
        lives here -- see DESIGN.md §18), perform the unit's single
        batched transfer, then finish every member.

        * NodeCrashError at drain: the parked device results may live on
          the dead node; fail over ONCE by re-running each member through
          the solo pipeline at its still-pinned epoch (replans onto
          buddies holding identical rows -- byte-identical by the
          differential property).
        * TransientFaultError (retry budget already spent): every member
          rejects typed.
        * Sort-cap overflow surfacing at materialization: the signature
          is poisoned, the member re-runs down the general path."""
        unit = fl.unit
        try:
            try:
                fire_with_retries(self.db, "serving.drain",
                                  group=len(unit.tickets), clock=self.clock)
            except NodeCrashError:
                for t in unit.tickets:
                    if t.state == "running":
                        t.stats.failovers += 1
                        self._run_solo(t, None)
                return len(unit.tickets)
            except TransientFaultError as e:
                err = QueryRejectedError(f"drain failed: {e}",
                                         epoch=unit.epoch)
                for t in unit.tickets:
                    if t.state == "running":
                        self._reject(t, err, kind="unavailable")
                return len(unit.tickets)
            host = self._fetch(fl)
            now = self.clock.now()
            for m, h in zip(fl.members, host):
                t = m.ticket
                t.stats.exec_s = now - fl.t0
                if m.mode == "ready":
                    self._complete(t, m.out, m.es)
                elif m.mode == "fused_solo":
                    out = m.finish(h)
                    if out is None:
                        # overflow at materialization: sig poisoned, the
                        # sync re-run takes the general path
                        self._run_solo(t, t.plan)
                    else:
                        m.es.fused = True
                        self._complete(t, _finalize(t.q, out), m.es)
                elif m.mode == "fused_shared":
                    out = m.finish(h)
                    if out is None:
                        out = self._shared_general(t.q, t.plan, m.cols,
                                                   m.valid, m.es)
                    else:
                        m.es.fused = True
                    self._complete(t, _finalize(t.q, out), m.es)
                elif m.mode == "dup":
                    # members are harvested in group order, so the
                    # primary (earlier index) has already settled
                    pm = fl.members[m.ref]
                    pt = pm.ticket
                    if pt.state == "done":
                        m.es.fused = pm.es.fused
                        m.es.rows_scanned = pm.es.rows_scanned
                        self._complete(t, pt._result, m.es)
                    else:   # primary rejected/failed: run this one solo
                        self._run_solo(t, t.plan)
                else:   # select
                    v, sel = h
                    out = {c: arr[v] for c, arr in sel.items()}
                    self._complete(t, _finalize(t.q, out), m.es)
            self.stats.drains += 1
            return len(unit.tickets)
        finally:
            unit.res.release()
