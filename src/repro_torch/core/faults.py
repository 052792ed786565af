"""Deterministic, seeded fault injection for the simulated cluster.

The paper's availability claim (§4.3 K-safety, §4.9 recovery) is only as
good as the failure timings it survives.  This module lets tests (and the
chaos tier in scripts/verify.sh) splice failures into *named injection
points* threaded through the stack -- commit apply, tuple-mover passes,
recovery replay, buddy reads, per-shard slab builds, exchange
collectives, serving admission and shared scans (the canonical list is
:data:`INJECTION_POINTS`) -- with programmable schedules:

    inj = db.enable_faults(seed=7)
    inj.on("exchange.resegment", CrashNode(node=2), hit=3)
    inj.on("recovery.buddy_read", Transient(), times=2)
    inj.chaos(("commit.apply", "tuple_mover.moveout"),
              p=0.05, action=CrashNode())        # seeded probabilistic

Everything is deterministic given the seed: per-point hit counters drive
nth-hit schedules, and probabilistic rules draw from one
``np.random.default_rng(seed)`` in firing order.

Failure taxonomy (what a fired action raises):

* ``NodeCrashError`` -- a node died (the action already called
  ``db.fail_node``).  Never retried at the injection site; it propagates
  to the *query* level, where ``engine.pipeline.execute`` replans onto
  buddies at the same pinned epoch (bounded failover retry).
* ``TransientFaultError`` -- a recoverable blip (network hiccup, slow
  peer).  Injection sites wrap their work in :func:`with_retries`, which
  retries with exponential backoff; exhaustion escalates to the caller's
  typed degradation error (``QueryRejectedError`` for queries,
  ``RecoverySourceLostError`` for recovery).
* ``FaultTimeout`` -- an attempt exceeded the per-attempt timeout (e.g.
  a ``Hang`` action); subclasses ``TransientFaultError`` so it retries
  the same way.

The default ``db.faults`` is a :class:`NullInjector` whose ``fire`` is a
no-op -- production paths pay two attribute lookups, nothing else.

Mirrors ``src/repro/core/faults.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# every named injection point threaded through the stack, the canonical
# registry for docs and chaos sweeps (tests iterate this so a new point
# cannot be forgotten by the chaos tier).  The serving.* points land in
# engine/serving.py: ``serving.admit`` fires per admission decision
# (before anything is pinned or queued), ``serving.rate_limit`` per
# token-bucket check (also pre-pin), ``serving.shared_scan`` once per
# coalesced scan attempt (a crash there exercises multi-query failover),
# ``serving.dispatch`` once per dispatch unit as its device programs
# launch, and ``serving.drain`` once per unit as its parked futures are
# harvested (a crash there exercises the mid-flight drain failover, a
# Hang there simulates a slow query stalling the drain stage).
INJECTION_POINTS = (
    "commit.apply",
    "tuple_mover.moveout",
    "tuple_mover.mergeout",
    "recovery.replay",
    "recovery.buddy_read",
    "segmented.slab_build",
    "segmented.buddy_read",
    "exchange.resegment",
    "exchange.broadcast",
    "serving.admit",
    "serving.rate_limit",
    "serving.shared_scan",
    "serving.dispatch",
    "serving.drain",
)


class FaultError(Exception):
    """Base class of injected failures."""


class TransientFaultError(FaultError):
    """A recoverable blip: the injection site retries with backoff."""


class FaultTimeout(TransientFaultError):
    """An attempt exceeded its per-attempt timeout budget."""

    def __init__(self, point: str, elapsed_s: float, budget_s: float):
        self.point, self.elapsed_s, self.budget_s = point, elapsed_s, \
            budget_s
        super().__init__(f"{point}: attempt took {elapsed_s:.3f}s "
                         f"(budget {budget_s:.3f}s)")


class NodeCrashError(FaultError):
    """A node failed at this point (``db.fail_node`` already ran)."""

    def __init__(self, node: int, point: str):
        self.node, self.point = node, point
        super().__init__(f"node {node} crashed at {point}")


# ---------------------------------------------------------------------------
# actions: callables (db, point, ctx, rng) -> None, raising to signal
# ---------------------------------------------------------------------------

class CrashNode:
    """Fail a node at the point.  ``node=None`` crashes the node named in
    the firing context (the one being operated on), falling back to a
    seeded-random up node for node-less points (exchange collectives).

    ``respect_k_safety=True`` turns the action into a no-op while any
    OTHER node is not serving: a second simultaneous failure would exceed
    K=1 (losing a buddy pair loses the WOS of both copies of a segment --
    the paper's cluster-down case, unrecoverable by design).  Chaos
    schedules over DML streams that must converge with a never-failed
    reference use this; query-only chaos may crash freely, because reads
    degrade to typed errors instead of losing state."""

    def __init__(self, node: Optional[int] = None, *,
                 respect_k_safety: bool = False):
        self.node = node
        self.respect_k_safety = respect_k_safety

    def __call__(self, db, point: str, ctx: dict, rng) -> None:
        nid = self.node
        if nid is None:
            nid = ctx.get("node")
        if nid is None:
            cands = [n.id for n in db.nodes if n.up]
            if not cands:
                return
            nid = int(cands[int(rng.integers(len(cands)))])
        if self.respect_k_safety and db is not None and \
                any(not n.serving() for n in db.nodes if n.id != nid):
            return
        if db is not None and db.nodes[nid].up:
            db.fail_node(nid)
        raise NodeCrashError(int(nid), point)

    def __repr__(self):
        return f"CrashNode(node={self.node})"


class Transient:
    """Raise a retryable TransientFaultError."""

    def __init__(self, message: str = "injected transient fault"):
        self.message = message

    def __call__(self, db, point: str, ctx: dict, rng) -> None:
        raise TransientFaultError(f"{point}: {self.message}")

    def __repr__(self):
        return "Transient()"


class Hang:
    """Stall the attempt (does not raise): the per-attempt timeout in
    :func:`with_retries` converts the slow attempt into a FaultTimeout,
    which retries like a transient -- a hung peer must fail the attempt,
    not wedge the query.

    When the firing context carries a ``clock`` (the serving layer passes
    its scheduler clock at ``serving.dispatch``/``serving.drain``), the
    hang sleeps on THAT clock -- under a virtual clock the stall advances
    simulated time with no wall-clock sleep, so slow-query schedules
    replay deterministically (engine/serving.VirtualClock)."""

    def __init__(self, seconds: float = 0.05):
        self.seconds = seconds

    def __call__(self, db, point: str, ctx: dict, rng) -> None:
        clock = ctx.get("clock")
        if clock is not None:
            clock.sleep(self.seconds)
        else:
            time.sleep(self.seconds)

    def __repr__(self):
        return f"Hang({self.seconds})"


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Rule:
    point: str
    action: Callable
    after: int = 0               # skip the first N eligible hits
    times: Optional[int] = None  # fire at most N times (None = forever)
    p: Optional[float] = None    # probabilistic (seeded) instead of nth-hit
    node: Optional[int] = None   # only hits whose ctx names this node
    seen: int = 0                # eligible hits observed
    fired: int = 0               # times actually fired


class NullInjector:
    """Default ``db.faults``: injection disabled, ``fire`` is a no-op."""

    is_null = True
    total_fired = 0
    paused = False

    def fire(self, point: str, **ctx) -> None:
        return None

    def fired(self, point: str) -> int:
        return 0

    def hit_count(self, point: str) -> int:
        return 0

    @contextmanager
    def suspended(self):
        yield self


NULL_INJECTOR = NullInjector()


class FaultInjector:
    """Seeded, deterministic fault scheduler (see module docstring).

    Retry policy knobs consumed by :func:`with_retries`:
    ``max_attempts`` (per injection site, default 3), ``backoff_s``
    (base of the exponential backoff, default 0 so tests stay fast) and
    ``attempt_timeout_s`` (per-attempt budget; None disables)."""

    is_null = False

    def __init__(self, db=None, seed: Optional[int] = None, *,
                 max_attempts: int = 3, backoff_s: float = 0.0,
                 attempt_timeout_s: Optional[float] = None):
        self.db = db
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.rules: List[_Rule] = []
        self.hits: Counter = Counter()     # per-point deterministic count
        self.log: List[Tuple[str, dict]] = []   # (point, ctx) per firing
        self.total_fired = 0
        self.paused = False
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        self.attempt_timeout_s = attempt_timeout_s

    # ------------------------------------------------------- scheduling --

    def on(self, point: str, action: Callable, *, hit: Optional[int] = None,
           after: int = 0, times: Optional[int] = None,
           p: Optional[float] = None,
           node: Optional[int] = None) -> "FaultInjector":
        """Register a schedule: fire ``action`` at ``point``.

        ``hit=N`` fires exactly on the Nth eligible hit (sugar for
        ``after=N-1, times=1``); ``after``/``times`` window repeated
        firings; ``p`` makes the rule probabilistic (one seeded draw per
        eligible hit); ``node`` restricts to hits whose context names
        that node."""
        if hit is not None:
            after, times = hit - 1, 1
        self.rules.append(_Rule(point, action, after=after, times=times,
                                p=p, node=node))
        return self

    def chaos(self, points: Sequence[str], *, p: float,
              action: Optional[Callable] = None,
              times: Optional[int] = None) -> "FaultInjector":
        """Probabilistic schedule over many points at once."""
        act = action if action is not None else CrashNode()
        for pt in points:
            self.on(pt, act, p=p, times=times)
        return self

    @contextmanager
    def suspended(self):
        """Temporarily disable firing (e.g. while a test repairs the
        cluster between chaos rounds) without resetting counters."""
        prev, self.paused = self.paused, True
        try:
            yield self
        finally:
            self.paused = prev

    # ----------------------------------------------------------- firing --

    def fire(self, point: str, **ctx) -> None:
        """Hit an injection point.  Deterministically evaluates every
        matching rule; a triggered action may raise (see taxonomy)."""
        self.hits[point] += 1
        if self.paused:
            return
        for rule in self.rules:
            if rule.point != point:
                continue
            if rule.node is not None and ctx.get("node") != rule.node:
                continue
            rule.seen += 1
            if rule.times is not None and rule.fired >= rule.times:
                continue
            if rule.p is not None:
                if float(self.rng.random()) >= rule.p:
                    continue
            elif rule.seen <= rule.after:
                continue
            rule.fired += 1
            self.total_fired += 1
            self.log.append((point, dict(ctx)))
            rule.action(self.db, point, ctx, self.rng)

    def fired(self, point: str) -> int:
        return sum(r.fired for r in self.rules if r.point == point)

    def hit_count(self, point: str) -> int:
        return int(self.hits[point])


# ---------------------------------------------------------------------------
# retry-with-backoff wrapper used at transient-tolerant injection sites
# ---------------------------------------------------------------------------

def with_retries(db, point: str, fn: Callable, *, stats=None,
                 attempts: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 timeout_s: Optional[float] = None, **ctx):
    """Fire ``point`` then run ``fn()``, retrying TransientFaultError /
    per-attempt timeouts with exponential backoff.  NodeCrashError is
    never retried here (node loss is a *query*-level failover, not an
    attempt-level blip).  Exhausted attempts re-raise the last transient
    for the caller to escalate into its typed degradation error.  With
    the NullInjector this is exactly ``fn()``."""
    inj = getattr(db, "faults", None) if db is not None else None
    if inj is None or inj.is_null:
        return fn()
    n_attempts = attempts if attempts is not None else inj.max_attempts
    backoff = inj.backoff_s if backoff_s is None else backoff_s
    budget = inj.attempt_timeout_s if timeout_s is None else timeout_s
    last: Optional[TransientFaultError] = None
    for k in range(max(n_attempts, 1)):
        t0 = time.monotonic()
        try:
            inj.fire(point, **ctx)
            out = fn()
        except TransientFaultError as e:
            last = e
        else:
            elapsed = time.monotonic() - t0
            if budget is not None and elapsed > budget:
                last = FaultTimeout(point, elapsed, budget)
            else:
                return out
        if stats is not None and hasattr(stats, "fault_retries"):
            stats.fault_retries += 1
        if backoff and k + 1 < n_attempts:
            time.sleep(backoff * (2 ** k))
    raise TransientFaultError(
        f"{point}: {n_attempts} attempt(s) exhausted") from last


def fire_with_retries(db, point: str, *, stats=None, **ctx) -> None:
    """A bare injection point (no wrapped work): transients are absorbed
    by the retry loop, crashes and exhausted transients propagate."""
    with_retries(db, point, lambda: None, stats=stats, **ctx)
