"""Declarative admission scheduling for the serving engine.

UPIR's thesis is that parallel execution decisions belong in the IR, not
hard-coded in a runtime. The engine's admission/slot-fill order is exactly
such a decision: which queued request gets the next free decode slot (and,
under pool pressure, which running request is preempted) used to be an
implicit FIFO ``deque`` buried in ``runtime.engine``. This module makes it a
validated, declarative spec — :class:`SchedulingPolicy` — that the engine
*consults* instead of assuming, and that renders into the canonical UPIR
program text (the ``sched(...)`` annotation next to ``mm(...)``/``caps(...)``
on the decode cache's data attribute), so engines with different policies
fingerprint — and therefore plan-cache — apart.

Policies (``kind``):

* ``fifo`` — submission order; the default, bitwise-compatible with the
  pre-policy engine (head-of-queue admission, newest-admitted eviction).
* ``priority`` — higher ``Request.priority_class`` admits first, FIFO within
  a class. With ``preempt=True`` (the default) a queued request may evict the
  lowest-class running request through the engine's existing
  eviction-by-recompute machinery (paged layout only — dense slots have no
  pages to release), so an interactive class overtakes a batch class
  mid-flight without losing any tokens: evicted streams replay exactly.
* ``fair`` — per-tenant weighted fairness by cumulative service (a deficit
  round-robin over normalized served tokens): the queued tenant with the
  least ``service / weight`` admits next, FIFO within a tenant. Any tenant
  with queued work is eventually the minimum — starvation-free.
* ``sjf`` — shortest-prefill-first: the smallest prompt bucket admits next,
  FIFO within a bucket length.

``prefix_affinity=True`` is a modifier on any base policy (requires the
engine's prefix cache): queued requests whose page-chain prefixes currently
hit the engine's prefix index are admitted first —
among them, and among the misses, the base policy orders. Admitting hits
while their pages are still cached converts would-be re-prefills into page
shares.

Selection (:func:`select_index`) and victim choice (:func:`victim`) are pure
functions of the policy, the queue, and the (tiny, host-side) scheduler
state, so the invariants — FIFO bitwise compatibility, no reordering within
a priority class, fair starvation-freedom — are directly property-testable
without an engine in the loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

POLICY_KINDS = ("fifo", "priority", "fair", "sjf")


def _fmt_weight(w: float) -> str:
    return f"{w:g}"


@dataclasses.dataclass(frozen=True)
class SchedulingPolicy:
    """Validated, declarative admission-scheduling spec.

    * ``kind`` — one of ``fifo | priority | fair | sjf`` (see module doc).
    * ``prefix_affinity`` — admit prefix-cache hits first (any base policy;
      the engine requires ``prefix_cache=True`` to honor it).
    * ``preempt`` — ``priority`` only: allow a queued higher-class request to
      evict the lowest-class running request (eviction-by-recompute).
    * ``tenant_weights`` — ``fair`` only: ``((tenant, weight), ...)``;
      unlisted tenants weigh 1.0. Canonicalized sorted by tenant name so two
      equal specs render (and fingerprint) identically.

    The rendered form (:meth:`ext`) is what ``core.plans.build_program``
    attaches to the decode cache's data attribute and ``core.printer``
    prints as ``sched(...)`` — the policy participates in the canonical
    program fingerprint exactly like page geometry and capability flags do.
    """

    kind: str = "fifo"
    prefix_affinity: bool = False
    preempt: bool = True
    tenant_weights: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.kind not in POLICY_KINDS:
            raise ValueError(f"scheduling kind must be one of "
                             f"{'|'.join(POLICY_KINDS)}, got {self.kind!r}")
        if self.tenant_weights and self.kind != "fair":
            raise ValueError("tenant_weights only apply to the 'fair' "
                             f"policy, not {self.kind!r}")
        canon = []
        seen = set()
        for entry in self.tenant_weights:
            name, weight = entry
            if not isinstance(name, str) or not name:
                raise ValueError(f"tenant name must be a non-empty string, "
                                 f"got {name!r}")
            if name in seen:
                raise ValueError(f"duplicate tenant weight for {name!r}")
            weight = float(weight)
            if not math.isfinite(weight) or weight <= 0:
                raise ValueError(f"tenant weight must be finite and > 0, "
                                 f"got {weight!r} for {name!r}")
            seen.add(name)
            canon.append((name, weight))
        object.__setattr__(self, "tenant_weights",
                           tuple(sorted(canon)))

    # ------------------------------------------------------------- rendering

    def weight(self, tenant: str) -> float:
        for name, w in self.tenant_weights:
            if name == tenant:
                return w
        return 1.0

    def ext(self) -> Dict[str, Any]:
        """The policy as ``sched(...)`` extension keys for the UPIR decode
        program (``core.printer.SCHED_EXT_KEYS`` order). Only
        behavior-bearing fields render: ``preempt`` is meaningless outside
        ``priority`` and ``tenants`` outside ``fair``, so they are omitted
        there rather than fingerprinting dead knobs."""
        out: Dict[str, Any] = {"policy": self.kind}
        if self.prefix_affinity:
            out["prefix_affinity"] = True
        if self.kind == "priority" and self.preempt:
            out["preempt"] = True
        if self.kind == "fair" and self.tenant_weights:
            out["tenants"] = ",".join(f"{n}:{_fmt_weight(w)}"
                                      for n, w in self.tenant_weights)
        return out

    def describe(self) -> str:
        parts = [self.kind]
        if self.kind == "priority" and self.preempt:
            parts.append("preempt")
        if self.kind == "fair" and self.tenant_weights:
            parts.append("tenants(" + ",".join(
                f"{n}:{_fmt_weight(w)}" for n, w in self.tenant_weights) + ")")
        if self.prefix_affinity:
            parts.append("prefix_affinity")
        return "+".join(parts)


FIFO = SchedulingPolicy()


class SchedulerState:
    """Mutable host-side scheduling state owned by one engine.

    Today this is only the ``fair`` policy's per-tenant cumulative service
    (normalized by weight); every other policy is stateless. Service is
    charged at admission (:meth:`charge`) with the request's token footprint
    — prompt bucket + generation budget — so a tenant that keeps admitting
    grows its normalized service and yields to waiting tenants."""

    def __init__(self, policy: SchedulingPolicy):
        self.policy = policy
        self._service: Dict[str, float] = {}

    def service(self, tenant: str) -> float:
        return self._service.get(tenant, 0.0)

    def charge(self, req: Any) -> None:
        if self.policy.kind != "fair":
            return
        cost = float(max(req.bucket, 1) + max(req.max_new_tokens, 0))
        self._service[req.tenant] = (self._service.get(req.tenant, 0.0)
                                     + cost / self.policy.weight(req.tenant))


def select_index(policy: SchedulingPolicy, queue: Sequence[Any], *,
                 state: Optional[SchedulerState] = None,
                 prefix_hit: Optional[Callable[[Any], bool]] = None
                 ) -> Optional[int]:
    """Index of the next request to admit, or None on an empty queue.

    Pure in (policy, queue contents, state, probe results). ``fifo`` always
    returns the head — index 0, exactly the old ``popleft`` — including for
    eviction-requeued requests (the engine requeues victims at the front).
    Ties in every policy break toward the lowest queue index, so no policy
    ever reorders requests it considers equivalent."""
    if not queue:
        return None
    pool = list(range(len(queue)))
    if policy.prefix_affinity and prefix_hit is not None:
        hits = [i for i in pool if prefix_hit(queue[i])]
        if hits:
            pool = hits
    if policy.kind == "fifo":
        return pool[0]
    if policy.kind == "priority":
        best = max(queue[i].priority_class for i in pool)
        return next(i for i in pool if queue[i].priority_class == best)
    if policy.kind == "sjf":
        shortest = min(queue[i].bucket for i in pool)
        return next(i for i in pool if queue[i].bucket == shortest)
    # fair: least normalized service among tenants with queued work, then
    # FIFO within the chosen tenant
    first: Dict[str, int] = {}
    for i in pool:
        t = queue[i].tenant
        if t not in first:
            first[t] = i
    svc = state.service if state is not None else (lambda t: 0.0)
    tenant = min(first, key=lambda t: (svc(t), first[t]))
    return first[tenant]


def backoff_eligible(queue: Sequence[Any], tick: int):
    """Indices of queued requests whose quarantine backoff has expired.

    Fault-tolerant engines re-admit quarantined requests with an exponential
    backoff expressed in engine ticks (``Request._not_before``); admission
    must only consider requests whose delay has elapsed, while still letting
    the declarative policy order the eligible subset. Returns ``None`` when
    *every* request is eligible — the no-faults fast path, so the engine can
    hand the queue to :func:`select_index` unsliced — otherwise the list of
    eligible queue indices (possibly empty)."""
    if all(getattr(r, "_not_before", 0) <= tick for r in queue):
        return None
    return [i for i, r in enumerate(queue)
            if getattr(r, "_not_before", 0) <= tick]


def victim(policy: SchedulingPolicy, running: Sequence[Any]) -> Any:
    """The running request to evict under pool pressure.

    ``fifo``/``fair``/``sjf`` keep the pre-policy invariant — evict the
    newest-admitted sequence (oldest requests always make progress, which is
    the overcommit liveness argument). ``priority`` evicts from the lowest
    class first, newest-admitted within that class, so high classes only
    ever yield to each other."""
    if policy.kind == "priority":
        return min(running,
                   key=lambda r: (r.priority_class, -r._admit_seq))
    return max(running, key=lambda r: r._admit_seq)


def wants_preemption(policy: SchedulingPolicy, candidate: Any,
                     running: Sequence[Any]) -> bool:
    """True when admitting ``candidate`` justifies evicting the policy's
    victim: only the ``priority`` policy preempts, and only for a strictly
    higher class (equal classes queue FIFO behind each other)."""
    if policy.kind != "priority" or not policy.preempt or not running:
        return False
    return victim(policy, running).priority_class < candidate.priority_class


def note_preemption(telemetry: Any, policy: SchedulingPolicy, candidate: Any,
                    running: Sequence[Any]) -> None:
    """Record the scheduler's preemption decision as a telemetry event.

    Called by the engine right before it evicts (``running`` still holds the
    victim, so the event names both sides of the decision). Emission lives
    here with the decision logic — the event is attributable to the policy,
    not to the eviction machinery that carries it out. No-op when the engine
    runs without telemetry."""
    if telemetry is None:
        return
    v = victim(policy, running)
    telemetry.event("preempted", rid=v.rid,
                    by=candidate.rid,
                    victim_class=v.priority_class,
                    candidate_class=candidate.priority_class)
