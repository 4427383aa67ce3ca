"""Admission layer of the serving core: queue, quotas, deadline-aware
lane packing, load shedding.

Port of ``repro.runtime.admission`` (host-side, numpy). Top layer of
the three-layer runtime (see docs/serving.md): everything
about WHO runs and in WHICH morsel pack is decided here, before the
dispatch layer (runtime/dispatch.py) ever sees a batch. The paper's Fig 14
admission rule — pool every tenant's sources into shared 64-wide MS-BFS
lane morsels only when ``recommend_policy`` says the pooled batch
saturates the lanes — is kept verbatim; what this module adds around it is
the serving policy:

- **Tenant quotas** (``tenant_quota``): a cap on each tenant's concurrent
  (queued + in-flight) queries. Submissions over quota are *shed* at
  admission — the open-loop stream keeps arriving whether or not we are
  keeping up, so one tenant's burst must not grow the shared queue without
  bound (Hauck et al.: inter-query parallelism has to be throttled jointly
  with intra-query width).

- **Deadline-aware lane packing with eviction**: a packed MS-BFS batch
  finishes when its SLOWEST lane converges, so a tight-deadline query
  packed next to a deep one inherits the deep query's completion time.
  When the runtime has a warm latency estimate (the dispatch layer's
  learned per-bucket depth × the serving loop's measured ms-per-iteration
  EWMA), ``plan()`` predicts the pack's slowest-lane time and EVICTS any
  member whose deadline slack cannot survive it — the evictee re-packs as
  its own solo batch (``core.msbfs.LanePacker.evict`` is a pure deletion:
  the survivors keep arrival order, so their rows are untouched). Only a
  deadline reads the estimates: a pack none of whose members has one
  makes none, and otherwise each member is estimated once a plan round
  (the estimators' state changes only between rounds, when a batch
  settles or a delta lands), however many eviction passes follow.

- **Load shedding**: a query is dropped (never executed, reported shed)
  when its deadline has already expired at plan time, or when even a solo
  batch is predicted to blow it — running it would only steal capacity
  from queries that can still make their SLOs. Quota/queue-full rejections
  are shed at submit time. Sheds are never silent: every one lands in
  ``AdmissionStats`` with its reason and in the submitter's ticket.

Determinism: admission decisions are a pure function of (submission
order, quotas, the injected ``clock`` readings, and the dispatch layer's
learned state). With no deadlines and no quotas — the synchronous façade's
configuration — ``plan()`` reproduces the legacy ``flush`` batching
bit-for-bit: same pooled policy decision, same arrival-order source
concatenation, same per-query spans. The seeded-replay lock in
tests/test_serving.py pins this.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np

from .. import trace
from ..core import QUERY_KINDS, recommend_policy
from ..core.msbfs import LanePacker

# shed reasons (AdmissionTicket.shed_reason / AdmissionStats.sheds_by_reason)
SHED_QUOTA = "quota"  # tenant over its concurrent-query quota
SHED_QUEUE_FULL = "queue_full"  # global queue cap reached
SHED_EXPIRED = "expired"  # deadline already passed when planning began
SHED_HOPELESS = "hopeless"  # even a solo batch is predicted to miss


@dataclasses.dataclass
class AdmittedQuery:
    """One queued query: sources + tenant + its absolute deadline (clock
    seconds; None = no SLO)."""

    qid: str
    tenant: str
    sources: np.ndarray
    t_submit: float
    t_deadline: float | None = None
    query_kind: str = "reach"


@dataclasses.dataclass
class AdmissionTicket:
    """What ``submit`` hands back: admitted (queued), shed (with reason),
    or instantly done (zero-source queries complete at admission — there
    is nothing to traverse, and the result shape is known)."""

    qid: str
    admitted: bool
    shed_reason: str | None = None
    done: bool = False


@dataclasses.dataclass
class PlannedBatch:
    """One dispatch-ready batch: flat sources in arrival order + per-query
    row spans into the lane-major result rows. ``policy`` is "ntkms" for
    the shared lane pack, None for a solo batch (the dispatch layer's
    ``recommend_policy`` decides, exactly as the legacy per-query path)."""

    queries: list[AdmittedQuery]
    sources: np.ndarray
    spans: dict[str, tuple[int, int]]
    packed: bool
    policy: str | None
    query_kind: str = "reach"


@dataclasses.dataclass
class AdmissionPlan:
    """One ``plan()`` round: batches to dispatch (packed batch first, then
    evicted/solo batches in arrival order), instantly-complete results
    (zero-source), and the queries shed this round."""

    batches: list[PlannedBatch]
    instant: dict[str, np.ndarray]
    shed: list[tuple[str, str]]  # (qid, reason)


@dataclasses.dataclass
class AdmissionStats:
    submitted: int = 0
    admitted: int = 0
    shed: int = 0
    evictions: int = 0  # pulled out of the shared pack to a solo batch
    estimated: int = 0  # depth_hint calls made by plan()
    zero_source: int = 0
    sheds_by_reason: collections.Counter = dataclasses.field(
        default_factory=collections.Counter
    )


class AdmissionQueue:
    """Multi-tenant admission queue over one graph.

    ``depth_hint(sources, lanes)`` and ``ms_per_iter()`` are the dispatch/
    service layers' latency estimators (learned convergence depth, measured
    ms per iteration). Either returning None disables deadline
    eviction/shedding for that plan round — cold admission must not evict
    on a guess, and the no-estimator configuration is exactly the legacy
    deterministic batching.

    ``max_batch_sources`` bounds one plan round's packed pool (saxml-style
    bucketed batching): when set, ``plan()`` serves the arrival-order
    prefix of the queue whose pooled sources fit the cap and leaves the
    rest queued for the next round. A bounded batch bounds the serving
    loop's admission granularity — a query never waits behind more than
    one capped batch before it can join a pack, which is what keeps the
    tail latency of an always-on stream at O(batch) instead of
    O(backlog). ``None`` (default) keeps the legacy whole-queue pooling.

    ``clock`` is injectable so replay tests drive admission with a manual
    clock (determinism lock); it is read only at submit/plan, never inside
    dispatch."""

    def __init__(
        self,
        n_nodes: int,
        n_devices: int,
        avg_degree: float,
        lanes: int = 64,
        tenant_quota: int | None = None,
        max_queue: int | None = None,
        max_batch_sources: int | None = None,
        depth_hint: Callable[[np.ndarray, int], int | None] | None = None,
        ms_per_iter: Callable[[], float | None] | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.n_nodes = int(n_nodes)
        self.n_devices = int(n_devices)
        self.avg_degree = float(avg_degree)
        self.lanes = int(lanes)
        self.tenant_quota = tenant_quota
        self.max_queue = max_queue
        self.max_batch_sources = max_batch_sources
        self.depth_hint = depth_hint
        self.ms_per_iter = ms_per_iter
        self.clock = clock
        self.stats = AdmissionStats()
        self._queue: list[AdmittedQuery] = []
        self._instant: list[tuple[str, np.ndarray]] = []
        self._active: dict[str, str] = {}  # qid -> tenant (queued or in-flight)
        self._active_by_tenant: collections.Counter = collections.Counter()
        self._next_qid = 0

    # ------------------------------------------------------------- submit

    def pending(self) -> int:
        """Queries queued for the next plan round (instant results count:
        they still need a plan round to be delivered)."""
        return len(self._queue) + len(self._instant)

    def in_flight(self, tenant: str | None = None) -> int:
        """Admitted-but-not-completed queries (queued + dispatched)."""
        if tenant is None:
            return len(self._active)
        return self._active_by_tenant[tenant]

    def submit(
        self,
        sources,
        tenant: str = "default",
        deadline_ms: float | None = None,
        qid: str | None = None,
        now: float | None = None,
        query_kind: str = "reach",
    ) -> AdmissionTicket:
        """Admit (or shed) one query. ``deadline_ms`` is the SLO relative
        to submission; it becomes an absolute clock deadline here. A
        duplicate qid among admitted-but-uncompleted queries is a caller
        bug (two results would race for one key) and raises.

        ``query_kind`` names the scenario family (``core.QUERY_KINDS``);
        kinds whose edge compute has no saturating lane form
        (``lanes_ok=False``) are admitted normally but never join the
        shared MS-BFS lane pack — ``plan()`` always serves them solo."""
        if query_kind not in QUERY_KINDS:
            raise ValueError(
                f"unknown query_kind: {query_kind!r} "
                f"(known: {sorted(QUERY_KINDS)})"
            )
        self.stats.submitted += 1
        if qid is None:
            qid = f"q{self._next_qid}"
            self._next_qid += 1
        if qid in self._active:
            raise ValueError(f"duplicate qid: {qid!r} is already in flight")
        sources = np.asarray(sources, np.int32).reshape(-1)
        if len(sources) == 0:
            # nothing to traverse: complete at admission with the empty
            # (0, n_nodes) levels block a zero-row span would produce
            self.stats.admitted += 1
            self.stats.zero_source += 1
            self._instant.append(
                (qid, np.zeros((0, self.n_nodes), np.int32))
            )
            return AdmissionTicket(qid, admitted=True, done=True)
        if (
            self.max_queue is not None
            and len(self._queue) >= self.max_queue
        ):
            return self._shed_ticket(qid, SHED_QUEUE_FULL)
        if (
            self.tenant_quota is not None
            and self._active_by_tenant[tenant] >= self.tenant_quota
        ):
            return self._shed_ticket(qid, SHED_QUOTA)
        now = self.clock() if now is None else now
        t_deadline = None
        if deadline_ms is not None:
            if deadline_ms <= 0:  # expired before it was even queued
                return self._shed_ticket(qid, SHED_EXPIRED)
            t_deadline = now + deadline_ms / 1e3
        self.stats.admitted += 1
        self._active[qid] = tenant
        self._active_by_tenant[tenant] += 1
        self._queue.append(
            AdmittedQuery(qid, tenant, sources, now, t_deadline, query_kind)
        )
        return AdmissionTicket(qid, admitted=True)

    def _shed_ticket(self, qid: str, reason: str) -> AdmissionTicket:
        self.stats.shed += 1
        self.stats.sheds_by_reason[reason] += 1
        return AdmissionTicket(qid, admitted=False, shed_reason=reason)

    def complete(self, qid: str) -> None:
        """Release one query's quota slot (result delivered or shed after
        admission)."""
        tenant = self._active.pop(qid, None)
        if tenant is not None:
            self._active_by_tenant[tenant] -= 1

    # --------------------------------------------------------------- plan

    def _predicted_ms(self, sources: np.ndarray, lanes: int,
                      rate: float | None) -> float | None:
        if rate is None or self.depth_hint is None:
            return None
        self.stats.estimated += 1
        depth = self.depth_hint(sources, lanes)
        return None if depth is None else depth * rate

    def plan(self, now: float | None = None) -> AdmissionPlan:
        """Drain the queue into dispatch-ready batches.

        Paper Fig 14 rule first: one pooled ``recommend_policy`` decision
        over every queued source. If the pool saturates the 64-wide lanes
        the queries pack into ONE shared MS-BFS batch — then, when a
        member has a deadline, the deadline pass estimates each member
        once, predicts the pack's slowest-lane completion and evicts/sheds
        members that cannot survive it (see module docstring). Otherwise
        every query is its own solo batch, in arrival order. The whole
        plan is the ``admission.plan`` span; a round that packs enters
        one ``admission.predict`` span around the deadline pass's
        estimates (none when no member has a deadline)."""
        with trace.span("admission.plan"):
            return self._plan(now)

    def _plan(self, now: float | None) -> AdmissionPlan:
        now = self.clock() if now is None else now
        instant = dict(self._instant)
        self._instant.clear()
        queue, self._queue = self._queue, []
        shed: list[tuple[str, str]] = []

        def shed_query(q: AdmittedQuery, reason: str) -> None:
            self.stats.shed += 1
            self.stats.sheds_by_reason[reason] += 1
            self.complete(q.qid)
            shed.append((q.qid, reason))

        # drop queries whose deadline has already passed: executing them
        # cannot produce an in-SLO answer, only queueing delay for others.
        # >= — a ticket planned AT its exact deadline instant is expired
        # (the deadline is "done strictly before t"): with an injected
        # clock the boundary is deterministic, matching submit-time's
        # `deadline_ms <= 0` shed instead of racing past it
        live: list[AdmittedQuery] = []
        for q in queue:
            if q.t_deadline is not None and now >= q.t_deadline:
                shed_query(q, SHED_EXPIRED)
            else:
                live.append(q)
        if not live:
            return AdmissionPlan([], instant, shed)

        if self.max_batch_sources is not None and len(live) > 1:
            # bounded batch: serve the arrival-order prefix that fits the
            # cap (always at least one query), requeue the rest — the
            # driver's next pump re-plans them, after new arrivals had a
            # chance to join the queue
            k, pooled = 1, len(live[0].sources)
            while (
                k < len(live)
                and pooled + len(live[k].sources) <= self.max_batch_sources
            ):
                pooled += len(live[k].sources)
                k += 1
            self._queue = live[k:] + self._queue
            live = live[:k]

        # kinds without a lane form are carved out BEFORE the Fig 14
        # pooling decision: a burst of (say) weighted top-k or ppr sources
        # can neither be lane-packed itself nor tip the reach pool's
        # recommend_policy into ntkms on its behalf — they always dispatch
        # as solo batches (the dispatch layer re-checks the same
        # ``lanes_ok`` bit, so a bypassing caller still cannot lane-pack)
        poolable = [q for q in live if QUERY_KINDS[q.query_kind].lanes_ok]
        forced_solo = {
            q.qid for q in live if not QUERY_KINDS[q.query_kind].lanes_ok
        }
        total = sum(len(q.sources) for q in poolable)
        policy = (
            recommend_policy(
                total, self.n_devices, self.avg_degree, n_nodes=self.n_nodes
            )
            if poolable
            else None
        )
        batches: list[PlannedBatch] = []
        solo: list[AdmittedQuery] = []
        if policy == "ntkms":
            packer = LanePacker(self.lanes)
            by_qid = {q.qid: q for q in poolable}
            for q in poolable:
                packer.add(q.qid, q.sources)
            # only a deadline reads the estimates: without one nothing can
            # be evicted or shed, so none is made. With one, every member
            # is estimated once (the pack's time is the max over all of
            # them); nothing changes the estimators within a round
            ests = None
            with trace.span("admission.predict"):
                if any(q.t_deadline is not None for q in poolable):
                    rate = self.ms_per_iter() if self.ms_per_iter else None
                    ests = {
                        q.qid: self._predicted_ms(q.sources, 1, rate)
                        for q in poolable
                    }
                    if any(v is None for v in ests.values()):
                        ests = None  # cold: no estimate, no eviction
            # eviction fixpoint: a packed batch finishes with its SLOWEST
            # lane, so the pack estimate is the max over the members' solo
            # depth estimates; pulling the deepest member out lowers it,
            # so re-check until no member violates its slack
            # (arrival-order scan => determinism)
            while ests is not None and len(packer):
                pack_ms = max(ests[qid] for qid in packer.qids)
                evicted = None
                for qid in packer.qids:
                    q = by_qid[qid]
                    if q.t_deadline is None:
                        continue
                    slack_ms = (q.t_deadline - now) * 1e3
                    if slack_ms < pack_ms:
                        evicted = q
                        break
                if evicted is None:
                    break
                packer.evict(evicted.qid)
                solo_ms = ests[evicted.qid]
                slack_ms = (evicted.t_deadline - now) * 1e3
                if slack_ms < solo_ms:
                    # even alone it cannot make its deadline: shed instead
                    # of burning a solo batch on a guaranteed miss
                    shed_query(evicted, SHED_HOPELESS)
                else:
                    self.stats.evictions += 1
                    solo.append(evicted)
            if len(packer):
                flat, spans = packer.pack()
                batches.append(PlannedBatch(
                    queries=[by_qid[qid] for qid in packer.qids],
                    sources=flat, spans=spans, packed=True, policy="ntkms",
                ))
        else:
            solo = poolable
        # solo batches in arrival order, evictees keeping their original
        # queue position; forced-solo kinds interleave by the same rule
        solo_qids = {q.qid for q in solo} | forced_solo
        for q in live:  # arrival order
            if q.qid not in solo_qids:
                continue
            batches.append(PlannedBatch(
                queries=[q], sources=q.sources,
                spans={q.qid: (0, len(q.sources))}, packed=False,
                policy=None, query_kind=q.query_kind,
            ))
        return AdmissionPlan(batches, instant, shed)
