"""Service layer of the serving core: the always-on loop (port of
``repro.runtime.service``).

The admission layer (``runtime/admission.py``) decides who runs in which
morsel pack, the dispatch layer (``runtime/dispatch.py``) executes one
batch, and ``ServingLoop`` keeps batches flowing: an open-loop arrival
stream is admitted, packed, dispatched and accounted per tenant, and graph
deltas are applied mid-stream behind a version fence.

**The pipeline.** One batch is three steps of the dispatcher's
split-phase API: ``begin_batch`` (plan + phase 1), ``settle_batch``
(survivors, phase 2, learning) and ``finalize_batch`` (the deferred state
stitch). The loop runs them double-buffered, at most one settled but
unfinalized batch riding behind the one in flight::

    begin(i)            # batch i's phase 1
    finalize(i-1)       # batch i-1's stitch
    settle(i)           # batch i's phase 2 and learning

Learning order is untouched (``settle(i)`` precedes ``begin(i+1)``), so
results, budgets and thresholds are those of the synchronous façade on the
same admission order; ``overlap=False`` runs the same steps strictly in
series. ``begin_batch`` returns with batch i's phase 1 in flight on the
dispatcher's phase-1 worker (its own thread and, on a card, its own
stream), so ``finalize(i-1)`` runs on this thread while phase 1 runs, and
``settle(i)`` joins it.

**Telemetry.** Per-tenant submitted / completed / shed / deadline-miss
counters and latencies, split warm/cold: a batch that raised the engine
cache's ``compile_events`` (a new engine or a new morsel count) is cold,
and its queries are left out of the warm percentiles.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from .. import trace
from ..core import QUERY_KINDS
from .admission import AdmissionQueue, AdmissionTicket, PlannedBatch
from .dispatch import QueryDispatcher, SettledBatch, _host


def unpack_levels(
    levels: np.ndarray,
    spans: dict[str, tuple[int, int]],
    n_nodes: int,
    packed: bool,
) -> dict[str, np.ndarray]:
    """Per-query result rows out of one batch's levels.

    Packed (nTkMS) batches carry levels as [morsels, n_pad, lanes] uint8
    with 255 = unreached: lane-major flatten to one row per source, map the
    sentinel to -1, slice each query's span. Solo batches carry [rows,
    n_pad] with one row per source already. Both slice off the graph's
    padding columns."""
    n = n_nodes
    levels = np.asarray(levels)
    if packed:
        per_src = (
            levels[:, :n, :].transpose(0, 2, 1).reshape(-1, n)
        ).astype(np.int32)
        per_src[per_src == 255] = -1
        return {qid: per_src[a:b] for qid, (a, b) in spans.items()}
    return {
        qid: levels[a:b, :n].astype(np.int32)
        for qid, (a, b) in spans.items()
    }


def _pctl(values: list[float], p: float) -> float:
    return float(np.percentile(np.asarray(values), p)) if values else float("nan")


@dataclasses.dataclass
class TenantStats:
    """One tenant's serving record. ``latencies_ms`` holds every completed
    query (submit to delivery); ``warm_latencies_ms`` leaves out queries
    served by a cold batch, and the percentiles read it."""

    submitted: int = 0
    completed: int = 0
    shed: int = 0
    deadline_misses: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    warm_latencies_ms: list = dataclasses.field(default_factory=list)

    def p50(self, warm: bool = True) -> float:
        return _pctl(self.warm_latencies_ms if warm else self.latencies_ms, 50)

    def p99(self, warm: bool = True) -> float:
        return _pctl(self.warm_latencies_ms if warm else self.latencies_ms, 99)


@dataclasses.dataclass
class ServingStats:
    """Loop-level counters. A finalize is one batch's deferred state
    stitch; it is overlapped when it ran after a later batch began, that
    is while the later batch's phase 1 was in flight.
    ``cold_ms`` sums the wall of cold batches, reported apart from the warm
    percentiles."""

    batches: int = 0
    cold_batches: int = 0
    finalizes: int = 0
    overlapped_finalizes: int = 0
    cold_ms: float = 0.0
    deltas_applied: int = 0  # graph mutations served mid-stream
    tenants: dict = dataclasses.field(default_factory=dict)

    @property
    def overlap_occupancy(self) -> float:
        """Fraction of finalizes run after a later batch began, behind
        its phase 1 (0.0 in serial mode and on one-batch streams)."""
        return (
            self.overlapped_finalizes / self.finalizes
            if self.finalizes
            else 0.0
        )

    def tenant(self, name: str) -> TenantStats:
        return self.tenants.setdefault(name, TenantStats())

    def _all(self, warm: bool) -> list:
        out: list = []
        for ts in self.tenants.values():
            out.extend(ts.warm_latencies_ms if warm else ts.latencies_ms)
        return out

    def p50(self, warm: bool = True) -> float:
        return _pctl(self._all(warm), 50)

    def p99(self, warm: bool = True) -> float:
        return _pctl(self._all(warm), 99)

    @property
    def completed(self) -> int:
        return sum(ts.completed for ts in self.tenants.values())

    @property
    def shed(self) -> int:
        return sum(ts.shed for ts in self.tenants.values())

    @property
    def deadline_misses(self) -> int:
        return sum(ts.deadline_misses for ts in self.tenants.values())


class ServingLoop:
    """Always-on serving loop over one graph on a mesh of ranks (or one
    device; on a mesh it runs on rank 0, over a ``leading`` dispatcher):
    open-loop admission in, per-tenant results and telemetry out.

    ``overlap=True`` (default) runs the double-buffered pipeline of the
    module docstring; ``overlap=False`` runs each batch's three steps back
    to back. ``max_batch_sources`` (forwarded to the admission queue)
    bounds one batch's pooled sources, so a backlog drains as a sequence
    of capped batches. ``clock`` is injectable (shared with the admission
    queue) so replays drive deadlines with a manual clock; ``on_result``
    fires once per delivered query, and a submission from inside it joins
    the next plan round."""

    def __init__(
        self,
        device=None,
        csr=None,
        *,
        dispatcher: QueryDispatcher | None = None,
        overlap: bool = True,
        tenant_quota: int | None = None,
        max_queue: int | None = None,
        max_batch_sources: int | None = None,
        clock: Callable[[], float] = time.perf_counter,
        on_result: Callable[[str, np.ndarray], None] | None = None,
        **dispatcher_kw,
    ):
        if dispatcher is None:
            # serving default: pow2-pad morsel counts, so variable pool
            # sizes hit a bounded set of morsel shapes
            dispatcher_kw.setdefault("pad_pow2_morsels", True)
            dispatcher = QueryDispatcher(device, csr, **dispatcher_kw)
        self.dispatcher = dispatcher
        self.overlap = overlap
        self.clock = clock
        self.on_result = on_result
        self.admission = AdmissionQueue(
            n_nodes=dispatcher.csr.n_nodes,
            n_devices=dispatcher.mesh.size,
            avg_degree=dispatcher.csr.avg_degree,
            tenant_quota=tenant_quota,
            max_queue=max_queue,
            max_batch_sources=max_batch_sources,
            depth_hint=dispatcher.depth_hint,
            ms_per_iter=lambda: self._ms_per_iter,
            clock=clock,
        )
        self.stats = ServingStats()
        self.results: dict[str, np.ndarray] = {}
        # (settled batch, its plan entry, begin time, cold?): the one
        # settled but unfinalized batch the pipeline carries
        self._tail: tuple[SettledBatch, PlannedBatch, float, bool] | None = None
        # measured serving rate for the admission layer's deadline math:
        # EWMA of warm-batch wall per slowest-lane iteration
        self._ms_per_iter: float | None = None
        # submit-time record per in-flight qid: (tenant, t_submit, t_deadline)
        self._meta: dict[str, tuple[str, float, float | None]] = {}
        # DeltaReports of every apply_delta served by this loop, in order
        self.delta_reports: list = []

    @property
    def graph_version(self) -> int:
        """The dispatcher's current ``operands_version`` (0 = unmutated)."""
        return self.dispatcher.operands_version

    # ------------------------------------------------------------- intake

    def submit(
        self,
        sources,
        tenant: str = "default",
        deadline_ms: float | None = None,
        qid: str | None = None,
        query_kind: str = "reach",
    ) -> AdmissionTicket:
        """Admit one query into the stream (see ``AdmissionQueue.submit``).
        Shed submissions are counted against the tenant and never run.

        ``query_kind`` selects the scenario family (``core.QUERY_KINDS``;
        an unknown one raises ``ValueError``): "reach" delivers per-source
        level rows; the other kinds deliver their own result leaves, a
        ``[rows, n(, k)]`` array for "topk_paths" dists and "ppr" mass, a
        dict of such arrays for "pattern_counts"."""
        now = self.clock()
        ticket = self.admission.submit(
            sources, tenant=tenant, deadline_ms=deadline_ms, qid=qid,
            now=now, query_kind=query_kind,
        )
        ts = self.stats.tenant(tenant)
        ts.submitted += 1
        if not ticket.admitted:
            ts.shed += 1
        else:
            t_deadline = (
                now + deadline_ms / 1e3 if deadline_ms is not None else None
            )
            self._meta[ticket.qid] = (tenant, now, t_deadline)
        return ticket

    # ------------------------------------------------------------ pipeline

    def pump(self) -> int:
        """One plan round: drain the admission queue into batches and push
        them through the pipeline. Returns the number of batches
        dispatched. The last settled batch stays unfinalized so the next
        pump's first batch can overlap it; ``drain()`` flushes it."""
        plan = self.admission.plan(now=self.clock())
        for qid, levels in plan.instant.items():
            self._deliver(qid, levels, cold=False)
        for qid, reason in plan.shed:
            meta = self._meta.pop(qid, None)
            if meta is not None:
                self.stats.tenant(meta[0]).shed += 1
        for pb in plan.batches:
            self._dispatch(pb)
        return len(plan.batches)

    def _dispatch(self, pb: PlannedBatch) -> None:
        t0 = self.clock()
        compiles0 = self.dispatcher.cache.compile_events
        inflight = self.dispatcher.begin_batch(
            pb.sources, policy=pb.policy, query_kind=pb.query_kind,
        )
        if self._tail is not None and self.overlap:
            # batch i's phase 1 is in flight on the dispatcher's worker:
            # stitch batch i-1 meanwhile
            self._finalize_tail(overlapped=True)
        settled = self.dispatcher.settle_batch(inflight)
        # compile_events (builds + first-seen morsel shapes), not misses
        cold = self.dispatcher.cache.compile_events > compiles0
        self.stats.batches += 1
        if cold:
            self.stats.cold_batches += 1
        self._tail = (settled, pb, t0, cold)
        if not self.overlap:
            self._finalize_tail(overlapped=False)

    def _finalize_tail(self, overlapped: bool) -> None:
        """The ``service.finalize`` span, from the stitch to the last
        delivery; the copy to the host and the unpack are the
        ``service.unpack`` span inside it."""
        settled, pb, t0, cold = self._tail
        self._tail = None
        with trace.span("service.finalize"):
            outcome = settled.finalize()
            t1 = self.clock()
            self.stats.finalizes += 1
            if overlapped:
                self.stats.overlapped_finalizes += 1
            wall_ms = (t1 - t0) * 1e3
            iters = _host(outcome.result.iterations)
            depth = float(iters.max()) if iters.size else 0.0
            if cold:
                self.stats.cold_ms += wall_ms
            elif depth > 0:
                rate = wall_ms / depth
                self._ms_per_iter = (
                    rate
                    if self._ms_per_iter is None
                    else 0.5 * self._ms_per_iter + 0.5 * rate
                )
            with trace.span("service.unpack"):
                out = self._unpack(outcome.result.state, pb)
            for q in pb.queries:
                self._deliver(q.qid, out[q.qid], cold)

    def _unpack(self, state, pb: PlannedBatch) -> dict:
        """Each query's result, copied to the host and sliced."""
        n = self.dispatcher.csr.n_nodes
        if pb.query_kind == "reach":
            return unpack_levels(_host(state.levels), pb.spans, n, pb.packed)
        # non-reach kinds are never lane-packed, so each result leaf holds
        # one row per source: slice the spans and the padding
        assert not pb.packed, pb.query_kind
        leaves = QUERY_KINDS[pb.query_kind].result_leaves
        arrs = {leaf: _host(getattr(state, leaf)) for leaf in leaves}
        return {
            qid: (
                arrs[leaves[0]][a:b, :n]
                if len(leaves) == 1
                else {leaf: arrs[leaf][a:b, :n] for leaf in leaves}
            )
            for qid, (a, b) in pb.spans.items()
        }

    def _deliver(self, qid: str, levels: np.ndarray, cold: bool) -> None:
        t_done = self.clock()
        tenant, t_sub, t_deadline = self._meta.pop(
            qid, ("default", t_done, None)
        )
        ts = self.stats.tenant(tenant)
        ts.completed += 1
        lat_ms = (t_done - t_sub) * 1e3
        ts.latencies_ms.append(lat_ms)
        if not cold:
            ts.warm_latencies_ms.append(lat_ms)
        if t_deadline is not None and t_done > t_deadline:
            ts.deadline_misses += 1
        self.results[qid] = levels
        self.admission.complete(qid)
        if self.on_result is not None:
            self.on_result(qid, levels)

    # ------------------------------------------------------------ mutation

    def apply_delta(self, delta):
        """Mutate the served graph mid-stream behind a fence: every query
        admitted before this call is planned, dispatched and settled on
        the old graph (the queue drains through the pipeline first), and
        every query admitted after sees the new one. The settled but
        unfinalized tail may ride through the delta: its device work is
        done, and its payload keeps the old tensors alive until the
        stitch. Returns the dispatcher's ``DeltaReport``. On a mesh the
        fence drains here, on rank 0, and the leading dispatcher sends the
        delta to the followers behind the batches drained, so every rank
        folds it at the same point of the stream."""
        while self.admission.pending():
            self.pump()
        report = self.dispatcher.apply_delta(delta)
        # the admission planner's pooled-policy and deadline math key on
        # avg_degree: refresh it against the mutated graph
        self.admission.avg_degree = float(self.dispatcher.csr.avg_degree)
        self.stats.deltas_applied += 1
        self.delta_reports.append(report)
        return report

    # ------------------------------------------------------------- driving

    def drain(self) -> dict[str, np.ndarray]:
        """Serve until the queue is empty and the tail is finalized.
        Queries submitted from ``on_result`` mid-drain are served before
        drain returns."""
        while self.admission.pending() or self._tail is not None:
            if self.admission.pending():
                self.pump()
            elif self._tail is not None:
                self._finalize_tail(overlapped=False)
        return self.results

    def run_stream(self, arrivals: list[dict]) -> dict[str, np.ndarray]:
        """Serve an open-loop arrival schedule: each entry has ``t_ms``
        (offset from the stream's start) and either ``sources`` (a query,
        with optional ``tenant`` / ``deadline_ms`` / ``qid`` /
        ``query_kind``) or ``delta`` (a ``GraphDelta`` applied at its time
        through ``apply_delta``'s fence). Arrivals are admitted when their
        time comes whether or not the loop keeps up, and the stream is
        drained at the end."""
        order = sorted(range(len(arrivals)), key=lambda i: arrivals[i]["t_ms"])
        t0 = self.clock()
        i = 0
        while i < len(order):
            now_ms = (self.clock() - t0) * 1e3
            while i < len(order) and arrivals[order[i]]["t_ms"] <= now_ms:
                a = arrivals[order[i]]
                i += 1
                if "delta" in a:
                    self.apply_delta(a["delta"])
                    continue
                self.submit(
                    a["sources"], tenant=a.get("tenant", "default"),
                    deadline_ms=a.get("deadline_ms"), qid=a.get("qid"),
                    query_kind=a.get("query_kind", "reach"),
                )
            if self.admission.pending():
                self.pump()
            elif self._tail is not None:
                self._finalize_tail(overlapped=False)
            elif i < len(order):
                wait = arrivals[order[i]]["t_ms"] / 1e3 - (self.clock() - t0)
                if wait > 0:
                    time.sleep(min(wait, 0.005))
        self.drain()
        return self.results
