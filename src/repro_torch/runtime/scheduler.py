"""Synchronous façade over the serving core (port of
``repro.runtime.scheduler``).

``AdaptiveScheduler`` is the dispatch layer (``QueryDispatcher``: engine
cache, two-phase hybrid, learners) plus the synchronous
``submit``/``flush`` admission surface, which runs the admission planner
with no quotas and no deadlines: the legacy pooled batching. For the
always-on overlapped loop with tenant telemetry, drive a dispatcher
through ``runtime.service.ServingLoop``.
"""
from __future__ import annotations

import numpy as np

from .admission import AdmissionQueue
from .dispatch import QueryDispatcher
from .service import unpack_levels


class AdaptiveScheduler(QueryDispatcher):
    """Build-once, serve-many recursive-query runtime over one graph on a
    mesh of ranks (or one device): ``QueryDispatcher`` plus
    ``submit``/``flush``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._admission = AdmissionQueue(
            n_nodes=self.csr.n_nodes,
            n_devices=self.mesh.size,
            avg_degree=self.csr.avg_degree,
        )
        self.admissions = {"ntkms": 0, "per_query": 0}

    def apply_delta(self, delta):
        """Graph mutation through the dispatcher, plus the façade's own
        refresh: its admission queue keyed its pooled-policy decision on
        the ``avg_degree`` of the graph it was built with. A follower
        replays the delta through this method too, so every rank
        refreshes."""
        report = super().apply_delta(delta)
        self._admission.avg_degree = float(self.csr.avg_degree)
        return report

    def submit(self, sources, qid: str | None = None) -> str:
        """Queue one tenant's query for the next ``flush``."""
        return self._admission.submit(sources, qid=qid).qid

    def flush(self) -> dict[str, np.ndarray]:
        """Run all queued queries; returns {qid: levels [k, n_nodes] int32}
        (-1 = unreached), one row per submitted source. Sources pool into
        shared 64-lane morsels only when the pooled batch saturates the
        lanes (paper Fig 14)."""
        if not self._admission.pending():
            return {}
        plan = self._admission.plan()
        out: dict[str, np.ndarray] = dict(plan.instant)
        packed = any(pb.packed for pb in plan.batches)
        if plan.batches:
            self.admissions["ntkms" if packed else "per_query"] += 1
        for pb in plan.batches:
            outcome = self.query(pb.sources, policy=pb.policy)
            out.update(unpack_levels(
                outcome.result.state.levels.cpu().numpy(), pb.spans,
                self.csr.n_nodes, pb.packed,
            ))
            for q in pb.queries:
                self._admission.complete(q.qid)
        for qid in plan.instant:
            self._admission.complete(qid)
        return out
