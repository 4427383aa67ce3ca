"""The port's ``AdmissionQueue.plan`` against the JAX package's, and how
often the port's deadline pass estimates.

Both queues get the same queries, the same manual clock, the same
``ms_per_iter`` and each a counting wrapper of one ``depth_hint``. Every
case's plan (batches, sources, spans, ``packed``/``policy``, instant
results, sheds with their reasons in order) and admission stats equal
JAX's. The port estimates each packed member at most once a round, and
none when no member has a deadline:

- ``no_deadline``: 64 one-source queries pack, the port calls
  ``depth_hint`` never (``AdmissionStats.estimated == 0``), and one
  ``admission.predict`` span lies inside the ``admission.plan`` span.
- ``evict_and_shed``: tight deadlines force several fixpoint passes with
  evictions and ``hopeless`` sheds (and one ``expired`` shed before the
  pack): one call a member on the port, more on JAX's.
- ``cold``: deadlines but a ``depth_hint`` that returns None: nothing is
  evicted; the port still estimates each member once.
- ``one_deadline``: one deadline among 63 queries without, evicted.
- ``solo``: too few sources to pack, with deadlines: solo batches and no
  estimate, no ``admission.predict`` span.
"""
import threading
import time

import numpy as np
import pytest

from repro.runtime.admission import AdmissionQueue as JQueue

from repro_torch import trace
from repro_torch.runtime.admission import SHED_EXPIRED, SHED_HOPELESS
from repro_torch.runtime.admission import AdmissionQueue as TQueue

T0 = 100.0  # the manual clock's reading at every submit and plan
N_NODES = 1000
MS_PER_ITER = 1.0


class CountingHint:
    """``depth_hint`` from a table of per-source depths (None: cold),
    recording the sources of every call."""

    def __init__(self, depths):
        self.depths = depths
        self.calls = []

    def __call__(self, sources, lanes):
        assert lanes == 1
        self.calls.append(tuple(int(s) for s in sources))
        if self.depths is None:
            return None
        return max(self.depths.get(int(s), 4) for s in sources)


# each case: (queries as (qid, sources, deadline_ms or None, submit
# time), per-source depths or None for a cold estimator)
def _no_deadline():
    return [(f"q{i}", [i], None, T0) for i in range(64)], {}


def _evict_and_shed():
    qs = [("expired", [900], 1.0, T0 - 0.002)]  # deadline T0 - 1 ms
    # deepest member with a deadline a solo batch cannot make: evicted
    # and shed first, which lowers the pack's time from 64 to 32 ms
    qs.append(("deep_doomed", [1], 50.0, T0))
    qs.append(("medium", [2], 40.0, T0))  # survives the lowered pack
    qs.append(("deep", [3], None, T0))  # 32 ms, no deadline: stays
    qs.append(("tight1", [4], 20.0, T0))  # evicted, served solo
    qs.append(("tight2", [5], 10.0, T0))  # evicted, served solo
    qs.append(("doomed", [6], 3.0, T0))  # solo 8 ms > 3: shed hopeless
    qs.append(("loose", [7], 100.0, T0))
    qs += [(f"f{i}", [10 + i], None, T0) for i in range(58)]
    return qs, {1: 64, 3: 32, 6: 8}


def _cold():
    qs = [(f"q{i}", [i], 5.0 if i % 3 == 0 else None, T0)
          for i in range(64)]
    return qs, None


def _one_deadline():
    qs = [(f"q{i}", [i], None, T0) for i in range(64)]
    qs[17] = ("q17", [17], 10.0, T0)
    return qs, {40: 16}  # the pack's 16 ms > 10 ms: evicted, solo 4 ms


def _solo():
    qs = [(f"q{i}", [2 * i, 2 * i + 1], 5.0 if i % 2 else None, T0)
          for i in range(20)]
    return qs, {3: 64}


CASES = {
    "no_deadline": _no_deadline,
    "evict_and_shed": _evict_and_shed,
    "cold": _cold,
    "one_deadline": _one_deadline,
    "solo": _solo,
}


def _queue(cls, hint):
    return cls(N_NODES, 1, 4.0, lanes=64, depth_hint=hint,
               ms_per_iter=lambda: MS_PER_ITER, clock=lambda: T0)


def _plan_key(plan):
    return (
        [(tuple(q.qid for q in b.queries), b.sources.tolist(),
          sorted(b.spans.items()), b.packed, b.policy, b.query_kind)
         for b in plan.batches],
        sorted((k, v.shape) for k, v in plan.instant.items()),
        list(plan.shed),
    )


def _stats_key(stats):
    return (stats.submitted, stats.admitted, stats.shed, stats.evictions,
            stats.zero_source, dict(stats.sheds_by_reason))


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.disable()
    yield
    trace.disable()


@pytest.mark.parametrize("case", list(CASES))
def test_plan_matches_jax_and_estimates_once(case):
    queries, depths = CASES[case]()
    jhint, thint = CountingHint(depths), CountingHint(depths)
    jq, tq = _queue(JQueue, jhint), _queue(TQueue, thint)
    for q in (jq, tq):
        for qid, sources, deadline_ms, t_submit in queries:
            q.submit(np.asarray(sources, np.int32), qid=qid,
                     deadline_ms=deadline_ms, now=t_submit)
    jplan = jq.plan()
    trace.enable()
    t_start = time.perf_counter()
    tplan = tq.plan()
    trace.disable()
    assert _plan_key(tplan) == _plan_key(jplan)
    assert _stats_key(tq.stats) == _stats_key(jq.stats)
    assert tq.pending() == jq.pending() == 0

    packed = [b for b in tplan.batches if b.packed]
    has_deadline = any(d is not None for _, _, d, _ in queries)
    if case == "solo":
        assert not packed
    else:
        assert len(packed) == 1
    # the port: each live member of the pack once, only under a deadline
    members = [tuple(s) for _, s, d, t in queries
               if d is None or (T0 - t) * 1e3 < d]
    if packed and has_deadline:
        assert sorted(thint.calls) == sorted(members)
    else:
        assert thint.calls == []
    assert tq.stats.estimated == len(thint.calls)

    if case == "evict_and_shed":
        assert tq.stats.evictions == 2
        assert tplan.shed == [
            ("expired", SHED_EXPIRED), ("deep_doomed", SHED_HOPELESS),
            ("doomed", SHED_HOPELESS)]
        assert len(jhint.calls) > 2 * len(members)  # JAX: a pass an evictee
    if case == "one_deadline":
        assert tq.stats.evictions == 1
        assert [b.queries[0].qid for b in tplan.batches[1:]] == ["q17"]
    if case == "cold":
        assert tq.stats.evictions == 0 and not tplan.shed
    if case == "no_deadline":
        assert len(jhint.calls) == 64  # JAX estimates nothing reads

    me = threading.current_thread().name
    by = {}
    for r in trace.records(t_start):
        if r.thread == me:
            by.setdefault(r.name, []).append(r)
    (outer,) = by["admission.plan"]
    predicts = by.get("admission.predict", [])
    assert len(predicts) == (1 if packed else 0)
    assert all(outer.t0 <= p.t0 and p.t1 <= outer.t1 for p in predicts)
