"""The port's open-loop ``ServingLoop`` and serving driver against the JAX
package's.

- A seeded multi-tenant stream (quota sheds, deadlines met and missed)
  replayed with a manual clock through JAX's ``ServingLoop`` and the
  port's, with ``overlap`` on and off: per-query results bitwise equal,
  and equal batches, cold batches, finalizes, overlapped finalizes, shed,
  deadline misses, learned budgets and refitted thresholds.
- ``run_stream`` with a delta entry: queries before it see the old graph,
  queries after it the new one (``tests/oracle.py``); the loop's fence
  drains the queue first and refreshes the admission degree.
- A submission from ``on_result`` during ``drain`` (flush during drain)
  and quota shedding, against JAX's loop.
- ``serve.main(["--device", "cpu", ...])`` on the open loop with
  ``--mutate-stream``: the same arrival schedule as JAX's driver (deltas
  included) and every query's levels equal to JAX's ``ServingLoop`` on
  that schedule. Batch counts are not compared: batch formation follows
  the wall clock.
"""
import functools

import numpy as np
import pytest

from oracle import bfs_levels

import repro.graph.delta as jdelta
import repro.launch.serve as jserve
from repro.graph.csr import csr_from_edges
from repro.graph.generators import PAPER_DATASET_FAMILIES, PAPER_DATASETS
from repro.graph.generators import powerlaw
from repro.launch.mesh import make_mesh
from repro.runtime.service import ServingLoop as JLoop

import repro_torch.graph.delta as tdelta
from repro_torch.launch import serve
from repro_torch.runtime.service import ServingLoop as TLoop

from test_torch_delta import port_delta
from test_torch_graph import to_port


@functools.lru_cache(maxsize=None)
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


@functools.lru_cache(maxsize=None)
def serve_graph():
    """A power-law main component plus one 40-node path whose head is a
    deep, low-degree source."""
    main = powerlaw(160, 5.0, seed=0)
    s, t = main.edge_list()
    p = np.arange(39, dtype=np.int64) + 160
    csr = csr_from_edges(200, np.concatenate([s, p, p + 1]),
                         np.concatenate([t, p + 1, p]))
    return csr, 160


class ManualClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt_s: float) -> None:
        self.t += dt_s


def loops(overlap, **kw):
    csr, _ = serve_graph()
    kw = dict(backend="dopt", family="powerlaw", max_iters=64, **kw)
    jc, tc = ManualClock(), ManualClock()
    return (JLoop(mesh11(), csr, overlap=overlap, clock=jc, **kw), jc,
            TLoop("cpu", to_port(csr), overlap=overlap, clock=tc, **kw), tc)


def stream(head):
    """Rounds of (qid, tenant, sources, deadline_ms, ms to advance after
    the submission): shallow queries, the path head, a pooled >= 64-source
    round, and deadlines that the clock then meets or passes."""
    rng = np.random.default_rng(7)
    rounds = []
    for r in range(5):
        round_ = []
        for q in range(3):
            src = rng.integers(0, 160, 70 if r == 3 else 4)
            if (r + q) % 2 == 0:
                src[0] = head
            deadline = (20.0, 80.0, None)[q]
            round_.append((f"r{r}q{q}", f"t{q % 2}", src.astype(np.int32),
                           deadline, 15.0 * q))
        rounds.append(round_)
    return rounds


def run_rounds(loop, clock, rounds):
    tickets = {}
    for round_ in rounds:
        for qid, tenant, src, deadline, adv in round_:
            t = loop.submit(src, tenant=tenant, deadline_ms=deadline, qid=qid)
            tickets[qid] = (t.admitted, t.shed_reason)
            clock.advance(adv / 1e3)
        loop.pump()
        clock.advance(0.030)
    loop.drain()
    return tickets


@pytest.mark.parametrize("overlap", [True, False])
def test_manual_clock_replay_matches_jax(overlap):
    jl, jc, tl, tc = loops(overlap, tenant_quota=2, refit_every=2)
    _, head = serve_graph()
    rounds = stream(head)
    jt, tt = run_rounds(jl, jc, rounds), run_rounds(tl, tc, rounds)
    assert jt == tt
    assert sorted(jl.results) == sorted(tl.results)
    for qid in jl.results:
        np.testing.assert_array_equal(jl.results[qid], tl.results[qid],
                                      err_msg=qid)
    js, ts = jl.stats, tl.stats
    for f in ("batches", "cold_batches", "finalizes", "overlapped_finalizes",
              "shed", "deadline_misses", "completed"):
        assert getattr(js, f) == getattr(ts, f), f
    assert ts.batches > 5 and ts.shed > 0
    # the manual clock stands still inside pump(): only a tail delivered
    # by a later pump (the overlapped pipeline) can miss its deadline
    assert (ts.overlapped_finalizes > 0) == overlap
    assert (ts.deadline_misses > 0) == overlap
    assert ts.overlap_occupancy == js.overlap_occupancy
    for name in js.tenants:
        a, b = js.tenants[name], ts.tenants[name]
        assert (a.submitted, a.completed, a.shed, a.deadline_misses) == (
            b.submitted, b.completed, b.shed, b.deadline_misses), name
        assert a.latencies_ms == b.latencies_ms
        assert a.warm_latencies_ms == b.warm_latencies_ms
    jd, td = jl.dispatcher, tl.dispatcher
    assert jd.budget_model.budgets(64) == td.budget_model.budgets(64)
    assert jd.stats.refits == td.stats.refits > 0
    assert dict(jd.direction_thresholds.table) == dict(
        td.direction_thresholds.table)
    assert jl.admission.stats.sheds_by_reason == (
        tl.admission.stats.sheds_by_reason)


def test_run_stream_applies_delta_entries_in_order():
    csr, _ = serve_graph()
    pc = to_port(csr)
    delta = tdelta.random_delta(pc, 20, 20, seed=8)
    csr2 = tdelta.apply_delta_csr(pc, delta)
    rng = np.random.default_rng(4)
    a, b, c = (rng.integers(0, 160, 4).astype(np.int32) for _ in range(3))
    loop = TLoop("cpu", pc, backend="dopt", family="powerlaw", max_iters=64)
    out = loop.run_stream([
        {"t_ms": 0.0, "sources": a, "qid": "a"},
        {"t_ms": 1.0, "sources": c, "qid": "c", "tenant": "x"},
        {"t_ms": 5.0, "delta": delta},
        {"t_ms": 9.0, "sources": b, "qid": "b"},
    ])
    for qid, src, g in (("a", a, pc), ("c", c, pc), ("b", b, csr2)):
        np.testing.assert_array_equal(
            out[qid], np.stack([bfs_levels(g, int(x)) for x in src]),
            err_msg=qid)
    assert loop.stats.deltas_applied == 1 and loop.graph_version == 1
    assert loop.delta_reports[0].version == 1
    assert loop.stats.tenant("x").completed == 1
    assert loop.admission.avg_degree == pytest.approx(csr2.avg_degree)


def test_apply_delta_fence_serves_admitted_queries_first():
    csr, _ = serve_graph()
    pc = to_port(csr)
    delta = tdelta.random_delta(pc, 15, 15, seed=9)
    csr2 = tdelta.apply_delta_csr(pc, delta)
    loop = TLoop("cpu", pc, backend="dopt", family="powerlaw", max_iters=64)
    rng = np.random.default_rng(3)
    pre = rng.integers(0, 160, 4).astype(np.int32)
    post = rng.integers(0, 160, 4).astype(np.int32)
    loop.submit(pre, qid="pre")
    rep = loop.apply_delta(delta)
    assert loop.admission.pending() == 0 and loop.delta_reports == [rep]
    loop.submit(post, qid="post")
    res = loop.drain()
    np.testing.assert_array_equal(
        res["pre"], np.stack([bfs_levels(pc, int(x)) for x in pre]))
    np.testing.assert_array_equal(
        res["post"], np.stack([bfs_levels(csr2, int(x)) for x in post]))


def test_flush_during_drain_and_quota_shedding_match_jax():
    csr, _ = serve_graph()
    s0 = np.arange(4, dtype=np.int32)
    s1 = np.arange(50, 54, dtype=np.int32)
    outs = []
    for make in (lambda **kw: JLoop(mesh11(), csr, **kw),
                 lambda **kw: TLoop("cpu", to_port(csr), **kw)):
        fired = []

        def on_result(qid, lv):
            if not fired:  # submit from inside result delivery
                fired.append(qid)
                loop.submit(s1, qid="followup")

        loop = make(backend="dopt", family="powerlaw", max_iters=64,
                    tenant_quota=1, on_result=on_result)
        t0 = loop.submit(s0, tenant="busy", qid="first")
        t1 = loop.submit(s1 + 1, tenant="busy", qid="over")
        assert t0.admitted and not t1.admitted
        res = loop.drain()
        assert fired == ["first"] and set(res) == {"first", "followup"}
        assert loop.stats.tenant("busy").shed == 1
        outs.append(res)
    for qid in outs[0]:
        np.testing.assert_array_equal(outs[0][qid], outs[1][qid])


def test_unported_query_kind_refused_at_submit():
    """A kind no package serves is refused at submit, as JAX refuses it,
    before any tenant is charged; every kind JAX serves is admitted."""
    csr, _ = serve_graph()
    loop = TLoop("cpu", to_port(csr), backend="dopt", max_iters=64)
    jl = JLoop(mesh11(), csr, backend="dopt", max_iters=64)
    for lp in (loop, jl):
        with pytest.raises(ValueError, match="unknown query_kind"):
            lp.submit(np.arange(3, dtype=np.int32), query_kind="nope")
    assert loop.stats.tenants == {}
    t = loop.submit(np.arange(3, dtype=np.int32), query_kind="ppr")
    assert t.admitted and loop.stats.tenant("default").submitted == 1


def assert_same_schedule(jarr, tarr):
    assert len(jarr) == len(tarr)
    for a, b in zip(jarr, tarr):
        assert a["t_ms"] == b["t_ms"] and ("delta" in a) == ("delta" in b)
        if "delta" in a:
            for f in ("add_src", "add_dst", "del_src", "del_dst"):
                np.testing.assert_array_equal(getattr(a["delta"], f),
                                              getattr(b["delta"], f))
        else:
            np.testing.assert_array_equal(a["sources"], b["sources"])
            assert a["tenant"] == b["tenant"]


@pytest.mark.parametrize("extra", [
    [],  # the open loop, the default path
    ["--mutate-stream", "2", "--no-overlap", "--tenants", "3"],
])
def test_open_loop_serve_matches_jax(extra, capsys):
    argv = ["--device", "cpu", "--dataset", "ldbc", "--scale", "0.1",
            "--arrivals", "10", "--rate", "200", *extra]
    got = []
    assert serve.main(argv, on_stream=got.append) == 0
    out = capsys.readouterr().out
    assert "open loop: 10 Poisson arrivals" in out and "warm p50" in out
    (rec,) = got
    loop = rec.loop
    assert loop.stats.completed == 10 and len(loop.results) == 10
    n_deltas = int(extra[1]) if extra else 0
    assert loop.stats.deltas_applied == n_deltas
    if n_deltas:
        assert "graph deltas: 2 applied" in out
    # JAX's driver builds the same schedule; its loop serves every query
    # on the graph version it was admitted under, as the port's does
    csr = PAPER_DATASETS["ldbc"](0.1)
    jarr = jserve.poisson_arrivals(csr, 200.0, 10, 8, tenants=(
        3 if extra else 2), seed=1)
    if n_deltas:
        span, cur = jarr[-1]["t_ms"], csr
        for i in range(n_deltas):
            d = jdelta.random_delta(cur, 64, 64, seed=500 + i)
            cur = jdelta.apply_delta_csr(cur, d)
            jarr.append({"t_ms": span * (i + 1) / (n_deltas + 1),
                         "delta": d})
        jarr.sort(key=lambda a: a["t_ms"])
    assert_same_schedule(jarr, rec.arrivals)
    jl = JLoop(mesh11(), csr, family=PAPER_DATASET_FAMILIES["ldbc"])
    jres = jl.run_stream(jarr)
    assert sorted(jres) == sorted(loop.results)
    for qid in jres:
        np.testing.assert_array_equal(jres[qid], loop.results[qid],
                                      err_msg=qid)
    if n_deltas:
        assert loop.dispatcher.csr.n_edges == jl.dispatcher.csr.n_edges
