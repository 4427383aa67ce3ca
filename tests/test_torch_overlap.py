"""The port's phase-1 worker: ``begin_batch`` returns with phase 1 in
flight, as the JAX package's asynchronous dispatch does.

- With ``core.dispatcher._run_morsel`` held on an event in the worker's
  thread, ``begin_batch`` returns while phase 1 is unfinished and
  ``settle_batch`` completes only after the release: the static engine,
  the hybrid with a serial and with a gang resume, a chunked batch (its
  chunk loop runs at settle time, each chunk's phase 1 on the worker) and
  a ``ppr`` batch; each result against JAX's ``query``.
- In ``ServingLoop(overlap=True)`` every overlapped ``finalize(i-1)``
  starts while batch i's phase 1 is unfinished (phase 1 waits for the
  finalize to start, so the order is forced, not raced); per-query
  results equal ``overlap=False`` and JAX's loop on the same manual
  clock, and so do the loop's counters.
- An error raised in phase 1 surfaces from ``settle_batch`` or from the
  join in ``apply_delta``, with the worker's frames in its traceback;
  phase 1 ran once, on the worker, and the dispatcher serves on.
- More dispatchers than cores run the pipelined loop at once under a
  10 us thread switch interval, each equal to the serial run.
- ``test_torch_ranks.pipelined_run`` (the loop's order over the
  split-phase API, a delta applied between a batch's begin and settle)
  on one rank and on two gloo ranks, leader and follower: the batch in
  flight finishes on the old graph and later batches run on the new one
  (``tests/oracle.py``), overlapped equals serial and JAX's, and every
  rank's ``Wire`` equals its serial run's.

Every wait carries its own timeout: a hang fails the test.
"""
import functools
import os
import sys
import threading
import traceback

import numpy as np
import pytest

from oracle import bfs_levels

import repro.graph.delta as jdelta
from repro.graph.generators import powerlaw
from repro.launch.mesh import make_mesh
from repro.runtime.dispatch import QueryDispatcher as JDispatcher

import repro_torch.core.dispatcher as tdispatcher
import repro_torch.graph.delta as tdelta
from repro_torch.launch.mesh import run_ranks
from repro_torch.runtime.dispatch import QueryDispatcher as TDispatcher

import test_torch_ranks as TR
from test_torch_delta import port_delta
from test_torch_graph import np_of, to_port
from test_torch_service import loops, run_rounds, serve_graph, stream

WAIT_S = 60.0  # any single wait; a hang fails after it
# about 3.5 x the 2-rank group's 3.4 s alone, a cold forkserver included
# (0.9 s warm)
OVERLAP_RANKS_TIMEOUT_S = 12


@functools.lru_cache(maxsize=None)
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


@functools.lru_cache(maxsize=None)
def graph():
    return powerlaw(160, 5.0, seed=0)


SOURCES = np.array([3, 17, 44, 90], np.int32)

# dispatcher options, query options, the InflightBatch kind
CASES = {
    "static": (dict(adaptive=False, backend="dopt"), {}, "static"),
    "hybrid_serial": (dict(phase1_iters=1, gang_resume=False,
                           backend="dopt"), {}, "hybrid"),
    "hybrid_gang": (dict(phase1_iters=1, backend="dopt"), {}, "hybrid"),
    "chunked": (dict(phase1_iters=1, max_inflight=1, backend="dopt"), {},
                "chunked"),
    "ppr": (dict(phase1_iters=1), dict(query_kind="ppr"), "hybrid"),
}


class Background:
    """``fn()`` on a daemon thread; ``result(timeout)`` re-raises."""

    def __init__(self, fn):
        self.finished = threading.Event()
        self._box = {}

        def run():
            try:
                self._box["out"] = fn()
            except BaseException as e:
                self._box["err"] = e
            finally:
                self.finished.set()

        threading.Thread(target=run, daemon=True).start()

    def result(self, timeout: float):
        assert self.finished.wait(timeout), f"no result in {timeout} s"
        if "err" in self._box:
            raise self._box["err"]
        return self._box["out"]


def on_worker() -> bool:
    return threading.current_thread().name == "phase1"


@pytest.fixture
def held(monkeypatch):
    """``_run_morsel`` held on ``release`` in the phase-1 worker's thread
    (``entered`` is set once it was reached there)."""
    entered, release = threading.Event(), threading.Event()
    run_morsel = tdispatcher._run_morsel

    def holding(*args, **kwargs):
        if on_worker():
            entered.set()
            assert release.wait(WAIT_S), "phase 1 was never released"
        return run_morsel(*args, **kwargs)

    monkeypatch.setattr(tdispatcher, "_run_morsel", holding)
    yield entered, release
    release.set()  # a failed test never leaves the worker held


def assert_state_matches_jax(got, exp):
    """Integer leaves bitwise; float leaves (``ppr`` mass) at rtol 1e-5,
    the port's tolerance where a node has more than 64 in-edges."""
    for name in exp.state._fields:
        a = np.asarray(getattr(exp.state, name))
        b = np_of(getattr(got.state, name))
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(np_of(got.iterations),
                                  np.asarray(exp.iterations))


@pytest.mark.parametrize("case", sorted(CASES))
def test_begin_returns_with_phase1_in_flight(case, held):
    kw, qkw, kind = CASES[case]
    entered, release = held
    d = TDispatcher("cpu", to_port(graph()), max_iters=64, **kw)
    inflight = d.begin_batch(SOURCES, **qkw)
    assert inflight.kind == kind
    if kind == "chunked":
        # the chunk loop runs at settle time: nothing is in flight yet
        assert not entered.is_set()
    else:
        assert entered.wait(WAIT_S), "phase 1 never reached the worker"
        assert not inflight.payload["phase1"].done()
    settle = Background(lambda: d.settle_batch(inflight).finalize())
    assert entered.wait(WAIT_S)
    # settle waits for the held phase 1 ...
    assert not settle.finished.wait(0.3)
    release.set()
    # ... and completes once it is released
    out = settle.result(WAIT_S)
    if kind == "hybrid":
        assert out.redispatched > 0
        assert (out.resumed_serial > 0) == (case == "hybrid_serial")
    jd = JDispatcher(mesh11(), graph(), max_iters=64, **kw)
    assert_state_matches_jax(out.result, jd.query(SOURCES, **qkw).result)


def instrument(loop, gate: threading.Event, log: list) -> None:
    """Record, at each finalize of ``loop``, whether it was overlapped,
    the kind of the batch in flight and whether that batch's phase 1 was
    still unfinished; batch i's phase 1 waits on ``gate`` until the
    finalize that should hide behind it has started."""
    disp = loop.dispatcher
    begin, finalize_tail = disp.begin_batch, loop._finalize_tail
    kind = [None]

    def begin_batch(*args, **kwargs):
        gate.clear()
        inflight = begin(*args, **kwargs)
        kind[0] = inflight.kind
        if loop._tail is None:
            gate.set()  # no finalize comes before settle
        return inflight

    def finalize(overlapped):
        p = disp._inflight
        log.append((overlapped, kind[0], p is not None and not p.done()))
        gate.set()
        return finalize_tail(overlapped)

    disp.begin_batch = begin_batch
    loop._finalize_tail = finalize


def test_serving_loop_finalize_runs_behind_phase1(monkeypatch):
    gate, log = threading.Event(), []
    run_morsel = tdispatcher._run_morsel

    def gated(*args, **kwargs):
        if on_worker():
            assert gate.wait(WAIT_S), "no finalize released phase 1"
        return run_morsel(*args, **kwargs)

    monkeypatch.setattr(tdispatcher, "_run_morsel", gated)
    kw = dict(tenant_quota=2, refit_every=2)
    jl, jc, tl, tc = loops(True, **kw)
    _, _, sl, sc = loops(False, **kw)
    instrument(tl, gate, log)
    _, head = serve_graph()
    rounds = stream(head)
    assert run_rounds(tl, tc, rounds) == run_rounds(jl, jc, rounds)
    run_rounds(sl, sc, rounds)
    assert sorted(tl.results) == sorted(jl.results)
    for qid in jl.results:
        np.testing.assert_array_equal(tl.results[qid], jl.results[qid],
                                      err_msg=qid)
    # the quota sheds by what is in flight, so the serial loop admits
    # other queries: every query both served is equal
    both = set(tl.results) & set(sl.results)
    assert len(both) > len(tl.results) // 2
    for qid in both:
        np.testing.assert_array_equal(tl.results[qid], sl.results[qid],
                                      err_msg=qid)
    for f in ("batches", "cold_batches", "finalizes", "overlapped_finalizes",
              "shed", "deadline_misses", "completed"):
        assert getattr(tl.stats, f) == getattr(jl.stats, f), f
    assert tl.stats.overlap_occupancy == jl.stats.overlap_occupancy
    overlapped = [(k, u) for o, k, u in log if o]
    assert len(overlapped) == tl.stats.overlapped_finalizes > 0
    # a chunked batch runs its chunks at settle time, in JAX as here
    behind = [u for k, u in overlapped if k != "chunked"]
    assert behind and all(behind)
    # a finalize outside the pipeline has nothing in flight
    assert not any(u for o, _, u in log if not o)


@pytest.mark.parametrize("where", ["settle", "apply_delta"])
def test_phase1_error_surfaces_where_joined(where, monkeypatch):
    ran = []
    run_morsel = tdispatcher._run_morsel

    def failing(*args, **kwargs):
        ran.append(threading.current_thread().name)
        raise RuntimeError("phase 1 failed")

    monkeypatch.setattr(tdispatcher, "_run_morsel", failing)
    csr = to_port(graph())
    delta = port_delta(jdelta.random_delta(graph(), 15, 15, seed=9))
    d = TDispatcher("cpu", csr, max_iters=64, backend="dopt")
    inflight = d.begin_batch(SOURCES)
    join = (lambda: d.settle_batch(inflight)) if where == "settle" else (
        lambda: d.apply_delta(delta))
    with pytest.raises(RuntimeError, match="phase 1 failed") as err:
        join()
    frames = [f.name for f in traceback.extract_tb(err.value.__traceback__)]
    assert "failing" in frames and "_phase1_job" in frames
    assert ran == ["phase1"]  # once, on the worker: nothing ran it again
    if where == "apply_delta":
        assert d.operands_version == 0  # the delta was not folded
    monkeypatch.setattr(tdispatcher, "_run_morsel", run_morsel)
    if where == "apply_delta":
        d.apply_delta(delta)
        csr = tdelta.apply_delta_csr(csr, delta)
    out = d.query(SOURCES)
    np.testing.assert_array_equal(
        np_of(out.result.state.levels)[:, : csr.n_nodes],
        np.stack([bfs_levels(csr, int(s)) for s in SOURCES]))


@functools.lru_cache(maxsize=None)
def pipelined_expectations():
    """JAX's outcomes of the pipelined run, and the BFS of each batch's
    graph version (the delta lands inside batch ``OVERLAP_DELTA_AT``)."""
    jcsr = graph()
    delta = jdelta.random_delta(jcsr, 15, 15, seed=9)
    jd = JDispatcher(mesh11(), jcsr, max_iters=64, phase1_iters=1)
    jouts = TR.pipelined_run(jd, TR.overlap_batches(), delta,
                             TR.OVERLAP_DELTA_AT, True)
    csr2 = jdelta.apply_delta_csr(jcsr, delta)
    bfs = [np.stack([bfs_levels(jcsr if i <= TR.OVERLAP_DELTA_AT else csr2,
                                int(s)) for s in srcs])
           for i, (srcs, _) in enumerate(TR.overlap_batches())]
    return jouts, bfs, jcsr.n_nodes


def check_batches(got: list, jouts, bfs, n: int) -> None:
    """``got[i]`` = batch i's (levels, iterations)."""
    assert len(got) == len(jouts) == len(bfs)
    for i, ((lv, it), jo, ref) in enumerate(zip(got, jouts, bfs)):
        # rows pad to the mesh's shards: compare the graph's columns
        np.testing.assert_array_equal(
            lv[:, :n], np.asarray(jo.result.state.levels)[:, :n],
            err_msg=f"batch {i} against JAX")
        np.testing.assert_array_equal(it, np.asarray(jo.result.iterations),
                                      err_msg=f"batch {i} iterations")
        np.testing.assert_array_equal(
            lv[:, :n], ref, err_msg=f"batch {i} against its graph's BFS")


def test_one_rank_pipelined_loop_with_delta_in_flight():
    jouts, bfs, n = pipelined_expectations()
    csr = to_port(graph())
    delta = port_delta(jdelta.random_delta(graph(), 15, 15, seed=9))
    for overlap in (True, False):
        d = TDispatcher("cpu", csr, max_iters=64, phase1_iters=1)
        outs = TR.pipelined_run(d, TR.overlap_batches(), delta,
                                TR.OVERLAP_DELTA_AT, overlap)
        check_batches([(np_of(o.result.state.levels),
                        np_of(o.result.iterations)) for o in outs],
                      jouts, bfs, n)
        assert d.stats.deltas == 1 and d._inflight is None


def test_many_pipelined_dispatchers_under_a_short_switch_interval():
    """More dispatchers than cores, each with its worker, run the
    pipelined loop at once while the interpreter switches threads every
    10 us: every run equals the serial one."""
    csr = to_port(graph())
    delta = port_delta(jdelta.random_delta(graph(), 15, 15, seed=9))
    batches = TR.overlap_batches()[:3]

    def run(overlap):
        d = TDispatcher("cpu", csr, max_iters=64, phase1_iters=1)
        return [(np_of(o.result.state.levels), np_of(o.result.iterations))
                for o in TR.pipelined_run(d, batches, delta, 1, overlap)]

    ref = run(False)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runs = [Background(lambda: run(True))
                for _ in range(len(os.sched_getaffinity(0)) + 2)]
        outs = [r.result(WAIT_S) for r in runs]
    finally:
        sys.setswitchinterval(interval)
    for out in outs:
        for (lv, it), (rlv, rit) in zip(out, ref, strict=True):
            np.testing.assert_array_equal(lv, rlv)
            np.testing.assert_array_equal(it, rit)


@pytest.fixture(scope="module")
def mesh_runs():
    return run_ranks(TR.overlap_rank, 2, timeout_s=OVERLAP_RANKS_TIMEOUT_S)


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_pipelined_loop_with_delta_in_flight(mesh_runs, rank):
    out = mesh_runs[rank]
    jouts, bfs, n = pipelined_expectations()
    for mode in ("overlap", "serial"):
        got = out[mode]
        assert sorted(got) == list(range(len(bfs))), mode
        check_batches([got[s] for s in sorted(got)], jouts, bfs, n)
    assert out["overlap", "wire"] == out["serial", "wire"]
    assert out["overlap", "wire"][0] > 0  # the mesh ran collectives
    assert "phase1" in out["threads"]
