"""The port's spans (``repro_torch.trace``) on the serving path.

- Off, as by default, a ``ServingLoop`` run with
  ``torch.profiler.record_function`` and ``torch.cuda.Event`` patched to
  raise enters no span, writes no record and delivers every query's BFS
  levels (``tests/oracle.py``).
- On, every row equals the run with tracing off, and the record holds one
  ``admission.plan`` a pump, one ``dispatch.phase1`` a batch on the
  ``phase1`` thread, one ``dispatch.join`` a batch, one
  ``service.finalize`` and one ``service.unpack`` (inside it) a finalize,
  ``admission.predict`` only inside a plan, and as many ``engine.iter``
  as the batches' morsels iterated in both phases.
- Device intervals: with fake timing events, an engine call's
  ``engine.iter_gap`` sums the gaps between its iterations once every
  event reports done, spans keep no device time of their own, a span
  outside an engine call makes no event, and nothing synchronises.
- Records written from many threads at once are all kept.
"""
import inspect
import sys
import threading
import time

import numpy as np
import pytest
import torch

from oracle import bfs_levels

from repro_torch import trace
from repro_torch.graph.generators import powerlaw
from repro_torch.runtime.dispatch import QueryDispatcher
from repro_torch.runtime.service import ServingLoop

WAIT_S = 60.0  # any single join; a hang fails after it

# dispatcher options: the hybrid with a serial phase 2, the static engine
CASES = {
    "hybrid": dict(phase1_iters=2, gang_resume=False),
    "static": dict(adaptive=False),
}


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    yield
    trace.disable()


def graph():
    return powerlaw(160, 5.0, seed=0)


def serve(opts: dict, on: bool):
    """Rounds of one-source queries (a pooled round of 70 packs into lane
    morsels), served through the overlapped loop; returns the loop, its
    rows, the plan rounds it pumped and the iterations its batches ran."""
    if on:
        trace.enable()
    disp = QueryDispatcher("cpu", graph(), backend="dopt", family="powerlaw",
                           max_iters=64, pad_pow2_morsels=True, **opts)
    iters = []
    disp.on_finalized = lambda seq, o: iters.append(
        int(o.result.iterations.sum()))
    loop = ServingLoop(dispatcher=disp, overlap=True)
    pumps = []
    pump = loop.pump
    loop.pump = lambda: pumps.append(pump()) or pumps[-1]
    rng = np.random.default_rng(3)
    for r in range(4):
        for q in range(70 if r == 2 else 3):
            loop.submit(rng.integers(0, 160, 1).astype(np.int32),
                        qid=f"r{r}q{q}")
        loop.pump()
    loop.drain()
    trace.disable()
    return loop, dict(loop.results), pumps, iters


def check_levels(results):
    g = graph()
    rng = np.random.default_rng(3)
    for r in range(4):
        for q in range(70 if r == 2 else 3):
            src = rng.integers(0, 160, 1)
            np.testing.assert_array_equal(
                results[f"r{r}q{q}"].reshape(-1), bfs_levels(g, src),
                err_msg=f"r{r}q{q}")


def _raise(*a, **k):
    raise AssertionError("a span site reached torch with tracing off")


@pytest.mark.parametrize("case", sorted(CASES))
def test_off_enters_no_span(case, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    t0 = time.perf_counter()
    loop, rows, _, _ = serve(CASES[case], on=False)
    assert trace.records(t0) == []
    assert loop.stats.batches > 3
    check_levels(rows)


def _inside(inner, outer) -> bool:
    return any(o.thread == inner.thread and o.t0 <= inner.t0
               and inner.t1 <= o.t1 for o in outer)


@pytest.mark.parametrize("case", sorted(CASES))
def test_on_records_each_span(case):
    _, rows_off, _, _ = serve(CASES[case], on=False)
    t0 = time.perf_counter()
    loop, rows, pumps, iters = serve(CASES[case], on=True)
    assert not trace.enabled()
    assert sorted(rows) == sorted(rows_off)
    for qid in rows_off:
        np.testing.assert_array_equal(rows[qid], rows_off[qid], err_msg=qid)
    by = {}
    for r in trace.records(t0):
        by.setdefault(r.name, []).append(r)
    st = loop.stats
    me = threading.current_thread().name
    assert all(n > 0 for n in pumps)
    assert len(by["admission.plan"]) == len(pumps)
    assert all(r.thread == me for r in by["admission.plan"])
    assert len(by["dispatch.phase1"]) == st.batches
    assert {r.thread for r in by["dispatch.phase1"]} == {"phase1"}
    assert len(by["dispatch.join"]) == st.batches
    assert len(by["service.finalize"]) == st.finalizes == st.batches
    assert len(by["service.unpack"]) == st.finalizes
    assert all(_inside(u, by["service.finalize"])
               for u in by["service.unpack"])
    assert by["admission.predict"]  # the pooled round packs
    assert all(_inside(p, by["admission.plan"])
               for p in by["admission.predict"])
    assert len(by["engine.iter"]) == sum(iters) > 0
    threads = {r.thread for r in by["engine.iter"]}
    if case == "hybrid":
        assert loop.dispatcher.stats.redispatched > 0
        assert threads == {"phase1", me}  # phase 2 on the loop's
    else:
        assert threads == {"phase1"}
    # no device here: no interval, no gap record
    assert "engine.iter_gap" not in by
    assert all(r.device_ms is None for rs in by.values() for r in rs)


class FakeEvent:
    """A timing event on a fake device clock: ``record`` takes the next
    tick, ``query`` says whether the test has let it complete."""

    tick = 0
    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done = False
        FakeEvent.made.append(self)

    def record(self, stream=None):
        FakeEvent.tick += 1
        self.at = FakeEvent.tick

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time on an event not done"
        return float(end.at - self.at)


@pytest.fixture
def fake_device(monkeypatch):
    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    return torch.device("cuda", 0)


def test_device_intervals_resolve_when_done(fake_device):
    trace.enable()
    t0 = time.perf_counter()
    with trace.engine_call(fake_device):
        for _ in range(3):
            with trace.span("engine.iter", fake_device):
                FakeEvent.tick += 10  # the iteration's launches
            FakeEvent.tick += 4  # the host loop between iterations
    assert len(FakeEvent.made) == 6  # a pair an iteration
    with trace.span("dispatch.phase1", fake_device):
        pass  # outside an engine call: no event
    assert len(FakeEvent.made) == 6
    by = {}
    for r in trace.records(t0):
        by.setdefault(r.name, []).append(r)
    assert len(by["engine.iter"]) == 3 and len(by["engine.iter_gap"]) == 1
    # nothing completed yet: nothing resolved
    assert all(r.device_ms is None for rs in by.values() for r in rs)
    for ev in FakeEvent.made:
        ev.done = True
    trace.records(t0)
    # the end of one iteration to the start of the next: 4 + 1 ticks twice
    assert by["engine.iter_gap"][0].device_ms == 10.0
    # the spans are the gap's links, with no device time of their own
    assert all(r.device_ms is None
               for r in by["engine.iter"] + by["dispatch.phase1"])
    assert all(_inside(r, by["engine.iter_gap"]) for r in by["engine.iter"])


def test_one_iteration_has_no_gap(fake_device):
    trace.enable()
    t0 = time.perf_counter()
    with trace.engine_call(fake_device):
        with trace.span("engine.iter", fake_device):
            pass
    gap = [r for r in trace.records(t0) if r.name == "engine.iter_gap"]
    assert [r.device_ms for r in gap] == [0.0]


def test_facility_reads_nothing_back_from_the_device():
    src = inspect.getsource(trace)
    for word in ("synchronize", ".item(", ".cpu(", ".numpy(", ".tolist(",
                 "wait_event", ".wait("):
        assert word not in src, word


def test_threads_write_at_once():
    """More writers than cores, switching every 10 us: every record of
    every thread is kept."""
    threads, each = 24, 400
    trace.enable()
    t0 = time.perf_counter()
    go = threading.Event()

    def write(i):
        go.wait(WAIT_S)
        for _ in range(each):
            with trace.span(f"stress.{i}"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=write, args=(i,), name=f"w{i}")
              for i in range(threads)]
        for t in ts:
            t.start()
        go.set()
        for t in ts:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    counts = {}
    for r in trace.records(t0):
        if r.name.startswith("stress."):
            assert r.thread == "w" + r.name.split(".")[1]
            counts[r.name] = counts.get(r.name, 0) + 1
    assert counts == {f"stress.{i}": each for i in range(threads)}
