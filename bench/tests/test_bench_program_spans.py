"""The readers of the program's own spans (``harness/program_spans.py``)
in whole CPU runs: a traced run reports the five host-clock metrics and
leaves out ``engine.iter_gap_ms`` (no device), and turns the program's
facility off where the window closes, so the traced part's profiler sees
no span begin; an untraced run never turns it on; against a program
without the facility a traced run reports none of them and still ends."""
from __future__ import annotations

import time

import pytest

from bench_cpu import tiny_run
from harness import program_spans, tracing
from repro_torch import trace

CELL = "ldbc-knows-n160k.reach1-c128"
HOST = ["admission.plan_ms", "admission.predict_ms",
        "dispatch.phase1_run_ms", "dispatch.join_wait_ms",
        "service.unpack_ms"]


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    yield
    trace.disable()


def test_traced_run_reports_program_spans(monkeypatch):
    armed = []  # (facility on?, host time) where the profiler is armed
    arm = tracing.Profiler.arm

    def arm_seen(self):
        armed.append((trace.enabled(), time.perf_counter()))
        arm(self)

    monkeypatch.setattr(tracing.Profiler, "arm", arm_seen)
    t0 = time.perf_counter()
    r = tiny_run(CELL, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert set(HOST) <= set(m)
    assert all(m[k]["value"] > 0 and m[k]["unit"] == "ms" for k in HOST)
    assert "engine.iter_gap_ms" not in m
    # the benchmark's own spans are still read
    assert {"service.finalize_ms", "dispatch.phase1_ms"} <= set(m)
    assert not trace.enabled()
    # off before the profiler is armed: no span begins in the traced part
    assert len(armed) == 1 and not armed[0][0]
    begun = [rec for rec in trace.records(t0) if rec.t0 >= armed[0][1]]
    assert begun == []


def test_untraced_run_leaves_the_facility_off():
    t0 = time.perf_counter()
    r = tiny_run(CELL, seconds=0.5)
    assert r["correct"], r["checks"]
    assert not trace.enabled()
    assert trace.records(t0) == []


def test_program_without_the_facility(monkeypatch):
    monkeypatch.setattr(program_spans, "trace", None)
    r = tiny_run(CELL, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert not set(HOST + ["engine.iter_gap_ms"]) & set(m)
    assert {"service.finalize_ms", "dispatch.phase1_ms"} <= set(m)
    assert not trace.enabled()
