"""A whole run on the CPU at a small size, untraced and traced, and the
command's refusals."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_cpu import BENCH, ROOT, tiny_run

CELLS = ["ldbc-knows-n160k.reach1-c128", "lj-n200k.reach1-c128"]


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_reports_end_to_end(workload):
    r = tiny_run(workload)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert set(m) == {"sources_per_s", "query_p50_ms", "query_p95_ms",
                      "setup_s"}
    assert all(v["value"] > 0 for v in m.values())
    assert m["query_p95_ms"]["value"] >= m["query_p50_ms"]["value"]
    assert m["setup_s"]["unit"] == "s"
    assert r["device"]["count"] == 1


def test_traced_run_reports_per_layer():
    r = tiny_run(CELLS[0], trace=True)
    m = r["metrics"]
    # the CPU path launches no kernel: the device readers find nothing
    assert {"service.finalize_ms", "admission.lane_fill",
            "dispatch.phase1_ms", "setup.operands_s"} <= set(m)
    assert "msbfs_extend_roofline" not in m and "device.idle_share" not in m
    assert m["admission.lane_fill"]["value"] == pytest.approx(100.0)
    assert "window_s" in r["device"] and "busy_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["correct"]


def test_same_seed_same_queries():
    a = tiny_run(CELLS[0], seconds=0.3)
    b = tiny_run(CELLS[0], seconds=0.3)
    fa, fb = a["info"]["figures"], b["info"]["figures"]
    assert a["info"]["graph_edges"] == b["info"]["graph_edges"]
    assert fa["distinct_sources"] > 0 and fb["distinct_sources"] > 0


def _command(cwd, *extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "7", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_command_refuses_without_a_card():
    out = _command(ROOT)
    if "no CUDA device" not in out.stderr:
        pytest.skip("a card is present: the refusal is not reached")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")


def test_command_rejects_unknown_workload():
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "x.y", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
