"""The benchmark's arithmetic on made-up spans and traces: percentiles,
rates, spreads, the busy union and its gaps, the bytes a launch needs,
and the reduction of a Chrome trace."""
from __future__ import annotations

import math
import statistics

import numpy as np
import pytest
import torch

from bench_cpu import BENCH  # noqa: F401
from harness import kernel_bytes, probes, stats, tracing


def test_percentile_nearest_rank():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile([], 50) is None
    with pytest.raises(ValueError):
        stats.percentile(xs, 0)


def test_mean_rate_spread():
    assert stats.mean([1, 2, 3, 6]) == 3.0
    assert stats.mean([]) is None
    assert stats.rate(300, 20.0) == 15.0
    with pytest.raises(ValueError):
        stats.rate(1, 0)
    vals = [10, 11, 12, 13, 14, 15]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.union_length(iv) == pytest.approx(3 + 1 + 1)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert stats.gaps(iv, 1, 5.5) == [(3, 5)]
    assert stats.union_length([]) == 0.0
    assert stats.gaps([], 0, 1) == [(0, 1)]


def test_extend_bytes():
    # 3 active 128x128 tiles, 10 source blocks of 64 lanes
    got = kernel_bytes.extend_bytes(3, 128, 10, 64)
    assert got == 3 * (128 * 128 + 8) + 10 * 128 * 8
    # 65 lanes take two words
    assert kernel_bytes.extend_bytes(0, 128, 1, 65) == 128 * 16


def test_roofline_share():
    # 3.35 GB in 2 ms is half the peak
    assert kernel_bytes.roofline_share(3.35e9, 2e-3) == pytest.approx(50.0)
    assert kernel_bytes.roofline_share(0, 1.0) is None
    assert kernel_bytes.roofline_share(1.0, 0) is None


def test_active_tiles():
    g, b, lanes = 4, 8, 64
    x = torch.zeros(g, b, lanes, dtype=torch.uint8)
    x[1, 3, 5] = 1
    x[3, 0, 63] = 1
    rows = torch.tensor([0, 1, 1, 3, 2, 3], dtype=torch.int32)
    cols = torch.tensor([0, 0, 4, 1, 2, 3], dtype=torch.int32)  # 4 is pad
    assert int(probes.active_tiles(x, rows, cols, 4)) == 3


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_summary_leaves_out_the_probe_stream():
    events = [
        # the marker, launched by the serving thread onto stream 9
        _ev("user_annotation", tracing.MARKER, 0, 10, tid=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, tid=1, correlation=1),
        _ev("kernel", "fill_marker", 20, 5, tid=9, correlation=1, stream=9),
        # program kernels on streams 7 and 13, a copy, a probe kernel
        _ev("kernel", "void extend_kernel<1>", 100, 50, tid=7, stream=7,
            correlation=2),
        _ev("kernel", "binned_pull_kernel", 120, 60, tid=13, stream=13,
            correlation=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 400, 100, tid=7, stream=7,
            correlation=4),
        _ev("kernel", "probe_sum", 300, 40, tid=9, stream=9,
            correlation=5),
        # bench spans of the serving thread
        _ev("user_annotation", "bench.settle_batch", 150, 150, tid=1),
        _ev("user_annotation", "bench.finalize", 310, 80, tid=1),
    ]
    ts = tracing.summarize(events, window_s=1e-3)
    assert ts.kernels == 2
    assert ts.busy_s == pytest.approx((180 - 100 + 100) * 1e-6)
    assert tracing.kernel_seconds(ts, "extend_kernel") == (
        1, pytest.approx(50e-6))
    # one idle gap 180..400 inside the traced span: its middle (290)
    # falls in the settle span
    assert set(ts.idle_by_host) == {"bench.settle_batch"}
    assert ts.idle_by_host["bench.settle_batch"] == pytest.approx(220e-6)
    assert math.isclose(ts.window_s, 1e-3)


def test_trace_summary_empty():
    ts = tracing.summarize([], window_s=0.5)
    assert ts.kernels == 0 and ts.busy_s == 0 and ts.idle_by_host == {}


def test_spread_of_numpy_quartiles_differs():
    # the rule is statistics.quantiles, not numpy's default
    vals = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0]
    q = np.percentile(vals, [25, 50, 75])
    assert stats.spread(vals) != pytest.approx((q[2] - q[0]) / q[1])
