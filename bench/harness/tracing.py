"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the
last seconds of the window, read back from its Chrome trace.

What is read: every device operation (kernels, copies, sets) with its
stream and its interval; the bench's own spans on the serving thread
(``record_function`` annotations named ``bench.*``), which name what the
host was doing in each idle gap of the device; and the stream of the
launch probes, found by a marker that the serving thread launches on it
inside the annotation ``bench.marker``, whose operations are left out of
every count.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import shutil
import tempfile
import time

from . import stats

MARKER = "bench.marker"


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # the traced window's length (host clock)
    busy_s: float  # union of the device operations' intervals
    kernels: int  # device kernels launched by the program
    kernel_s: dict  # kernel name -> device seconds (summed)
    kernel_n: dict  # kernel name -> launches
    idle_by_host: dict  # host span -> idle device seconds inside it


class Profiler:
    """``torch.profiler`` on a schedule of one warm-up cycle and one active
    cycle. ``arm`` starts it in set-up (its start takes seconds on the
    card); ``start`` turns recording on, cheaply, where the traced part of
    the window begins; ``stop`` ends the active cycle once the window has
    closed, and the trace is written then. ``mark`` runs on the probe
    stream."""

    def __init__(self, device, probe_stream=None):
        self.device = device
        self.probe_stream = probe_stream
        self.prof = None
        self.t_start = self.t_stop = None
        self.timings = {}
        self._dir = None

    def arm(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._dir = tempfile.mkdtemp(prefix="bench-trace-")
        t0 = time.perf_counter()
        self.prof = profile(
            activities=acts, record_shapes=False, with_stack=False,
            profile_memory=False,
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=self._export)
        self.prof.start()
        self.timings["arm_s"] = time.perf_counter() - t0

    def _export(self, prof) -> None:
        prof.export_chrome_trace(os.path.join(self._dir, "trace.json"))

    def start(self) -> None:
        t0 = time.perf_counter()
        self.prof.step()
        self.t_start = time.perf_counter()
        self.timings["start_s"] = self.t_start - t0
        self.mark()

    def mark(self) -> None:
        import torch

        if self.probe_stream is None:
            return
        with torch.profiler.record_function(MARKER):
            with torch.cuda.stream(self.probe_stream):
                torch.zeros(1, device=self.device).add_(1)

    def stop(self) -> None:
        self.t_stop = time.perf_counter()
        self.prof.step()
        self.timings["stop_s"] = time.perf_counter() - self.t_stop

    def summary(self) -> TraceSummary:
        """Read the written trace back, then drop it and the profiler."""
        try:
            t0 = time.perf_counter()
            self.prof.stop()
            with open(os.path.join(self._dir, "trace.json")) as f:
                events = json.load(f).get("traceEvents", [])
            self.timings["read_s"] = time.perf_counter() - t0
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)
            self.prof = None
        return summarize(events, self.t_stop - self.t_start)


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def summarize(events: list, window_s: float) -> TraceSummary:
    """Reduce Chrome-trace events to the window's device figures."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    device = [e for e in xs if _cat(e) in dev_cats]
    # the probe stream: where the marker's launch landed
    marks = [(e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in xs if _cat(e) == "user_annotation"
             and e.get("name") == MARKER]
    corr = set()
    for e in xs:
        if _cat(e) in ("cuda_runtime", "cuda_driver"):
            t = float(e["ts"])
            if any(e.get("tid") == tid and a <= t <= b
                   for tid, a, b in marks):
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    corr.add(c)
    probe_streams = {
        (e.get("args") or {}).get("stream") for e in device
        if (e.get("args") or {}).get("correlation") in corr
    }
    probe_streams.discard(None)
    ours = [e for e in device
            if (e.get("args") or {}).get("stream") not in probe_streams]
    iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ours]
    busy_us = stats.union_length(iv)
    kernel_s: dict = {}
    kernel_n: dict = {}
    for e in ours:
        if _cat(e) != "kernel":
            continue
        name = str(e.get("name", "?"))
        kernel_s[name] = kernel_s.get(name, 0.0) + float(e["dur"]) * 1e-6
        kernel_n[name] = kernel_n.get(name, 0) + 1
    # idle gaps of the device inside the traced span, by the bench span
    # of the serving thread around each gap's middle (the bench spans do
    # not nest)
    idle_by_host: dict = {}
    if iv:
        lo = min(a for a, _ in iv)
        hi = max(b for _, b in iv)
        spans = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             str(e.get("name")))
            for e in xs if _cat(e) == "user_annotation"
            and str(e.get("name", "")).startswith("bench.")
            and e.get("name") != MARKER)
        starts = [sp[0] for sp in spans]
        for a, b in stats.gaps(iv, lo, hi):
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            label = (spans[i][2] if i >= 0 and spans[i][1] >= mid
                     else "bench.none")
            idle_by_host[label] = idle_by_host.get(label, 0.0) + (b - a) * 1e-6
    return TraceSummary(
        window_s=float(window_s), busy_s=busy_us * 1e-6,
        kernels=sum(kernel_n.values()), kernel_s=kernel_s,
        kernel_n=kernel_n, idle_by_host=idle_by_host,
    )


def kernel_seconds(summary: TraceSummary, marker: str) -> tuple[int, float]:
    """Launches and device seconds of the kernels whose name holds
    ``marker``."""
    n = sum(v for k, v in summary.kernel_n.items() if marker in k)
    s = sum(v for k, v in summary.kernel_s.items() if marker in k)
    return n, s
