"""Where a served batch's time goes in the PyTorch/CUDA port, on one GPU.

    python3 scripts/profile_port_serve.py [--scale 10] [--batches 3]

Serves the LDBC proxy through ``repro_torch.launch.serve.QueryService``
in the two traffic shapes of ``chip_smoke.py`` (nTkS with ``dopt_fused``,
8 sources per batch; nTkMS with ``recommend``, 64 sources per batch),
warms each with two batches, then records ``--batches`` more under
``torch.profiler``. Prints the card's name and power limit and, per shape:
the window's wall time, the device
busy time (the union of the GPU kernel and copy intervals) and idle
share, the device time of each port kernel per launch, the top device
kernels and the top host operations by self time, as JSON on the last
line of standard output.

Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_KERNELS = {
    "binned_pull": ("binned_pull_kernel",),
    "msbfs_extend": ("extend_kernel",),
}


def _device_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _union_us(intervals) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile_shape(svc, csr, pick_sources, per_batch, batches, seed0):
    from torch.profiler import ProfilerActivity, profile

    # sources are picked up front: the pick runs a host BFS probe per
    # candidate and is no part of serving
    sources = [pick_sources(csr, per_batch, seed=seed0 + b)
               for b in range(2 + batches)]

    def serve_one(b):
        res, _ = svc.query(sources[b])
        torch.cuda.synchronize()
        return res

    for b in range(2):  # operand build, engine build, allocator warm-up
        serve_one(b)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in range(2, 2 + batches):
            serve_one(b)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [
        e for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    ]
    busy_us = _union_us(
        (e.time_range.start, e.time_range.end) for e in dev_events
    )
    per_kernel = {}
    for port_name, markers in PORT_KERNELS.items():
        sel = [e for e in dev_events if any(m in e.name for m in markers)]
        if sel:
            per_kernel[port_name] = {
                "device_launches": len(sel),
                "device_us_per_launch": float(np.mean(
                    [e.time_range.end - e.time_range.start for e in sel])),
            }
    avgs = prof.key_averages()
    dev_top = sorted(
        (a for a in avgs
         if str(getattr(a, "device_type", "")).endswith("CUDA")),
        key=_device_time, reverse=True,
    )[:10]
    host_top = sorted(avgs, key=lambda a: a.self_cpu_time_total,
                      reverse=True)[:12]
    return {
        "batches": batches,
        "sources_per_batch": per_batch,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": (1.0 - busy_us / wall_us) if wall_us else None,
        "device_events": len(dev_events),
        "port_kernels": per_kernel,
        "top_device": [
            {"name": a.key[:80], "count": a.count,
             "device_ms": _device_time(a) / 1e3} for a in dev_top
        ],
        "top_host_self": [
            {"name": a.key[:80], "count": a.count,
             "self_cpu_ms": a.self_cpu_time_total / 1e3} for a in host_top
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port_serve: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph.generators import (
        PAPER_DATASET_FAMILIES,
        PAPER_DATASETS,
        pick_sources,
    )
    from repro_torch.kernels import build
    from repro_torch.launch.serve import QueryService

    build.build_all()
    csr = PAPER_DATASETS["ldbc"](args.scale)
    family = PAPER_DATASET_FAMILIES["ldbc"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    out = {"device": torch.cuda.get_device_name(0),
           "name_and_power_limit": smi.stdout.strip().splitlines()[0],
           "scale": args.scale}
    print(out["name_and_power_limit"], flush=True)
    for name, backend, per_batch in (("ntks_dopt_fused_x8", "dopt_fused", 8),
                                     ("ntkms_recommend_x64", "recommend", 64)):
        svc = QueryService("cuda", csr, backend=backend, family=family)
        out[name] = profile_shape(svc, csr, pick_sources, per_batch,
                                  args.batches, seed0=100)
        del svc
        torch.cuda.empty_cache()
        print(name, json.dumps(out[name], indent=1), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
