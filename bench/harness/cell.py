"""A run of one cell, end to end: set-up, window, close, comparison and
the result line's fields. ``run.py`` calls ``run_cell`` after it has
found the card; the tests call it on the CPU at small sizes."""
from __future__ import annotations

import resource
import sys
import time

import numpy as np
import torch

from . import check, graphs, manifest
from .serving import MIN_LEVELS, POOL_SOURCES, CellRun, Warmup
from .tracing import TraceSummary

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``modules`` (default ``sys.modules``) that are
    JAX or the JAX package, each compared whole: ``repro_torch`` is not
    ``repro``."""
    mods = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in mods}
    return sorted(tops & set(FORBIDDEN))


def run_cell(man: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, *, t_start: float,
             config: dict | None = None, traffic: dict | None = None,
             control: dict | None = None, warmup: Warmup = Warmup(),
             pool_sources: int = POOL_SOURCES) -> dict:
    """One run; returns the result line's fields (``checks`` last).
    ``config``/``traffic``/``warmup``/``pool_sources`` replace the
    benchmark's (tests); ``control`` switches on a path of the program
    that breaks the configuration's guarantee (``{"max_deg": k}``)."""
    cell = manifest.cell(man, workload)
    config = config or manifest.config(man, cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = CellRun(config, traffic, seed, seconds, trace, device,
                  control=control, t_start=t_start, warmup=warmup)
    marks = {"imported": time.perf_counter()}
    indptr, indices = graphs.make_graph(config, run.graph_seed, device)
    marks["graph"] = time.perf_counter()
    pool = graphs.pick_sources(indptr, indices, pool_sources,
                               seed=run.pool_seed, min_levels=MIN_LEVELS)
    marks["pool"] = time.perf_counter()
    run.build(indptr, indices, pool)
    metrics = manifest.metrics_for(man, workload, trace)
    readers = {m["name"]: manifest.reader(m["name"]) for m in metrics}
    if trace:
        for mod in readers.values():
            if hasattr(mod, "install"):
                mod.install(run)
    run.serve()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    run.release()
    if run.probes is not None:
        run.launch_totals = run.probes.totals()
    # the reference runs once the program's state is freed
    from reference.bfs import LevelTable

    t_ref = time.perf_counter()
    table = LevelTable(indptr, indices, device)
    table.fill([int(x) for _, srcs, _ in run._sample for x in srcs])
    figures = check.compare(run._sample, table, run.n_nodes)
    figures["undelivered"] = run.undelivered
    figures["shed"] = run.shed
    ref_s = time.perf_counter() - t_ref
    correct, checks = check.verdict(figures)
    out_metrics = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has "
                                   "nothing to read")
            continue
        out_metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": run.submitted_window,
              "failed": run.shed + run.undelivered
              + figures["wrong_queries"],
              "metrics": out_metrics, "device": dev}
    ts = run.trace_summary
    if trace and ts is not None:
        dev["busy_s"] = ts.busy_s
        dev["window_s"] = ts.window_s
        result["breakdown"] = breakdown(ts)
    result["info"] = {
        "cold_batches_in_window": run.spans.cold_batches_window,
        "settled": run.spans.settled,
        "harness_s_in_window": run.spans.harness_s,
        "warmup_batches": run.spans.warmup_batches,
        "warmup_bins": run.spans.warmup_bins,
        "queries_in_window": run.spans.queries_delivered,
        "batches_in_window": len(run.spans.batch_iters),
        "mean_batch_iters": (sum(run.spans.batch_iters)
                             / max(len(run.spans.batch_iters), 1)),
        "redispatched_in_window": run.spans.redispatched,
        "sources_each_second": run.spans.per_second,
        "setup_marks_s": {k: v - t_start for k, v in marks.items()},
        "reference_s": ref_s, "figures": figures,
        "profiler": run.profiler.timings if run.profiler else None,
        "host_peak_bytes": 1024 * resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss,
        "graph_edges": int(indices.size),
        "max_degree": int(np.diff(indptr).max()),
    }
    result["checks"] = checks
    return result


def breakdown(ts: TraceSummary) -> dict:
    ops = sorted(ts.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(ts.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
