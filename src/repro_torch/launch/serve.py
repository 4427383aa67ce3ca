"""Recursive-query serving driver (port of ``repro.launch.serve``).

A resident query service over one graph on one device: operands are
built once, engines are built per (kind x policy x edge compute x
backend) into a shared cache and reused across request batches, and each
batch runs the paper's hybrid (phase 1 issues source-level morsels under
a learned budget, phase 2 re-dispatches the stragglers), with policy and
scan layout picked per batch and the online learners fed by the served
stream.

The port has the closed-loop driver (``--closed-loop``, implied by
``--paths``): one batch at a time through ``AdaptiveScheduler.query``.
It reports warm latency percentiles: batches that built a new engine or
ran a new morsel count are cold and reported apart. The open-loop
``ServingLoop``, ``--mutate-stream`` and the non-reach ``--query-kind``
values are not ported yet and raise ``NotImplementedError``.

    PYTHONPATH=src python -m repro_torch.launch.serve --closed-loop \\
        --dataset ldbc --scale 10 --sources-per-batch 8 --batches 20

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..core import histogram_lengths, reconstruct_paths
from ..graph.generators import (
    PAPER_DATASET_FAMILIES,
    PAPER_DATASETS,
    pick_sources,
)
from ..kernels.common import resolve_device, synchronize
from ..runtime.scheduler import AdaptiveScheduler


class QueryService:
    """Build-once, serve-many recursive query engine pool: a thin façade
    over ``AdaptiveScheduler`` whose ``query`` returns
    ``(IFEResult, policy_name)``."""

    def __init__(self, device, csr, max_deg=None, max_iters=64,
                 adaptive=True, backend="recommend",
                 direction_thresholds=None, family=None, online_adapt=True,
                 refit_every=16, cost="auto"):
        self.device = resolve_device(device)
        self.csr = csr
        self.max_iters = max_iters
        self.max_deg = max_deg
        self.scheduler = AdaptiveScheduler(
            self.device, csr, max_deg=max_deg, max_iters=max_iters,
            adaptive=adaptive, backend=backend,
            direction_thresholds=direction_thresholds, family=family,
            online_adapt=online_adapt, refit_every=refit_every, cost=cost,
        )
        self.last_outcome = None

    def query(self, sources, returns_paths=False, policy=None,
              state_layout="replicated", backend=None, query_kind="reach"):
        """One request batch -> (result state, policy used)."""
        out = self.scheduler.query(
            sources, returns_paths=returns_paths, policy=policy,
            state_layout=state_layout, backend=backend,
            query_kind=query_kind,
        )
        self.last_outcome = out
        return out.result, out.policy


@dataclasses.dataclass
class BatchRecord:
    """One served closed-loop batch, as handed to ``on_batch``."""

    index: int
    sources: np.ndarray
    result: Any  # IFEResult
    policy: str
    ms: float  # wall of the batch, output phase and device sync included
    cold: bool  # the batch built an engine or ran a new morsel count


def _pct(values, p):
    return np.percentile(np.asarray(values), p) if len(values) else float("nan")


def _report_core(sched, used=None) -> None:
    cache, stats = sched.cache, sched.stats
    if used:
        print(f"policies used: {used}")
    print(
        f"engine cache {len(cache)} built, "
        f"{cache.hits} hits / {cache.misses} misses "
        f"({dict(cache.misses_by_kind)} builds by kind)"
    )
    print(
        f"phase-2 resume: {stats.resumed_ganged} survivor(s) ganged across "
        f"{stats.gangs} gang dispatch(es) "
        f"(occupancy {stats.gang_occupancy:.2f}), "
        f"{stats.resumed_serial} resumed serially"
    )
    if sched.budget_model is not None:
        model = sched.budget_model
        budgets = {
            f"{fam}/2^{b}": v
            for (fam, b), v in model.budgets(sched.max_iters).items()
        }
        mp = model.mispredicts
        print(
            f"online adapt: {stats.refits} threshold refit(s) from "
            f"{sum(len(r) for r in sched._dir_samples.values())} live "
            f"samples; learned budgets {budgets}; "
            f"budget mispredicts {mp.too_low} too-low / {mp.too_high} "
            f"too-high over {mp.observed} morsels "
            f"(rate {stats.budget_mispredict_rate:.3f}, "
            f"{stats.budget_inert_slots} inert budget slots)"
        )


def run_closed_loop(args, csr, device, family,
                    on_batch: Callable[[BatchRecord], None] | None = None
                    ) -> int:
    svc = QueryService(device, csr, adaptive=not args.static,
                       backend=args.backend,
                       direction_thresholds=args.thresholds, family=family,
                       online_adapt=args.online_adapt,
                       refit_every=args.refit_every, cost=args.cost_mode)
    rng = np.random.default_rng(0)
    lat, warm_lat, p1_ms, p2_ms, used = [], [], [], [], {}
    redispatched, cold_ms = 0, 0.0
    cache = svc.scheduler.cache
    for b in range(args.batches):
        sources = pick_sources(csr, args.sources_per_batch, seed=100 + b)
        compiles0 = cache.compile_events
        t0 = time.perf_counter()
        res, pol = svc.query(sources, returns_paths=args.paths,
                             policy=args.policy,
                             query_kind=args.query_kind)
        if args.paths and not pol.startswith("ntkms"):
            dests = rng.integers(0, csr.n_nodes, 4).astype(np.int32)
            reconstruct_paths(
                res.state.parents[0, : csr.n_nodes], dests, max_len=32
            )
        else:
            histogram_lengths(res.state.levels)
        synchronize(svc.device)
        dt = (time.perf_counter() - t0) * 1e3
        lat.append(dt)
        cold = cache.compile_events > compiles0
        if cold:
            cold_ms += dt
        else:
            warm_lat.append(dt)
        used[pol] = used.get(pol, 0) + 1
        out = svc.last_outcome
        p1_ms.append(out.phase_ms["phase1"])
        p2_ms.append(out.phase_ms["phase2"])
        redispatched += out.redispatched
        if on_batch is not None:
            on_batch(BatchRecord(b, sources, res, pol, dt, cold))
        if b < 3 or b == args.batches - 1:
            phase = (
                f"p1 {out.phase_ms['phase1']:7.1f} ms"
                f" p2 {out.phase_ms['phase2']:7.1f} ms"
                if out.hybrid else "static"
            )
            print(f"batch {b:3d}: {len(sources)} sources -> {pol:6s} "
                  f"{dt:8.1f} ms  [{phase}]")
    p1_ms, p2_ms = map(np.asarray, (p1_ms, p2_ms))
    print(
        f"served {args.batches} batches ({args.batches - len(warm_lat)} "
        f"cold): warm p50 {_pct(warm_lat, 50):.1f} ms, "
        f"p99 {_pct(warm_lat, 99):.1f} ms "
        f"(all-in p50 {_pct(lat, 50):.1f} ms, p99 {_pct(lat, 99):.1f} ms); "
        f"cold-start {cold_ms:.0f} ms excluded from warm percentiles"
    )
    print(
        f"phase1 p50/p99 {_pct(p1_ms, 50):.1f}/{_pct(p1_ms, 99):.1f} ms; "
        f"phase2 p50/p99 {_pct(p2_ms, 50):.1f}/{_pct(p2_ms, 99):.1f} ms; "
        f"{redispatched} morsels re-dispatched"
    )
    _report_core(svc.scheduler, used)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ldbc",
                    choices=sorted(PAPER_DATASETS))
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--closed-loop", action="store_true",
                    help="one-batch-at-a-time driver (implied by --paths); "
                         "the open-loop ServingLoop is not ported yet")
    ap.add_argument("--batches", type=int, default=20,
                    help="closed-loop request batches")
    ap.add_argument("--arrivals", type=int, default=60,
                    help="open-loop arrival count")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="open-loop Poisson arrival rate (queries/sec)")
    ap.add_argument("--tenants", type=int, default=2,
                    help="open-loop tenant count")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="open loop: per-query SLO deadline")
    ap.add_argument("--quota", type=int, default=None,
                    help="open loop: max concurrent queries per tenant")
    ap.add_argument("--overlap", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="open loop: overlap host materialization with the "
                         "next batch's device work")
    ap.add_argument("--sources-per-batch", type=int, default=8)
    ap.add_argument("--max-batch-sources", type=int, default=None,
                    help="open loop: bound one batch's pooled sources")
    ap.add_argument("--mutate-stream", type=int, default=0, metavar="N",
                    help="open loop: interleave N seeded graph deltas "
                         "(not ported yet)")
    ap.add_argument("--delta-edges", type=int, default=64, metavar="M",
                    help="edges added and deleted per --mutate-stream delta")
    ap.add_argument("--query-kind", default="reach",
                    choices=("reach", "topk_paths", "ppr", "pattern_counts"),
                    help="scenario family; the port serves 'reach' (BFS "
                         "levels)")
    ap.add_argument("--paths", action="store_true",
                    help="return actual paths (parents), not lengths")
    ap.add_argument("--policy", default=None,
                    choices=(None, "1t1s", "nt1s", "ntks", "ntkms"))
    ap.add_argument("--backend", default="recommend",
                    choices=("ell_push", "ell_pull", "pull_binned",
                             "pull_binned_fused", "block_mxu", "dopt",
                             "dopt_ell", "dopt_binned", "dopt_fused",
                             "recommend"),
                    help="frontier-extension backend; 'recommend' picks the "
                         "scan layout per batch — all choices give "
                         "bit-identical results")
    ap.add_argument("--thresholds", default=None, metavar="BENCH_JSON",
                    help="fit the direction switch's alpha/beta from this "
                         "trace file instead of Beamer's constants (a pin)")
    ap.add_argument("--static", action="store_true",
                    help="disable the adaptive hybrid (static dispatch)")
    ap.add_argument("--online-adapt", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="online budget model and threshold refits")
    ap.add_argument("--refit-every", type=int, default=16,
                    help="batches between in-flight threshold refits")
    ap.add_argument("--cost-mode", default="auto",
                    choices=("auto", "slots", "measured"),
                    help="direction-threshold fit cost model; 'auto' is "
                         "measured on CUDA, slots on the CPU")
    return ap


def main(argv=None,
         on_batch: Callable[[BatchRecord], None] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.query_kind != "reach":
        raise NotImplementedError(
            f"--query-kind {args.query_kind} is not ported yet (ROADMAP "
            "queue 1: the non-reach query kinds)"
        )
    if args.mutate_stream:
        raise NotImplementedError(
            "--mutate-stream is not ported yet (ROADMAP queue 1: the "
            "open-loop ServingLoop and graph/delta.py)"
        )
    if not (args.closed_loop or args.paths):
        raise NotImplementedError(
            "the open-loop ServingLoop is not ported yet (ROADMAP queue 1); "
            "pass --closed-loop"
        )
    device = resolve_device(args.device)
    csr = PAPER_DATASETS[args.dataset](args.scale)
    family = PAPER_DATASET_FAMILIES.get(args.dataset)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(
        f"serving {args.dataset} proxy on {name}: {csr.n_nodes} nodes, "
        f"{csr.n_edges} edges, avg degree {csr.avg_degree:.0f}"
    )
    return run_closed_loop(args, csr, device, family, on_batch=on_batch)


if __name__ == "__main__":
    raise SystemExit(main())
