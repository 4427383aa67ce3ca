"""Recursive-query serving driver (port of ``repro.launch.serve``).

A resident query service over one graph (one device, or a mesh of ranks
under torchrun, below): operands are
built once, engines are built per (kind x policy x edge compute x
backend) into a shared cache and reused across request batches, and each
batch runs the paper's hybrid (phase 1 issues source-level morsels under
a learned budget, phase 2 re-dispatches the stragglers), with policy and
scan layout picked per batch and the online learners fed by the served
stream.

Two drivers share that core:

- **Open loop** (the default): a ``runtime.service.ServingLoop`` serves a
  seeded Poisson arrival stream from several tenants, optionally with
  per-query deadlines (``--deadline-ms``) and tenant quotas (``--quota``);
  ``--no-overlap`` pins the strictly serial pipeline. ``--mutate-stream
  N`` interleaves N seeded edge deltas of ``--delta-edges`` inserts and
  deletes, each applied through the loop's version fence.
- **Closed loop** (``--closed-loop``, implied by ``--paths``): one batch at
  a time through ``AdaptiveScheduler.query``.

Both report warm latency percentiles: batches that built a new engine or
ran a new morsel count are cold and reported apart. ``--query-kind``
picks the scenario family every query asks for: ``reach`` (BFS levels),
``topk_paths`` (weighted k-shortest walk lengths; an unweighted dataset
gets seeded weights), ``ppr`` (personalized PageRank mass) or
``pattern_counts`` (2/3-hop walk counts); the non-reach kinds are never
lane-packed.

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset ldbc \\
        --scale 10 --rate 20 --arrivals 60 --mutate-stream 2
    PYTHONPATH=src python -m repro_torch.launch.serve --closed-loop \\
        --dataset ldbc --scale 10 --sources-per-batch 8 --batches 20
    PYTHONPATH=src python -m repro_torch.launch.serve --query-kind ppr \\
        --dataset ldbc --scale 10 --arrivals 20

Runs on ``cuda`` unless ``--device cpu`` is given.

Under torchrun (``WORLD_SIZE`` > 1) every rank serves on the mesh of
the JAX package's ``serve``, ``(1, WORLD_SIZE)`` over ``("data",
"model")``, and holds its own graph shards: rank 0 runs either loop and
prints, ranks > 0 replay its dispatcher calls (``QueryDispatcher.follow``).
The collective backend is NCCL when each rank takes its own card (no
``--device``) and gloo when every rank is given the one ``--device``:
``--device cpu``, or ``--device cuda:0`` for ranks that share one card.
``--mutate-stream`` runs there too: rank 0 builds the seeded deltas and
the followers get each one through the control channel, folding it into
their own shards::

    PYTHONPATH=src torchrun --nproc-per-node 4 \
        -m repro_torch.launch.serve --closed-loop --scale 10 --batches 8
    PYTHONPATH=src torchrun --nproc-per-node 2 \
        -m repro_torch.launch.serve --device cpu --closed-loop --scale 0.1
    PYTHONPATH=src torchrun --nproc-per-node 2 \
        -m repro_torch.launch.serve --device cpu --mutate-stream 2
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from ..core import histogram_lengths, reconstruct_paths
from ..graph.delta import apply_delta_csr, random_delta
from ..graph.generators import (
    PAPER_DATASET_FAMILIES,
    PAPER_DATASETS,
    pick_sources,
)
from ..kernels.common import resolve_device, synchronize
from ..runtime.dispatch import QueryDispatcher
from ..runtime.scheduler import AdaptiveScheduler
from ..runtime.service import ServingLoop
from .mesh import Mesh, as_mesh, init_distributed, make_mesh


class QueryService:
    """Build-once, serve-many recursive query engine pool: a thin façade
    over ``AdaptiveScheduler`` whose ``query`` returns
    ``(IFEResult, policy_name)``."""

    def __init__(self, mesh, csr, max_deg=None, max_iters=64,
                 adaptive=True, backend="recommend",
                 direction_thresholds=None, family=None, online_adapt=True,
                 refit_every=16, cost="auto"):
        self.mesh = as_mesh(mesh)
        self.device = self.mesh.device
        self.csr = csr
        self.max_iters = max_iters
        self.max_deg = max_deg
        self.scheduler = AdaptiveScheduler(
            self.mesh, csr, max_deg=max_deg, max_iters=max_iters,
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


@dataclasses.dataclass
class StreamRecord:
    """One served open-loop stream, as handed to ``on_stream``: the
    drained loop (results, telemetry, delta reports) and the arrival
    schedule it served, deltas included, in time order."""

    loop: ServingLoop
    arrivals: list
    wall_s: float


def _pct(values, p):
    return np.percentile(np.asarray(values), p) if len(values) else float("nan")


def poisson_arrivals(csr, rate_qps: float, n_arrivals: int,
                     sources_per_query: int, tenants: int = 1,
                     deadline_ms: float | None = None, seed: int = 0,
                     query_kind: str = "reach"):
    """Seeded open-loop Poisson schedule for ``ServingLoop.run_stream``:
    exponential inter-arrival gaps at ``rate_qps``, tenants round-robin,
    each query's sources drawn by the closed-loop driver's
    ``pick_sources`` rule."""
    rng = np.random.default_rng(seed)
    gaps_ms = rng.exponential(1e3 / rate_qps, size=n_arrivals)
    t_ms = np.cumsum(gaps_ms)
    return [
        {
            "t_ms": float(t_ms[i]),
            "sources": pick_sources(csr, sources_per_query, seed=100 + i),
            "tenant": f"t{i % tenants}",
            "deadline_ms": deadline_ms,
            "query_kind": query_kind,
        }
        for i in range(n_arrivals)
    ]


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


def open_loop_dispatcher(args, csr, mesh, family) -> QueryDispatcher:
    """The open loop's dispatcher (every rank of a mesh builds the same)."""
    return QueryDispatcher(
        mesh, csr, adaptive=not args.static, backend=args.backend,
        direction_thresholds=args.thresholds, family=family,
        online_adapt=args.online_adapt, refit_every=args.refit_every,
        cost=args.cost_mode, pad_pow2_morsels=True,
    )


def closed_loop_service(args, csr, mesh, family) -> QueryService:
    """The closed loop's service (every rank of a mesh builds the same)."""
    return QueryService(mesh, csr, adaptive=not args.static,
                        backend=args.backend,
                        direction_thresholds=args.thresholds, family=family,
                        online_adapt=args.online_adapt,
                        refit_every=args.refit_every, cost=args.cost_mode)


def run_open_loop(args, csr, mesh, family,
                  on_stream: Callable[[StreamRecord], None] | None = None,
                  on_outcome=None) -> int:
    disp = open_loop_dispatcher(args, csr, mesh, family)
    disp.leading = True  # ranks > 0 replay its calls
    disp.on_finalized = on_outcome
    loop = ServingLoop(
        dispatcher=disp,
        overlap=args.overlap, tenant_quota=args.quota,
        max_batch_sources=args.max_batch_sources,
    )
    arrivals = poisson_arrivals(
        csr, args.rate, args.arrivals, args.sources_per_batch,
        tenants=args.tenants, deadline_ms=args.deadline_ms, seed=1,
        query_kind=args.query_kind,
    )
    if args.mutate_stream:
        # seeded edge-edit batches spread evenly through the schedule;
        # run_stream applies each through the serving fence
        span = arrivals[-1]["t_ms"] if arrivals else 0.0
        cur = csr
        for i in range(args.mutate_stream):
            t_ms = span * (i + 1) / (args.mutate_stream + 1)
            d = random_delta(cur, args.delta_edges, args.delta_edges,
                             seed=500 + i)
            cur = apply_delta_csr(cur, d)  # deletes sample the live graph
            arrivals.append({"t_ms": float(t_ms), "delta": d})
        arrivals.sort(key=lambda a: a["t_ms"])
    print(
        f"open loop: {args.arrivals} Poisson arrivals at {args.rate:.1f} "
        f"q/s across {args.tenants} tenant(s)"
        + (f", deadline {args.deadline_ms:.0f} ms" if args.deadline_ms else "")
        + (f", {args.mutate_stream} interleaved graph delta(s) of "
           f"±{args.delta_edges} edges" if args.mutate_stream else "")
    )
    t0 = time.perf_counter()
    try:
        loop.run_stream(arrivals)
    finally:
        loop.dispatcher.release_followers()
    wall_s = time.perf_counter() - t0
    st = loop.stats
    print(
        f"served {st.completed} queries in {wall_s:.2f} s over "
        f"{st.batches} batches ({st.cold_batches} cold); "
        f"warm p50 {st.p50():.1f} ms, p99 {st.p99():.1f} ms "
        f"(all-in p50 {st.p50(warm=False):.1f} ms, "
        f"p99 {st.p99(warm=False):.1f} ms); "
        f"cold-start {st.cold_ms:.0f} ms excluded from warm percentiles"
    )
    print(
        f"overlap occupancy {st.overlap_occupancy:.2f} "
        f"({st.overlapped_finalizes}/{st.finalizes} finalizes after the "
        f"next batch began); shed {st.shed}, "
        f"deadline misses {st.deadline_misses}, "
        f"evictions {loop.admission.stats.evictions}"
    )
    for name in sorted(st.tenants):
        ts = st.tenants[name]
        print(
            f"  tenant {name}: {ts.completed}/{ts.submitted} served, "
            f"warm p50 {ts.p50():.1f} ms p99 {ts.p99():.1f} ms, "
            f"shed {ts.shed}, misses {ts.deadline_misses}"
        )
    if st.deltas_applied:
        reps = loop.delta_reports
        same = sum(1 for r in reps if r.same_shape)
        inval = sum(r.engines_invalidated for r in reps)
        print(
            f"graph deltas: {st.deltas_applied} applied "
            f"(now version {loop.graph_version}); {same} kept every "
            f"operand shape, {inval} engine(s) invalidated by reshapes; "
            f"apply_delta ms {[round(r.ms, 1) for r in reps]}; final graph "
            f"{loop.dispatcher.csr.n_edges} edges"
        )
        for i, r in enumerate(reps):
            slowest = (f" (slowest rank {r.ms_max:.1f} ms)"
                       if loop.dispatcher.mesh.size > 1 else "")
            print(f"  delta {i}: {r.changed_edges} effective edges changed, "
                  f"{r.structures_changed} structure(s) changed, "
                  f"{r.structures_rebuilt} rebuilt, {r.binned_moves} "
                  f"row(s) re-binned, {r.engines_invalidated} engine(s) "
                  f"invalidated; {r.ms:.1f} ms{slowest}")
    _report_core(loop.dispatcher)
    if on_stream is not None:
        on_stream(StreamRecord(loop, arrivals, wall_s))
    return 0


def run_closed_loop(args, csr, mesh, family,
                    on_batch: Callable[[BatchRecord], None] | None = None,
                    on_outcome=None) -> int:
    svc = closed_loop_service(args, csr, mesh, family)
    svc.scheduler.leading = True  # ranks > 0 replay its calls
    svc.scheduler.on_finalized = on_outcome
    rng = np.random.default_rng(0)
    lat, warm_lat, p1_ms, p2_ms, used = [], [], [], [], {}
    redispatched, cold_ms = 0, 0.0
    cache = svc.scheduler.cache
    try:
        for b in range(args.batches):
            sources = pick_sources(csr, args.sources_per_batch, seed=100 + b)
            compiles0 = cache.compile_events
            t0 = time.perf_counter()
            res, pol = svc.query(sources, returns_paths=args.paths,
                                 policy=args.policy,
                                 query_kind=args.query_kind)
            # a non-reach kind's result is its own leaves (dists / mass /
            # wedges + closed): the sync times the whole state
            if args.query_kind == "reach":
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
    finally:
        svc.scheduler.release_followers()
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
                    help="torch device to serve on (default: cuda, the "
                         "rank's card under torchrun, over NCCL; a device "
                         "given under torchrun is every rank's, over gloo; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--closed-loop", action="store_true",
                    help="one-batch-at-a-time driver (implied by --paths); "
                         "default is the open-loop ServingLoop")
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
                         "evenly through the arrivals, each applied through "
                         "the serving fence")
    ap.add_argument("--delta-edges", type=int, default=64, metavar="M",
                    help="edges added and deleted per --mutate-stream delta")
    ap.add_argument("--query-kind", default="reach",
                    choices=("reach", "topk_paths", "ppr", "pattern_counts"),
                    help="scenario family of every query: 'reach' = BFS "
                         "levels, 'topk_paths' = weighted k-shortest walk "
                         "lengths (seeded weights when the dataset has "
                         "none), 'ppr' = personalized PageRank mass, "
                         "'pattern_counts' = 2/3-hop walk counts")
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
         on_batch: Callable[[BatchRecord], None] | None = None,
         on_stream: Callable[[StreamRecord], None] | None = None,
         on_outcome: Callable[[int, Any], None] | None = None) -> int:
    """Serve from the command line. ``on_batch`` receives each closed-loop
    batch, ``on_stream`` the drained open-loop stream (both on rank 0),
    ``on_outcome`` every rank's finalized batches
    (``QueryDispatcher.on_finalized``)."""
    args = build_parser().parse_args(argv)
    mesh, owned = _serving_mesh(args)
    try:
        return _serve(args, mesh, on_batch, on_stream, on_outcome)
    finally:
        if owned:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serving_mesh(args) -> tuple[Mesh, bool]:
    """The one-rank mesh on ``--device``, or under torchrun (or inside a
    process group already up) JAX ``serve``'s ``(1, WORLD_SIZE)`` mesh
    over ``("data", "model")``; the flag says this call set the process
    group up."""
    import torch.distributed as dist

    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world == 1:
        return as_mesh(resolve_device(args.device)), False
    # one card a rank takes NCCL; ranks given one device (the CPU, or a
    # card they share, which NCCL refuses) take gloo
    backend = "nccl" if args.device is None else "gloo"
    owned = not dist.is_initialized()
    if owned:
        init_distributed(backend)
    device = args.device
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', dist.get_rank()))}"
    return make_mesh((1, world), ("data", "model"), device), owned


def _serve(args, mesh: Mesh, on_batch, on_stream, on_outcome) -> int:
    device = mesh.device
    csr = PAPER_DATASETS[args.dataset](args.scale)
    if args.query_kind == "topk_paths" and csr.weights is None:
        # the k-shortest relax needs weights; the proxy datasets have
        # none, so they get JAX's seeded uniform weighting
        rng = np.random.default_rng(7)
        csr = dataclasses.replace(
            csr,
            weights=rng.uniform(0.1, 2.0, csr.n_edges).astype(np.float32),
        )
    family = PAPER_DATASET_FAMILIES.get(args.dataset)
    closed = args.closed_loop or args.paths
    if mesh.rank > 0:
        # a follower: the same dispatcher, driven by rank 0's calls
        disp = (closed_loop_service(args, csr, mesh, family).scheduler
                if closed else open_loop_dispatcher(args, csr, mesh, family))
        disp.on_finalized = on_outcome
        disp.follow()
        return 0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ranks = (f" x {mesh.size} ranks ({mesh.backend})" if mesh.size > 1
             else "")
    print(
        f"serving {args.dataset} proxy on {name}{ranks}: {csr.n_nodes} "
        f"nodes, {csr.n_edges} edges, avg degree {csr.avg_degree:.0f}"
    )
    if closed:
        return run_closed_loop(args, csr, mesh, family, on_batch=on_batch,
                               on_outcome=on_outcome)
    return run_open_loop(args, csr, mesh, family, on_stream=on_stream,
                         on_outcome=on_outcome)


if __name__ == "__main__":
    raise SystemExit(main())
