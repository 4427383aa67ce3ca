"""Dispatch layer of the serving core: engine cache + two-phase hybrid
(port of ``repro.runtime.dispatch`` on a mesh of ranks or one device).

``QueryDispatcher`` executes one batch of source nodes: the engine cache,
the paper's two-phase hybrid (nTkS phase 1 under a learned budget,
gang-scheduled phase-2 re-dispatch of the survivors), backend
recommendation and the online learners (per-bucket budget model and
in-flight direction-threshold refits). The split-phase surface is kept:

- ``begin_batch`` plans the batch on the calling thread and hands phase 1
  (or the static engine) to the dispatcher's phase-1 worker, then returns
  with it in flight, as JAX's asynchronous dispatch does;
- ``settle_batch`` joins phase 1, takes the survivors, resumes them
  (phase 2), runs the post-batch learning and returns a ``SettledBatch``;
- ``finalize_batch`` stitches the phase-2 survivors back over the
  phase-1 state.

**The phase-1 worker.** The port's engines read their loop condition on
the host every iteration, so an engine call blocks its thread until the
morsels converge. One daemon thread per dispatcher, started at the first
``begin_batch``, runs those calls one at a time in submission order; on a
CUDA device it runs them on a stream of its own. At submit the worker's
stream waits on an event recorded on the caller's stream (the morsels and
the operands are in place); at the end of phase 1 it records an event that
the caller's stream waits on when the batch is joined, before any output
is read, and the outputs are marked as used on the caller's stream for
the caching allocator. The two events also keep ``binned_pull``'s shared
hub counters and partials ordered between phase 1 and phase 2. An error
raised in phase 1 re-raises where the batch is joined, with its
traceback; nothing runs phase 1 again on the calling thread. Everything
else stays on the calling thread: planning, the engine cache, phase 2,
learning and the stitch, so ``settle(i)`` still precedes ``begin(i+1)``.

**One thread per process group at a time.** Phase 1 runs collectives over
the mesh's axis groups. Every dispatcher call that issues collectives on
those groups, or replaces operands, while a batch is in flight joins
phase 1 first: ``settle_batch``, ``apply_delta``, ``release_followers``
and ``query``. The control channel (``_bcast``, the default group) and
the stitch do not join: the axis groups are process groups of their own
(``launch.mesh.Mesh``), so a leader's broadcast and a follower's
``follow`` loop run beside the worker's collectives.

What differs from the JAX package:

- ``compile_events`` counts first builds of an engine key and first
  morsel counts per key: the port compiles no program per shape, but the
  serving driver's warm/cold split keys off the same counter;
- ``cost="auto"`` means "measured" (``BackendCostProbe`` with CUDA
  events) on a CUDA device and "slots" on the CPU;
- ``recommend_policy``'s memory bound reads the CUDA device's
  ``total_memory`` (16 GiB, the JAX default, on the CPU);
- operand bundles are keyed on the extension spec and the policy's
  graph axes of size above 1 (on one device the spec alone), so a
  dispatcher may hold fewer bundles than JAX's and fold a delta into
  fewer of them;
- ``apply_delta`` places each changed structure as new tensors (a copy,
  also on the CPU) and times itself (``DeltaReport.ms``, and the slowest
  rank's ``ms_max``). On a mesh each rank folds a sharded bundle into its
  own shard only (``graph.delta.RankShard``): the rebuild decisions are
  OR'd over the ranks sharing the bundle, so epochs and engine
  invalidations move together, and the report is reduced over them
  (``changed`` OR'd, ``binned_moves`` summed) into the same
  ``DeltaReport`` on every rank;
- on a mesh of ranks every rank runs its own dispatcher over its own
  shards, either all making the same calls (SPMD, as the tests do) or
  with rank 0 leading (``leading=True``, as ``serve`` runs it): each
  ``begin_batch`` / ``settle_batch`` / finalize / ``apply_delta`` it
  runs is first broadcast, and ranks > 0 replay them in order in
  ``follow`` until
  ``release_followers``. Every decision that
  picks a collective is the same on every rank: plans and learners feed
  only on global values (gathered iteration counts, stats summed over
  the graph axes), and measured cost rates are taken on rank 0 and
  broadcast.

Graph mutation: ``apply_delta`` folds a ``GraphDelta`` into a writable
host mirror of every cached bundle (``graph.delta.fold_operands``) and
re-places only the structures whose content changed. ``EngineKey`` carries
the shape epoch of the structures an engine scans, so a same-shape delta
leaves the cache warm and a reshaping one invalidates exactly the stale
keys. A batch pins its operands and epochs when it begins, so a delta that
lands while it is in flight never tears it across graph versions.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..core import (
    POLICIES,
    QUERY_KINDS,
    BackendCostProbe,
    BudgetModel,
    DirectionThresholds,
    ExtendSpec,
    IFEResult,
    MorselPolicy,
    as_spec,
    build_engine,
    build_gang_resume_engine,
    build_resume_engine,
    count_budget_mispredicts,
    degree_bucket,
    fit_direction_thresholds,
    gang_scatter_back,
    hybrid_phases,
    pad_sources,
    pow2ceil as _pow2ceil,
    prepare_graph,
    recommend_backend,
    recommend_k,
    recommend_policy,
)
from ..core.collectives import any_over, gang_handoff, max_allreduce, psum
from ..core.extend import GraphOperands, effective_csr
from ..graph.csr import CSRGraph
from ..graph.delta import (
    STRUCTURES,
    DeltaReport,
    FoldReport,
    GraphDelta,
    RankShard,
    apply_delta_csr,
    diff_effective,
    fold_operands,
)
from ..kernels.common import map_tensors, synchronize
from ..launch.mesh import as_mesh


def _bcast(obj):
    """Rank 0's ``obj`` on every rank (the control channel of a mesh)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]

#: device memory ``recommend_policy`` assumes off the card (the JAX default)
DEFAULT_HBM_BYTES = 16 * 2**30


@dataclasses.dataclass(frozen=True)
class EngineKey:
    """Cache identity of one engine: ``kind`` is "static", "phase1",
    "resume" or "gang"; ``extend`` the backend and direction mode;
    ``stats`` marks the sample-tapped flavor.

    ``operands_epoch`` is the shape generation of the structures the
    engine scans: a delta folded in place leaves it alone (the engine
    stays warm and is handed the new tensors at call time), a delta that
    rebuilds a structure with new shapes bumps it, so stale keys are
    invalidated. It is deliberately not the ``operands_version``: keying
    on the version would make every delta cold."""

    kind: str
    policy: MorselPolicy
    edge_compute: str
    n_nodes_padded: int
    max_iters: int
    state_layout: str
    extend: ExtendSpec = ExtendSpec()
    stats: bool = False
    operands_epoch: int = 0


class EngineCache:
    """Engine cache: bounded LRU with hit/miss accounting per engine kind
    and a ledger of the morsel counts each engine has run with.

    ``compile_events`` = builds + first-seen (engine, morsel count) pairs:
    the serving driver classifies a batch that raised it as cold. The
    mapping surface (``len``, ``iter``, ``in``, ``keys``, ``items``,
    ``get``, ``count_by_kind``) is public; ``invalidate`` drops the keys a
    reshaping graph delta made stale."""

    DEFAULT_MAX_ENTRIES = 128

    def __init__(self, max_entries: int | None = DEFAULT_MAX_ENTRIES):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1: {max_entries}")
        self.max_entries = max_entries
        self._engines: collections.OrderedDict[EngineKey, Any] = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.hits_by_kind: collections.Counter = collections.Counter()
        self.misses_by_kind: collections.Counter = collections.Counter()
        self._shapes: dict[EngineKey, set] = {}
        self.shape_misses = 0
        self.evictions = 0
        self.invalidations = 0  # entries dropped by invalidate()

    @property
    def compile_events(self) -> int:
        return self.misses + self.shape_misses

    def note_shape(self, key: EngineKey, shape) -> bool:
        """Record that ``key``'s engine runs with input ``shape``; True
        (and a ``shape_miss``) the first time the pair is seen."""
        seen = self._shapes.setdefault(key, set())
        if shape in seen:
            return False
        seen.add(shape)
        self.shape_misses += 1
        return True

    def __len__(self) -> int:
        return len(self._engines)

    def __iter__(self):
        return iter(self._engines)

    def __contains__(self, key: EngineKey) -> bool:
        return key in self._engines

    def keys(self):
        """The cached ``EngineKey``s, in build order."""
        return self._engines.keys()

    def items(self):
        """(EngineKey, engine) pairs, in build order."""
        return self._engines.items()

    def get(self, key: EngineKey, default=None):
        """Cached engine for ``key`` (no hit/miss accounting, no build)."""
        return self._engines.get(key, default)

    def count_by_kind(self, kind: str) -> int:
        """How many engines of one ``EngineKey.kind`` are cached."""
        return sum(1 for k in self._engines if k.kind == kind)

    def get_or_build(self, key: EngineKey, builder: Callable[[], Any]):
        kind = key.kind
        eng = self._engines.get(key)
        if eng is not None:
            self.hits += 1
            self.hits_by_kind[kind] += 1
            self._engines.move_to_end(key)
            return eng
        self.misses += 1
        self.misses_by_kind[kind] += 1
        eng = builder()
        self._engines[key] = eng
        if (
            self.max_entries is not None
            and len(self._engines) > self.max_entries
        ):
            old_key, _ = self._engines.popitem(last=False)
            self._shapes.pop(old_key, None)
            self.evictions += 1
        return eng

    def invalidate(self, predicate: Callable[[EngineKey], bool]) -> int:
        """Drop every cached engine whose key matches ``predicate`` (and
        its shape ledger); returns how many went. A later request for one
        of them is a fresh miss with fresh shape misses."""
        stale = [k for k in self._engines if predicate(k)]
        for k in stale:
            del self._engines[k]
            self._shapes.pop(k, None)
        self.invalidations += len(stale)
        return len(stale)


@dataclasses.dataclass
class QueryOutcome:
    """One served batch: result plus how the runtime executed it
    (``redispatched == resumed_ganged + resumed_serial``; the ``budget_*``
    counters classify the real morsels against the phase-1 budget)."""

    result: IFEResult
    policy: str
    hybrid: bool
    redispatched: int
    phase_ms: dict
    phase1_budget: int
    resumed_ganged: int = 0
    resumed_serial: int = 0
    gang_width: int = 0
    budget_too_low: int = 0
    budget_too_high: int = 0
    budget_inert_slots: int = 0
    budget_observed: int = 0


@dataclasses.dataclass
class SchedulerStats:
    """Cumulative runtime counters across every served batch."""

    queries: int = 0
    hybrid_runs: int = 0
    redispatched: int = 0
    resumed_ganged: int = 0
    resumed_serial: int = 0
    gangs: int = 0
    gang_slots: int = 0
    phase1_ms: float = 0.0
    phase2_ms: float = 0.0
    budget_too_low: int = 0
    budget_too_high: int = 0
    budget_inert_slots: int = 0
    budget_observed: int = 0
    refits: int = 0
    deltas: int = 0  # GraphDeltas applied (apply_delta calls)

    @property
    def gang_occupancy(self) -> float:
        return self.resumed_ganged / self.gang_slots if self.gang_slots else 0.0

    @property
    def budget_mispredict_rate(self) -> float:
        if not self.budget_observed:
            return 0.0
        return (self.budget_too_low + self.budget_too_high) / (
            self.budget_observed
        )

    def record(self, outcome: QueryOutcome) -> None:
        self.queries += 1
        if outcome.hybrid:
            self.hybrid_runs += 1
        self.redispatched += outcome.redispatched
        self.resumed_ganged += outcome.resumed_ganged
        self.resumed_serial += outcome.resumed_serial
        self.phase1_ms += outcome.phase_ms.get("phase1", 0.0)
        self.phase2_ms += outcome.phase_ms.get("phase2", 0.0)
        self.budget_too_low += outcome.budget_too_low
        self.budget_too_high += outcome.budget_too_high
        self.budget_inert_slots += outcome.budget_inert_slots
        self.budget_observed += outcome.budget_observed


@dataclasses.dataclass
class OperandBundle:
    """One device-placed operand bundle and its mutation bookkeeping.

    ``version`` is the ``operands_version`` the tensors hold; ``epochs``
    counts, per structure slot, the deltas that rebuilt it with new shapes
    (``EngineKey.operands_epoch`` derives from them); ``host`` is the
    writable CPU mirror deltas fold into, made by the first delta (a copy
    of the device tensors, never the tensors themselves). Iterates as
    ``(ops, n_pad)``."""

    ops: GraphOperands
    n_pad: int
    version: int = 0
    epochs: dict = dataclasses.field(default_factory=dict)
    host: Any = None

    def __iter__(self):
        return iter((self.ops, self.n_pad))


@dataclasses.dataclass
class InflightBatch:
    """A planned batch whose phase 1 (or static engine) is in flight on
    the phase-1 worker (``payload["phase1"]``, a ``Future``);
    ``kind`` routes ``settle_batch``: "hybrid", "static" or "chunked"
    (an oversized batch run as a chunk loop at settle time: nothing is in
    flight)."""

    kind: str
    name: str
    n_real: int
    buckets: np.ndarray
    payload: Any
    seq: int = 0  # the batch's number on the mesh's control channel


@dataclasses.dataclass
class SettledBatch:
    """A batch past its sync points and learning; ``finalize()``
    (idempotent) runs the deferred state stitch."""

    outcome: QueryOutcome
    _materialize: Callable[[], IFEResult] | None = None
    seq: int = 0  # the batch's number on the mesh's control channel
    _on_finalize: Callable[[], None] | None = None
    _on_done: Callable[[int, QueryOutcome], None] | None = None

    @property
    def finalized(self) -> bool:
        return self._materialize is None

    def finalize(self) -> QueryOutcome:
        if self._on_finalize is not None:
            self._on_finalize()
            self._on_finalize = None
        if self._materialize is not None:
            self.outcome.result = self._materialize()
            self._materialize = None
        if self._on_done is not None:
            done, self._on_done = self._on_done, None
            done(self.seq, self.outcome)
        return self.outcome


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class _Phase1Worker:
    """The dispatcher's phase-1 thread (module docstring): ``submit``
    queues one engine call and returns a ``Future`` of ``(output, event
    recorded on the worker's stream or None)``. The thread holds only its
    queue, so it ends once the owning dispatcher is gone; it is a daemon
    and never keeps the process alive."""

    def __init__(self, device: torch.device):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        threading.Thread(target=_phase1_loop, args=(self._jobs, device),
                         name="phase1", daemon=True).start()
        weakref.finalize(self, self._jobs.put, None)

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        ready = (torch.cuda.current_stream(self.device).record_event()
                 if self.device.type == "cuda" else None)
        self._jobs.put((fut, ready, fn, args))
        return fut


def _phase1_loop(jobs: queue.SimpleQueue, device: torch.device) -> None:
    stream = None
    if device.type == "cuda":
        torch.cuda.set_device(device)
        stream = torch.cuda.Stream(device)
    while True:
        job = jobs.get()
        if job is None:
            return
        _phase1_job(stream, *job)
        del job  # an idle thread pins no batch


def _phase1_job(stream, fut: Future, ready, fn, args) -> None:
    """One engine call on the worker, the ``dispatch.phase1`` span."""
    try:
        if stream is None:
            with trace.span("dispatch.phase1"):
                out, done = fn(*args), None
        else:
            with torch.cuda.stream(stream):
                stream.wait_event(ready)
                with trace.span("dispatch.phase1"):
                    out = fn(*args)
                    done = stream.record_event()
    except BaseException as e:
        # handed to the future, which re-raises it where the batch is
        # joined (as concurrent.futures' own workers do): a join never
        # waits on a future left unresolved
        fut.set_exception(e)
    else:
        fut.set_result((out, done))


def _used_on(t: torch.Tensor, stream) -> torch.Tensor:
    if t.is_cuda:
        t.record_stream(stream)
    return t


def _take_padded(x: torch.Tensor, idx: torch.Tensor, rows: int):
    """``x[idx]`` padded with all-zero rows to ``rows`` (inert members)."""
    out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[: idx.numel()] = x[idx]
    return out


class QueryDispatcher:
    """Build-once, serve-many execution layer over one graph on a mesh of
    ranks (a bare device is the one-rank mesh). The execution and
    learning contract is the JAX package's:
    ``adaptive`` enables the two-phase hybrid for policies with source
    morsels, ``gang_resume=False`` pins the serial phase-2 resume,
    ``online_adapt`` turns on the per-bucket budget model and the
    threshold refits, all bit-identical in result state."""

    def __init__(
        self,
        mesh,
        csr: CSRGraph,
        max_deg: int | None = None,
        max_iters: int = 64,
        adaptive: bool = True,
        phase1_iters: int | None = None,
        max_inflight: int | None = None,
        backend="recommend",
        direction_thresholds: DirectionThresholds | str | Path | None = None,
        family: str | None = None,
        gang_resume: bool = True,
        online_adapt: bool = True,
        budget_model: BudgetModel | None = None,
        refit_every: int = 16,
        sample_window: int = 2048,
        pad_pow2_morsels: bool = False,
        cost: str = "auto",
    ):
        self.mesh = as_mesh(mesh)
        self.device = self.mesh.device
        self.csr = csr
        self.max_deg = max_deg
        self.max_iters = max_iters
        self.adaptive = adaptive
        self.phase1_iters = phase1_iters
        self.max_inflight = max_inflight
        self.backend = backend
        if isinstance(direction_thresholds, (str, Path)):
            direction_thresholds = fit_direction_thresholds(
                direction_thresholds
            )
        self.direction_thresholds = direction_thresholds
        self._thresholds_pinned = direction_thresholds is not None
        self.family = family
        self.gang_resume = gang_resume
        self.online_adapt = online_adapt
        self.budget_model = (
            budget_model
            if budget_model is not None
            else (BudgetModel() if online_adapt else None)
        )
        self.refit_every = max(1, int(refit_every))
        self.pad_pow2_morsels = pad_pow2_morsels
        if cost == "auto":
            cost = "measured" if self.device.type == "cuda" else "slots"
        if cost not in ("slots", "measured"):
            raise ValueError(f"unknown cost mode: {cost!r}")
        self.cost_mode = cost
        self.hbm_bytes = (
            torch.cuda.get_device_properties(self.device).total_memory
            if self.device.type == "cuda" else DEFAULT_HBM_BYTES
        )
        self.cost_probe = BackendCostProbe()
        self._cost_rates: dict[int, dict] = {}
        self.stats = SchedulerStats()
        self.cache = EngineCache()
        self._graphs: dict[tuple, OperandBundle] = {}
        # graph-mutation counter, bumped by every apply_delta
        self.operands_version = 0
        self._iter_p90s: collections.deque = collections.deque(maxlen=32)
        self._dir_samples: dict[int, collections.deque] = {}
        self._sample_window = int(sample_window)
        self._batches_since_refit = 0
        self._seq = 0  # batches begun (the control channel's numbering)
        # rank 0 broadcasts its calls to followers (``serve``'s mode)
        self.leading = False
        # called with (seq, outcome) as each batch is finalized, on every
        # rank (a follower's replays included)
        self.on_finalized: Callable[[int, QueryOutcome], None] | None = None
        self._worker: _Phase1Worker | None = None  # started at first use
        self._inflight: Future | None = None  # the last phase 1 submitted

    # ------------------------------------------------------ phase-1 worker

    def _submit_phase1(self, engine, *args) -> Future:
        """Queue one engine call on the phase-1 worker."""
        if self._worker is None:
            self._worker = _Phase1Worker(self.device)
        self._inflight = self._worker.submit(engine, *args)
        return self._inflight

    def _await(self, phase1: Future):
        """``phase1``'s output once it has finished (its error re-raised
        here): the caller's stream waits on its end and the outputs are
        marked as used on that stream. The wait is the ``dispatch.join``
        span."""
        if self._inflight is phase1:
            self._inflight = None
        with trace.span("dispatch.join"):
            out, done = phase1.result()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            map_tensors(lambda t: _used_on(t, stream), out)
        return out

    def _join(self) -> None:
        """Wait for every phase 1 submitted (the worker runs them in
        order): the rule of the module docstring."""
        if self._inflight is not None:
            self._await(self._inflight)

    # ------------------------------------------------------- rank 0 leads

    @property
    def leads(self) -> bool:
        """Rank 0 of a mesh of several ranks, set ``leading``: its calls
        are broadcast to the followers."""
        return self.leading and self.mesh.size > 1 and self.mesh.rank == 0

    def follow(self) -> int:
        """Ranks > 0: replay rank 0's dispatcher calls, in order, until it
        calls ``release_followers``; returns the batches replayed."""
        if self.mesh.size == 1 or self.mesh.rank == 0:
            raise RuntimeError("only ranks > 0 of a mesh follow")
        pending, n = {}, 0
        while True:
            op, seq, kw = _bcast(None)
            if op == "stop":
                return n
            if op == "begin":
                pending[seq] = self.begin_batch(**kw)
                n += 1
            elif op == "settle":
                pending[seq] = self.settle_batch(pending.pop(seq))
            elif op == "finalize":
                pending.pop(seq).finalize()
            elif op == "delta":
                self.apply_delta(kw["delta"])
            else:
                raise RuntimeError(f"unknown control message {op!r}")

    def release_followers(self) -> None:
        """Rank 0: let every follower's ``follow`` return."""
        self._join()
        if self.leads:
            _bcast(("stop", 0, {}))

    # ------------------------------------------------------------- engines

    def _bundle_key(self, policy: MorselPolicy, spec: ExtendSpec) -> tuple:
        # the shard layout depends on the graph axes that split the graph
        split = tuple(a for a in policy.graph_axes
                      if self.mesh.shape.get(a, 1) > 1)
        return (
            split,
            spec.needs_rev,
            spec.needs_binned,
            spec.needs_binned_pack,
            spec.needs_blocks,
            spec.pad_block,
        )

    def _graph_for(
        self, policy: MorselPolicy, spec: ExtendSpec = ExtendSpec()
    ) -> OperandBundle:
        """This rank's operand bundle for ``spec`` under ``policy``'s
        graph split, built once and shared by every spec needing the same
        structures and split. Rows pad for ``mesh.size`` shards, so every
        policy's bundle has one ``n_pad`` and phase-1 state resumes on the
        phase-2 graph unchanged. A delta folds into the shared bundle
        once; a batch in flight keeps the ``(ops, epoch)`` it resolved at
        begin time."""
        key = self._bundle_key(policy, spec)
        if key not in self._graphs:
            ops, n_pad = prepare_graph(
                self.csr, self.mesh, policy, self.max_deg, extend=spec,
                pad_shards=self.mesh.size,
            )
            self._graphs[key] = OperandBundle(
                ops=ops, n_pad=n_pad, version=self.operands_version,
            )
        return self._graphs[key]

    def _spec_epoch(self, bundle: OperandBundle, spec: ExtendSpec) -> int:
        """The shape generation of the structures ``spec`` scans out of
        ``bundle``: the max epoch over exactly those structures, so a
        rebuild of the blocks does not invalidate push engines sharing the
        bundle."""
        e = bundle.epochs
        v = e.get("fwd", 0)
        if spec.needs_rev:
            v = max(v, e.get("rev", 0))
        if spec.needs_binned:
            v = max(v, e.get("rev_binned", 0))
        if spec.needs_binned_pack:
            v = max(v, e.get("rev_binned_pack", 0))
        if spec.needs_blocks:
            v = max(v, e.get("blocks", 0))
        return v

    # ------------------------------------------------------- graph mutation

    def apply_delta(self, delta: GraphDelta) -> DeltaReport:
        """Mutate the served graph: fold ``delta`` into every cached
        operand bundle instead of rebuilding it.

        Per bundle only the structures whose content changed are placed
        anew (untouched device tensors are kept), and only structures
        whose shapes changed (a row overflowed its ELL width, a degree left
        every bucket's range, a new tile found no free slot) bump their
        epoch: a same-shape delta leaves every engine warm and
        ``cache.compile_events`` flat, a reshaping one invalidates exactly
        the keys of engines scanning a rebuilt structure. Batches planned
        after this call see the new graph; batches in flight keep the
        tensors they pinned at begin time. On a mesh every rank calls it
        (SPMD, or rank 0 leading and the followers replaying it). A phase 1
        in flight is joined first: the fold's collectives run over its
        process groups."""
        self._join()
        if self.leads:
            _bcast(("delta", self.operands_version, {"delta": delta}))
        t0 = time.perf_counter()
        wire0 = self.mesh.wire.bytes
        new_csr = apply_delta_csr(self.csr, delta)
        old_eff = effective_csr(self.csr, self.max_deg)
        new_eff = effective_csr(new_csr, self.max_deg)
        diff = diff_effective(old_eff, new_eff, delta)
        self.operands_version += 1
        folds = []
        for key, bundle in self._graphs.items():
            if bundle.host is None:
                # the first delta against this bundle: one copy to the
                # host, reused by every later fold
                bundle.host = map_tensors(
                    lambda t: t.detach().to("cpu", copy=True), bundle.ops
                )
            rep = self._fold_bundle(key, bundle, old_eff, new_eff, diff)
            bundle.version = self.operands_version
            for s, r in rep.reshaped.items():
                if r:
                    bundle.epochs[s] = bundle.epochs.get(s, 0) + 1
            folds.append((key, rep))
        self.csr = new_csr
        # stale-state sweep: measured cost rates were taken on the old
        # operands, and the learners are keyed to the old degree buckets
        self._cost_rates.clear()
        self.invalidate_learned_state()
        invalidated = self.cache.invalidate(self._engine_stale)
        self.stats.deltas += 1
        synchronize(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        wire_bytes = self.mesh.wire.bytes - wire0
        ms_max = ms
        if self.mesh.size > 1:
            every = self.mesh.axes(self.mesh.axis_names)
            ms_max = float(max_allreduce(torch.tensor(
                [ms], dtype=torch.float64, device=self.mesh.wire_device),
                every)[0])
        return DeltaReport(
            version=self.operands_version,
            n_adds=delta.n_adds,
            n_dels=delta.n_dels,
            changed_edges=diff.n_changed_edges,
            dirty_fwd_rows=int(len(diff.fwd_dirty)),
            dirty_rev_rows=int(len(diff.rev_dirty)),
            bundles=len(self._graphs),
            structures_changed=sum(r.n_changed for _, r in folds),
            structures_rebuilt=sum(r.n_reshaped for _, r in folds),
            binned_moves=sum(r.binned_moves for _, r in folds),
            engines_invalidated=invalidated,
            ms=ms,
            ms_max=ms_max,
            wire_bytes=wire_bytes,
            folds=tuple(folds),
        )

    def _fold_bundle(self, key, bundle: OperandBundle, old_eff, new_eff,
                     diff) -> FoldReport:
        """Fold one bundle's host mirror, place what changed and return
        the bundle's report, the same on every rank. A bundle split over
        graph axes of the mesh holds this rank's shard: the fold agrees
        its rebuilds over those axes, and ``changed`` and the moves are
        reduced over them."""
        split = self.mesh.axes(key[0])
        shard = None
        if split.size > 1:
            shard = RankShard(split.index(), split.size, bundle.n_pad)
        structs, rep = fold_operands(
            bundle.host, old_eff, new_eff, diff, shard=shard,
            agree=lambda flag: any_over(flag, split))
        bundle.host = GraphOperands(**structs)
        bundle.ops = self._place_structures(bundle, rep)
        if shard is None:
            return rep
        counts = psum(torch.tensor(
            [int(rep.changed[s]) for s in STRUCTURES] + [rep.binned_moves],
            dtype=torch.int64, device=self.mesh.wire_device), split).tolist()
        return FoldReport(
            changed={s: c > 0 for s, c in zip(STRUCTURES, counts)},
            reshaped=rep.reshaped, binned_moves=int(counts[-1]))

    def invalidate_learned_state(self) -> None:
        """Reset the online learners whose keys or samples embed the old
        degree distribution: the per-bucket budget windows, the global-p90
        fallback, the direction samples and the refitted threshold table
        (a table the caller pinned stays). Part of ``apply_delta``'s
        fence."""
        if self.budget_model is not None:
            self.budget_model.reset()
        self._iter_p90s.clear()
        self._dir_samples.clear()
        self._batches_since_refit = 0
        if not self._thresholds_pinned:
            self.direction_thresholds = None

    def _place_structures(self, bundle: OperandBundle, rep) -> GraphOperands:
        """Place exactly the structures a fold changed (on a mesh: in this
        rank's shard), each as new tensors copied from the host mirror
        (also on the CPU: the next fold writes the mirror, and a batch in
        flight may still read the old tensors); unchanged structures keep
        their tensors. A new ``BinnedPullPack`` builds its own launch
        record."""
        dev = self.device
        old, host = bundle.ops, bundle.host
        pick = {
            name: (
                map_tensors(lambda t: t.to(dev, copy=True),
                            getattr(host, name))
                if rep.changed[name] else getattr(old, name)
            )
            for name in STRUCTURES
        }
        return GraphOperands(**pick)

    def _engine_stale(self, key: EngineKey) -> bool:
        """True when ``key`` was keyed on shapes an applied delta has
        since rebuilt."""
        bundle = self._graphs.get(self._bundle_key(key.policy, key.extend))
        if bundle is None:
            return False
        return key.operands_epoch != self._spec_epoch(bundle, key.extend)

    def engine(
        self,
        kind: str,
        policy: MorselPolicy,
        edge_compute: str,
        n_pad: int,
        max_iters: int | None = None,
        state_layout: str = "replicated",
        extend: ExtendSpec = ExtendSpec(),
        collect_stats: bool = False,
        morsel_shape=None,
        epoch: int = 0,
    ):
        """The cached engine of one key; ``epoch`` is the shape epoch of
        the operands the caller resolved for it (``_spec_epoch``)."""
        cap = int(max_iters if max_iters is not None else self.max_iters)
        key = EngineKey(kind, policy, edge_compute, n_pad, cap, state_layout,
                        extend, collect_stats, int(epoch))
        mesh = self.mesh
        if kind == "static":
            builder = lambda: build_engine(
                mesh, policy, edge_compute, n_pad, cap,
                state_layout=state_layout, extend=extend,
                collect_stats=collect_stats,
            )
        elif kind == "phase1":
            builder = lambda: build_engine(
                mesh, policy, edge_compute, n_pad, cap,
                state_layout=state_layout, sync="shard", extend=extend,
                collect_stats=collect_stats,
            )
        elif kind == "resume":
            builder = lambda: build_resume_engine(
                mesh, policy, edge_compute, n_pad, cap, extend=extend,
                collect_stats=collect_stats,
            )
        elif kind == "gang":
            builder = lambda: build_gang_resume_engine(
                mesh, policy, edge_compute, n_pad, cap, extend=extend,
                state_layout=state_layout, collect_stats=collect_stats,
            )
        else:
            raise ValueError(f"unknown engine kind: {kind}")
        eng = self.cache.get_or_build(key, builder)
        if morsel_shape is not None:
            self.cache.note_shape(key, tuple(morsel_shape))
        return eng

    # ------------------------------------------------------------ dispatch

    def _phase1_budget(self, buckets=()) -> int:
        """Phase-1 iteration cap: a pinned ``phase1_iters``, else the
        budget model's covering budget for ``buckets``, else the pow2 of
        the recent global p90, else the cold budget."""
        if self.phase1_iters is not None:
            return max(1, min(self.phase1_iters, self.max_iters))
        if self.budget_model is not None:
            b = self.budget_model.budget_for(
                self.family, buckets, self.max_iters
            )
            if b is not None:
                return b
        if self._iter_p90s:
            b = _pow2ceil(int(np.median(self._iter_p90s)) + 1)
        else:
            b = (
                self.budget_model.cold_budget
                if self.budget_model is not None
                else 8
            )
        return max(4, min(b, self.max_iters))

    def _record_iters(self, iters: np.ndarray):
        if iters.size:
            self._iter_p90s.append(float(np.percentile(iters, 90)))

    def _morsel_buckets(self, sources: np.ndarray, lanes: int) -> np.ndarray:
        """pow2 source-degree bucket per real morsel (the budget model's
        key)."""
        if len(sources) == 0:
            return np.zeros(0, np.int64)
        deg = self.csr.degrees[
            np.clip(sources, 0, self.csr.n_nodes - 1)
        ].astype(np.float64)
        n_m = -(-len(sources) // lanes)
        pad = np.full(n_m * lanes - len(sources), np.nan)
        mean = np.nanmean(
            np.concatenate([deg, pad]).reshape(n_m, lanes), axis=1
        )
        return np.asarray([degree_bucket(float(m)) for m in mean], np.int64)

    def depth_hint(self, sources, lanes: int = 1) -> int | None:
        """Predicted convergence depth of a prospective batch (None before
        anything was learned)."""
        if self.budget_model is None or len(sources) == 0:
            return None
        buckets = self._morsel_buckets(
            np.asarray(sources, np.int64).reshape(-1), lanes
        )
        return self.budget_model.budget_for(
            self.family, buckets, self.max_iters
        )

    # ---------------------------------------------------- online adaptation

    def _record_samples(self, stats: np.ndarray, trips: np.ndarray,
                        n_pad: int, push_slots: int,
                        start: np.ndarray | None = None,
                        phase: int = 1) -> None:
        """One fit-consumable record per (real morsel, iteration) of a
        stats-tap buffer; ``start`` is each morsel's first recorded row."""
        store = self._dir_samples.setdefault(
            int(n_pad), collections.deque(maxlen=self._sample_window)
        )
        for i in range(stats.shape[0]):
            j0 = int(start[i]) if start is not None else 0
            for j in range(j0, int(trips[i])):
                n_f, m_f, m_u, pull, _wall, pbytes = (
                    float(v) for v in stats[i, j]
                )
                store.append({
                    "it": j,
                    "phase": phase,
                    "frontier": n_f,
                    "m_frontier": m_f,
                    "m_unexplored": m_u,
                    "push_slots": float(push_slots),
                    "pull_slots_binned": None if pull < 0 else pull,
                    "pull_bytes_binned": None if pbytes < 0 else pbytes,
                })

    def _rates_for(self, n_pad: int) -> dict:
        """Measured per-backend ms/slot rates for ``n_pad``, probed on
        first use and kept for the dispatcher's life."""
        if n_pad in self._cost_rates:
            return self._cost_rates[n_pad]
        if self.mesh.size > 1:
            # each rank's timings differ: rank 0 measures its shard and
            # every rank plans with its rates
            rates = self._probe_rates(n_pad) if self.mesh.rank == 0 else None
            rates = self._cost_rates[n_pad] = _bcast(rates)
            return rates
        rates = self._cost_rates[n_pad] = self._probe_rates(n_pad)
        return rates

    def _probe_rates(self, n_pad: int) -> dict:
        best = None
        score = lambda o: (
            (o.rev_binned is not None) + (o.rev_binned_pack is not None)
        )
        for ops, npad in self._graphs.values():
            if int(npad) == int(n_pad) and (
                best is None or score(ops) > score(best)
            ):
                best = ops
        return {} if best is None else self.cost_probe.rates(best, int(n_pad))

    def online_trace(self, cost: str | None = None) -> dict:
        """The accumulated live samples as a ``BENCH_direction_opt``-shaped
        document, the input of ``fit_direction_thresholds``."""
        c = self.cost_mode if cost is None else cost
        workloads = []
        for n_pad, recs in sorted(self._dir_samples.items()):
            records = [dict(r) for r in recs]
            if c == "measured":
                rates = self._rates_for(n_pad)
                pr = rates.get("ell_push", {}).get("ms_per_slot")
                br = rates.get("pull_binned", {}).get("ms_per_slot")
                fr = rates.get("pull_binned_fused", {}).get("ms_per_slot")
                for r in records:
                    ps = r.get("pull_slots_binned")
                    r["push_wall_ms"] = (
                        None if pr is None else pr * r["push_slots"]
                    )
                    r["pull_wall_ms_binned"] = (
                        None if (br is None or ps is None) else br * ps
                    )
                    r["pull_wall_ms_fused"] = (
                        None if (fr is None or ps is None) else fr * ps
                    )
            workloads.append({
                "graph": f"online_npad{n_pad}",
                "kind": self.family or "unknown",
                "n": int(self.csr.n_nodes),
                "n_pad": int(n_pad),
                "n_edges": int(self.csr.n_edges),
                "avg_degree": float(self.csr.avg_degree),
                "backends": {"ell_push": {"iterations": records}},
            })
        return {"workloads": workloads}

    def refit_thresholds(self, cost: str | None = None) -> (
        DirectionThresholds | None
    ):
        """Refit ``direction_thresholds`` from the live samples (no-op
        before any sample landed)."""
        if not any(len(r) for r in self._dir_samples.values()):
            return None
        c = self.cost_mode if cost is None else cost
        self.direction_thresholds = fit_direction_thresholds(
            self.online_trace(cost=c), cost=c
        )
        self.stats.refits += 1
        return self.direction_thresholds

    def _learn(self, outcome: QueryOutcome, buckets: np.ndarray,
               n_real: int) -> None:
        """Post-batch learning over the real morsels, then the refit
        cadence."""
        iters = _host(outcome.result.iterations)[:n_real]
        self._record_iters(iters)
        if (
            self.budget_model is not None
            and self.phase1_iters is None
            and n_real > 0
        ):
            self.budget_model.observe_batch(
                self.family, buckets[:n_real], iters
            )
            if outcome.hybrid:
                self.budget_model.mispredicts.count(
                    outcome.budget_too_low, outcome.budget_too_high,
                    outcome.budget_inert_slots, outcome.budget_observed,
                )
        if self.online_adapt and not self._thresholds_pinned:
            self._batches_since_refit += 1
            if self._batches_since_refit >= self.refit_every:
                self._batches_since_refit = 0
                self.refit_thresholds()

    # ------------------------------------------ split-phase hybrid internals

    def _begin_hybrid(self, pol, ec, g, n_pad, morsels, state_layout,
                      extend=ExtendSpec(), n_real=0, buckets=(), epoch=0):
        """Choose the budget and hand phase 1 to the worker. The phase-2
        operands and their epoch are resolved and pinned here too, so a
        delta applied before ``_settle_hybrid`` cannot run phase 2 on
        another graph."""
        p1, p2 = hybrid_phases(
            pol.source_axes, pol.graph_axes, lanes=pol.lanes,
            or_impl=pol.or_impl,
        )
        budget = self._phase1_budget(buckets)
        collect = bool(self.online_adapt)
        eng1 = self.engine(
            "phase1", p1, ec, n_pad, max_iters=budget,
            state_layout=state_layout, extend=extend,
            collect_stats=collect, morsel_shape=morsels.shape[:1],
            epoch=epoch,
        )
        b2 = self._graph_for(p2, extend)
        t0 = time.perf_counter()
        phase1 = self._submit_phase1(eng1, g, morsels)
        return {
            "pol": pol, "p2": p2, "ec": ec, "g": g, "n_pad": n_pad,
            "state_layout": state_layout, "extend": extend,
            "n_real": n_real, "budget": budget, "collect": collect,
            "phase1": phase1, "t0": t0, "g2": b2.ops,
            "n_pad2": b2.n_pad, "epoch2": self._spec_epoch(b2, extend),
        }

    def _settle_hybrid(self, inf) -> SettledBatch:
        """Join phase 1, read its survivors, resume them (phase 2) and
        defer the state stitch into ``SettledBatch.finalize``."""
        pol, p2, ec = inf["pol"], inf["p2"], inf["ec"]
        g, n_pad = inf["g"], inf["n_pad"]
        state_layout, extend = inf["state_layout"], inf["extend"]
        n_real, budget, collect = inf["n_real"], inf["budget"], inf["collect"]
        sharded = state_layout == "sharded" and self.mesh.size > 1
        out1 = self._await(inf["phase1"])
        res1, stats1 = out1 if collect else (out1, None)
        f1 = res1.state.frontier
        active = _host((f1 != 0).reshape(f1.shape[0], -1).any(dim=1))
        t1 = time.perf_counter()
        idx = np.nonzero(active)[0]
        phase_ms = {"phase1": (t1 - inf["t0"]) * 1e3, "phase2": 0.0}
        iters1 = _host(res1.iterations)
        n_real = int(min(n_real, iters1.shape[0]))
        too_low, too_high, inert = count_budget_mispredicts(
            budget, iters1[:n_real], active[:n_real],
            floor=(
                self.budget_model.floor
                if self.budget_model is not None
                else 4
            ),
        )
        # the global forward ELL's slots (each rank holds one shard)
        push_slots = int(g.fwd.indices.numel()) * (
            self.mesh.axes(pol.graph_axes).size)
        if stats1 is not None and n_real > 0:
            self._record_samples(
                _host(stats1)[:n_real], iters1[:n_real], n_pad,
                push_slots=push_slots,
            )
        if idx.size == 0:
            return SettledBatch(QueryOutcome(
                result=res1, policy=pol.name, hybrid=True, redispatched=0,
                phase_ms=phase_ms, phase1_budget=budget,
                budget_too_low=too_low, budget_too_high=too_high,
                budget_inert_slots=inert, budget_observed=n_real,
            ))
        # the sharded phase 2 is the gang engine (no serial sharded resume)
        use_gang = self.gang_resume and (idx.size > 1 or sharded)

        # survivors padded to a pow2 morsel count (all-zero pad members
        # are inert: zero-trip loops)
        kp = _pow2ceil(idx.size)
        sub_it = np.zeros((kp,), iters1.dtype)
        sub_it[: idx.size] = iters1[idx]
        g2, n_pad2 = inf["g2"], inf["n_pad2"]
        if n_pad2 != n_pad:
            raise RuntimeError(f"phase graphs disagree: {n_pad2} != {n_pad}")
        state1 = res1.state
        if sharded:
            # phase-1 rows (gathered by the engine) -> this rank's phase-2
            # rows over every mesh axis, survivors picked and padded
            sub_state = gang_handoff(state1, idx, kp,
                                     self.mesh.axes(p2.graph_axes))
        else:
            idx_t = torch.as_tensor(idx, dtype=torch.long, device=f1.device)
            sub_state = type(state1)(*(_take_padded(x, idx_t, kp)
                                       for x in state1))

        if use_gang:
            eng2 = self.engine(
                "gang", p2, ec, n_pad, state_layout=state_layout,
                extend=extend, collect_stats=collect, morsel_shape=(kp,),
                epoch=inf["epoch2"],
            )
            self.stats.gangs += 1
            self.stats.gang_slots += kp
        else:
            eng2 = self.engine(
                "resume", p2, ec, n_pad, extend=extend,
                collect_stats=collect, epoch=inf["epoch2"],
            )
        out2 = eng2(g2, sub_state, torch.as_tensor(sub_it))
        res2, stats2 = out2 if collect else (out2, None)
        iters2 = _host(res2.iterations)
        synchronize(self.device)
        t2 = time.perf_counter()
        phase_ms["phase2"] = (t2 - t1) * 1e3
        if stats2 is not None:
            self._record_samples(
                _host(stats2)[: idx.size], iters2[: idx.size], n_pad,
                push_slots=push_slots, start=sub_it[: idx.size], phase=2,
            )

        final_iters = iters1.copy()
        final_iters[idx] = iters2[: idx.size]

        def materialize() -> IFEResult:
            return IFEResult(
                state=gang_scatter_back(state1, res2.state, idx),
                iterations=torch.as_tensor(final_iters),
            )

        outcome = QueryOutcome(
            result=IFEResult(state=None,
                             iterations=torch.as_tensor(final_iters)),
            policy=pol.name, hybrid=True, redispatched=int(idx.size),
            phase_ms=phase_ms, phase1_budget=budget,
            resumed_ganged=int(idx.size) if use_gang else 0,
            resumed_serial=0 if use_gang else int(idx.size),
            gang_width=kp if use_gang else 0,
            budget_too_low=too_low, budget_too_high=too_high,
            budget_inert_slots=inert, budget_observed=n_real,
        )
        return SettledBatch(outcome, materialize)

    def _run_hybrid(self, pol, ec, g, n_pad, morsels, state_layout,
                    extend=ExtendSpec(), n_real=0, buckets=(), epoch=0):
        """The two-phase hybrid on one morsel batch, synchronously."""
        inf = self._begin_hybrid(
            pol, ec, g, n_pad, morsels, state_layout, extend=extend,
            n_real=n_real, buckets=buckets, epoch=epoch,
        )
        return self._settle_hybrid(inf).finalize()

    def _begin_static(self, pol, ec, g, n_pad, morsels, state_layout,
                      extend=ExtendSpec(), epoch=0):
        eng = self.engine(
            "static", pol, ec, n_pad, state_layout=state_layout,
            extend=extend, morsel_shape=morsels.shape[:1], epoch=epoch,
        )
        t0 = time.perf_counter()
        phase1 = self._submit_phase1(eng, g, morsels)
        return {"pol": pol, "phase1": phase1, "t0": t0}

    def _settle_static(self, inf) -> SettledBatch:
        res = self._await(inf["phase1"])
        synchronize(self.device)
        t1 = time.perf_counter()
        return SettledBatch(QueryOutcome(
            result=res, policy=inf["pol"].name, hybrid=False,
            redispatched=0,
            phase_ms={"phase1": (t1 - inf["t0"]) * 1e3, "phase2": 0.0},
            phase1_budget=0,
        ))

    def _run_static(self, pol, ec, g, n_pad, morsels, state_layout,
                    extend=ExtendSpec(), n_real=0, buckets=(), epoch=0):
        inf = self._begin_static(
            pol, ec, g, n_pad, morsels, state_layout, extend=extend,
            epoch=epoch,
        )
        return self._settle_static(inf).finalize()

    # ------------------------------------------------------ batch planning

    def _plan_query(self, sources, returns_paths, policy, backend,
                    query_kind="reach"):
        """Resolve policy, edge compute, extension spec, operands,
        morsels, chunking and the budget model's bucket keys for one
        source batch.

        ``query_kind`` selects the scenario family (``QUERY_KINDS``):
        "reach" picks sp/msbfs x lengths/parents; the other kinds name
        their edge compute, and one with no lane form
        (``lanes_ok=False``) never runs under a lane-packed policy: an
        auto-recommended one degrades to nTkS, a pinned one raises."""
        kind = QUERY_KINDS.get(query_kind)
        if kind is None:
            raise ValueError(
                f"unknown query_kind: {query_kind!r} "
                f"(known: {sorted(QUERY_KINDS)})"
            )
        if query_kind != "reach" and returns_paths:
            raise ValueError(
                "returns_paths is a reach-family option; "
                f"query_kind={query_kind!r} has its own result leaves"
            )
        sources = np.asarray(sources, np.int32).reshape(-1)
        name = policy or recommend_policy(
            len(sources),
            self.mesh.size,
            self.csr.avg_degree,
            returns_paths=returns_paths,
            n_nodes=self.csr.n_nodes,
            hbm_bytes=self.hbm_bytes,
        )
        pol = POLICIES[name]()
        if pol.is_multi_source and not kind.lanes_ok:
            if policy is not None:
                raise ValueError(
                    f"policy {policy!r} lane-packs sources but "
                    f"query_kind={query_kind!r} has no lane form"
                )
            name = "ntks"
            pol = POLICIES[name]()
        if kind.edge_compute is not None:
            ec = kind.edge_compute
        elif pol.is_multi_source:
            ec = "msbfs_parents" if returns_paths else "msbfs_lengths"
        else:
            ec = "sp_parents" if returns_paths else "sp_lengths"
        backend = backend if backend is not None else self.backend
        if backend == "recommend":
            backend = recommend_backend(
                ec, self.csr.avg_degree, n_nodes=self.csr.n_nodes,
                lanes=pol.lanes, family=self.family,
                thresholds=self.direction_thresholds,
            )
        spec = as_spec(backend)
        bundle = self._graph_for(pol, spec)
        g, n_pad = bundle.ops, bundle.n_pad
        # the shape epoch of the tensors resolved here keys every engine
        # this batch runs (phase 1, static, each chunk)
        epoch = self._spec_epoch(bundle, spec)
        src_shards = self.mesh.axes(pol.source_axes).size
        morsels = pad_sources(sources, src_shards, pol.lanes, n_pad)
        # paper Fig 13: dense graphs cap concurrent source morsels (k);
        # oversized batches run in fixed-size chunks
        k = (
            self.max_inflight
            if self.max_inflight is not None
            else recommend_k(self.csr.avg_degree)
        )
        chunk = max(src_shards, k * src_shards)
        if self.pad_pow2_morsels and 0 < morsels.shape[0] <= chunk:
            m2 = min(_pow2ceil(morsels.shape[0]), chunk)
            if m2 > morsels.shape[0]:
                inert = np.full(
                    (m2 - morsels.shape[0], pol.lanes), n_pad, np.int32
                )
                morsels = np.concatenate([morsels, inert], axis=0)
        # learning sees only the real morsels
        n_real = max(1, -(-len(sources) // pol.lanes))
        buckets = (
            self._morsel_buckets(sources, pol.lanes)
            if self.budget_model is not None and self.phase1_iters is None
            else np.zeros(0, np.int64)
        )
        return sources, name, pol, ec, spec, g, n_pad, morsels, chunk, \
            n_real, buckets, epoch

    def _hybrid_eligible(self, pol, state_layout: str) -> bool:
        # the sharded phase 2 is the gang engine: without it the sharded
        # batch runs the static program
        return (self.adaptive and bool(pol.source_axes)
                and (state_layout == "replicated" or self.gang_resume))

    # -------------------------------------------------- split-phase surface

    def begin_batch(
        self,
        sources,
        returns_paths: bool = False,
        policy: str | None = None,
        state_layout: str = "replicated",
        backend=None,
        query_kind: str = "reach",
    ) -> InflightBatch:
        """Plan one batch and hand its phase 1 (or static engine) to the
        phase-1 worker; returns with it in flight. Settle it with
        ``settle_batch`` before the next ``begin_batch``: learning is
        host-serial. On a mesh, rank 0 first tells the followers."""
        seq = self._seq
        self._seq += 1
        if self.leads:
            _bcast(("begin", seq, dict(
                sources=np.asarray(sources), returns_paths=returns_paths,
                policy=policy, state_layout=state_layout, backend=backend,
                query_kind=query_kind)))
        inflight = self._begin(sources, returns_paths, policy, state_layout,
                               backend, query_kind)
        inflight.seq = seq
        return inflight

    def _begin(self, sources, returns_paths, policy, state_layout, backend,
               query_kind) -> InflightBatch:
        (sources, name, pol, ec, spec, g, n_pad, morsels, chunk, n_real,
         buckets, epoch) = self._plan_query(
             sources, returns_paths, policy, backend, query_kind)
        if morsels.shape[0] > chunk:
            payload = {
                "pol": pol, "ec": ec, "spec": spec, "g": g, "n_pad": n_pad,
                "morsels": morsels, "chunk": chunk,
                "state_layout": state_layout, "epoch": epoch,
            }
            return InflightBatch("chunked", name, n_real, buckets, payload)
        m = torch.as_tensor(morsels)
        if self._hybrid_eligible(pol, state_layout):
            inf = self._begin_hybrid(
                pol, ec, g, n_pad, m, state_layout, extend=spec,
                n_real=n_real, buckets=buckets, epoch=epoch,
            )
            return InflightBatch("hybrid", name, n_real, buckets, inf)
        inf = self._begin_static(pol, ec, g, n_pad, m, state_layout,
                                 extend=spec, epoch=epoch)
        return InflightBatch("static", name, n_real, buckets, inf)

    def settle_batch(self, inflight: InflightBatch) -> SettledBatch:
        """Join phase 1, resume survivors, run post-batch learning; the
        stitched state may still be deferred to ``finalize_batch``."""
        if self.leads:
            _bcast(("settle", inflight.seq, {}))
        if inflight.kind == "chunked":
            p = inflight.payload
            outcome = self._run_chunked(
                p["pol"], p["ec"], p["g"], p["n_pad"], p["morsels"],
                p["chunk"], p["state_layout"], p["spec"],
                inflight.n_real, inflight.buckets, p["epoch"],
            )
            settled = SettledBatch(outcome)
        elif inflight.kind == "hybrid":
            settled = self._settle_hybrid(inflight.payload)
        else:
            settled = self._settle_static(inflight.payload)
        settled.outcome.policy = inflight.name
        self._learn(settled.outcome, inflight.buckets, inflight.n_real)
        self.stats.record(settled.outcome)
        settled.seq = inflight.seq
        settled._on_done = self.on_finalized
        if self.leads:
            settled._on_finalize = lambda: _bcast(
                ("finalize", settled.seq, {}))
        return settled

    def finalize_batch(self, settled: SettledBatch) -> QueryOutcome:
        return settled.finalize()

    def _run_chunked(self, pol, ec, g, n_pad, morsels, chunk, state_layout,
                     spec, n_real, buckets, epoch=0) -> QueryOutcome:
        """The in-flight-cap chunk loop: fixed-size chunks stitched into
        one outcome."""
        run_fn = (
            self._run_hybrid if self._hybrid_eligible(pol, state_layout)
            else self._run_static
        )
        outcomes = []
        for i in range(0, morsels.shape[0], chunk):
            part = morsels[i : i + chunk]
            if part.shape[0] < chunk:
                pad = np.full(
                    (chunk - part.shape[0], part.shape[1]), n_pad, np.int32
                )
                part = np.concatenate([part, pad], axis=0)
            real_in = max(0, min(chunk, n_real - i))
            outcomes.append(run_fn(
                pol, ec, g, n_pad, torch.as_tensor(part), state_layout,
                extend=spec, n_real=real_in,
                buckets=buckets[i : i + real_in], epoch=epoch,
            ))
        result = IFEResult(
            state=type(outcomes[0].result.state)(*(
                torch.cat(xs) for xs in zip(
                    *[o.result.state for o in outcomes])
            )),
            iterations=torch.cat(
                [o.result.iterations for o in outcomes]
            ),
        )
        return QueryOutcome(
            result=result,
            policy=pol.name,
            hybrid=any(o.hybrid for o in outcomes),
            redispatched=sum(o.redispatched for o in outcomes),
            phase_ms={
                "phase1": sum(o.phase_ms["phase1"] for o in outcomes),
                "phase2": sum(o.phase_ms["phase2"] for o in outcomes),
            },
            phase1_budget=max(o.phase1_budget for o in outcomes),
            resumed_ganged=sum(o.resumed_ganged for o in outcomes),
            resumed_serial=sum(o.resumed_serial for o in outcomes),
            gang_width=max(o.gang_width for o in outcomes),
            budget_too_low=sum(o.budget_too_low for o in outcomes),
            budget_too_high=sum(o.budget_too_high for o in outcomes),
            budget_inert_slots=sum(o.budget_inert_slots for o in outcomes),
            budget_observed=sum(o.budget_observed for o in outcomes),
        )

    def query(
        self,
        sources,
        returns_paths: bool = False,
        policy: str | None = None,
        state_layout: str = "replicated",
        backend=None,
        query_kind: str = "reach",
    ) -> QueryOutcome:
        """Serve one request batch synchronously: ``begin_batch`` +
        ``settle_batch`` + ``finalize_batch``, after any phase 1 in
        flight."""
        self._join()
        inflight = self.begin_batch(
            sources, returns_paths=returns_paths, policy=policy,
            state_layout=state_layout, backend=backend,
            query_kind=query_kind,
        )
        return self.settle_batch(inflight).finalize()
