"""Morsel dispatching policies, budget learning and direction thresholds
(port of ``repro.core.policies``; host-side numpy, same rules).

A policy names which mesh axes shard source morsels and which partition
the graph (``launch.mesh.Mesh``: one process per rank). On one device
every axis has size 1 and the names select only the execution shape
(source morsels, lane width, phase split). ``recommend_policy``'s memory bound
takes the device's total memory from the caller (the dispatcher passes
the CUDA device's ``total_memory``).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from .collectives import REDISPATCH_OR_IMPL
from .extend import ExtendSpec


def pow2ceil(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1)."""
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class MorselPolicy:
    name: str
    source_axes: tuple[str, ...]  # mesh axes sharding source morsels
    graph_axes: tuple[str, ...]  # mesh axes partitioning the graph
    lanes: int = 1  # 64 => multi-source morsels (MS-BFS)
    or_impl: str = "allgather"  # frontier-union collective (see collectives)

    @property
    def is_multi_source(self) -> bool:
        return self.lanes > 1


def policy_1t1s(
    mesh_axes: Sequence[str] = ("data", "model")
) -> MorselPolicy:
    return MorselPolicy("1T1S", tuple(mesh_axes), ())


def policy_nt1s(
    mesh_axes: Sequence[str] = ("data", "model"), or_impl: str = "allgather"
) -> MorselPolicy:
    return MorselPolicy("nT1S", (), tuple(mesh_axes), or_impl=or_impl)


def policy_ntks(
    source_axes: Sequence[str] = ("data",),
    graph_axes: Sequence[str] = ("model",),
    or_impl: str = "allgather",
) -> MorselPolicy:
    return MorselPolicy("nTkS", tuple(source_axes), tuple(graph_axes), or_impl=or_impl)


def policy_ntkms(
    source_axes: Sequence[str] = ("data",),
    graph_axes: Sequence[str] = ("model",),
    lanes: int = 64,
    or_impl: str = "allgather",
) -> MorselPolicy:
    return MorselPolicy(
        "nTkMS", tuple(source_axes), tuple(graph_axes), lanes=lanes, or_impl=or_impl
    )


POLICIES = {
    "1t1s": policy_1t1s,
    "nt1s": policy_nt1s,
    "ntks": policy_ntks,
    "ntkms": policy_ntkms,
}


def hybrid_phases(
    source_axes: Sequence[str] = ("data",),
    graph_axes: Sequence[str] = ("model",),
    lanes: int = 1,
    or_impl: str = "allgather",
) -> tuple[MorselPolicy, MorselPolicy]:
    """The adaptive hybrid's (phase-1, phase-2) policy pair.

    Phase 1: nTkS (or nTkMS when ``lanes`` > 1) with the caller's
    ``or_impl`` — source morsels over ``source_axes``, graph over
    ``graph_axes``. Phase 2: nT1S over BOTH axis groups with the ring
    frontier union (collectives.REDISPATCH_OR_IMPL): all devices gang up
    on each surviving morsel's frontier.
    """
    p1 = MorselPolicy(
        "nTkMS" if lanes > 1 else "nTkS",
        tuple(source_axes), tuple(graph_axes),
        lanes=lanes, or_impl=or_impl,
    )
    p2 = MorselPolicy(
        "nT1S", (), tuple(source_axes) + tuple(graph_axes),
        lanes=lanes, or_impl=REDISPATCH_OR_IMPL,
    )
    return p1, p2


def recommend_policy(
    n_sources: int,
    n_devices: int,
    avg_degree: float,
    returns_paths: bool = False,
    n_nodes: int | None = None,
    hbm_bytes: int = 16 * 2**30,
) -> str:
    """The paper's conclusions (§5, §7) as a dispatch rule. ``hbm_bytes``
    is the device memory the path-output bound is checked against.

    - nTkMS only when sources saturate ≥1 full 64-lane morsel (Fig 14) and,
      for path outputs, when the 536 B/node/morsel upfront allocation fits
      (§5.6's Graph500 OOM).
    - otherwise nTkS — the robust hybrid — everywhere (§5.4 recommendation).
      (1T1S/nT1S are never *better* than nTkS in the paper's study; they are
      kept as explicit baselines, not recommendations.)
    """
    if n_sources >= 64:
        if returns_paths and n_nodes is not None:
            morsels = -(-n_sources // 64)
            upfront = 536 * n_nodes * min(morsels, max(n_devices, 1))
            if upfront > 0.5 * hbm_bytes:
                return "ntks"
        return "ntkms"
    return "ntks"


# ---------------------------------------------------------------------------
# Direction thresholds: Beamer's constants, optionally re-fitted from traces.
# ---------------------------------------------------------------------------

BEAMER_ALPHA = 14.0
BEAMER_BETA = 24.0


def degree_bucket(avg_degree: float) -> int:
    """pow2 bucket id of a workload's average degree (the granularity the
    fitted threshold table is keyed at): 0 for <=1, else ceil(log2)."""
    if avg_degree <= 1.0:
        return 0
    return int(math.ceil(math.log2(avg_degree) - 1e-12))


# ---------------------------------------------------------------------------
# Phase-1 budget learning: per-(dataset-family, source-degree-bucket) model.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BudgetMispredicts:
    """Cumulative phase-1 budget mispredict counters.

    ``too_low`` counts real morsels that survived phase 1 (the budget sat
    below their convergence depth, so they paid a re-dispatch); ``too_high``
    counts converged real morsels whose depth sat strictly under half the
    budget — a smaller pow2 budget would have covered them with room to
    spare. The right-sized band is ``[budget/2, budget]``: serving
    ``pow2ceil(depth + 1)`` for a steady depth never mispredicts (depth
    exactly a pow2 quantizes to ``2·depth``, the band's lower edge).
    ``inert_slots`` is the budget slack
    ``budget - trips`` summed over converged morsels — the iteration slots a
    lockstep phase-1 schedule would have burned inert, and the latency a
    straggler waits under few-device nTkS before its all-device phase 2.
    """

    too_low: int = 0
    too_high: int = 0
    inert_slots: int = 0
    observed: int = 0  # real morsels the counters classified

    @property
    def rate(self) -> float:
        """Mispredicted real morsels per observed real morsel."""
        if not self.observed:
            return 0.0
        return (self.too_low + self.too_high) / self.observed

    def count(self, too_low: int, too_high: int, inert_slots: int,
              observed: int) -> None:
        self.too_low += int(too_low)
        self.too_high += int(too_high)
        self.inert_slots += int(inert_slots)
        self.observed += int(observed)

    def reset(self) -> None:
        self.too_low = self.too_high = self.inert_slots = self.observed = 0


def count_budget_mispredicts(
    budget: int, trips, survived, floor: int = 4
) -> tuple[int, int, int]:
    """Classify one batch's REAL morsels against its phase-1 budget.

    ``trips`` are the morsels' phase-1 iteration counts, ``survived`` the
    phase-1 survivor mask (frontier still live at the budget). Returns
    ``(too_low, too_high, inert_slots)`` per the BudgetMispredicts
    semantics; a budget at the quantization floor never counts too_high
    (no smaller budget was available to pick).
    """
    trips = np.asarray(trips)
    survived = np.asarray(survived, bool)
    conv = trips[~survived]
    too_low = int(survived.sum())
    inert_slots = int(np.maximum(int(budget) - conv, 0).sum())
    too_high = (
        int((conv * 2 < int(budget)).sum()) if int(budget) > floor else 0
    )
    return too_low, too_high, inert_slots


class BudgetModel:
    """Per-(dataset-family, source-degree-bucket) phase-1 budget learner.

    Each key holds a bounded window of observed per-morsel convergence
    depths (final IFE trip counts); ``predict`` serves the window's
    ``quantile`` pow2-quantized (so the budget only compiles O(log
    max_iters) distinct phase-1 engines), with the same fallback chain as
    ``DirectionThresholds.lookup``: exact (family, bucket) -> nearest
    bucket within the family -> nearest bucket across all families ->
    ``None`` (the caller's global-p90 cold path; ``cold_budget`` is what
    the scheduler serves when that path holds no data either). The scheduler feeds it
    only *real* morsels — pad/inert morsels exit at 0 iterations and
    would drag every bucket's budget below its true convergence depth —
    and skips it entirely when ``phase1_iters`` is pinned.

    ``mispredicts`` accumulates the outcome counters for the batches this
    model budgeted (see BudgetMispredicts / count_budget_mispredicts).
    """

    def __init__(self, window: int = 64, quantile: float = 90.0,
                 floor: int = 4, cold_budget: int = 8):
        self.window = int(window)
        self.quantile = float(quantile)
        self.floor = int(floor)
        self.cold_budget = int(cold_budget)
        self._windows: dict[tuple, collections.deque] = {}
        self.mispredicts = BudgetMispredicts()

    def __len__(self) -> int:
        """Number of non-empty (family, bucket) windows."""
        return sum(1 for w in self._windows.values() if w)

    @property
    def n_samples(self) -> int:
        return sum(len(w) for w in self._windows.values())

    def observe(self, family, bucket: int, trips) -> None:
        """Append real-morsel convergence depths to one bucket's window."""
        trips = np.asarray(trips).reshape(-1)
        if trips.size == 0:
            return
        w = self._windows.setdefault(
            (family, int(bucket)), collections.deque(maxlen=self.window)
        )
        w.extend(int(t) for t in trips)

    def observe_batch(self, family, buckets, trips) -> None:
        """Per-morsel (bucket, trip) pairs of one served batch."""
        for b, t in zip(buckets, np.asarray(trips).reshape(-1)):
            self.observe(family, int(b), [int(t)])

    def reset(self) -> None:
        """Drop every learned window (the mispredict telemetry stays —
        it is cumulative accounting, not bucket-keyed state). The
        dispatcher calls this in its graph-delta fence: a mutation moves
        sources between degree buckets, so depths observed under the old
        bucketing must not budget post-delta batches."""
        self._windows.clear()

    def _window_for(self, family, bucket: int):
        w = self._windows.get((family, int(bucket)))
        if w:
            return w
        # nearest bucket within the family, then across all families —
        # ties break toward the smaller bucket id then the family repr,
        # mirroring DirectionThresholds.lookup determinism
        near = [
            (abs(kb - bucket), kb, str(kf), kf)
            for (kf, kb), win in self._windows.items()
            if win and kf == family
        ]
        if not near:
            near = [
                (abs(kb - bucket), kb, str(kf), kf)
                for (kf, kb), win in self._windows.items()
                if win
            ]
        if not near:
            return None
        _, kb, _, kf = min(near, key=lambda t: t[:3])
        return self._windows[(kf, kb)]

    def predict(self, family, bucket: int, max_iters: int) -> int | None:
        """pow2-quantized ``quantile`` of the bucket's window (with the
        lookup fallback chain), clamped to [floor, max_iters]; None when
        the model holds no samples at all."""
        w = self._window_for(family, bucket)
        if w is None:
            return None
        b = pow2ceil(
            int(np.percentile(np.asarray(w, np.float64), self.quantile)) + 1
        )
        return max(self.floor, min(b, int(max_iters)))

    def budget_for(self, family, buckets, max_iters: int) -> int | None:
        """One covering budget for a batch spanning ``buckets``: the max
        of the per-bucket predictions (most morsels should converge
        inside phase 1). None when the model is empty or no bucket is
        given."""
        preds = [
            self.predict(family, b, max_iters) for b in sorted(set(
                int(b) for b in buckets
            ))
        ]
        preds = [p for p in preds if p is not None]
        return max(preds) if preds else None

    def budgets(self, max_iters: int) -> dict:
        """Snapshot of every learned bucket's served budget (reporting)."""
        return {
            k: self.predict(k[0], k[1], max_iters)
            for k, w in sorted(self._windows.items(),
                               key=lambda kv: (str(kv[0][0]), kv[0][1]))
            if w
        }


@dataclasses.dataclass(frozen=True)
class DirectionThresholds:
    """Fitted (alpha, beta) per (dataset-family, degree-bucket).

    ``table`` maps ``(family, bucket)`` to ``(alpha, beta)``; lookups fall
    back family-first (nearest bucket of the same family), then to the
    Beamer defaults — so the table is total over every query even when the
    bench traces only covered a few workload families.
    """

    table: Mapping  # {(family, bucket): (alpha, beta)}
    default: tuple = (BEAMER_ALPHA, BEAMER_BETA)

    def lookup(self, family: str | None, avg_degree: float) -> tuple:
        b = degree_bucket(avg_degree)
        if family is not None:
            if (family, b) in self.table:
                return self.table[(family, b)]
            near = [
                (abs(kb - b), kb, v)
                for (kf, kb), v in self.table.items()
                if kf == family
            ]
            if near:
                return min(near)[2]
        # no family match: nearest bucket across all families, then default
        near = [(abs(kb - b), kb, v) for (_, kb), v in self.table.items()]
        if near:
            return min(near)[2]
        return self.default


#: cap on the per-axis candidate decision boundaries _fit_group searches.
#: Offline bench traces stay well under it (every boundary is searched);
#: the scheduler's ONLINE sample store can hold thousands of near-unique
#: ratios, and an uncapped grid would put an O(|A|·|B|·records) search on
#: the serving path — over the cap the sorted boundary set is subsampled
#: at evenly-spaced ranks (deterministic; Beamer anchors always kept).
MAX_FIT_CANDIDATES = 64


def _boundary_candidates(vals, anchor: float) -> list:
    cands = sorted(set(vals) | {anchor, 0.0})
    if len(cands) <= MAX_FIT_CANDIDATES:
        return cands
    idx = np.linspace(0, len(cands) - 1, MAX_FIT_CANDIDATES).astype(int)
    return sorted({cands[i] for i in idx} | {anchor, 0.0})


def _fit_group(recs: list[tuple], push_key: str, pull_key: str) -> tuple:
    """One (family, bucket) group: pick (alpha, beta) minimizing the total
    per-iteration scan cost the Beamer predicate would have chosen over the
    trace — where "cost" is whatever the caller's (``push_key``,
    ``pull_key``) record fields carry: slot counts under ``cost="slots"``
    (the deterministic proxy), probe-measured wall-ms under
    ``cost="measured"``. ``recs`` are (iteration_record, n) pairs — n
    travels per record, since one group may aggregate same-family
    workloads of different sizes.

    Candidate thresholds come from the trace itself — each iteration's
    ``m_u/m_f`` (resp. ``n/n_f``) ratio is the exact alpha (beta) at which
    that iteration's predicate flips — plus the Beamer defaults, so the
    search space is the set of distinct decision boundaries the trace can
    express (rank-subsampled past MAX_FIT_CANDIDATES — see above). The
    per-candidate cost is numpy-vectorized over the records, keeping the
    in-flight refit cheap enough for the serving path. Deterministic:
    ties break toward the Beamer constants."""
    pts = []
    for r, n in recs:
        if any(
            r.get(k) is None
            for k in ("m_frontier", "m_unexplored", "frontier",
                      push_key, pull_key)
        ):
            continue  # pre-v2 / trimmed / unmeasured record: no sample
        m_f = float(r["m_frontier"])
        m_u = float(r["m_unexplored"])
        n_f = float(r["frontier"])
        pts.append(
            (m_f, m_u, n_f, float(n), float(r[push_key]),
             float(r[pull_key]))
        )
    if not pts:
        return (BEAMER_ALPHA, BEAMER_BETA)
    eps = 1e-9
    alphas = _boundary_candidates(
        (m_u / m_f * (1 + eps) for m_f, m_u, *_ in pts if m_f > 0),
        BEAMER_ALPHA,
    )
    betas = _boundary_candidates(
        (n / n_f * (1 + eps) for _, _, n_f, n, _, _ in pts if n_f > 0),
        BEAMER_BETA,
    )
    arr = np.asarray(pts, np.float64)  # [P, 6]
    m_f, m_u, n_f, n = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    push, pull = arr[:, 4], arr[:, 5]

    def cost(a: float, b: float) -> float:
        use_pull = (m_f * a > m_u) & (n_f * b > n)
        return float(np.where(use_pull, pull, push).sum())

    def key(ab):
        a, b = ab
        return (
            cost(a, b),
            abs(a - BEAMER_ALPHA) + abs(b - BEAMER_BETA),
            a,
            b,
        )

    return min(((a, b) for a in alphas for b in betas), key=key)


def fit_direction_thresholds(
    traces, pull: str = "binned", cost: str = "slots"
) -> DirectionThresholds:
    """Fit per-(dataset-family, degree-bucket) alpha/beta from bench traces.

    ``traces``: a parsed ``BENCH_direction_opt.json`` document (or its
    ``workloads`` list, or a path to the file). ``pull`` selects which
    pull flavor's cost the thresholds optimize for; "binned" is what
    ``recommend_backend`` serves ("fused" targets the Pallas kernel's
    rates under measured cost).

    ``cost`` picks the per-iteration cost fields the fit minimizes:

    - "slots" (default, deterministic): schema-v2 ``push_slots`` /
      ``pull_slots_{pull}`` scan-slot counts — the byte-proportional
      proxy that needs no timing.
    - "measured": ``push_wall_ms`` / ``pull_wall_ms_{pull}`` — wall
      costs from the schema-v3 bench (or ``online_trace(cost=
      "measured")``'s probe-rate annotation), so the fit weighs a slot
      by what it actually costs on this backend pairing.

    Records missing the selected fields are skipped — the fit degrades
    to the Beamer defaults (per group), never fails; a measured-cost fit
    over a slots-only trace is exactly such a degradation.
    """
    if cost not in ("slots", "measured"):
        raise ValueError(f"unknown cost mode: {cost!r}")
    if isinstance(traces, (str, Path)):
        traces = json.loads(Path(traces).read_text())
    workloads = traces.get("workloads", traces) if isinstance(
        traces, dict
    ) else traces
    if cost == "measured":
        push_key, pull_key = "push_wall_ms", f"pull_wall_ms_{pull}"
    else:
        push_key, pull_key = "push_slots", f"pull_slots_{pull}"
    groups: dict[tuple, list] = {}
    for w in workloads:
        # the runtime predicate compares n_f*beta against the PADDED row
        # count (ExtendCtx.n_out), so beta must be fitted against n_pad,
        # not the logical node count; old traces fall back to n
        n = w.get("n_pad", w.get("n"))
        if n is None:
            continue
        fam = w.get("kind", "unknown")
        bucket = degree_bucket(float(w.get("avg_degree", 1.0)))
        recs = groups.setdefault((fam, bucket), [])
        # every backend replays the same frontier trajectory (bit-parity),
        # so the canonical push trace carries the group's cost samples
        be = w.get("backends", {}).get("ell_push", {})
        recs.extend((r, int(n)) for r in be.get("iterations", []))
    table = {
        k: _fit_group(recs, push_key, pull_key)
        for k, recs in groups.items()
    }
    return DirectionThresholds(table=table)


def recommend_backend(
    edge_compute: str = "sp_lengths",
    avg_degree: float = 8.0,
    n_nodes: int | None = None,
    lanes: int = 1,
    block: int = 128,
    family: str | None = None,
    thresholds: DirectionThresholds | None = None,
    operands=None,
):
    """Physical scan layout for the extension step (core.extend backends).

    The EmptyHeaded lesson as a dispatch rule: pick the layout by expected
    frontier/adjacency density, not globally.

    - ``bellman_ford`` (weighted relax, no monotone visited set): nothing to
      suppress, so bottom-up never wins — stay on the forward push scatter.
    - 64-wide lane morsels on graphs dense at block granularity (expected
      edges per ``block``² tile ≳ 1, i.e. ``avg_degree·block ≳ n``): the
      saturating-matmul block path amortizes one adjacency scan over all
      lanes on the MXU and skips frontier-empty stripes.
    - everything else (BFS-family traversals): the Beamer alpha/beta
      direction switch over **degree-binned** pull slabs — push while
      frontiers are sparse, binned pull with visited-suppression once the
      frontier's edge mass dominates. With a fitted ``thresholds`` table
      the switch runs the trace-fitted alpha/beta for this
      (``family``, degree-bucket) instead of Beamer's CPU constants.

    Deterministic and *total*: a pure function of its arguments, and when
    the caller passes the ``operands`` bundle (or a bare EllGraph, like
    every other operand-accepting entry point) it will only ever name a
    backend whose physical operands exist in that bundle (falling back
    toward ``ell_push``, which every bundle carries).
    """
    from .extend import as_operands

    ops = None if operands is None else as_operands(operands)
    have = lambda attr: ops is None or getattr(ops, attr) is not None
    if edge_compute == "bellman_ford":
        return "ell_push"
    dense_blocks = (
        n_nodes is not None and avg_degree * block * block >= n_nodes
    )  # expected edges per block² tile = avg_degree·block²/n ≥ 1
    if edge_compute == "topk_paths":
        # pull-native: the k-slot relax only exists as a reverse-ELL gather
        return "ell_pull"
    if edge_compute == "ppr":
        # additive float diffusion has one order-stable physical form (the
        # push scatter-add); the block matmul would reorder float sums
        return "ell_push"
    if edge_compute == "pattern_counts":
        # exact int32 hop chains: MXU matmuls when the graph is dense at
        # block granularity, else the same sums via the push scatter
        if dense_blocks and have("blocks"):
            return "block_mxu"
        return "ell_push"
    if lanes >= 64 and dense_blocks and have("blocks"):
        return "block_mxu"
    if have("rev_binned"):
        if thresholds is not None:
            alpha, beta = thresholds.lookup(family, avg_degree)
            return ExtendSpec(
                direction="auto", alpha=float(alpha), beta=float(beta)
            )
        return "dopt_binned"
    if have("rev"):
        if thresholds is not None:
            alpha, beta = thresholds.lookup(family, avg_degree)
            return ExtendSpec(
                direction="auto", pull="ell",
                alpha=float(alpha), beta=float(beta),
            )
        return "dopt_ell"
    return "ell_push"


def recommend_k(avg_degree: float, n_threads: int = 32) -> int:
    """Paper §5.5 / Fig 13: optimal concurrent source morsels k vs density.
    Degradation onsets observed at k=16/8/4 for avg degree 100/250/500."""
    if avg_degree >= 500:
        return min(4, n_threads)
    if avg_degree >= 250:
        return min(8, n_threads)
    if avg_degree >= 100:
        return min(16, n_threads)
    return n_threads
