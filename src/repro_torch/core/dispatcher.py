"""Morsel dispatcher over a mesh of ranks (port of
``repro.core.dispatcher``).

The JAX package compiles a ``shard_map`` program per (mesh, policy,
graph shape, edge compute, backend). The port runs the same program as
one process per rank (``launch.mesh.Mesh``): source morsels are split
over the policy's source axes, graph rows over its graph axes, and every
rank runs a host loop over its own morsels, each with its own
convergence loop (the paper's "sticky" worker finishes a morsel before
taking the next). Collectives run over the graph axes; the loop
condition is reduced over the source and graph axes (``sync="global"``)
or the graph axes only (``sync="shard"``, phase 1 of the hybrid, where
source groups exit at their own trip counts and every ring degrades to
its allgather flavor, as JAX's rule has it).

An engine takes global arguments and returns global results, as a
``shard_map`` program does with global arrays: it picks its rank's
morsels (and, in the sharded layout, rows), runs, and gathers the
results back over the mesh. The sharded gang engine is the exception on
the way in: it takes each rank's rows as ``collectives.gang_handoff``
placed them.

- ``build_engine``: phase 1 or the static program;
- ``build_resume_engine``: phase 2, one survivor at a time;
- ``build_gang_resume_engine``: phase 2 for all survivors under one
  loop, lane-packed so one scan serves the gang, with per-survivor masks
  (counts equal the serial resume's).

A bare device is the one-rank mesh: every axis has size 1, nothing is
sliced or gathered, and each loop condition is one host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .. import trace
from ..graph.csr import CSRGraph, ShardedBlocks
from ..kernels.common import to_device
from ..launch.mesh import Mesh, as_mesh
from .collectives import (
    any_over,
    gang_merge_scatter,
    gather_rows,
    max_allreduce,
    merge_contribution,
    merge_scatter,
)
from .edge_compute import EDGE_COMPUTES, _member
from .extend import (
    STATS_WIDTH,
    ExtendCtx,
    ExtendSpec,
    GraphOperands,
    as_operands,
    as_spec,
    build_operands,
    check_operands,
    frontier_stats,
    make_backend,
    operand_stream,
    operands_from_numpy,
    stats_bin_widths,
)
from .ife import IFEResult
from .policies import MorselPolicy


def pad_sources(
    sources: np.ndarray, shards: int, lanes: int, inert_id: int
) -> np.ndarray:
    """[(s,)] -> [n_morsels_padded, lanes]; pad entries get ``inert_id``
    (>= n_nodes: empty lanes, zero-iteration morsels)."""
    s = np.asarray(sources, dtype=np.int32).reshape(-1)
    n_morsels = -(-len(s) // lanes)
    n_morsels = -(-n_morsels // shards) * shards
    out = np.full((n_morsels * lanes,), inert_id, dtype=np.int32)
    out[: len(s)] = s
    return out.reshape(n_morsels, lanes)


@dataclasses.dataclass(frozen=True)
class QueryEngine:
    """A recursive-query executor for one (mesh, policy, graph shape,
    edge compute, backend) combination."""

    mesh: Mesh
    policy: MorselPolicy
    edge_compute: str
    n_nodes_padded: int
    max_iters: int
    fn: Any
    extend: ExtendSpec = ExtendSpec()

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def __call__(self, graph, *args):
        """Static/phase-1 engines: ``engine(graph, source_morsels)``.
        Resume engines: ``engine(graph, state0, it0)``."""
        with trace.engine_call(self.device):
            return self.fn(strip_operands(self.extend, as_operands(graph)),
                           *args)


def strip_operands(spec: ExtendSpec, ops: GraphOperands) -> GraphOperands:
    """Exactly the operands ``spec`` scans (raises if one is missing)."""
    check_operands(spec, ops)
    return GraphOperands(
        fwd=ops.fwd,
        rev=ops.rev if spec.needs_rev else None,
        rev_binned=ops.rev_binned if spec.needs_binned else None,
        rev_binned_pack=(
            ops.rev_binned_pack if spec.needs_binned_pack else None
        ),
        blocks=ops.blocks if spec.needs_blocks else None,
    )


def _stack_states(states: list):
    return type(states[0])(*(torch.stack(x) for x in zip(*states)))


@dataclasses.dataclass(frozen=True)
class _Layout:
    """One engine's view of the mesh: graph axes ``ga`` (size ``k``),
    source axes ``sa``, and whether state rows are sharded."""

    mesh: Mesh
    ga: Any
    sa: Any
    sharded: bool

    @classmethod
    def of(cls, mesh: Mesh, policy: MorselPolicy, state_layout: str):
        if state_layout not in ("replicated", "sharded"):
            raise ValueError(f"unknown state_layout: {state_layout}")
        missing = [a for a in policy.graph_axes + policy.source_axes
                   if a not in mesh.shape]
        if missing and mesh.size > 1:
            raise ValueError(f"policy axes {missing} are not mesh axes")
        ga = mesh.axes(policy.graph_axes)
        sa = mesh.axes(policy.source_axes)
        return cls(mesh, ga, sa, state_layout == "sharded" and ga.size > 1)

    def ctx(self, n: int, rows_local: int, or_impl: str) -> ExtendCtx:
        """The extension context of this rank's shard (the one-device
        context when the graph axes have size 1)."""
        if self.ga.size == 1:
            return ExtendCtx(n_out=n)
        offset = self.ga.index() * rows_local
        return ExtendCtx(
            n_out=n,
            row_offset=None if self.sharded else offset,
            row_base=offset if self.sharded else None,
            axes=self.ga, or_impl=or_impl, sharded=self.sharded,
        )

    def local_morsels(self, morsels) -> torch.Tensor:
        m = torch.as_tensor(morsels, dtype=torch.int32).cpu()
        if self.sa.size == 1:
            return m
        per = m.shape[0] // self.sa.size
        i = self.sa.index()
        return m[i * per : (i + 1) * per]

    def gather(self, res: IFEResult, stats, rows_sharded: bool):
        """Global results: state rows over the graph axes (sharded
        layout), then morsels over the source axes."""
        state = res.state
        if rows_sharded:
            state = type(state)(*(gather_rows(x, self.ga, 1) for x in state))
        state = type(state)(*(gather_rows(x, self.sa, 0) for x in state))
        it = gather_rows(res.iterations.to(self.mesh.wire_device), self.sa,
                         0).cpu()
        if stats is not None:
            stats = gather_rows(stats, self.sa, 0)
        return IFEResult(state=state, iterations=it), stats


def _run_morsel(ec, be, ops, ctx, state, it: int, cap: int, stats, bw,
                sync_axes, merge):
    """One morsel's convergence loop from (state, it); the stats tap
    writes row ``it`` before each extension. The condition is reduced
    over ``sync_axes``, so every rank of the sync group runs the same
    trip count. Each iteration is one ``engine.iter`` span, on the device's
    current stream from its first launch to its last."""
    dev = state.frontier.device
    while it < cap and any_over(bool((state.frontier != 0).any()),
                                sync_axes):
        with trace.span("engine.iter", dev):
            if stats is not None:
                stats[it] = frontier_stats(ops, state, ctx, bin_widths=bw)
            merged = merge(ec.extend(be, ops, state, ctx))
            state = ec.apply(state, merged, it)
        it += 1
    return state, it


def _result(states, iters, stats_rows, collect_stats):
    res = IFEResult(
        state=_stack_states(states),
        iterations=torch.tensor(iters, dtype=torch.int32),
    )
    return res, (torch.stack(stats_rows) if collect_stats else None)


def build_engine(
    mesh,
    policy: MorselPolicy,
    edge_compute: str,
    n_nodes_padded: int,
    max_iters: int | None = None,
    state_layout: str = "replicated",
    sync: str = "global",
    extend="ell_push",
    collect_stats: bool = False,
) -> QueryEngine:
    """Phase-1 / static engine: ``fn(ops, morsels [m, lanes])`` runs each
    of this rank's morsels to convergence (or ``max_iters``) and returns
    the global stacked ``IFEResult`` (plus ``stats[m, cap, STATS_WIDTH]``
    with ``collect_stats``: row ``it`` is the it-th iteration's
    ``frontier_stats`` sample, rows past the morsel's trips stay zero).

    ``state_layout="sharded"`` keeps only the shard's state rows on each
    rank (sources outside the shard start inert) and merges with a
    reduce-scatter; ``"replicated"`` keeps whole states and all-reduces.
    ``sync`` is as in the module docstring."""
    if sync not in ("global", "shard"):
        raise ValueError(f"unknown sync mode: {sync}")
    mesh = as_mesh(mesh)
    lay = _Layout.of(mesh, policy, state_layout)
    dev = mesh.device
    ec = EDGE_COMPUTES[edge_compute]
    spec = as_spec(extend)
    cap = int(max_iters if max_iters is not None else n_nodes_padded)
    n = n_nodes_padded
    if not policy.graph_axes:
        sync_axes = ()  # no graph split: every rank's morsels run alone
    elif sync == "global":
        sync_axes = lay.sa + lay.ga
    else:
        sync_axes = lay.ga
    # the JAX package's rule for shard sync: where source groups may leave
    # the loop at different trip counts, no ring runs inside it
    divergent = sync == "shard" and lay.sa.size > 1
    or_impl = ("allgather" if divergent and policy.or_impl == "ring"
               else policy.or_impl)
    scatter_impl = "allgather" if divergent else "ring"
    if lay.sharded:
        merge = lambda c: merge_scatter(ec.MERGE, c, lay.ga, or_impl,
                                        impl=scatter_impl)
    else:
        merge = lambda c: merge_contribution(ec.MERGE, c, lay.ga, or_impl)

    def fn(ops: GraphOperands, morsels):
        be = make_backend(spec)
        rows_local = ops.fwd.n_nodes
        ctx = lay.ctx(n, rows_local, or_impl)
        bw = stats_bin_widths(ops) if collect_stats else None
        local = lay.local_morsels(morsels).to(dev)
        states, iters, stats_rows = [], [], []
        for m in range(local.shape[0]):
            stats = (
                torch.zeros((cap, STATS_WIDTH), dtype=torch.float32,
                            device=dev)
                if collect_stats else None
            )
            srcs = local[m]
            if lay.sharded:
                # only this shard's rows: out-of-shard sources become the
                # inert id rows_local
                base = ctx.row_base
                inside = (srcs >= base) & (srcs < base + rows_local)
                state0 = ec.init(rows_local,
                                 torch.where(inside, srcs - base, rows_local))
            else:
                state0 = ec.init(n, srcs)
            state, it = _run_morsel(ec, be, ops, ctx, state0, 0, cap, stats,
                                    bw, sync_axes, merge)
            states.append(state)
            iters.append(it)
            stats_rows.append(stats)
        res, stats = _result(states, iters, stats_rows, collect_stats)
        res, stats = lay.gather(res, stats, lay.sharded)
        return (res, stats) if collect_stats else res

    return QueryEngine(mesh, policy, edge_compute, n, cap, fn, spec)


def _phase2_layout(mesh: Mesh, policy: MorselPolicy, state_layout: str,
                   what: str) -> _Layout:
    if policy.source_axes:
        raise ValueError(
            f"{what} re-dispatches under frontier parallelism; policy "
            f"must not shard sources (got {policy.source_axes})"
        )
    return _Layout.of(mesh, policy, state_layout)


def build_resume_engine(
    mesh,
    policy: MorselPolicy,
    edge_compute: str,
    n_nodes_padded: int,
    max_iters: int | None = None,
    extend="ell_push",
    collect_stats: bool = False,
) -> QueryEngine:
    """Phase-2 engine, one survivor at a time: ``fn(ops, state0, it0)``
    continues each morsel of the stacked replicated ``state0`` from its
    counter ``it0[m]`` under ``policy``'s frontier parallelism (every rank
    of the graph axes cooperates on one frontier). Morsels whose frontier
    is already empty are inert. With ``collect_stats`` the records land
    at each iteration's absolute row (rows below ``it0`` stay zero)."""
    mesh = as_mesh(mesh)
    lay = _phase2_layout(mesh, policy, "replicated", "resume engine")
    dev = mesh.device
    ec = EDGE_COMPUTES[edge_compute]
    spec = as_spec(extend)
    cap = int(max_iters if max_iters is not None else n_nodes_padded)
    n = n_nodes_padded
    merge = lambda c: merge_contribution(ec.MERGE, c, lay.ga, policy.or_impl)

    def fn(ops: GraphOperands, state0, it0):
        be = make_backend(spec)
        ctx = lay.ctx(n, ops.fwd.n_nodes, policy.or_impl)
        bw = stats_bin_widths(ops) if collect_stats else None
        it0 = [int(x) for x in torch.as_tensor(it0).reshape(-1)]
        states, iters, stats_rows = [], [], []
        for m, start in enumerate(it0):
            stats = (
                torch.zeros((cap, STATS_WIDTH), dtype=torch.float32,
                            device=dev)
                if collect_stats else None
            )
            state, it = _run_morsel(ec, be, ops, ctx, _member(state0, m),
                                    start, cap, stats, bw, lay.ga, merge)
            states.append(state)
            iters.append(it)
            stats_rows.append(stats)
        res, stats = _result(states, iters, stats_rows, collect_stats)
        return (res, stats) if collect_stats else res

    return QueryEngine(mesh, policy, edge_compute, n, cap, fn, spec)


def _map_extend(ec, be, ops, state, ctx, live: np.ndarray):
    """Gang extension of a compute with no lane form: ``extend`` per live
    member, results stacked; the engine masks the other members out, so
    they get zeros, not a scan. ``live`` is equal on every rank of the
    graph axes, so every rank runs the same collectives."""
    outs = {int(i): ec.extend(be, ops, _member(state, int(i)), ctx)
            for i in np.nonzero(live)[0]}
    like = next(iter(outs.values()))
    return torch.stack([outs[i] if i in outs else torch.zeros_like(like)
                        for i in range(len(live))])


def build_gang_resume_engine(
    mesh,
    policy: MorselPolicy,
    edge_compute: str,
    n_nodes_padded: int,
    max_iters: int | None = None,
    extend="ell_push",
    state_layout: str = "replicated",
    collect_stats: bool = False,
) -> QueryEngine:
    """Gang-scheduled phase-2 engine: ``fn(ops, state0, it0)`` resumes
    the whole survivor batch (leaves ``[S, ...]``, all-zero pad members
    inert) under one loop. Each iteration runs one gang extension
    (``ec.gang_extend``, lane-packed; a compute with no lane form extends
    its live members one by one, as JAX ``vmap``s it); a member is live
    while its own frontier is non-empty on some rank and its own counter
    is under the cap, and only live members update state and counter.
    Bit-identical to the serial resume, counters included. Each gang
    iteration is one ``engine.iter`` span.

    ``state_layout="sharded"``: ``state0`` holds this rank's rows
    (``collectives.gang_handoff``), the merge is the reduce-scatter of
    ``collectives.gang_merge_scatter``, and the result is gathered to
    global rows."""
    mesh = as_mesh(mesh)
    lay = _phase2_layout(mesh, policy, state_layout, "gang resume engine")
    dev = mesh.device
    ec = EDGE_COMPUTES[edge_compute]
    spec = as_spec(extend)
    cap = int(max_iters if max_iters is not None else n_nodes_padded)
    n = n_nodes_padded
    if lay.sharded:
        merge = lambda c: gang_merge_scatter(ec.MERGE, c, lay.ga,
                                             policy.or_impl)
    else:
        merge = lambda c: merge_contribution(ec.MERGE, c, lay.ga,
                                             policy.or_impl)

    def fn(ops: GraphOperands, state0, it0):
        be = make_backend(spec)
        ctx = lay.ctx(n, ops.fwd.n_nodes, policy.or_impl)
        bw = stats_bin_widths(ops) if collect_stats else None
        state = state0
        gang = int(state.frontier.shape[0])
        it = np.asarray(torch.as_tensor(it0).cpu(), np.int64).reshape(-1)
        stats = (
            torch.zeros((gang, cap, STATS_WIDTH), dtype=torch.float32,
                        device=dev)
            if collect_stats else None
        )
        tail = (1,) * (state.frontier.ndim - 1)
        while True:
            act = (state.frontier != 0).reshape(gang, -1).any(dim=1)
            act = max_allreduce(act.to(torch.int32).to(mesh.wire_device),
                                lay.ga)
            live = act.cpu().numpy().astype(bool) & (it < cap)
            if not live.any():
                break
            with trace.span("engine.iter", dev):
                if stats is not None:
                    for s in np.nonzero(live)[0]:
                        stats[s, min(int(it[s]), cap - 1)] = frontier_stats(
                            ops, _member(state, int(s)), ctx, bin_widths=bw
                        )
                contrib = (ec.gang_extend(be, ops, state, ctx)
                           if ec.LANES_OK
                           else _map_extend(ec, be, ops, state, ctx, live))
                merged = merge(contrib)
                it_b = torch.as_tensor(it, dtype=torch.int32, device=dev)
                applied = ec.apply(state, merged, it_b.view((-1,) + tail))
                mask = torch.as_tensor(live, device=dev)
                state = type(state)(*(
                    torch.where(mask.view((-1,) + (1,) * (new.ndim - 1)),
                                new, old)
                    for new, old in zip(applied, state)
                ))
            it = it + live
        if lay.sharded:
            state = type(state)(*(gather_rows(x, lay.ga, 1) for x in state))
        res = IFEResult(state=state,
                        iterations=torch.tensor(it, dtype=torch.int32))
        return (res, stats) if collect_stats else res

    return QueryEngine(mesh, policy, edge_compute, n, cap, fn, spec)


def _regroup_block_rows(sb: ShardedBlocks, k_shards: int, n_pad: int):
    """Fold ``shards`` stacked fine shards of tiles into ``k_shards``
    coarser policy shards, re-basing the local row-block ids."""
    fine = sb.block_rows.shape[0]
    group = fine // k_shards
    rb_fine = (n_pad // fine) // sb.block_size
    offs = (torch.arange(fine, dtype=torch.int32) % group) * rb_fine
    rows = sb.block_rows + offs[:, None]
    return ShardedBlocks(
        blocks=sb.blocks.reshape(k_shards, -1, *sb.blocks.shape[2:]),
        block_rows=rows.reshape(k_shards, -1),
        block_cols=sb.block_cols.reshape(k_shards, -1),
    )


def prepare_graph(
    csr: CSRGraph,
    mesh,
    policy: MorselPolicy,
    max_deg: int | None = None,
    extend="ell_push",
    pad_shards: int | None = None,
) -> tuple[GraphOperands, int]:
    """This rank's operands for ``policy`` on ``mesh``, placed on its
    device (all from the same truncated edge set). Rows pad to a
    multiple of ``lcm(policy shards, pad_shards) x pad_block`` (32, or
    the tile size for block operands), so bit-packed rings stay
    word-aligned per shard and phase 1 and phase 2 share one ``n_pad``
    (the dispatcher passes ``pad_shards=mesh.size``).

    When the policy shards the graph, the rank builds only its own shard
    (``operand_stream(...).build_shard(k)``, bitwise the matching slice
    of the whole build); otherwise every rank holds the whole graph.
    Returns (operands, n_pad)."""
    mesh = as_mesh(mesh)
    spec = as_spec(extend)
    ga = mesh.axes(policy.graph_axes)
    k_policy = ga.size
    shards = k_policy
    if pad_shards is not None:
        shards = int(math.lcm(shards, int(pad_shards)))
    if k_policy > 1:
        st = operand_stream(csr, spec, max_deg=max_deg, shards=shards,
                            binned_shards=k_policy)
        leaves = st.build_shard(ga.index())
        return operands_from_numpy(leaves, mesh.device), st.n_pad
    ops, n_pad = build_operands(csr, spec, max_deg=max_deg, shards=shards,
                                binned_shards=1)
    if ops.blocks is not None and shards > 1:
        ops = dataclasses.replace(
            ops, blocks=_regroup_block_rows(ops.blocks, 1, n_pad))
    return to_device(ops, mesh.device), n_pad


def run_recursive_query(
    mesh,
    csr: CSRGraph,
    sources,
    policy: MorselPolicy,
    edge_compute: str = "sp_lengths",
    max_iters: int | None = None,
    max_deg: int | None = None,
    state_layout: str = "replicated",
    extend="ell_push",
) -> IFEResult:
    """End-to-end IFE task on a mesh (or a device): states stacked over
    morsels (leading dim = padded morsel count), the same on every rank.
    Every backend and layout gives bit-identical results."""
    mesh = as_mesh(mesh)
    spec = as_spec(extend)
    g, n_pad = prepare_graph(csr, mesh, policy, max_deg, extend=spec)
    src_shards = mesh.axes(policy.source_axes).size
    morsels = pad_sources(np.asarray(sources), src_shards, policy.lanes,
                          n_pad)
    engine = build_engine(
        mesh, policy, edge_compute, n_pad, max_iters,
        state_layout=state_layout, extend=spec,
    )
    return engine(g, morsels)
