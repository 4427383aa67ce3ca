"""Morsel dispatcher on one device (port of ``repro.core.dispatcher``).

The JAX package compiles a ``shard_map`` program per (mesh, policy,
graph shape, edge compute, backend). The port runs on one
``torch.device``: the mesh's source and graph axes have size 1, so an
engine is a host loop over morsels, each with its own convergence loop
(the paper's "sticky" worker finishes a morsel before taking the next):

- ``build_engine``: phase 1 or the static program; ``sync`` is accepted
  for parity (per-morsel convergence is the only behaviour on one device);
- ``build_resume_engine``: phase 2, one survivor at a time from its saved
  state and iteration counter;
- ``build_gang_resume_engine``: phase 2 for all survivors under one loop,
  their frontiers lane-packed so one scan serves the gang (a compute
  with no lane form extends member by member instead, where JAX
  ``vmap``s it), with per-survivor masks so each survivor's state and
  counter advance only while it is live. Counts equal the serial
  resume's exactly.

Each loop condition is read on the host: one sync per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..graph.csr import CSRGraph
from ..kernels.common import resolve_device, to_device
from .collectives import merge_contribution
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
    """A recursive-query executor for one (device, policy, graph shape,
    edge compute, backend) combination."""

    device: torch.device
    policy: MorselPolicy
    edge_compute: str
    n_nodes_padded: int
    max_iters: int
    fn: Any
    extend: ExtendSpec = ExtendSpec()

    def __call__(self, graph, *args):
        """Static/phase-1 engines: ``engine(graph, source_morsels)``.
        Resume engines: ``engine(graph, state0, it0)``."""
        return self.fn(strip_operands(self.extend, as_operands(graph)), *args)


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


def _check_layout(state_layout: str) -> None:
    if state_layout != "replicated":
        raise NotImplementedError(
            f"state_layout={state_layout!r}: the sharded state layout is "
            "not ported yet (ROADMAP queue 1: multi-device collectives and "
            "the sharded layout)"
        )


def _stack_states(states: list):
    return type(states[0])(*(torch.stack(x) for x in zip(*states)))


def _run_morsel(ec, be, ops, ctx, state, it: int, cap: int, stats, bw):
    """One morsel's convergence loop from (state, it); the stats tap
    writes row ``it`` before each extension."""
    while it < cap and bool((state.frontier != 0).any()):
        if stats is not None:
            stats[it] = frontier_stats(ops, state, ctx, bin_widths=bw)
        merged = merge_contribution(ec.MERGE, ec.extend(be, ops, state, ctx))
        state = ec.apply(state, merged, it)
        it += 1
    return state, it


def _result(states, iters, stats_rows, collect_stats):
    res = IFEResult(
        state=_stack_states(states),
        iterations=torch.tensor(iters, dtype=torch.int32),
    )
    if collect_stats:
        return res, torch.stack(stats_rows)
    return res


def build_engine(
    device,
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
    morsel to convergence (or ``max_iters``) and returns the stacked
    ``IFEResult`` (plus ``stats[m, cap, STATS_WIDTH]`` with
    ``collect_stats``: row ``it`` is the it-th iteration's
    ``frontier_stats`` sample, rows past the morsel's trips stay zero)."""
    if sync not in ("global", "shard"):
        raise ValueError(f"unknown sync mode: {sync}")
    _check_layout(state_layout)
    dev = resolve_device(device)
    ec = EDGE_COMPUTES[edge_compute]
    spec = as_spec(extend)
    cap = int(max_iters if max_iters is not None else n_nodes_padded)
    n = n_nodes_padded

    def fn(ops: GraphOperands, morsels):
        be = make_backend(spec)
        ctx = ExtendCtx(n_out=n)
        bw = stats_bin_widths(ops) if collect_stats else None
        morsels = torch.as_tensor(morsels, dtype=torch.int32).to(dev)
        states, iters, stats_rows = [], [], []
        for m in range(morsels.shape[0]):
            stats = (
                torch.zeros((cap, STATS_WIDTH), dtype=torch.float32,
                            device=dev)
                if collect_stats else None
            )
            state, it = _run_morsel(ec, be, ops, ctx, ec.init(n, morsels[m]),
                                    0, cap, stats, bw)
            states.append(state)
            iters.append(it)
            stats_rows.append(stats)
        return _result(states, iters, stats_rows, collect_stats)

    return QueryEngine(dev, policy, edge_compute, n, cap, fn, spec)


def build_resume_engine(
    device,
    policy: MorselPolicy,
    edge_compute: str,
    n_nodes_padded: int,
    max_iters: int | None = None,
    extend="ell_push",
    collect_stats: bool = False,
) -> QueryEngine:
    """Phase-2 engine, one survivor at a time: ``fn(ops, state0, it0)``
    continues each morsel of the stacked ``state0`` from its counter
    ``it0[m]``. Morsels whose frontier is already empty are inert. With
    ``collect_stats`` the records land at each iteration's absolute row
    (rows below ``it0`` stay zero)."""
    if policy.source_axes:
        raise ValueError(
            "resume engine re-dispatches under frontier parallelism; "
            f"policy must not shard sources (got {policy.source_axes})"
        )
    dev = resolve_device(device)
    ec = EDGE_COMPUTES[edge_compute]
    spec = as_spec(extend)
    cap = int(max_iters if max_iters is not None else n_nodes_padded)
    n = n_nodes_padded

    def fn(ops: GraphOperands, state0, it0):
        be = make_backend(spec)
        ctx = ExtendCtx(n_out=n)
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
                                    start, cap, stats, bw)
            states.append(state)
            iters.append(it)
            stats_rows.append(stats)
        return _result(states, iters, stats_rows, collect_stats)

    return QueryEngine(dev, policy, edge_compute, n, cap, fn, spec)


def _map_extend(ec, be, ops, state, ctx, live: np.ndarray):
    """Gang extension of a compute with no lane form: ``extend`` per live
    member, results stacked; the engine masks the other members out, so
    they get zeros, not a scan."""
    outs = {int(i): ec.extend(be, ops, _member(state, int(i)), ctx)
            for i in np.nonzero(live)[0]}
    like = next(iter(outs.values()))
    return torch.stack([outs[i] if i in outs else torch.zeros_like(like)
                        for i in range(len(live))])


def build_gang_resume_engine(
    device,
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
    its live members one by one, as JAX ``vmap``s it); a member is live while its own frontier is
    non-empty and its own counter is under the cap, and only live members
    update state and counter. Bit-identical to the serial resume,
    counters included."""
    if policy.source_axes:
        raise ValueError(
            "gang resume engine re-dispatches under frontier parallelism; "
            f"policy must not shard sources (got {policy.source_axes})"
        )
    _check_layout(state_layout)
    dev = resolve_device(device)
    ec = EDGE_COMPUTES[edge_compute]
    spec = as_spec(extend)
    cap = int(max_iters if max_iters is not None else n_nodes_padded)
    n = n_nodes_padded

    def fn(ops: GraphOperands, state0, it0):
        be = make_backend(spec)
        ctx = ExtendCtx(n_out=n)
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
            live = act.cpu().numpy() & (it < cap)
            if not live.any():
                break
            if stats is not None:
                for s in np.nonzero(live)[0]:
                    stats[s, min(int(it[s]), cap - 1)] = frontier_stats(
                        ops, _member(state, int(s)), ctx, bin_widths=bw
                    )
            contrib = (ec.gang_extend(be, ops, state, ctx) if ec.LANES_OK
                       else _map_extend(ec, be, ops, state, ctx, live))
            merged = merge_contribution(ec.MERGE, contrib)
            it_b = torch.as_tensor(it, dtype=torch.int32, device=dev)
            applied = ec.apply(state, merged, it_b.view((-1,) + tail))
            mask = torch.as_tensor(live, device=dev)
            state = type(state)(*(
                torch.where(mask.view((-1,) + (1,) * (new.ndim - 1)),
                            new, old)
                for new, old in zip(applied, state)
            ))
            it = it + live
        res = IFEResult(state=state,
                        iterations=torch.tensor(it, dtype=torch.int32))
        return (res, stats) if collect_stats else res

    return QueryEngine(dev, policy, edge_compute, n, cap, fn, spec)


def prepare_graph(
    csr: CSRGraph,
    device,
    policy: MorselPolicy,
    max_deg: int | None = None,
    extend="ell_push",
) -> tuple[GraphOperands, int]:
    """Host build of the operands ``extend`` scans (all from the same
    truncated edge set), placed on ``device``. Rows pad to a multiple of
    ``pad_block`` (32, or the tile size for block operands)."""
    dev = resolve_device(device)
    spec = as_spec(extend)
    ops, n_pad = build_operands(csr, spec, max_deg=max_deg)
    return to_device(ops, dev), n_pad


def run_recursive_query(
    device,
    csr: CSRGraph,
    sources,
    policy: MorselPolicy,
    edge_compute: str = "sp_lengths",
    max_iters: int | None = None,
    max_deg: int | None = None,
    state_layout: str = "replicated",
    extend="ell_push",
) -> IFEResult:
    """End-to-end IFE task: states stacked over morsels (leading dim =
    padded morsel count). Every backend gives bit-identical results."""
    _check_layout(state_layout)
    spec = as_spec(extend)
    g, n_pad = prepare_graph(csr, device, policy, max_deg, extend=spec)
    morsels = pad_sources(np.asarray(sources), 1, policy.lanes, n_pad)
    engine = build_engine(
        device, policy, edge_compute, n_pad, max_iters,
        state_layout=state_layout, extend=spec,
    )
    return engine(g, morsels)
