"""edgeCompute() implementations of the reach family (port of
``repro.core.edge_compute``).

An edge compute is a triple: ``extend`` (the frontier-extension scan,
through a backend of ``core.extend``), ``MERGE`` (how contributions
combine across graph shards; identity on one device) and ``apply`` (the
end-of-iteration state update). Ported here: ``bfs_levels`` /
``sp_lengths``, ``sp_parents``, ``reachability``, ``msbfs_lengths`` and
``msbfs_parents``, with the push primitives over the forward ELL they
scan.

Sentinel handling: the JAX scatters drop the out-of-range sentinel id with
``mode="drop"``; PyTorch's indexed updates raise on it instead. The push
primitives here gather only the slots below each active row's degree
(every slot past the degree holds the sentinel) and additionally drop any
id ``>= n_out``, so no sentinel ever reaches an index. Every reduction is
an OR, a max or a min, so the result does not depend on the order in
which PyTorch applies the updates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph.csr import EllGraph
from .frontier import dense_from_sources, lanes_from_sources
from .msbfs import gang_pack_lanes, gang_unpack_lanes

INF_U8 = 255
NO_PARENT = 2**31 - 1

#: bytes of edge-indexed temporaries one push or gather chunk may hold
CHUNK_BUDGET = 1 << 28


# ---------------------------------------------------------------------------
# Degree chunking (shared with the pull gathers in core.extend).
# ---------------------------------------------------------------------------


def _deg_chunk(rows: int, width: int, budget: int = 2 << 30) -> int:
    """Largest power of two ``c`` with ``rows * c * width <= budget`` (at
    least 1): the degree-axis chunk that bounds a ``[rows, c, width]``
    temporary."""
    per_slot = max(rows * width, 1)
    c = max(budget // per_slot, 1)
    return 1 << (int(c).bit_length() - 1)


def chunk_fold(D: int, chunk: int, step, acc0):
    """Fold ``step(start, width, acc)`` over the degree axis ``[0, D)`` in
    ``chunk``-sized pieces plus one remainder piece. Ascending slot order
    either way, so order-invariant reductions equal the single-shot
    fold."""
    full, rem = divmod(D, chunk)
    acc = acc0
    for i in range(full):
        acc = step(i * chunk, chunk, acc)
    if rem:
        acc = step(full * chunk, rem, acc)
    return acc


# ---------------------------------------------------------------------------
# Push primitives over the forward ELL.
# ---------------------------------------------------------------------------


def active_edges(g: EllGraph, active: torch.Tensor, n_out: int):
    """(src, dst) int64 of every stored edge out of an ``active`` row: the
    slots below each row's degree, sentinel ids dropped."""
    rows = torch.nonzero(active[: g.n_nodes]).squeeze(1)
    deg = g.degrees[rows].long()
    src = torch.repeat_interleave(rows, deg)
    starts = torch.cumsum(deg, 0) - deg
    slot = torch.arange(src.numel(), device=src.device) - torch.repeat_interleave(
        starts, deg
    )
    dst = g.indices[src, slot].long()
    keep = dst < n_out
    return src[keep], dst[keep]


def _edge_chunks(n_edges: int, row_bytes: int):
    step = max(1, CHUNK_BUDGET // max(row_bytes, 1))
    return range(0, n_edges, step), step


def ell_reach_dense(g: EllGraph, frontier: torch.Tensor,
                    n_out: int | None = None) -> torch.Tensor:
    """frontier [n] bool -> [n_out] bool: v reached iff some active u has
    u -> v."""
    n = frontier.shape[0] if n_out is None else n_out
    _, dst = active_edges(g, frontier, n)
    out = torch.zeros(n, dtype=torch.bool, device=frontier.device)
    out[dst] = True
    return out


def ell_reach_lanes(g: EllGraph, lanes: torch.Tensor,
                    n_out: int | None = None) -> torch.Tensor:
    """[n, L] uint8 -> [n_out, L] uint8 per-lane max over in-edges from
    rows with any active lane (one edge list serves every lane)."""
    n_lanes = lanes.shape[-1]
    n = lanes.shape[0] if n_out is None else n_out
    src, dst = active_edges(g, (lanes != 0).any(dim=-1), n)
    out = torch.zeros((n, n_lanes), dtype=lanes.dtype, device=lanes.device)
    starts, step = _edge_chunks(src.numel(), 16 + n_lanes)
    for i in starts:
        out.index_reduce_(0, dst[i : i + step], lanes[src[i : i + step]],
                          "amax")
    return out


def ell_min_parent(g: EllGraph, frontier: torch.Tensor,
                   n_out: int | None = None) -> torch.Tensor:
    """cand_parent[v] = min active u with u -> v (NO_PARENT if none)."""
    n = frontier.shape[0] if n_out is None else n_out
    src, dst = active_edges(g, frontier, n)
    out = torch.full((n,), NO_PARENT, dtype=torch.int32,
                     device=frontier.device)
    out.index_reduce_(0, dst, src.to(torch.int32), "amin")
    return out


def ell_min_parent_lanes(g: EllGraph, lanes: torch.Tensor,
                         n_out: int | None = None) -> torch.Tensor:
    """Per-lane min-parent: [n, L] uint8 -> [n_out, L] int32."""
    n_lanes = lanes.shape[-1]
    n = lanes.shape[0] if n_out is None else n_out
    src, dst = active_edges(g, (lanes != 0).any(dim=-1), n)
    out = torch.full((n, n_lanes), NO_PARENT, dtype=torch.int32,
                     device=lanes.device)
    starts, step = _edge_chunks(src.numel(), 16 + 5 * n_lanes)
    for i in starts:
        s = src[i : i + step]
        cand = torch.where(
            lanes[s] != 0, s.to(torch.int32)[:, None], NO_PARENT
        )
        out.index_reduce_(0, dst[i : i + step], cand, "amin")
    return out


# ---------------------------------------------------------------------------
# Edge computes.
# ---------------------------------------------------------------------------




def _lane_level(it, like: torch.Tensor):
    """(it + 1) as the uint8 level (wrapping like JAX's astype)."""
    if isinstance(it, torch.Tensor):
        return ((it + 1) & 0xFF).to(torch.uint8)
    return (int(it) + 1) & 0xFF


class SPLengthState(NamedTuple):
    frontier: torch.Tensor  # [n] bool
    visited: torch.Tensor  # [n] bool
    levels: torch.Tensor  # [n] int32 (-1 = unreached)


class SPLengths:
    """Unweighted shortest-path lengths (paper Listing 2)."""

    MERGE = "or"

    @staticmethod
    def init(n_nodes: int, sources: torch.Tensor) -> SPLengthState:
        f = dense_from_sources(n_nodes, sources)
        levels = torch.where(f, 0, -1).to(torch.int32)
        return SPLengthState(frontier=f, visited=f.clone(), levels=levels)

    @staticmethod
    def extend(be, ops, state: SPLengthState, ctx):
        return be.reach_dense(ops, state.frontier, state.visited, ctx)

    @staticmethod
    def gang_extend(be, ops, state: SPLengthState, ctx):
        """Dense survivors repacked as MS-BFS lanes: one shared scan
        serves the whole gang (``[S, n]`` leaves)."""
        gang = state.frontier.shape[0]
        reached = be.reach_lanes(
            ops, gang_pack_lanes(state.frontier), gang_pack_lanes(state.visited), ctx
        )
        return gang_unpack_lanes(reached, gang) != 0

    @staticmethod
    def apply(state: SPLengthState, reached: torch.Tensor, it):
        new = reached & ~state.visited
        return SPLengthState(
            frontier=new,
            visited=state.visited | new,
            levels=torch.where(new, it + 1, state.levels).to(torch.int32),
        )


class BFSLevels(SPLengths):
    """Alias: BFS levels are unweighted SP lengths."""


class ReachState(NamedTuple):
    frontier: torch.Tensor
    visited: torch.Tensor


class Reachability:
    MERGE = "or"

    @staticmethod
    def init(n_nodes: int, sources: torch.Tensor) -> ReachState:
        f = dense_from_sources(n_nodes, sources)
        return ReachState(frontier=f, visited=f.clone())

    @staticmethod
    def extend(be, ops, state: ReachState, ctx):
        return be.reach_dense(ops, state.frontier, state.visited, ctx)

    @staticmethod
    def gang_extend(be, ops, state: ReachState, ctx):
        gang = state.frontier.shape[0]
        reached = be.reach_lanes(
            ops, gang_pack_lanes(state.frontier), gang_pack_lanes(state.visited), ctx
        )
        return gang_unpack_lanes(reached, gang) != 0

    @staticmethod
    def apply(state: ReachState, reached: torch.Tensor, it):
        new = reached & ~state.visited
        return ReachState(frontier=new, visited=state.visited | new)


class SPParentState(NamedTuple):
    frontier: torch.Tensor
    visited: torch.Tensor
    levels: torch.Tensor
    parents: torch.Tensor  # [n] int32, NO_PARENT where unreached


class SPParents:
    """Shortest paths with parent pointers (paper Listing 4): the
    contribution is (reached, min candidate parent)."""

    MERGE = "or_min"

    @staticmethod
    def init(n_nodes: int, sources: torch.Tensor) -> SPParentState:
        base = SPLengths.init(n_nodes, sources)
        parents = torch.full((n_nodes,), NO_PARENT, dtype=torch.int32,
                             device=sources.device)
        return SPParentState(base.frontier, base.visited, base.levels, parents)

    @staticmethod
    def extend(be, ops, state: SPParentState, ctx):
        return be.reach_parent_dense(ops, state.frontier, state.visited, ctx)

    @staticmethod
    def gang_extend(be, ops, state: SPParentState, ctx):
        gang = state.frontier.shape[0]
        reached, parents = be.reach_parent_lanes(
            ops, gang_pack_lanes(state.frontier), gang_pack_lanes(state.visited), ctx
        )
        return gang_unpack_lanes(reached, gang) != 0, gang_unpack_lanes(parents, gang)

    @staticmethod
    def apply(state: SPParentState, merged, it):
        reached, parent_cand = merged
        new = reached & ~state.visited
        return SPParentState(
            frontier=new,
            visited=state.visited | new,
            levels=torch.where(new, it + 1, state.levels).to(torch.int32),
            parents=torch.where(new, parent_cand, state.parents),
        )


class MSBFSState(NamedTuple):
    frontier: torch.Tensor  # [n, L] uint8
    visited: torch.Tensor  # [n, L] uint8
    levels: torch.Tensor  # [n, L] uint8 (255 = unreached)


class MSBFSLengths:
    """Multi-source BFS lengths over L lanes (paper §3.4); uint8 levels."""

    MERGE = "or"
    LANES = 64

    @staticmethod
    def init(n_nodes: int, sources: torch.Tensor) -> MSBFSState:
        f = lanes_from_sources(n_nodes, sources)
        levels = torch.full(f.shape, INF_U8, dtype=torch.uint8,
                            device=f.device)
        levels[f != 0] = 0
        return MSBFSState(frontier=f, visited=f.clone(), levels=levels)

    @staticmethod
    def extend(be, ops, state: MSBFSState, ctx):
        return be.reach_lanes(ops, state.frontier, state.visited, ctx)

    @staticmethod
    def gang_extend(be, ops, state: MSBFSState, ctx):
        gang, n_lanes = state.frontier.shape[0], state.frontier.shape[-1]
        reached = be.reach_lanes(
            ops, gang_pack_lanes(state.frontier), gang_pack_lanes(state.visited), ctx
        )
        return gang_unpack_lanes(reached, gang, n_lanes)

    @staticmethod
    def apply(state: MSBFSState, reached: torch.Tensor, it):
        new = reached & ~state.visited
        return MSBFSState(
            frontier=new,
            visited=state.visited | new,
            levels=torch.where(new != 0, _lane_level(it, new),
                               state.levels),
        )


class MSBFSParentState(NamedTuple):
    frontier: torch.Tensor
    visited: torch.Tensor
    levels: torch.Tensor
    parents: torch.Tensor  # [n, L] int32


class MSBFSParents:
    """Multi-source BFS with per-lane parents."""

    MERGE = "or_min"
    LANES = 64

    @staticmethod
    def init(n_nodes: int, sources: torch.Tensor) -> MSBFSParentState:
        base = MSBFSLengths.init(n_nodes, sources)
        parents = torch.full(base.frontier.shape, NO_PARENT,
                             dtype=torch.int32, device=sources.device)
        return MSBFSParentState(base.frontier, base.visited, base.levels,
                                parents)

    @staticmethod
    def extend(be, ops, state: MSBFSParentState, ctx):
        return be.reach_parent_lanes(ops, state.frontier, state.visited, ctx)

    @staticmethod
    def gang_extend(be, ops, state: MSBFSParentState, ctx):
        gang, n_lanes = state.frontier.shape[0], state.frontier.shape[-1]
        reached, parents = be.reach_parent_lanes(
            ops, gang_pack_lanes(state.frontier), gang_pack_lanes(state.visited), ctx
        )
        return (gang_unpack_lanes(reached, gang, n_lanes),
                gang_unpack_lanes(parents, gang, n_lanes))

    @staticmethod
    def apply(state: MSBFSParentState, merged, it):
        reached, parent_cand = merged
        new = reached & ~state.visited
        is_new = new != 0
        return MSBFSParentState(
            frontier=new,
            visited=state.visited | new,
            levels=torch.where(is_new, _lane_level(it, new), state.levels),
            parents=torch.where(is_new, parent_cand, state.parents),
        )


EDGE_COMPUTES = {
    "bfs_levels": BFSLevels,
    "sp_lengths": SPLengths,
    "sp_parents": SPParents,
    "reachability": Reachability,
    "msbfs_lengths": MSBFSLengths,
    "msbfs_parents": MSBFSParents,
}


class QueryKind(NamedTuple):
    """One row of the serving-surface query registry: how a client-facing
    ``query_kind`` maps onto edge computes and what comes back."""

    edge_compute: str | None
    result_leaves: tuple
    lanes_ok: bool = True


#: the port serves the reach family only; the JAX package's
#: topk_paths / ppr / pattern_counts kinds are a later slice
QUERY_KINDS = {
    "reach": QueryKind(None, ("levels",)),
}
