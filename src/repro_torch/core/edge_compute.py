"""edgeCompute() implementations (port of ``repro.core.edge_compute``).

An edge compute is a triple: ``extend`` (the frontier-extension scan,
through a backend of ``core.extend``), ``MERGE`` (how contributions
combine across graph shards, ``core.collectives``) and ``apply`` (the
end-of-iteration state update). Ported here: the reach family
(``bfs_levels`` / ``sp_lengths``, ``sp_parents``, ``reachability``,
``msbfs_lengths``, ``msbfs_parents``), the weighted relax
``bellman_ford`` and the non-reach query kinds ``topk_paths``, ``ppr``
and ``pattern_counts``, with the ELL primitives they scan.

Sentinel handling: the JAX scatters drop the out-of-range sentinel id with
``mode="drop"``; PyTorch's indexed updates raise on it instead. The push
primitives here gather only the slots below each row's degree (every slot
past the degree holds the sentinel) and additionally drop any id
``>= n_out``, so no sentinel ever reaches an index.

Summing order: OR, max, min and integer sums do not depend on the order
in which updates land, so those scatters use PyTorch's indexed updates.
A float sum does (PPR's exit test compares float sums with ``EPS``), and
CUDA's atomic ``index_add_`` adds in a different order on every run. So
``ell_push_sum`` adds floats in a fixed order that is the same on the CPU
and the card (``LiveEdges``): each destination's contributions in
ascending source order, one after the other from 0.0, which is the order
JAX's CPU scatter adds them in. Past ``FOLD_WIDTH`` contributions a
destination's sum is folded in groups of ``FOLD_WIDTH`` (the group sums
are folded the same way), so a hub costs a few dozen vector adds, not one
add per in-edge.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..graph.csr import EllGraph
from ..kernels.common import derived
from .frontier import dense_from_sources, lanes_from_sources
from .msbfs import gang_pack_lanes, gang_unpack_lanes

INF_U8 = 255
NO_PARENT = 2**31 - 1
INF = float("inf")

#: bytes of edge-indexed temporaries one push or gather chunk may hold
CHUNK_BUDGET = 1 << 28
#: contributions one destination adds strictly one after the other
FOLD_WIDTH = 64


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


def _row_edges(g: EllGraph, rows: torch.Tensor, n_out: int):
    """(src, slot, dst) int64 of every stored edge out of ``rows`` in row
    then slot order: the slots below each row's degree, sentinel ids
    dropped."""
    deg = g.degrees[rows].long()
    src = torch.repeat_interleave(rows, deg)
    starts = torch.cumsum(deg, 0) - deg
    slot = torch.arange(src.numel(), device=src.device) - torch.repeat_interleave(
        starts, deg
    )
    dst = g.indices[src, slot].long()
    keep = dst < n_out
    return src[keep], slot[keep], dst[keep]


def active_edges(g: EllGraph, active: torch.Tensor, n_out: int):
    """(src, dst) int64 of every stored edge out of an ``active`` row."""
    rows = torch.nonzero(active[: g.n_nodes]).squeeze(1)
    src, _, dst = _row_edges(g, rows, n_out)
    return src, dst


class LiveEdges(NamedTuple):
    """Every stored edge of a forward ELL, built once per slab (the
    scatters of the weighted and additive computes run over it, so no
    padding slot is ever touched), plus the fixed summing plan."""

    src: torch.Tensor  # [m] int64, edges sorted by (dst, src)
    dst: torch.Tensor  # [m] int64
    weights: Optional[torch.Tensor]  # [m] float32, None = unit weights
    folds: tuple  # per level, [rounds, groups] int64 gather map (pad = len)
    out: torch.Tensor  # [n_out] int64 slot of each row's sum (pad = len)


def _fold_plan(dst: torch.Tensor, n_out: int):
    """Gather maps that add each destination's items in their order:
    ``FOLD_WIDTH`` items to a group, one round per item, until every
    destination holds one sum; then where each destination's sum sits."""
    dev = dst.device
    seg = dst
    cnt = torch.bincount(seg, minlength=n_out)
    rows = torch.arange(n_out, device=dev)
    folds = []
    while seg.numel() and int(cnt.max()) > 1:
        m = seg.numel()
        pos = torch.arange(m, device=dev) - (torch.cumsum(cnt, 0) - cnt)[seg]
        groups = (cnt + FOLD_WIDTH - 1) // FOLD_WIDTH
        gid = (torch.cumsum(groups, 0) - groups)[seg] + pos // FOLD_WIDTH
        fmap = torch.full(
            (min(FOLD_WIDTH, int(cnt.max())), int(groups.sum())), m,
            dtype=torch.int64, device=dev,
        )
        fmap[pos % FOLD_WIDTH, gid] = torch.arange(m, device=dev)
        folds.append(fmap)
        seg = torch.repeat_interleave(rows, groups)
        cnt = groups
    out = torch.full((n_out,), seg.numel(), dtype=torch.int64, device=dev)
    out[seg] = torch.arange(seg.numel(), device=dev)
    return tuple(folds), out


def live_edges(g: EllGraph, n_out: int) -> LiveEdges:
    """``g``'s ``LiveEdges`` for ``[n_out]`` outputs, built on first use
    and kept on the slab (``kernels.common.derived``)."""

    def build():
        rows = torch.arange(g.n_nodes, device=g.indices.device)
        src, slot, dst = _row_edges(g, rows, n_out)
        order = torch.argsort(dst, stable=True)  # keeps ascending src
        src, slot, dst = src[order], slot[order], dst[order]
        w = None if g.weights is None else g.weights[src, slot]
        folds, out = _fold_plan(dst, n_out)
        return LiveEdges(src, dst, w, folds, out)

    return derived(g, f"live_edges_{n_out}", build)


def ordered_sum(le: LiveEdges, vals: torch.Tensor) -> torch.Tensor:
    """Per-destination sums of ``vals`` (one per live edge, in ``le``'s
    order) in the fixed order of ``le.folds``: elementwise adds only, so
    the CPU and the card give the same bits."""
    for fmap in le.folds:
        got = torch.cat([vals, vals.new_zeros(1)])[fmap]
        acc = vals.new_zeros(fmap.shape[1])
        for r in range(fmap.shape[0]):
            acc.add_(got[r])
        vals = acc
    return torch.cat([vals, vals.new_zeros(1)])[le.out]


def _local_rows(x: torch.Tensor, rows: int, row_offset) -> torch.Tensor:
    """This shard's rows of a global state tensor (replicated layout);
    ``row_offset=None`` means ``x`` is already local."""
    if row_offset is None:
        return x
    return x[row_offset : row_offset + rows]


def _edge_chunks(n_edges: int, row_bytes: int):
    step = max(1, CHUNK_BUDGET // max(row_bytes, 1))
    return range(0, n_edges, step), step


def ell_reach_dense(g: EllGraph, frontier: torch.Tensor,
                    n_out: int | None = None, *,
                    row_offset=None) -> torch.Tensor:
    """frontier [n] bool -> [n_out] bool: v reached iff some active u has
    u -> v.

    Two state layouts: replicated, ``frontier`` is global and
    ``row_offset`` picks this shard's rows; sharded, ``frontier`` is
    already the shard's rows and ``n_out`` gives the global width. The
    slab's ids are global, so the contribution is ``[n_out]`` either
    way. The other push primitives take the same layout arguments."""
    n = frontier.shape[0] if n_out is None else n_out
    frontier = _local_rows(frontier, g.n_nodes, row_offset)
    _, dst = active_edges(g, frontier, n)
    out = torch.zeros(n, dtype=torch.bool, device=frontier.device)
    out[dst] = True
    return out


def ell_reach_lanes(g: EllGraph, lanes: torch.Tensor,
                    n_out: int | None = None, *,
                    row_offset=None) -> torch.Tensor:
    """[n, L] uint8 -> [n_out, L] uint8 per-lane max over in-edges from
    rows with any active lane (one edge list serves every lane)."""
    n_lanes = lanes.shape[-1]
    n = lanes.shape[0] if n_out is None else n_out
    lanes = _local_rows(lanes, g.n_nodes, row_offset)
    src, dst = active_edges(g, (lanes != 0).any(dim=-1), n)
    out = torch.zeros((n, n_lanes), dtype=lanes.dtype, device=lanes.device)
    starts, step = _edge_chunks(src.numel(), 16 + n_lanes)
    for i in starts:
        out.index_reduce_(0, dst[i : i + step], lanes[src[i : i + step]],
                          "amax")
    return out


def _row_base(row_offset, row_base) -> int:
    """Global id of the shard's first row (0 on one shard)."""
    if row_offset is not None:
        return int(row_offset)
    return 0 if row_base is None else int(row_base)


def ell_min_parent(g: EllGraph, frontier: torch.Tensor,
                   n_out: int | None = None, *, row_offset=None,
                   row_base=None) -> torch.Tensor:
    """cand_parent[v] = min active u with u -> v (NO_PARENT if none);
    ``row_base`` is the global id of the first local row (sharded
    layout)."""
    n = frontier.shape[0] if n_out is None else n_out
    frontier = _local_rows(frontier, g.n_nodes, row_offset)
    src, dst = active_edges(g, frontier, n)
    out = torch.full((n,), NO_PARENT, dtype=torch.int32,
                     device=frontier.device)
    base = _row_base(row_offset, row_base)
    out.index_reduce_(0, dst, (src + base).to(torch.int32), "amin")
    return out


def ell_min_parent_lanes(g: EllGraph, lanes: torch.Tensor,
                         n_out: int | None = None, *, row_offset=None,
                         row_base=None) -> torch.Tensor:
    """Per-lane min-parent: [n, L] uint8 -> [n_out, L] int32."""
    n_lanes = lanes.shape[-1]
    n = lanes.shape[0] if n_out is None else n_out
    lanes = _local_rows(lanes, g.n_nodes, row_offset)
    base = _row_base(row_offset, row_base)
    src, dst = active_edges(g, (lanes != 0).any(dim=-1), n)
    out = torch.full((n, n_lanes), NO_PARENT, dtype=torch.int32,
                     device=lanes.device)
    starts, step = _edge_chunks(src.numel(), 16 + 5 * n_lanes)
    for i in starts:
        s = src[i : i + step]
        cand = torch.where(
            lanes[s] != 0, (s + base).to(torch.int32)[:, None], NO_PARENT
        )
        out.index_reduce_(0, dst[i : i + step], cand, "amin")
    return out


def ell_min_dist(g: EllGraph, dist: torch.Tensor, frontier: torch.Tensor,
                 n_out: int | None = None, *,
                 row_offset=None) -> torch.Tensor:
    """Weighted relax: cand[v] = min over active u of dist[u] + w(u, v)."""
    n = dist.shape[0] if n_out is None else n_out
    le = live_edges(g, n)
    du = _local_rows(torch.where(frontier != 0, dist, INF), g.n_nodes,
                     row_offset)
    cand = du[le.src] + (1.0 if le.weights is None else le.weights)
    out = torch.full((n,), INF, dtype=torch.float32, device=dist.device)
    out.index_reduce_(0, le.dst, cand, "amin")
    return out


def ell_push_sum(g: EllGraph, values: torch.Tensor, n_out: int | None = None,
                 normalize: bool = False, *,
                 row_offset=None) -> torch.Tensor:
    """Additive push: out[v] = sum over rows u with edge u->v of values[u]
    (divided by u's out-degree first with ``normalize``). Integer sums
    are exact in any order and take ``index_add_``; float sums take the
    fixed order of ``ordered_sum``."""
    n = values.shape[0] if n_out is None else n_out
    values = _local_rows(values, g.n_nodes, row_offset)
    if normalize:
        values = values / torch.clamp(g.degrees, min=1).to(values.dtype)
    le = live_edges(g, n)
    vals = values[le.src]
    if values.dtype.is_floating_point:
        return ordered_sum(le, vals)
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_add_(0, le.dst, vals)


class TopkChunk(NamedTuple):
    start: int  # first degree slot of the chunk
    width: int
    rows: Optional[torch.Tensor]  # int64 rows with degree > start (None = all)


def _topk_chunks(rev: EllGraph, k: int) -> tuple:
    """Degree-axis chunks of a reverse ELL for the k-best relax: each
    chunk reads only the rows whose degree reaches into it, and holds at
    most ``CHUNK_BUDGET`` bytes of temporaries. Kept on the slab."""

    def build():
        rows, width_all = rev.indices.shape
        deg = rev.degrees.long()
        per_slot = 16 + 8 * k  # int64 id, f32 weight, k gathered + k cand
        chunks, start = [], 0
        top = int(deg.max()) if rows else 0
        while start < min(top, width_all):
            live = torch.nonzero(deg > start).squeeze(1)
            width = max(1, CHUNK_BUDGET // (per_slot * max(live.numel(), 1)))
            width = min(width, width_all - start)
            chunks.append(TopkChunk(
                start, width, None if live.numel() == rows else live
            ))
            start += width
        return tuple(chunks)

    return derived(rev, f"topk_chunks_{k}", build)


def ell_min_topk(rev: EllGraph, gdists: torch.Tensor,
                 seed_row: torch.Tensor) -> torch.Tensor:
    """Full-Jacobi k-best relax over the reverse ELL: for each row v, the
    k smallest of {gdists[u, :] + w(u, v) : u in-neighbor of v} plus v's
    own seed value, sorted ascending ([rows, k]). Only values are kept, so
    ``topk`` over the merged candidates equals JAX's sort-and-slice. The
    degree axis is read in chunks of live rows (``_topk_chunks``)."""
    rows = rev.indices.shape[0]
    n_out, k = gdists.shape
    acc = torch.full((rows, k), INF, dtype=torch.float32,
                     device=gdists.device)
    acc[:, 0] = seed_row
    ext = torch.cat([gdists, torch.full((1, k), INF, dtype=gdists.dtype,
                                        device=gdists.device)])
    for c in _topk_chunks(rev, k):
        cols = slice(c.start, c.start + c.width)
        ids = rev.indices[:, cols] if c.rows is None else rev.indices[c.rows, cols]
        got = ext[ids.clamp(0, n_out).long()]  # [r, width, k]
        if rev.weights is not None:
            w = rev.weights[:, cols] if c.rows is None else rev.weights[c.rows, cols]
            got = got + w[:, :, None]
        else:
            got = got + 1.0
        prev = acc if c.rows is None else acc[c.rows]
        merged = torch.cat([prev, got.reshape(got.shape[0], -1)], dim=1)
        best = torch.topk(merged, k, dim=1, largest=False, sorted=True).values
        if c.rows is None:
            acc = best
        else:
            acc[c.rows] = best
    return acc


# ---------------------------------------------------------------------------
# Edge computes.
# ---------------------------------------------------------------------------


def _member(state, i: int):
    return type(state)(*(x[i] for x in state))


def fma_f32(m: torch.Tensor, a: float, s: torch.Tensor) -> torch.Tensor:
    """``m + a * s`` over float32 ``m``, ``s`` and a float32-exact ``a``,
    rounded once to float32 as XLA's fused multiply-add rounds it. The
    product is exact in float64; the sum is rounded to odd in float64
    (TwoSum's error term picks the odd neighbour when the sum is inexact),
    and a float64 rounded to odd rounds to the nearest float32 correctly."""
    m64 = m.double()
    p = a * s.double()
    t = m64 + p
    bp = t - m64
    err = (m64 - (t - bp)) + (p - bp)
    odd = torch.nextafter(t, torch.where(err > 0, INF, -INF).double())
    inexact_even = (err != 0) & ((t.view(torch.int64) & 1) == 0)
    return torch.where(inexact_even, odd, t).to(torch.float32)


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
    #: safe to fold into MS-BFS lanes (admission reads QueryKind.lanes_ok)
    LANES_OK = True

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
    LANES_OK = True

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
    LANES_OK = True

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
    LANES_OK = True

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
    LANES_OK = True

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


class BellmanFordState(NamedTuple):
    frontier: torch.Tensor  # [n] bool
    dist: torch.Tensor  # [n] float32


class BellmanFord:
    """Weighted SSSP; nodes may re-enter the frontier (walk semantics)."""

    MERGE = "min"
    LANES_OK = False  # a float-min relax has no saturating lane form

    @staticmethod
    def init(n_nodes: int, sources: torch.Tensor) -> BellmanFordState:
        f = dense_from_sources(n_nodes, sources)
        return BellmanFordState(frontier=f, dist=torch.where(f, 0.0, INF))

    @staticmethod
    def extend(be, ops, state: BellmanFordState, ctx):
        return be.min_dist(ops, state.dist, state.frontier, ctx)

    @staticmethod
    def apply(state: BellmanFordState, cand: torch.Tensor, it):
        return BellmanFordState(frontier=cand < state.dist,
                                dist=torch.minimum(state.dist, cand))


class TopKState(NamedTuple):
    frontier: torch.Tensor  # [n] bool: some slot of this row improved
    dists: torch.Tensor  # [n, K] float32, sorted ascending (inf = empty)
    src_mask: torch.Tensor  # [n] bool


class TopKPaths:
    """Weighted top-k shortest-walk lengths (k-slot Bellman-Ford): each
    round recomputes every row's k best from its seed value and
    ``dists[u, :] + w(u, v)`` over all in-neighbors u, so the loop stops
    at the k-best fixpoint. Pull-only: it scans the reverse ELL."""

    MERGE = "min"
    LANES_OK = False
    K = 4

    @staticmethod
    def init(n_nodes: int, sources: torch.Tensor) -> TopKState:
        src = dense_from_sources(n_nodes, sources)
        dists = torch.full((n_nodes, TopKPaths.K), INF, dtype=torch.float32,
                           device=src.device)
        dists[:, 0] = torch.where(src, 0.0, INF)
        return TopKState(frontier=src, dists=dists, src_mask=src.clone())

    @staticmethod
    def local_extend(g, state, *args, **kwargs):
        raise NotImplementedError(
            "top-k relax is pull-only (scans the reverse ELL); run it "
            "through a backend with reverse operands (extend='ell_pull')"
        )

    @staticmethod
    def extend(be, ops, state: TopKState, ctx):
        return be.min_topk(ops, state.dists, state.src_mask, ctx)

    @staticmethod
    def apply(state: TopKState, merged: torch.Tensor, it):
        return TopKState(frontier=(merged < state.dists).any(dim=-1),
                         dists=merged, src_mask=state.src_mask)


class PPRState(NamedTuple):
    frontier: torch.Tensor  # [n] f32: residual where > EPS, else exactly 0
    residual: torch.Tensor  # [n] f32
    mass: torch.Tensor  # [n] f32, the PPR estimate


class PPRDiffusion:
    """Personalized PageRank by residual diffusion: every round, all rows
    with residual above EPS settle at once; ALPHA of the settled residual
    lands in ``mass`` and (1-ALPHA), out-degree normalized, diffuses to the
    out-neighbors. ``frontier`` holds the residual where it exceeds EPS
    and 0 elsewhere, so the engine's ``any(frontier != 0)`` is the
    convergence test. Rows of out-degree 0 leak their share."""

    MERGE = "sum"
    LANES_OK = False
    ALPHA = 0.15
    EPS = 1e-4

    @staticmethod
    def init(n_nodes: int, sources: torch.Tensor) -> PPRState:
        r = dense_from_sources(n_nodes, sources).to(torch.float32)
        return PPRState(frontier=r, residual=r.clone(),
                        mass=torch.zeros_like(r))

    @staticmethod
    def extend(be, ops, state: PPRState, ctx):
        push = (1.0 - PPRDiffusion.ALPHA) * state.frontier
        return be.push_sum(ops, push, ctx, normalize=True)

    @staticmethod
    def apply(state: PPRState, pushed: torch.Tensor, it):
        settled = state.frontier
        r = state.residual - settled + pushed
        alpha = float(torch.tensor(PPRDiffusion.ALPHA, dtype=torch.float32))
        return PPRState(
            frontier=torch.where(r > PPRDiffusion.EPS, r, 0.0),
            residual=r,
            mass=fma_f32(state.mass, alpha, settled),
        )


class PatternState(NamedTuple):
    frontier: torch.Tensor  # [n] int32: walk counts of the current hop
    wedges: torch.Tensor  # [n] int32: 2-hop walk counts from the seeds
    closed: torch.Tensor  # [n] int32: 3-hop walk counts from the seeds
    src_mask: torch.Tensor  # [n] bool


def _at_hop(it, hop: int, new: torch.Tensor, old):
    """``new`` where the iteration counter equals ``hop``, else ``old``;
    ``it`` is a Python int or a per-member tensor that broadcasts."""
    if isinstance(it, torch.Tensor):
        return torch.where(it == hop, new, old)
    return new if int(it) == hop else old


class PatternCounts:
    """2-3-hop pattern counts (wedges / closed walks) as an additive push
    chain: hop t+1 is c[v] = sum_u c[u] * A[u, v] in int32 (wrapping like
    JAX's). Hop 2 latches ``wedges``, hop 3 latches ``closed`` and zeroes
    the frontier, so the loop stops after exactly HOPS iterations."""

    MERGE = "sum"
    LANES_OK = False
    HOPS = 3

    @staticmethod
    def init(n_nodes: int, sources: torch.Tensor) -> PatternState:
        src = dense_from_sources(n_nodes, sources)
        z = torch.zeros(n_nodes, dtype=torch.int32, device=src.device)
        return PatternState(frontier=src.to(torch.int32), wedges=z,
                            closed=z.clone(), src_mask=src)

    @staticmethod
    def extend(be, ops, state: PatternState, ctx):
        return be.push_sum(ops, state.frontier, ctx)

    @staticmethod
    def apply(state: PatternState, pushed: torch.Tensor, it):
        # it=0 -> pushed = 1-hop counts; it=1 -> 2-hop; it=2 -> 3-hop
        last = PatternCounts.HOPS - 1
        if isinstance(it, torch.Tensor):
            frontier = torch.where(it >= last, 0, pushed)
        else:
            frontier = torch.zeros_like(pushed) if int(it) >= last else pushed
        return PatternState(
            frontier=frontier,
            wedges=_at_hop(it, 1, pushed, state.wedges),
            closed=_at_hop(it, 2, pushed, state.closed),
            src_mask=state.src_mask,
        )


EDGE_COMPUTES = {
    "bfs_levels": BFSLevels,
    "sp_lengths": SPLengths,
    "sp_parents": SPParents,
    "bellman_ford": BellmanFord,
    "reachability": Reachability,
    "msbfs_lengths": MSBFSLengths,
    "msbfs_parents": MSBFSParents,
    "topk_paths": TopKPaths,
    "ppr": PPRDiffusion,
    "pattern_counts": PatternCounts,
}


class QueryKind(NamedTuple):
    """One row of the serving-surface query registry: how a client-facing
    ``query_kind`` maps onto edge computes and what comes back.
    ``edge_compute`` is None for the reach family (the dispatcher picks
    sp/msbfs x lengths/parents); ``lanes_ok`` mirrors the compute's
    LANES_OK and gates MS-BFS lane packing at admission."""

    edge_compute: str | None
    result_leaves: tuple
    needs_weights: bool = False
    lanes_ok: bool = True


QUERY_KINDS = {
    "reach": QueryKind(None, ("levels",)),
    "topk_paths": QueryKind(
        "topk_paths", ("dists",), needs_weights=True, lanes_ok=False
    ),
    "ppr": QueryKind("ppr", ("mass",), lanes_ok=False),
    "pattern_counts": QueryKind(
        "pattern_counts", ("wedges", "closed"), lanes_ok=False
    ),
}
