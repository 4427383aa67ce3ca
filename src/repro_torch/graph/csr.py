"""Graph storage structures (port of ``repro.graph.csr``).

- ``CSRGraph`` (host, numpy): canonical compressed-sparse-row adjacency.
- ``EllGraph``: padded fixed-width neighbor lists. Every row has
  ``max_deg`` slots; empty slots hold the out-of-range sentinel
  ``n_nodes``, which every scatter and gather of the port drops or reads
  as the neutral element.
- ``BinnedRevEll``: degree-binned reverse-adjacency slabs for the
  bottom-up (pull) extension; each degree bucket is its own slab padded
  only to that bucket's width, and a (permutation, inverse) pair restores
  the original row order.
- ``BlockAdjacency`` / ``ShardedBlocks``: 0/1 ``[B, B]`` int8 tiles of the
  adjacency matrix plus tile coordinates, the operand of the MS-BFS block
  kernel.

Per-shard builders (``binned_plan`` / ``binned_rev_shard``, ``ell_shard``,
``sharded_blocks_nb`` / ``sharded_blocks_shard``) build one rank's shard
alone, bitwise equal to the matching slice of the whole-graph build.

The builders are the JAX package's numpy builders, unchanged; they return
CPU tensors (``torch.from_numpy``), which callers move to their device.
Node ids are int32 throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Host-side CSR adjacency (out-edges)."""

    indptr: np.ndarray  # [n_nodes + 1] int64
    indices: np.ndarray  # [n_edges] int32, destination node ids
    weights: Optional[np.ndarray] = None  # [n_edges] float32 (optional)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return int(self.indptr[-1])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def avg_degree(self) -> float:
        return self.n_edges / max(self.n_nodes, 1)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]

    def reverse(self) -> "CSRGraph":
        """In-edge CSR (transpose); stable in the forward edge order."""
        n = self.n_nodes
        src = np.repeat(np.arange(n, dtype=np.int32), self.degrees)
        order = np.argsort(self.indices, kind="stable")
        rindices = src[order]
        rindptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(rindptr, self.indices + 1, 1)
        rindptr = np.cumsum(rindptr)
        w = None if self.weights is None else self.weights[order]
        return CSRGraph(indptr=rindptr, indices=rindices, weights=w)

    def edge_list(self) -> tuple[np.ndarray, np.ndarray]:
        src = np.repeat(
            np.arange(self.n_nodes, dtype=np.int32), self.degrees
        )
        return src, self.indices.astype(np.int32)

    def edge_keys(self) -> np.ndarray:
        """Sorted ``src * n_nodes + dst`` int64 keys, one per edge (strictly
        increasing for a deduped CSR). Raises past the int32 node-id range
        the operand layouts support."""
        if self.n_nodes >= 2**31:
            raise ValueError(
                f"n_nodes={self.n_nodes} exceeds the int32 node-id range "
                "(< 2**31) that edge keys and operand layouts support"
            )
        src = np.repeat(np.arange(self.n_nodes, dtype=np.int64), self.degrees)
        return src * self.n_nodes + self.indices.astype(np.int64)


def csr_from_edges(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: Optional[np.ndarray] = None,
    dedup: bool = True,
) -> CSRGraph:
    """Build CSR from an edge list, sorting and (optionally) deduplicating.

    The dedup is stable keep-first over the ``src * n_nodes + dst`` key:
    among duplicate edges the earliest in input order survives, weights
    included. ``n_nodes`` must be below ``2**31``: node ids are stored as
    int32, so larger graphs would wrap on the cast; this raises instead."""
    if n_nodes >= 2**31:
        raise ValueError(
            f"n_nodes={n_nodes} exceeds the int32 node-id range (< 2**31); "
            "indices would silently wrap on the int32 cast"
        )
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    key = src * n_nodes + dst
    order = np.argsort(key, kind="stable")
    key, src, dst = key[order], src[order], dst[order]
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)[order]
    if dedup and len(key):
        keep = np.concatenate([[True], key[1:] != key[:-1]])
        src, dst = src[keep], dst[keep]
        if weights is not None:
            weights = weights[keep]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(
        indptr=indptr, indices=dst.astype(np.int32), weights=weights
    )


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Padded neighbor lists: ``indices[v, j]`` is the j'th out-neighbor of
    v, or the sentinel (the padded node count) when ``j >= degrees[v]``."""

    indices: torch.Tensor  # [n_nodes, max_deg] int32
    degrees: torch.Tensor  # [n_nodes] int32
    weights: Optional[torch.Tensor] = None  # [n_nodes, max_deg] float32

    @property
    def n_nodes(self) -> int:
        return int(self.indices.shape[0])

    @property
    def max_deg(self) -> int:
        return int(self.indices.shape[1])

    @property
    def mask(self) -> torch.Tensor:
        """[n_nodes, max_deg] bool: slot j of row v holds an edge."""
        slots = torch.arange(self.max_deg, dtype=torch.int32,
                             device=self.indices.device)
        return slots[None, :] < self.degrees[:, None]


def _ell_slot_positions(
    indptr: np.ndarray, cap: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row, slot, csr_position) triples of every kept edge: slot j of row
    v maps to csr position indptr[v] + j, for j < min(deg, cap)."""
    degs = np.diff(indptr).astype(np.int64)
    kept = np.minimum(degs, cap)
    rows = np.repeat(np.arange(len(degs), dtype=np.int64), kept)
    total = int(kept.sum())
    slots = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(kept) - kept, kept
    )
    pos = indptr[:-1][rows] + slots
    return rows, slots, pos


def ell_from_csr(
    csr: CSRGraph, max_deg: Optional[int] = None, pad_to_multiple: int = 8
) -> EllGraph:
    """CSR -> ELL, truncating rows beyond ``max_deg`` if given. A zero
    effective cap yields a genuine zero-width ``[n, 0]`` slab."""
    n = csr.n_nodes
    degs = csr.degrees.astype(np.int32)
    if max_deg is None:
        cap = int(degs.max()) if n else 0
    else:
        cap = max(int(max_deg), 0)
    if cap > 0:
        cap = -(-cap // pad_to_multiple) * pad_to_multiple
    # torch fills the slab on all its threads (numpy's fill of a
    # multi-GB slab is one thread faulting its pages in); the edges are
    # written through the numpy view
    indices = torch.full((n, cap), n, dtype=torch.int32)  # sentinel = n
    rows, slots, pos = _ell_slot_positions(csr.indptr, cap)
    indices.numpy()[rows, slots] = csr.indices[pos]
    w = None
    if csr.weights is not None:
        w = torch.zeros((n, cap), dtype=torch.float32)
        w.numpy()[rows, slots] = csr.weights[pos]
    clipped = np.minimum(degs, cap).astype(np.int32)
    return EllGraph(indices=indices, degrees=_t(clipped), weights=w)


def truncate_csr(csr: CSRGraph, max_deg: Optional[int]) -> CSRGraph:
    """The effective graph after an ELL degree cap: the first ``max_deg``
    out-edges per node. Every other operand derives from it, so every
    extension backend scans the same edge set."""
    if max_deg is None or (len(csr.degrees) == 0) or (
        int(csr.degrees.max()) <= max_deg
    ):
        return csr
    rows, _, pos = _ell_slot_positions(csr.indptr, int(max_deg))
    kept = np.minimum(csr.degrees, int(max_deg))
    indptr = np.zeros(csr.n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(kept)
    return CSRGraph(
        indptr=indptr,
        indices=csr.indices[pos].astype(np.int32),
        weights=None if csr.weights is None else csr.weights[pos],
    )


@dataclasses.dataclass(frozen=True)
class BinnedRevEll:
    """Degree-binned reverse-adjacency slabs (the pull-gather operand).

    ``slabs[b]`` is ``[K, rows_b, width_b]`` int32 in-neighbor ids
    (sentinel = padded row count); bucket 0 is the zero-width slab of
    rows with no in-edges. ``perm[k, p]`` is the local row stored at
    binned position ``p`` (``rows_local`` at slab-padding positions) and
    ``inv[k, r]`` the binned position of local row ``r``, so the
    concatenated per-slab results gathered at ``inv`` are back in row
    order. ``K`` is the number of graph shards stacked (1 on one device
    and on a rank of a mesh, which holds only its own shard)."""

    slabs: tuple  # of [K, rows_b, width_b] int32 per bucket
    perm: torch.Tensor  # [K, rows_binned] int32
    inv: torch.Tensor  # [K, rows_local] int32
    slab_weights: Optional[tuple] = None  # [K, rows_b, width_b] f32 each

    @property
    def n_slabs(self) -> int:
        return len(self.slabs)

    @property
    def rows_local(self) -> int:
        return int(self.inv.shape[-1])

    @property
    def widths(self) -> tuple:
        return tuple(int(s.shape[-1]) for s in self.slabs)

    @property
    def capacity_slots(self) -> int:
        """Adjacency slots of one shard's full scan."""
        return int(sum(s.shape[-2] * s.shape[-1] for s in self.slabs))

    def row_widths(self) -> np.ndarray:
        """[K, rows_local] host array: each local row's slab width."""
        w = np.concatenate(
            [
                np.full((s.shape[-2],), s.shape[-1], np.int64)
                for s in self.slabs
            ]
        )
        return w[self.inv.cpu().numpy()]


def _degree_bucket_edges(
    degs: np.ndarray, max_overhead: float
) -> list[tuple[int, int]]:
    """Inclusive (lo, hi) degree ranges of the nonzero buckets: pow2
    bucket edges refined so every bucket has ``hi <= max_overhead * lo``."""
    uniq = np.unique(degs[degs > 0])
    edges: list[tuple[int, int]] = []
    i = 0
    while i < len(uniq):
        lo = int(uniq[i])
        pow2_hi = 1 << (lo - 1).bit_length() if lo > 1 else 1
        limit = min(int(lo * max_overhead), pow2_hi) if lo > 1 else 1
        j = i
        while j + 1 < len(uniq) and int(uniq[j + 1]) <= limit:
            j += 1
        edges.append((lo, int(uniq[j])))
        i = j + 1
    return edges


def binned_rev_csr(
    csr: CSRGraph,
    n_pad: int,
    shards: int = 1,
    max_overhead: float = 1.1,
) -> BinnedRevEll:
    """Degree-binned reverse slabs of the (truncated) forward graph
    ``csr``; rows ``>= csr.n_nodes`` up to ``n_pad`` are empty and land in
    the zero-width slab. Deterministic in its inputs."""
    if n_pad % max(shards, 1):
        raise ValueError(f"n_pad={n_pad} is not divisible by {shards}")
    rev = csr.reverse()
    n = rev.n_nodes
    rows_local = n_pad // shards
    degs = np.zeros(n_pad, np.int64)
    degs[:n] = rev.degrees
    nz_edges = _degree_bucket_edges(degs, max_overhead)
    bucket_of = np.zeros(n_pad, np.int64)
    widths = [0]
    for b, (lo, hi) in enumerate(nz_edges, start=1):
        bucket_of[(degs >= lo) & (degs <= hi)] = b
        widths.append(hi)
    n_buckets = len(widths)
    shard_of = np.arange(n_pad, dtype=np.int64) // rows_local
    local = np.arange(n_pad, dtype=np.int64) % rows_local

    counts = np.zeros((shards, n_buckets), np.int64)
    np.add.at(counts, (shard_of, bucket_of), 1)
    rows_b = counts.max(axis=0)
    starts = np.concatenate([[0], np.cumsum(rows_b)])[:-1]
    rows_binned = int(rows_b.sum())

    # rows of one (shard, bucket) keep ascending local-row order
    order = np.lexsort((local, bucket_of, shard_of))
    o_shard, o_bucket, o_local = (
        shard_of[order], bucket_of[order], local[order]
    )
    key = o_shard * n_buckets + o_bucket
    run_start = np.concatenate([[0], np.cumsum(np.bincount(
        key.astype(np.int64), minlength=shards * n_buckets
    ))])[:-1]
    slot_in_bucket = np.arange(n_pad, dtype=np.int64) - run_start[key]
    pos = starts[o_bucket] + slot_in_bucket

    perm = np.full((shards, rows_binned), rows_local, np.int32)
    perm[o_shard, pos] = o_local.astype(np.int32)
    inv = np.zeros((shards, rows_local), np.int32)
    inv[o_shard, o_local] = pos.astype(np.int32)

    has_w = rev.weights is not None
    slabs, slab_w = [], []
    for b in range(n_buckets):
        w = widths[b]
        slab = np.full((shards, int(rows_b[b]), w), n_pad, np.int32)
        wslab = (
            np.zeros((shards, int(rows_b[b]), w), np.float32)
            if has_w
            else None
        )
        if w > 0:
            sel = o_bucket == b
            rows = order[sel]
            kept = degs[rows]
            flat = np.repeat(np.arange(len(rows)), kept)
            slots = np.arange(int(kept.sum()), dtype=np.int64) - np.repeat(
                np.cumsum(kept) - kept, kept
            )
            src = rev.indptr[rows][flat] + slots
            slab[o_shard[sel][flat], slot_in_bucket[sel][flat], slots] = (
                rev.indices[src]
            )
            if has_w:
                wslab[
                    o_shard[sel][flat], slot_in_bucket[sel][flat], slots
                ] = rev.weights[src]
        slabs.append(_t(slab))
        if has_w:
            slab_w.append(_t(wslab))
    return BinnedRevEll(
        slabs=tuple(slabs),
        perm=_t(perm),
        inv=_t(inv),
        slab_weights=tuple(slab_w) if has_w else None,
    )


@dataclasses.dataclass(frozen=True)
class BinnedPlan:
    """Shard-independent layout of the degree-binned reverse slabs:
    everything that couples shards in ``binned_rev_csr`` (bucket edges
    from the global degree histogram, the common max-over-shards slab row
    counts, the row-to-bucket map) in one O(n) pass, so one shard's slabs
    can be built from its own reverse rows alone (``binned_rev_shard``)."""

    widths: tuple  # per-bucket slab width; widths[0] == 0
    rows_b: np.ndarray  # [n_buckets] common slab row counts
    bucket_of: np.ndarray  # [n_pad] bucket id per padded row
    degs: np.ndarray  # [n_pad] effective in-degree per padded row
    shards: int
    n_pad: int

    @property
    def rows_local(self) -> int:
        return self.n_pad // self.shards

    @property
    def rows_binned(self) -> int:
        return int(self.rows_b.sum())


def binned_plan(
    rev_degs: np.ndarray,
    n_pad: int,
    shards: int = 1,
    max_overhead: float = 1.1,
) -> BinnedPlan:
    """The planning pass of ``binned_rev_csr`` without edge data;
    ``rev_degs`` is the effective graph's in-degree histogram."""
    if n_pad % max(shards, 1):
        raise ValueError(f"n_pad={n_pad} is not divisible by {shards}")
    rows_local = n_pad // shards
    degs = np.zeros(n_pad, np.int64)
    degs[: len(rev_degs)] = rev_degs
    nz_edges = _degree_bucket_edges(degs, max_overhead)
    bucket_of = np.zeros(n_pad, np.int64)
    widths = [0]
    for b, (lo, hi) in enumerate(nz_edges, start=1):
        bucket_of[(degs >= lo) & (degs <= hi)] = b
        widths.append(hi)
    shard_of = np.arange(n_pad, dtype=np.int64) // rows_local
    counts = np.zeros((shards, len(widths)), np.int64)
    np.add.at(counts, (shard_of, bucket_of), 1)
    return BinnedPlan(
        widths=tuple(widths),
        rows_b=counts.max(axis=0),
        bucket_of=bucket_of,
        degs=degs,
        shards=shards,
        n_pad=n_pad,
    )


def binned_rev_shard(
    plan: BinnedPlan, k: int, rev_local: CSRGraph
) -> BinnedRevEll:
    """Shard ``k``'s slice (leading axis 1) of ``binned_rev_csr``, built
    from the shard's own reverse rows (``partition.reverse_shard``):
    slots within one (shard, bucket) ascend by local row and in-neighbor
    lists keep the stable by-destination edge order, so the slice equals
    the wholesale build's ``[k:k+1]`` bitwise."""
    rl = plan.rows_local
    n_pad = plan.n_pad
    bucket_k = plan.bucket_of[k * rl : (k + 1) * rl]
    degs_k = plan.degs[k * rl : (k + 1) * rl]
    n_buckets = len(plan.widths)
    starts = np.cumsum(plan.rows_b) - plan.rows_b

    local = np.arange(rl, dtype=np.int64)
    order = np.argsort(bucket_k, kind="stable")
    o_bucket, o_local = bucket_k[order], local[order]
    run_start = np.concatenate(
        [[0], np.cumsum(np.bincount(o_bucket, minlength=n_buckets))]
    )[:-1]
    slot_in_bucket = np.arange(rl, dtype=np.int64) - run_start[o_bucket]
    pos = starts[o_bucket] + slot_in_bucket

    perm = np.full((1, plan.rows_binned), rl, np.int32)
    perm[0, pos] = o_local.astype(np.int32)
    inv = np.zeros((1, rl), np.int32)
    inv[0, o_local] = pos.astype(np.int32)

    has_w = rev_local.weights is not None
    slabs, slab_w = [], []
    for b in range(n_buckets):
        w = plan.widths[b]
        rb = int(plan.rows_b[b])
        slab = np.full((1, rb, w), n_pad, np.int32)
        wslab = np.zeros((1, rb, w), np.float32) if has_w else None
        if w > 0:
            sel = o_bucket == b
            rows = o_local[sel]
            kept = degs_k[rows]
            flat = np.repeat(np.arange(len(rows)), kept)
            slots = np.arange(int(kept.sum()), dtype=np.int64) - np.repeat(
                np.cumsum(kept) - kept, kept
            )
            src = rev_local.indptr[rows][flat] + slots
            slab[0, slot_in_bucket[sel][flat], slots] = rev_local.indices[src]
            if has_w:
                wslab[0, slot_in_bucket[sel][flat], slots] = (
                    rev_local.weights[src]
                )
        slabs.append(_t(slab))
        if has_w:
            slab_w.append(_t(wslab))
    return BinnedRevEll(
        slabs=tuple(slabs),
        perm=_t(perm),
        inv=_t(inv),
        slab_weights=tuple(slab_w) if has_w else None,
    )


def ell_shard(
    csr: CSRGraph, lo: int, hi: int, cap: int, sentinel: int
) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Rows ``[lo, hi)`` of the padded ELL slab as host numpy
    ``(indices [rows, cap], degrees [rows], weights or None)``: the
    row-range counterpart of ``pad_ell(ell_from_csr(csr), ...)``. ``cap``
    is the global row width and ``sentinel`` the padded node count; rows
    at or past ``csr.n_nodes`` are pad rows (all sentinel, degree 0)."""
    n = csr.n_nodes
    rows = hi - lo
    lo_r, hi_r = min(lo, n), min(hi, n)
    # the slabs are filled by torch on all its threads (see ell_from_csr)
    indices = torch.full((rows, cap), sentinel, dtype=torch.int32).numpy()
    degs = np.zeros(rows, np.int32)
    w = (torch.zeros((rows, cap), dtype=torch.float32).numpy()
         if csr.weights is not None else None)
    if hi_r > lo_r and cap > 0:
        sub = csr.indptr[lo_r : hi_r + 1] - csr.indptr[lo_r]
        r, s, p = _ell_slot_positions(sub, cap)
        base = csr.indptr[lo_r]
        indices[r, s] = csr.indices[base + p]
        if w is not None:
            w[r, s] = csr.weights[base + p]
    if hi_r > lo_r:
        degs[: hi_r - lo_r] = np.minimum(
            csr.degrees[lo_r:hi_r], cap
        ).astype(np.int32)
    return indices, degs, w


@dataclasses.dataclass(frozen=True)
class BlockAdjacency:
    """Block-sparse 0/1 adjacency: only ``[B, B]`` tiles holding an edge
    are stored, with their (src-block, dst-block) coordinates and a CSR
    ``row_ptr`` over source blocks."""

    blocks: torch.Tensor  # [n_blocks, B, B] int8 (A[u, v] = 1 if u->v)
    block_rows: torch.Tensor  # [n_blocks] int32
    block_cols: torch.Tensor  # [n_blocks] int32
    row_ptr: torch.Tensor  # [n_row_blocks + 1] int32

    @property
    def block_size(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n_row_blocks(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def occupancy(self) -> float:
        """Fraction of the dense block grid that is stored."""
        g = self.n_row_blocks
        return self.n_blocks / float(g * g)


@dataclasses.dataclass(frozen=True)
class ShardedBlocks:
    """Per-shard block-sparse 0/1 adjacency stacked over graph shards:
    local source row-block ids, global destination col-block ids, and
    all-zero pad tiles whose col id is the out-of-range sentinel
    ``n_out // B`` (dropped by every consumer)."""

    blocks: torch.Tensor  # [K, nb, B, B] int8
    block_rows: torch.Tensor  # [K, nb] int32
    block_cols: torch.Tensor  # [K, nb] int32 (pad = G)

    @property
    def block_size(self) -> int:
        return int(self.blocks.shape[2])


def sharded_blocks_from_csr(
    csr: CSRGraph, n_pad: int, shards: int, block: int = 128
) -> ShardedBlocks:
    """Stacked per-shard block adjacency; ``n_pad`` must be divisible by
    ``shards * block``."""
    if n_pad % (shards * block):
        raise ValueError(f"n_pad={n_pad} not divisible by {shards}*{block}")
    rows_local = n_pad // shards
    rb = rows_local // block
    g = n_pad // block
    src, dst = csr.edge_list()
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    shard = src // rows_local
    br = (src % rows_local) // block
    bc = dst // block
    key = (shard * rb + br) * g + bc
    uniq, inv = np.unique(key, return_inverse=True)
    nb_tot = len(uniq)
    # multi-GB tile slabs zeroed by torch on all its threads (numpy would
    # fault their pages in on one)
    tiles = torch.zeros((max(nb_tot, 1), block, block),
                        dtype=torch.int8).numpy()
    tiles[inv, src % block, dst % block] = 1
    u_shard = (uniq // (rb * g)).astype(np.int64)
    u_row = ((uniq // g) % rb).astype(np.int32)
    u_col = (uniq % g).astype(np.int32)
    counts = np.bincount(u_shard, minlength=shards) if nb_tot else np.zeros(
        shards, np.int64
    )
    nb = max(int(counts.max()) if nb_tot else 0, 1)
    out_blocks = torch.zeros((shards, nb, block, block),
                             dtype=torch.int8).numpy()
    out_rows = np.zeros((shards, nb), dtype=np.int32)
    out_cols = np.full((shards, nb), g, dtype=np.int32)  # sentinel col
    if nb_tot:
        starts = np.cumsum(counts) - counts
        slot = np.arange(nb_tot) - starts[u_shard]
        out_blocks[u_shard, slot] = tiles[:nb_tot]
        out_rows[u_shard, slot] = u_row
        out_cols[u_shard, slot] = u_col
    return ShardedBlocks(
        blocks=_t(out_blocks),
        block_rows=_t(out_rows),
        block_cols=_t(out_cols),
    )


def sharded_blocks_nb(
    csr: CSRGraph, n_pad: int, shards: int, block: int = 128
) -> int:
    """The common per-shard tile count of ``sharded_blocks_from_csr``:
    the one global quantity a per-shard block build needs."""
    if n_pad % (shards * block):
        raise ValueError(f"n_pad={n_pad} not divisible by {shards}*{block}")
    rows_local = n_pad // shards
    rb = rows_local // block
    g = n_pad // block
    src, dst = csr.edge_list()
    src = src.astype(np.int64)
    key = ((src // rows_local) * rb + (src % rows_local) // block) * g + (
        dst.astype(np.int64) // block
    )
    uniq = np.unique(key)
    if not len(uniq):
        return 1
    counts = np.bincount(uniq // (rb * g), minlength=shards)
    return max(int(counts.max()), 1)


def sharded_blocks_shard(
    csr: CSRGraph,
    n_pad: int,
    shards: int,
    nb: int,
    f_lo: int,
    f_hi: int,
    block: int = 128,
) -> ShardedBlocks:
    """Fine shards ``[f_lo, f_hi)`` of ``sharded_blocks_from_csr``
    (leading axis ``f_hi - f_lo``), built from those shards' edges only;
    ``nb`` is the global common tile count (``sharded_blocks_nb``). A
    shard's edges are a contiguous CSR row range and ``np.unique`` over
    its keys keeps the global key order, so the slices equal the
    wholesale build's bitwise."""
    rows_local = n_pad // shards
    rb = rows_local // block
    g = n_pad // block
    n = csr.n_nodes
    span = f_hi - f_lo
    lo = min(f_lo * rows_local, n)
    hi = min(f_hi * rows_local, n)
    e_lo, e_hi = int(csr.indptr[lo]), int(csr.indptr[hi])
    out_blocks = torch.zeros((span, nb, block, block),
                             dtype=torch.int8).numpy()
    out_rows = np.zeros((span, nb), np.int32)
    out_cols = np.full((span, nb), g, np.int32)  # sentinel col
    if e_hi > e_lo:
        pos = np.arange(e_lo, e_hi, dtype=np.int64)
        src = np.searchsorted(csr.indptr, pos, side="right") - 1
        dst = csr.indices[e_lo:e_hi].astype(np.int64)
        shard = src // rows_local
        key = (shard * rb + (src % rows_local) // block) * g + dst // block
        uniq, inv = np.unique(key, return_inverse=True)
        tiles = torch.zeros((len(uniq), block, block),
                            dtype=torch.int8).numpy()
        tiles[inv, src % block, dst % block] = 1
        u_shard = (uniq // (rb * g)).astype(np.int64) - f_lo
        counts = np.bincount(u_shard, minlength=span)
        starts = np.cumsum(counts) - counts
        slot = np.arange(len(uniq)) - starts[u_shard]
        out_blocks[u_shard, slot] = tiles
        out_rows[u_shard, slot] = ((uniq // g) % rb).astype(np.int32)
        out_cols[u_shard, slot] = (uniq % g).astype(np.int32)
    return ShardedBlocks(
        blocks=_t(out_blocks), block_rows=_t(out_rows), block_cols=_t(out_cols)
    )


def blocks_from_csr(csr: CSRGraph, block: int = 128) -> BlockAdjacency:
    """Block-sparse adjacency of the whole graph (host-side)."""
    n = csr.n_nodes
    g = -(-n // block)
    src, dst = csr.edge_list()
    br, bc = src // block, dst // block
    key = br.astype(np.int64) * g + bc
    uniq, inv = np.unique(key, return_inverse=True)
    nb = len(uniq)
    blocks = np.zeros((max(nb, 1), block, block), dtype=np.int8)
    blocks[inv, src % block, dst % block] = 1
    urows = (uniq // g).astype(np.int32)
    ucols = (uniq % g).astype(np.int32)
    row_ptr = np.zeros(g + 1, dtype=np.int32)
    np.add.at(row_ptr, urows + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int32)
    if nb == 0:
        urows = np.zeros(1, dtype=np.int32)
        ucols = np.zeros(1, dtype=np.int32)
    return BlockAdjacency(
        blocks=_t(blocks),
        block_rows=_t(urows),
        block_cols=_t(ucols),
        row_ptr=_t(row_ptr),
    )
