"""Graph partitioning for morsel policies (port of
``repro.graph.partition``).

Frontier morsels map to contiguous node ranges of the ELL rows.
``pad_ell`` pads the row count to a multiple of ``shards * block``;
padded rows have degree 0 and hold only the sentinel, so they are inert.
``reverse_shard`` is the per-rank build's primitive: one shard's rows of
the transpose without the whole reverse graph. ``slab_edges`` buckets an
edge list by destination range (the GNN substrate's slab layout).
"""
from __future__ import annotations

import numpy as np
import torch

from .csr import CSRGraph, EllGraph


def padded_n(n_nodes: int, shards: int, block: int = 8) -> int:
    unit = shards * block
    return -(-n_nodes // unit) * unit


def pad_ell(g: EllGraph, shards: int, block: int = 8) -> EllGraph:
    """Pad ELL rows to a multiple of ``shards * block``.

    Sentinel-remap contract: the unpadded slab marks empty slots with
    ``n_nodes``, but after padding row ``n_nodes`` is a real (inert) pad
    row, so every ``n_nodes`` sentinel is remapped to ``n_pad``, which is
    out of range for every ``[n_pad]`` scatter and gather. Pad rows are
    all-sentinel with degree 0 and zero weights. When no padding is needed
    the slab is returned unchanged."""
    n = g.n_nodes
    n_pad = padded_n(n, shards, block)
    if n_pad == n:
        return g
    dev = g.indices.device
    idx = torch.full(
        (n_pad, g.max_deg), n_pad, dtype=g.indices.dtype, device=dev
    )
    # remap in place on the new buffer: one copy of the slab, not three
    body = idx[:n]
    body.copy_(g.indices)
    body.masked_fill_(body == n, n_pad)
    degs = torch.zeros(n_pad, dtype=g.degrees.dtype, device=dev)
    degs[:n] = g.degrees
    w = None
    if g.weights is not None:
        w = torch.zeros(
            (n_pad, g.max_deg), dtype=g.weights.dtype, device=dev
        )
        w[:n] = g.weights
    return EllGraph(indices=idx, degrees=degs, weights=w)


def partition_bounds(n_pad: int, shards: int) -> np.ndarray:
    """Row offsets of each shard: [shards + 1]."""
    per = n_pad // shards
    return np.arange(shards + 1, dtype=np.int64) * per


def reverse_shard(csr: CSRGraph, lo: int, hi: int) -> CSRGraph:
    """Rows ``[lo, hi)`` of ``csr.reverse()`` without the whole
    transpose: the edges whose destination lands in the range, in
    ascending edge order, stable-sorted by destination, so the local
    in-neighbor lists equal the wholesale transpose's rows bitwise.
    ``hi`` may pass ``csr.n_nodes`` (padded rows are empty). The result
    has ``hi - lo`` rows of *global* source ids."""
    dst = csr.indices
    sel = np.flatnonzero((dst >= lo) & (dst < hi))
    src = (
        np.searchsorted(csr.indptr, sel, side="right").astype(np.int64) - 1
    )
    d = dst[sel].astype(np.int64) - lo
    order = np.argsort(d, kind="stable")
    rindptr = np.zeros(hi - lo + 1, dtype=np.int64)
    rindptr[1:] = np.cumsum(np.bincount(d, minlength=hi - lo))
    w = None if csr.weights is None else csr.weights[sel][order]
    return CSRGraph(
        indptr=rindptr,
        indices=src[order].astype(np.int32),
        weights=w,
    )


def slab_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    k_slabs: int,
    balance: str = "nodes",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Destination-aligned edge slabs: edges bucketed by destination node
    range, every bucket padded to the largest (pad edges: src 0, dst
    ``n_nodes``, dropped by segment reduces). Returns the flat
    ``[k_slabs * max_bucket]`` (src, dst) arrays and the ``[k_slabs + 1]``
    node bounds. ``balance="nodes"``: uniform node ranges;
    ``balance="edges"``: bounds on the in-degree cumsum, about E/K edges a
    slab."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if balance == "nodes":
        if n_nodes % k_slabs:
            raise ValueError(f"{n_nodes} nodes do not split into {k_slabs}")
        nl = n_nodes // k_slabs
        bounds = np.arange(k_slabs + 1, dtype=np.int64) * nl
    elif balance == "edges":
        indeg = np.bincount(dst, minlength=n_nodes)
        cum = np.concatenate([[0], np.cumsum(indeg)])
        targets = np.arange(1, k_slabs) * (len(dst) / k_slabs)
        cuts = np.searchsorted(cum, targets, side="left")
        bounds = np.concatenate([[0], cuts, [n_nodes]]).astype(np.int64)
    else:
        raise ValueError(balance)
    slab_of = np.clip(
        np.searchsorted(bounds, dst, side="right") - 1, 0, k_slabs - 1
    )
    order = np.argsort(slab_of, kind="stable")
    src, dst, slab_of = src[order], dst[order], slab_of[order]
    counts = np.bincount(slab_of, minlength=k_slabs)
    width = max(int(counts.max()), 1)
    starts = np.cumsum(counts) - counts
    pos = np.arange(len(src), dtype=np.int64) - starts[slab_of]
    out_src = np.zeros((k_slabs, width), np.int32)
    out_dst = np.full((k_slabs, width), n_nodes, np.int32)
    out_src[slab_of, pos] = src
    out_dst[slab_of, pos] = dst
    return out_src.reshape(-1), out_dst.reshape(-1), bounds
