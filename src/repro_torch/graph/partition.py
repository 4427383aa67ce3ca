"""Row padding of the ELL operands (port of ``repro.graph.partition``).

``pad_ell`` pads the row count to a multiple of ``shards * block``;
padded rows have degree 0 and hold only the sentinel, so they are inert.
"""
from __future__ import annotations

import torch

from .csr import EllGraph


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
