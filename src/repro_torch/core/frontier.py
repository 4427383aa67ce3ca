"""Frontier representations (port of ``repro.core.frontier``).

- dense bool ``[n]``: one IFE subroutine (1T1S / nT1S / nTkS);
- lanes ``[n, L] uint8``: L concurrent IFE subroutines (MS-BFS / nTkMS);
- packed ``[n, L//32]``: bit-packed lanes. The JAX package stores the
  words as uint32; PyTorch's uint32 support is partial, so the port keeps
  the same bit layout (lane l is bit l % 32 of word l // 32) in int64
  values in ``[0, 2**32)``.
"""
from __future__ import annotations

import torch

LANES = 64  # the paper's multi-source morsel width
PACK = 32  # bits per packed word


def source_rows(sources: torch.Tensor, n_nodes: int):
    """(row ids, in-range mask) of ``sources`` with JAX's index rules: a
    negative id down to ``-n_nodes`` counts from the end, anything else
    outside ``[0, n_nodes)`` is dropped."""
    ids = sources.long()
    ids = torch.where(ids < 0, ids + n_nodes, ids)
    return ids, (ids >= 0) & (ids < n_nodes)


def dense_from_sources(n_nodes: int, sources: torch.Tensor) -> torch.Tensor:
    """[n] bool with True at each in-range source."""
    f = torch.zeros(n_nodes, dtype=torch.bool, device=sources.device)
    ids, ok = source_rows(sources, n_nodes)
    f[ids[ok]] = True
    return f


def lanes_from_sources(n_nodes: int, sources: torch.Tensor) -> torch.Tensor:
    """[n, L] uint8 multi-source frontier: sources[l] activates lane l; an
    out-of-range source leaves its lane empty."""
    n_lanes = int(sources.shape[0])
    f = torch.zeros((n_nodes, n_lanes), dtype=torch.uint8,
                    device=sources.device)
    ids, ok = source_rows(sources, n_nodes)
    lanes = torch.arange(n_lanes, device=sources.device)
    f[ids[ok], lanes[ok]] = 1
    return f


def pack_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """[n, L] uint8 -> [n, L//32] int64 words holding uint32 bit patterns."""
    n, n_lanes = lanes.shape
    if n_lanes % PACK:
        raise ValueError(f"lane count {n_lanes} is not a multiple of {PACK}")
    bits = (lanes != 0).to(torch.int64).view(n, n_lanes // PACK, PACK)
    shifts = torch.arange(PACK, dtype=torch.int64, device=lanes.device)
    return (bits << shifts).sum(dim=-1)


def unpack_lanes(packed: torch.Tensor, lanes: int = LANES) -> torch.Tensor:
    """[n, W] words -> [n, lanes] uint8."""
    n, w = packed.shape
    if w * PACK != lanes:
        raise ValueError(f"{w} words do not hold {lanes} lanes")
    shifts = torch.arange(PACK, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64).unsqueeze(-1) >> shifts) & 1
    return bits.view(n, lanes).to(torch.uint8)


def frontier_size(frontier: torch.Tensor) -> torch.Tensor:
    """Number of active (node, lane) entries (dense or lanes layout), as
    an int32 scalar tensor."""
    return (frontier != 0).sum(dtype=torch.int32)


def any_active(frontier: torch.Tensor) -> torch.Tensor:
    return (frontier != 0).any()
