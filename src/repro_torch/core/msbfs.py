"""Multi-source BFS helpers (port of ``repro.core.msbfs``): gang lane
packing for the phase-2 resume, the block activity bitmap, and
``LanePacker`` for admission. The block extension itself is the
``msbfs_extend`` kernel, reached through ``core.extend.BlockBackend``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import BlockAdjacency
from ..kernels.msbfs_extend.ops import extend_blocks


def gang_pack_lanes(x: torch.Tensor) -> torch.Tensor:
    """Stack of morsel states -> one lane tensor: ``[S, rows]`` becomes
    ``[rows, S]`` and ``[S, rows, L]`` becomes ``[rows, S*L]`` uint8;
    morsel s owns columns ``[s*L, (s+1)*L)``."""
    if x.ndim == 2:
        return x.movedim(0, 1).to(torch.uint8).contiguous()
    gang, rows, n_lanes = x.shape
    return (x.movedim(0, 1).reshape(rows, gang * n_lanes)
            .to(torch.uint8).contiguous())


def gang_unpack_lanes(y: torch.Tensor, gang: int,
                      lanes: int = 0) -> torch.Tensor:
    """Inverse of ``gang_pack_lanes`` for a per-lane result ``[rows,
    S*L]`` of any dtype: ``[S, rows]`` (``lanes=0``) or ``[S, rows, L]``."""
    rows = y.shape[0]
    if lanes == 0:
        return y.movedim(0, 1).contiguous()
    return y.reshape(rows, gang, lanes).movedim(0, 1).contiguous()


def stripe_activity(lane_blocks: torch.Tensor) -> torch.Tensor:
    """[G, B, L] -> [G] bool: which source row-block stripes hold any
    frontier bit (the kernel skips tiles of inactive stripes)."""
    return (lane_blocks != 0).flatten(1).any(dim=1)


def frontier_block_activity(adj: BlockAdjacency,
                            lanes: torch.Tensor) -> torch.Tensor:
    """[n, L] -> [n_blocks] bool: which stored tiles have a frontier bit
    in their source stripe this iteration."""
    n, n_lanes = lanes.shape
    bsz = adj.block_size
    stripe = stripe_activity(lanes.reshape(n // bsz, bsz, n_lanes))
    return stripe[adj.block_rows.long()]


def active_block_count(adj: BlockAdjacency,
                       lanes: torch.Tensor) -> torch.Tensor:
    """Tiles one extension consumes under the activity skip."""
    return frontier_block_activity(adj, lanes).sum(dtype=torch.int32)


def block_extend_lanes(adj: BlockAdjacency,
                       lanes: torch.Tensor) -> torch.Tensor:
    """Frontier extension over the block-sparse adjacency: [n, L] uint8
    (n divisible by the tile size) -> reached [n, L] uint8, through the
    ``msbfs_extend`` kernel (its plain version for a CPU tensor)."""
    n, n_lanes = lanes.shape
    bsz = adj.block_size
    g = n // bsz
    out = extend_blocks(adj.blocks, adj.block_rows, adj.block_cols,
                        lanes.reshape(g, bsz, n_lanes), g_out=g)
    return out.reshape(n, n_lanes)


def block_extend_dense(adj: BlockAdjacency,
                       frontier: torch.Tensor) -> torch.Tensor:
    """Single-frontier variant: [n] bool -> [n] bool (lane width 1)."""
    reached = block_extend_lanes(adj, frontier[:, None].to(torch.uint8))
    return reached[:, 0] != 0


def scans_saved_factor(adj: BlockAdjacency, lanes: int = 64) -> float:
    """Analytic MS-BFS scan economy: independent BFS reads every tile once
    per lane, lane packing once per ``lanes``."""
    return float(lanes)


class LanePacker:
    """Incremental MS-BFS lane packing for the admission layer: queries
    are added in arrival order and may be evicted before dispatch;
    ``pack()`` lays the survivors' sources end to end in arrival order and
    returns each query's span into the per-source result rows."""

    def __init__(self, lanes: int = 64):
        self.lanes = int(lanes)
        self._entries: list[tuple[str, np.ndarray]] = []

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, qid: str) -> bool:
        return any(q == qid for q, _ in self._entries)

    @property
    def qids(self) -> list[str]:
        return [q for q, _ in self._entries]

    @property
    def n_sources(self) -> int:
        return sum(len(s) for _, s in self._entries)

    @property
    def n_morsels(self) -> int:
        return -(-self.n_sources // self.lanes)

    def add(self, qid: str, sources: np.ndarray) -> None:
        if qid in self:
            raise ValueError(f"duplicate qid in pack: {qid!r}")
        self._entries.append(
            (qid, np.asarray(sources, np.int32).reshape(-1))
        )

    def evict(self, qid: str) -> np.ndarray | None:
        """Remove one query; the others keep their arrival order."""
        for i, (q, s) in enumerate(self._entries):
            if q == qid:
                del self._entries[i]
                return s
        return None

    def pack(self) -> tuple[np.ndarray, dict[str, tuple[int, int]]]:
        """(flat sources in arrival order, {qid: (start, stop)})."""
        spans: dict[str, tuple[int, int]] = {}
        parts = []
        i = 0
        for qid, s in self._entries:
            spans[qid] = (i, i + len(s))
            parts.append(s)
            i += len(s)
        flat = (
            np.concatenate(parts) if parts else np.zeros(0, np.int32)
        ).astype(np.int32)
        return flat, spans
