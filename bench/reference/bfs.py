"""Plain BFS levels: the reference that decides ``correct``.

It imports nothing of the serving program (nor of the JAX package): it
reads only the CSR arrays the benchmark generated and the sources it
chose. A level is the number of edges on a shortest path from the source;
-1 marks a node the source does not reach.

``bfs_levels`` is the definition, one source at a time in numpy.
``LevelTable`` computes the rows it is asked for in blocks of sources, in
plain torch: a level-synchronous BFS whose step is one sparse product of
the transposed adjacency with the block's frontier columns (on the card
in a run, once the program is freed; ``tests/test_bench_reference.py``
holds it equal to ``bfs_levels``).
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 64  # sources a sparse product serves


def bfs_levels(indptr: np.ndarray, indices: np.ndarray,
               source: int) -> np.ndarray:
    """Levels ``[n]`` int32 of every node from ``source``."""
    n = len(indptr) - 1
    levels = np.full(n, -1, dtype=np.int32)
    levels[source] = 0
    frontier = np.asarray([source], dtype=np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
        hit = np.zeros(n, dtype=bool)
        hit[indices[np.repeat(starts, counts) + offs]] = True
        frontier = np.flatnonzero(hit & (levels < 0))
        levels[frontier] = depth
    return levels


def _transposed(indptr: np.ndarray, indices: np.ndarray,
                device) -> torch.Tensor:
    """``A^T`` as a sparse CSR float32 matrix (row ``v`` holds every
    ``u`` with an edge ``u -> v``)."""
    n = len(indptr) - 1
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dst = np.asarray(indices, dtype=np.int64)
    order = np.lexsort((src, dst))
    crow = np.zeros(n + 1, dtype=np.int64)
    crow[1:] = np.cumsum(np.bincount(dst, minlength=n))
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(src[order]),
        torch.ones(len(order), dtype=torch.float32), size=(n, n),
        device=device, check_invariants=True)


def bfs_block(at: torch.Tensor, sources) -> np.ndarray:
    """Levels ``[len(sources), n]`` int32 from each source, over the
    transposed adjacency ``at``."""
    n, k = at.shape[0], len(sources)
    dev = at.device
    cols = torch.arange(k, device=dev)
    src = torch.as_tensor(np.asarray(sources, dtype=np.int64), device=dev)
    levels = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    levels[src, cols] = 0
    frontier = torch.zeros((n, k), dtype=torch.float32, device=dev)
    frontier[src, cols] = 1.0
    depth = 0
    while True:
        depth += 1
        new = (torch.sparse.mm(at, frontier) > 0) & (levels < 0)
        if not bool(new.any()):
            break
        levels[new] = depth
        frontier = new.to(torch.float32)
    return levels.T.contiguous().cpu().numpy()


class LevelTable:
    """Reference rows by source: ``fill`` computes the missing ones in
    blocks of ``BLOCK``; ``row`` computes one alone if it was not
    filled."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 device=None):
        self.indptr = indptr
        self.indices = indices
        self.device = torch.device("cpu") if device is None else device
        self._rows: dict[int, np.ndarray] = {}

    def fill(self, sources) -> None:
        todo = sorted({int(s) for s in sources} - set(self._rows))
        if not todo:
            return
        at = _transposed(self.indptr, self.indices, self.device)
        for i in range(0, len(todo), BLOCK):
            block = todo[i:i + BLOCK]
            for s, row in zip(block, bfs_block(at, block)):
                self._rows[s] = row

    def row(self, source: int) -> np.ndarray:
        s = int(source)
        if s not in self._rows:
            self.fill([s])
        return self._rows[s]

    def __len__(self) -> int:
        return len(self._rows)
