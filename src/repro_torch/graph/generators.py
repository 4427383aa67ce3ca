"""Deterministic synthetic graph generators (port of
``repro.graph.generators``; host-side numpy, deterministic in (shape,
seed), bitwise the same graphs as the JAX package's).

The paper evaluates on LDBC100, LiveJournal, Spotify and Graph500-28; the
proxies below keep their degree structure at a reduced node count.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, csr_from_edges


def erdos_renyi(
    n_nodes: int, avg_degree: float, seed: int = 0, symmetric: bool = True
) -> CSRGraph:
    """G(n, m) with m = n*avg_degree directed edges."""
    rng = np.random.default_rng(seed)
    m = int(n_nodes * avg_degree)
    src = rng.integers(0, n_nodes, size=m, dtype=np.int64)
    dst = rng.integers(0, n_nodes, size=m, dtype=np.int64)
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return csr_from_edges(n_nodes, src, dst)


def rmat(
    scale: int,
    edge_factor: int = 16,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    symmetric: bool = True,
) -> CSRGraph:
    """RMAT generator (Graph500 uses a=.57 b=c=.19 d=.05)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(m)
        p_right = np.where(
            src_bit == 0,
            b / (a + b),
            (1 - a - b - c) / max(c + (1 - a - b - c), 1e-9),
        )
        dst_bit = (r2 < p_right).astype(np.int64)
        src |= src_bit << bit
        dst |= dst_bit << bit
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return csr_from_edges(n, src, dst)


def powerlaw(
    n_nodes: int,
    avg_degree: float,
    alpha: float = 2.1,
    seed: int = 0,
    symmetric: bool = True,
) -> CSRGraph:
    """Power-law endpoints via Zipf-distributed popularity (social-network
    proxy with a heavy-tailed degree mix)."""
    rng = np.random.default_rng(seed)
    m = int(n_nodes * avg_degree)
    ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
    probs = ranks ** (-alpha / 2.0)
    probs /= probs.sum()
    perm = rng.permutation(n_nodes)
    src = perm[rng.choice(n_nodes, size=m, p=probs)]
    dst = perm[rng.choice(n_nodes, size=m, p=probs)]
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return csr_from_edges(n_nodes, src, dst)


def ldbc_proxy(scale: float = 1.0, seed: int = 0) -> CSRGraph:
    """LDBC100: 448K nodes, 19.9M edges, avg degree 44."""
    n = max(int(4486 * scale), 64)
    return powerlaw(n, avg_degree=22.0, alpha=1.8, seed=seed)


def lj_proxy(scale: float = 1.0, seed: int = 1) -> CSRGraph:
    """LiveJournal: 4.8M nodes, 69M edges, avg degree 14."""
    n = max(int(48476 * scale), 64)
    return powerlaw(n, avg_degree=7.0, alpha=2.1, seed=seed)


def spotify_proxy(scale: float = 1.0, seed: int = 2) -> CSRGraph:
    """Spotify: 3.6M nodes, 1.9B edges, avg degree 535 (the dense
    outlier)."""
    n = max(int(3604 * scale), 256)
    return erdos_renyi(n, avg_degree=267.0, seed=seed)


def graph500_proxy(scale_log2: int = 12, seed: int = 3) -> CSRGraph:
    """Graph500-28: RMAT, avg degree ~35, reduced scale."""
    return rmat(scale_log2, edge_factor=17, seed=seed)


PAPER_DATASETS = {
    "ldbc": ldbc_proxy,
    "lj": lj_proxy,
    "spotify": spotify_proxy,
    "graph500": lambda scale=1.0, seed=3: graph500_proxy(12, seed=seed),
}

#: degree-structure family of each proxy (the direction-threshold table's
#: lookup key)
PAPER_DATASET_FAMILIES = {
    "ldbc": "powerlaw",
    "lj": "powerlaw",
    "spotify": "er",
    "graph500": "powerlaw",
}


def pick_sources(
    csr: CSRGraph, n_sources: int, seed: int = 0, min_levels: int = 3
) -> np.ndarray:
    """Random sources that can sustain >= min_levels of IFE, found with a
    numpy BFS depth probe per candidate."""
    rng = np.random.default_rng(seed)
    out: list[int] = []
    tried = set()
    # dense graphs may have no node sustaining min_levels: cap the search
    # and then accept candidates rather than spinning
    budget = min(csr.n_nodes, 50 * n_sources + 1000)
    while len(out) < n_sources:
        cand = int(rng.integers(0, csr.n_nodes))
        if cand in tried and len(tried) < csr.n_nodes:
            continue
        tried.add(cand)
        if len(tried) >= budget or _bfs_depth_at_least(
            csr, cand, min_levels
        ):
            out.append(cand)
    return np.asarray(out[:n_sources], dtype=np.int32)


def _bfs_depth_at_least(csr: CSRGraph, src: int, depth: int) -> bool:
    seen = np.zeros(csr.n_nodes, dtype=bool)
    seen[src] = True
    frontier = np.asarray([src], dtype=np.int64)
    indptr, indices = csr.indptr, csr.indices
    for level in range(depth):
        if level == depth - 1:
            # the last level needs one unseen neighbor, not the whole set:
            # scan the frontier in slices and stop at the first
            return _any_unseen_neighbor(indptr, indices, frontier, seen)
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return False
        base = np.repeat(starts, counts)
        offs = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        nbrs = indices[base + offs]
        new = np.unique(nbrs[~seen[nbrs]])
        if new.size == 0:
            return False
        seen[new] = True
        frontier = new
    return True


def _any_unseen_neighbor(indptr, indices, frontier, seen,
                         slots: int = 1 << 14) -> bool:
    """Whether some out-neighbor of ``frontier`` is not ``seen``, reading
    about ``slots`` adjacency entries at a time."""
    counts = indptr[frontier + 1] - indptr[frontier]
    ends = np.cumsum(counts)
    lo = 0
    while lo < len(frontier):
        base = int(ends[lo] - counts[lo])
        hi = max(int(np.searchsorted(ends, base + slots, side="right")),
                 lo + 1)
        starts, cnt = indptr[frontier[lo:hi]], counts[lo:hi]
        total = int(cnt.sum())
        offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        if not seen[indices[np.repeat(starts, cnt) + offs]].all():
            return True
        lo = hi
    return False
