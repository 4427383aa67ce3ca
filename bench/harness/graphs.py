"""The benchmark's graphs and source pools, made from the seed.

A graph is an expected-degree (Chung-Lu) graph: each end of an edge is
drawn with probability proportional to a node's weight, the weights
following a rank law ``rank**(-rank_exponent)`` over a seeded permutation
of the nodes, optionally capped at ``cap_over_mean`` times their mean.
Edges are undirected, without self-loops or duplicates, and drawn until
there are exactly ``n_nodes * mean_degree / 2`` of them, so the CSR (both
directions of every edge) holds ``mean_degree`` entries a node on
average. A configuration states the mean degree and the law's two numbers;
``tests/test_bench_graphs.py`` holds the law to the published statistics
it was fitted to.

``pick_sources`` is a frozen copy of the serving program's source rule
(``repro_torch/graph/generators.py`` as of the benchmark's first version):
the yardstick does not move when the program changes its own.

The edges are drawn with torch on the device a run serves from (a
``torch.Generator`` seeded from ``--seed``, in a few large calls); the
rest is host numpy. The CSR is returned as plain host arrays (``indptr``
int64, ``indices`` int32, sorted); the harness wraps them in the
program's ``CSRGraph`` and the reference reads the same arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def rank_weights(n_nodes: int, rank_exponent: float,
                 cap_over_mean: float | None = None) -> np.ndarray:
    """Weights ``[n]`` (rank order, summing to 1): ``r**-rank_exponent``
    for ranks ``r = 1..n``, capped so that no weight exceeds
    ``cap_over_mean`` times the mean of the capped weights."""
    w = np.arange(1, n_nodes + 1, dtype=np.float64) ** -float(rank_exponent)
    if cap_over_mean is not None and w[0] > cap_over_mean * w.mean():
        # the cap c solves c = cap_over_mean * mean(min(w, c)); the right
        # side grows slower than c, so bisect
        lo, hi = 0.0, float(w[0])
        for _ in range(200):
            c = 0.5 * (lo + hi)
            if c > cap_over_mean * np.minimum(w, c).mean():
                hi = c
            else:
                lo = c
        w = np.minimum(w, lo)
    return w / w.sum()


def draw_edges(n_nodes: int, n_edges: int, weights: np.ndarray,
               seed: int, device=None) -> torch.Tensor:
    """``n_edges`` distinct undirected edges as sorted keys
    ``lo * n_nodes + hi``, ``lo < hi``: each end drawn by ``weights`` over
    a seeded permutation of the nodes, draws repeated until enough are
    distinct, a seeded subset kept where there are more."""
    if n_edges > n_nodes * (n_nodes - 1) // 2:
        raise ValueError(f"{n_edges} edges do not fit {n_nodes} nodes")
    dev = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**63)
    w = torch.as_tensor(weights, dtype=torch.float64, device=dev)
    perm = torch.randperm(n_nodes, generator=gen, device=dev)
    keys = torch.zeros(0, dtype=torch.int64, device=dev)
    while keys.numel() < n_edges:
        k = int(1.05 * (n_edges - keys.numel())) + 64
        a, b = perm[torch.multinomial(w, 2 * k, replacement=True,
                                      generator=gen)].view(2, k)
        keep = a != b
        lo = torch.minimum(a, b)[keep]
        hi = torch.maximum(a, b)[keep]
        keys = torch.unique(torch.cat([keys, lo * n_nodes + hi]))
    if keys.numel() > n_edges:
        pick = torch.randperm(keys.numel(), generator=gen, device=dev)
        keys = torch.sort(keys[pick[:n_edges]]).values
    return keys


def make_graph(config: dict, seed: int, device=None):
    """The configuration's graph for ``seed``: ``(indptr, indices)``,
    symmetric, with ``mean_degree`` entries a node; its edges drawn on
    ``device``."""
    n = int(config["n_nodes"])
    law = config["degree_law"]
    w = rank_weights(n, float(law["rank_exponent"]),
                     law.get("cap_over_mean"))
    m = int(round(n * float(config["mean_degree"]) / 2))
    keys = draw_edges(n, m, w, seed, device)
    lo, hi = keys // n, keys % n
    both = torch.sort(torch.cat([lo * n + hi, hi * n + lo])).values
    src, dst = both // n, both % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0).cpu()
    return indptr, dst.to(torch.int32).cpu().numpy()


def pick_sources(indptr, indices, n_sources: int, seed: int = 0,
                 min_levels: int = 3) -> np.ndarray:
    """Random sources from which a BFS lasts at least ``min_levels``
    levels, found with a BFS depth probe per candidate (the program's
    rule, frozen)."""
    n_nodes = len(indptr) - 1
    rng = np.random.default_rng(seed)
    out: list[int] = []
    tried = set()
    # dense graphs may have no node that lasts min_levels: cap the search
    # and then accept candidates rather than spinning
    budget = min(n_nodes, 50 * n_sources + 1000)
    while len(out) < n_sources:
        cand = int(rng.integers(0, n_nodes))
        if cand in tried and len(tried) < n_nodes:
            continue
        tried.add(cand)
        if len(tried) >= budget or _depth_at_least(
                indptr, indices, cand, min_levels):
            out.append(cand)
    return np.asarray(out[:n_sources], dtype=np.int32)


def _depth_at_least(indptr, indices, src: int, depth: int) -> bool:
    seen = np.zeros(len(indptr) - 1, dtype=bool)
    seen[src] = True
    frontier = np.asarray([src], dtype=np.int64)
    for level in range(depth):
        if level == depth - 1:
            # the last level needs one unseen neighbour, not the whole set
            return _any_unseen_neighbor(indptr, indices, frontier, seen)
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return False
        base = np.repeat(starts, counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
        nbrs = indices[base + offs]
        new = np.unique(nbrs[~seen[nbrs]])
        if new.size == 0:
            return False
        seen[new] = True
        frontier = new
    return True


def _any_unseen_neighbor(indptr, indices, frontier, seen,
                         slots: int = 1 << 14) -> bool:
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
