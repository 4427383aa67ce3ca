"""The plain BFS of ``reference/`` on hand-made graphs, and its block
form against its definition."""
from __future__ import annotations

import numpy as np
import pytest

from bench_cpu import BENCH  # noqa: F401
from harness import graphs
from reference.bfs import BLOCK, LevelTable, bfs_levels


def _csr(n, edges):
    """``(indptr, indices)`` of the distinct ``edges``, sorted."""
    key = np.unique([u * n + v for u, v in edges])
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(key // n, minlength=n))
    return indptr, (key % n).astype(np.int32)


def test_path_cycle_and_unreached():
    # 0 -> 1 -> 2 -> 3 -> 1 (a cycle), 4 -> 0, 5 alone
    ip, ix = _csr(6, [(0, 1), (1, 2), (2, 3), (3, 1), (4, 0)])
    np.testing.assert_array_equal(bfs_levels(ip, ix, 0),
                                  [0, 1, 2, 3, -1, -1])
    np.testing.assert_array_equal(bfs_levels(ip, ix, 4),
                                  [1, 2, 3, 4, 0, -1])
    np.testing.assert_array_equal(bfs_levels(ip, ix, 5),
                                  [-1, -1, -1, -1, -1, 0])


def test_shortest_level_wins_and_duplicates():
    # two routes to 3: 0-1-2-3 and 0-3; duplicate edges dropped
    ip, ix = _csr(4, [(0, 1), (1, 2), (2, 3), (0, 3), (0, 3), (0, 1)])
    np.testing.assert_array_equal(bfs_levels(ip, ix, 0), [0, 1, 2, 1])


def test_star_and_table_cache():
    n = 50
    ip, ix = _csr(n, [(0, v) for v in range(1, n)]
                  + [(v, 0) for v in range(1, n)])
    t = LevelTable(ip, ix)
    row = t.row(7)
    assert row[7] == 0 and row[0] == 1
    assert (row[1:7] == 2).all() and (row[8:] == 2).all()
    assert t.row(7) is row and len(t) == 1
    assert row.dtype == np.int32


@pytest.mark.parametrize("mean,exponent,seed", [(6.0, 0.5, 1), (2.0, 0.8, 2),
                                                (12.0, 0.3, 2**31 + 3)])
def test_blocks_equal_the_definition(mean, exponent, seed):
    # sparse graphs leave nodes unreached; more sources than one block
    n = 500
    ip, ix = graphs.make_graph({"n_nodes": n, "mean_degree": mean,
                                "degree_law": {"rank_exponent": exponent}},
                               seed)
    t = LevelTable(ip, ix)
    sources = list(range(0, n, 5))
    t.fill(sources)
    assert len(t) == len(sources) > BLOCK
    for s in sources:
        np.testing.assert_array_equal(t.row(s), bfs_levels(ip, ix, s))


def test_directed_edges_follow_their_direction():
    # the block BFS walks u -> v only: 0 -> 1 -> 2, nothing back
    ip, ix = _csr(3, [(0, 1), (1, 2)])
    t = LevelTable(ip, ix)
    t.fill([0, 2])
    np.testing.assert_array_equal(t.row(0), [0, 1, 2])
    np.testing.assert_array_equal(t.row(2), [-1, -1, 0])
