"""The benchmark's graphs: the degree laws reproduce the published
statistics they were fitted to, a graph holds its configuration's mean
degree, and the frozen source rule equals the program's at small sizes."""
from __future__ import annotations

import numpy as np
import pytest

from bench_cpu import BENCH, ROOT  # noqa: F401
from harness import graphs, manifest
from repro_torch.graph import generators as port

MAN = manifest.load(ROOT)
CONFIGS = {c["name"]: manifest.config(MAN, c["name"], ROOT)
           for c in MAN["configs"]}


def _law(cfg):
    law = cfg["degree_law"]
    return law["rank_exponent"], law.get("cap_over_mean")


def rank_law_statistics(n, rank_exponent, cap_over_mean):
    """The expected-degree law's largest and median weight over the mean
    at ``n`` nodes."""
    w = graphs.rank_weights(n, rank_exponent, cap_over_mean) * n
    return {"max_over_mean": float(w[0]),
            "median_over_mean": float(np.median(w))}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mean_degree_is_published(name):
    cfg = CONFIGS[name]
    pub = cfg["published"]
    assert cfg["mean_degree"] == pytest.approx(
        pub["n_edges"] / pub["n_nodes"], abs=1e-4)


def test_ldbc_law_is_facebooks_shape():
    # Datagen's law at every scale: median 99 and cap 5,000 over mean 190
    cfg = CONFIGS["ldbc-knows-n160k"]
    for n in (cfg["n_nodes"], cfg["published"]["n_nodes"]):
        st = rank_law_statistics(n, *_law(cfg))
        assert st["median_over_mean"] == pytest.approx(99 / 190, rel=2e-3)
        assert st["max_over_mean"] == pytest.approx(5000 / 190, rel=1e-4)


def test_lj_law_gives_the_published_largest_degree():
    cfg = CONFIGS["lj-n200k"]
    pub = cfg["published"]
    st = rank_law_statistics(pub["n_nodes"], *_law(cfg))
    assert st["max_over_mean"] * cfg["mean_degree"] == pytest.approx(
        pub["max_degree"], rel=2e-3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graph_holds_the_mean_degree(name):
    cfg = dict(CONFIGS[name], n_nodes=3000)
    ip, ix = graphs.make_graph(cfg, 2**31 + 7)
    n = cfg["n_nodes"]
    assert ip.dtype == np.int64 and ix.dtype == np.int32
    assert len(ix) == 2 * round(n * cfg["mean_degree"] / 2)
    src = np.repeat(np.arange(n), np.diff(ip))
    assert not (src == ix).any()  # no self-loops
    key = src * n + ix
    assert (np.diff(key) > 0).all()  # sorted, no duplicates
    rev = np.sort(ix.astype(np.int64) * n + src)
    np.testing.assert_array_equal(rev, key)  # symmetric


def test_degrees_follow_the_weights():
    # the hub's degree tracks its expected degree; a capped law keeps
    # every node near its cap
    n, mean = 4000, 20.0
    w = graphs.rank_weights(n, 0.7, cap_over_mean=10.0)
    assert w.sum() == pytest.approx(1.0)
    assert w.max() == pytest.approx(10.0 / n, rel=1e-6)
    ip, ix = graphs.make_graph({"n_nodes": n, "mean_degree": mean,
                                "degree_law": {"rank_exponent": 0.7,
                                               "cap_over_mean": 10.0}}, 3)
    deg = np.diff(ip)
    assert deg.mean() == pytest.approx(mean)
    assert 150 <= deg.max() <= 260  # expected about 200


def test_same_seed_same_graph_other_seed_other():
    cfg = {"n_nodes": 200, "mean_degree": 5.0,
           "degree_law": {"rank_exponent": 0.6}}
    a = graphs.make_graph(cfg, 1)
    b = graphs.make_graph(cfg, 1)
    c = graphs.make_graph(cfg, 2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1]) or not np.array_equal(a[0], c[0])
    with pytest.raises(ValueError):
        graphs.draw_edges(4, 7, np.full(4, 0.25), 0)
    keys = graphs.draw_edges(4, 6, np.full(4, 0.25), 0)  # every pair
    assert keys.tolist() == [1, 2, 3, 6, 7, 11]


@pytest.mark.parametrize("k,min_levels", [(16, 3), (40, 2)])
def test_pick_sources_equals_program(k, min_levels):
    csr = port.powerlaw(400, 4.0, alpha=2.1, seed=3)
    got = graphs.pick_sources(csr.indptr, csr.indices, k, seed=9,
                              min_levels=min_levels)
    exp = port.pick_sources(csr, k, seed=9, min_levels=min_levels)
    np.testing.assert_array_equal(got, exp)
