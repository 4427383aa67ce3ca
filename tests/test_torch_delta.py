"""The port's graph deltas (``repro_torch.graph.delta``) against the JAX
package's ``repro.graph.delta`` on identical seeded inputs.

- ``GraphDelta`` normalisation and its validation errors;
- ``random_delta`` gives JAX's arrays for several seeds (deletes sample
  the live edge list), weighted and not;
- ``apply_delta_csr`` equals JAX's leaf by leaf over seeded edit scripts
  with duplicate, absent and self-loop edits and weights;
- ``diff_effective`` equals JAX's, truncation boundary under a cap
  included;
- ``fold_operands`` from the same leaves (JAX build -> numpy ->
  ``operands_from_numpy``): after every delta of a script every folded
  leaf is bitwise JAX's and the ``FoldReport`` is the same, on a
  same-shape fold, a re-binning move, an ELL overflow, a tile emptying
  then a tile claiming the freed slot then a full tile list, a weighted
  graph and an edgeless round trip.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.graph.csr as jcsr
import repro.graph.delta as jdelta
from repro.core import build_operands as j_build_operands
from repro.core.extend import GraphOperands as JGraphOperands
from repro.core.extend import effective_csr as j_effective_csr
from repro.graph.generators import erdos_renyi, powerlaw

import repro_torch.graph.delta as tdelta
from repro_torch.core.extend import GraphOperands as TGraphOperands
from repro_torch.core.extend import effective_csr as t_effective_csr
from repro_torch.core.extend import operands_from_numpy

from test_torch_graph import (
    assert_tree_equal,
    jax_operand_leaves,
    to_port,
    with_weights,
)


def rand_csr(n=100, m=700, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 2.0, m).astype(np.float32) if weighted else None
    return jcsr.csr_from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m),
                               weights=w)


def assert_csr_equal(a, b, msg=""):
    for f in ("indptr", "indices", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f"{msg} {f}"
            continue
        assert x.dtype == y.dtype, f"{msg} {f}"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f}")


def port_delta(d):
    return tdelta.GraphDelta(d.add_src, d.add_dst, d.del_src, d.del_dst,
                             add_weights=d.add_weights)


# ---------------------------------------------------------------------------
# GraphDelta, random_delta, apply_delta_csr, diff_effective
# ---------------------------------------------------------------------------


def test_delta_normalization_and_validation():
    d = tdelta.GraphDelta(add_src=[1, 2], add_dst=[3, 4])
    j = jdelta.GraphDelta(add_src=[1, 2], add_dst=[3, 4])
    assert d.n_adds == j.n_adds == 2 and d.n_dels == j.n_dels == 0
    for f in ("add_src", "add_dst", "del_src", "del_dst"):
        assert getattr(d, f).dtype == np.int64
        np.testing.assert_array_equal(getattr(d, f), getattr(j, f))
    np.testing.assert_array_equal(d.touched_rows(), j.touched_rows())
    w = tdelta.GraphDelta(add_src=[0], add_dst=[1], add_weights=[2])
    assert w.add_weights.dtype == np.float32
    for kw in (dict(add_src=[1], add_dst=[2, 3]),
               dict(del_src=[1, 2], del_dst=[3]),
               dict(add_src=[1], add_dst=[2], add_weights=[1.0, 2.0])):
        with pytest.raises(ValueError, match="mismatch"):
            tdelta.GraphDelta(**kw)
    with pytest.raises(ValueError, match="outside"):
        tdelta.GraphDelta(add_src=[99], add_dst=[0]).validate(n_nodes=10)
    with pytest.raises(ValueError, match="outside"):
        tdelta.GraphDelta(del_src=[0], del_dst=[-1]).validate(n_nodes=10)
    with pytest.raises(ValueError, match="unweighted"):
        tdelta.apply_delta_csr(
            to_port(rand_csr()),
            tdelta.GraphDelta(add_src=[0], add_dst=[1], add_weights=[2.0]),
        )


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 500])
def test_random_delta_matches_jax(seed, weighted):
    csr = rand_csr(n=90, m=500, seed=seed + 1, weighted=weighted)
    for n_adds, n_dels in ((12, 9), (0, 5), (7, 0)):
        j = jdelta.random_delta(csr, n_adds, n_dels, seed=seed)
        t = tdelta.random_delta(to_port(csr), n_adds, n_dels, seed=seed)
        for f in ("add_src", "add_dst", "del_src", "del_dst", "add_weights"):
            x, y = getattr(j, f), getattr(t, f)
            if x is None:
                assert y is None, f
                continue
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def edit_scripts(csr, seed):
    """Seeded deltas with duplicate adds and deletes, absent deletes,
    self-loops, re-inserts of live edges and (on weighted graphs) new
    weights."""
    r = np.random.default_rng(seed)
    n = csr.n_nodes
    s, t = csr.edge_list()
    live = r.integers(0, csr.n_edges, 6)
    adds_s = np.concatenate([r.integers(0, n, 10), s[live], [5, 5, 9]])
    adds_d = np.concatenate([r.integers(0, n, 10), t[live], [5, 5, 9]])
    dels_s = np.concatenate([s[live[:3]], s[live[:3]], r.integers(0, n, 4)])
    dels_d = np.concatenate([t[live[:3]], t[live[:3]], r.integers(0, n, 4)])
    w = None
    if csr.weights is not None:
        w = r.uniform(0.1, 2.0, len(adds_s)).astype(np.float32)
    yield jdelta.GraphDelta(adds_s, adds_d, dels_s, dels_d, add_weights=w)
    yield jdelta.random_delta(csr, 20, 20, seed=seed)
    yield jdelta.GraphDelta(del_src=s, del_dst=t)  # every edge deleted


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_apply_delta_csr_matches_jax(seed, weighted):
    csr = rand_csr(n=60, m=300, seed=seed, weighted=weighted)
    for i, d in enumerate(edit_scripts(csr, seed)):
        j = jdelta.apply_delta_csr(csr, d)
        t = tdelta.apply_delta_csr(to_port(csr), port_delta(d))
        assert_csr_equal(j, t, f"delta {i}")
    # weights default to 1.0 when a weighted graph gets an unweighted delta
    if weighted:
        d = jdelta.GraphDelta(add_src=[3], add_dst=[4])
        assert_csr_equal(jdelta.apply_delta_csr(csr, d),
                         tdelta.apply_delta_csr(to_port(csr), port_delta(d)))


def assert_diff_equal(j, t):
    assert j.n_nodes == t.n_nodes and j.n_changed_edges == t.n_changed_edges
    for f in ("fwd_dirty", "rev_dirty", "added", "removed", "reweighted"):
        x, y = getattr(j, f), getattr(t, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("cap", [None, 8])
@pytest.mark.parametrize("weighted", [False, True])
def test_diff_effective_matches_jax(cap, weighted):
    csr = rand_csr(n=50, m=600, seed=3, weighted=weighted)
    assert int(csr.degrees.max()) > 16
    for d in edit_scripts(csr, 4):
        new = jdelta.apply_delta_csr(csr, d)
        j = jdelta.diff_effective(j_effective_csr(csr, cap),
                                  j_effective_csr(new, cap), d)
        tc, tn = to_port(csr), to_port(new)
        t = tdelta.diff_effective(t_effective_csr(tc, cap),
                                  t_effective_csr(tn, cap), port_delta(d))
        assert_diff_equal(j, t)


def test_diff_effective_truncation_boundary():
    """Deleting an edge under a cap of 8 pulls a truncated edge into the
    effective set: both directions of the row are dirty."""
    csr = jcsr.csr_from_edges(12, np.zeros(10, np.int64), np.arange(1, 11))
    d = jdelta.GraphDelta(del_src=[0], del_dst=[1])
    new = jdelta.apply_delta_csr(csr, d)
    j = jdelta.diff_effective(j_effective_csr(csr, 8),
                              j_effective_csr(new, 8), d)
    t = tdelta.diff_effective(t_effective_csr(to_port(csr), 8),
                              t_effective_csr(to_port(new), 8),
                              port_delta(d))
    assert_diff_equal(j, t)
    assert 0 in t.fwd_dirty and t.n_changed_edges == 2
    np.testing.assert_array_equal(t.rev_dirty, [1, 9])


def test_reweighted_edges_dirty_their_rows():
    csr = rand_csr(n=40, m=200, seed=5, weighted=True)
    s, t = csr.edge_list()
    pick = np.arange(0, 40, 7)
    d = jdelta.GraphDelta(add_src=s[pick], add_dst=t[pick],
                          del_src=s[pick], del_dst=t[pick],
                          add_weights=np.full(len(pick), 9.5, np.float32))
    new = jdelta.apply_delta_csr(csr, d)
    td = tdelta.diff_effective(to_port(csr), to_port(new), port_delta(d))
    assert_diff_equal(jdelta.diff_effective(csr, new, d), td)
    assert td.n_changed_edges == 0 and len(td.reweighted) == len(pick)
    np.testing.assert_array_equal(td.fwd_dirty, np.unique(s[pick]))


# ---------------------------------------------------------------------------
# fold_operands: every structure, leaf by leaf, delta after delta
# ---------------------------------------------------------------------------


def j_host(csr, max_deg=None):
    """A writable numpy mirror of every structure at one ``n_pad`` (rows
    padded to the tile size for all of them)."""
    a, n_pad = j_build_operands(csr, "ell_pull", max_deg=max_deg, block=128)
    b, _ = j_build_operands(csr, "pull_binned_fused", max_deg=max_deg,
                            block=128)
    c, _ = j_build_operands(csr, "block_mxu", max_deg=max_deg)
    ops = JGraphOperands(fwd=a.fwd, rev=a.rev, rev_binned=b.rev_binned,
                         rev_binned_pack=b.rev_binned_pack, blocks=c.blocks)
    return jax.tree.map(lambda x: np.array(x), ops), n_pad


def fold_both(csr, deltas, max_deg=None):
    """Fold each delta into a JAX mirror and a port mirror built from its
    leaves; after each step assert every structure bitwise equal and the
    reports equal. Returns the port's reports."""
    jh, n_pad = j_host(csr, max_deg)
    # copies: operands_from_numpy shares the memory of writable arrays
    th = operands_from_numpy(
        {k: v.copy() for k, v in jax_operand_leaves(jh).items()})
    assert_tree_equal(jh, th, "start")
    reports = []
    cur = csr
    for i, d in enumerate(deltas):
        new = jdelta.apply_delta_csr(cur, d)
        j_old, j_new = (j_effective_csr(g, max_deg) for g in (cur, new))
        t_old, t_new = (t_effective_csr(to_port(g), max_deg)
                        for g in (cur, new))
        jdiff = jdelta.diff_effective(j_old, j_new, d)
        tdiff = tdelta.diff_effective(t_old, t_new, port_delta(d))
        js, jrep = jdelta.fold_operands(jh, j_old, j_new, jdiff)
        ts, trep = tdelta.fold_operands(th, t_old, t_new, tdiff)
        assert dataclasses.asdict(jrep) == dataclasses.asdict(trep), i
        for s in tdelta.STRUCTURES:
            assert_tree_equal(js[s], ts[s], f"delta {i} {s}")
            if not trep.reshaped[s]:  # folded in place, never replaced
                assert ts[s] is getattr(th, s), (i, s)
        jh = JGraphOperands(**js)
        th = TGraphOperands(**ts)
        reports.append(trep)
        cur = new
    return reports


def warm_graph():
    """In-degrees only {10, 11}: one refined reverse bucket of width 11;
    moving one edge from an 11-in-degree target to a 10-in-degree one
    (same source) changes content but no shape."""
    n = 64
    rng = np.random.default_rng(7)
    src_l, dst_l = [], []
    targets = list(range(32, 56))
    for i, t in enumerate(targets):
        for s in rng.choice(32, size=(10 if i % 2 == 0 else 11),
                            replace=False):
            src_l.append(int(s))
            dst_l.append(int(t))
    csr = jcsr.csr_from_edges(n, np.array(src_l), np.array(dst_l))
    indeg = np.bincount(dst_l, minlength=n)
    edges = set(zip(src_l, dst_l))
    for (s, t) in sorted(edges):
        if indeg[t] == 11:
            for t2 in targets:
                if indeg[t2] == 10 and (s, t2) not in edges:
                    return csr, jdelta.GraphDelta(add_src=[s], add_dst=[t2],
                                                  del_src=[s], del_dst=[t])
    raise AssertionError("the graph holds both in-degrees")


def test_fold_same_shape():
    csr, d = warm_graph()
    (rep,) = fold_both(csr, [d])
    assert rep.same_shape and rep.binned_moves == 0
    assert rep.changed == {"fwd": True, "rev": True, "rev_binned": True,
                           "rev_binned_pack": True, "blocks": True}


def swap_graph():
    """Targets 0-9 have in-degree 3 and targets 10-19 in-degree 5 (two
    buckets, no free slot); giving node 0 two more in-edges and taking two
    from node 10 swaps their buckets."""
    src, dst = [], []
    for t in range(20):
        for j in range(3 if t < 10 else 5):
            src.append(20 + (t * 5 + j) % 20)
            dst.append(t)
    csr = jcsr.csr_from_edges(40, np.array(src), np.array(dst))
    ins0 = set(np.asarray(src)[np.asarray(dst) == 0].tolist())
    new_src = [s for s in range(20, 40) if s not in ins0][:2]
    ins10 = np.asarray(src)[np.asarray(dst) == 10][:2]
    return csr, jdelta.GraphDelta(add_src=new_src, add_dst=[0, 0],
                                  del_src=ins10, del_dst=[10, 10])


def test_fold_rebinning_move_rewrites_perm_pad():
    csr, d = swap_graph()
    jh, _ = j_host(csr)
    perm0 = np.array(jh.rev_binned_pack.perm_pad)
    (rep,) = fold_both(csr, [d])
    assert rep.same_shape and rep.binned_moves == 2
    jh2, _ = j_host(csr)
    new = jdelta.apply_delta_csr(csr, d)
    old_eff, new_eff = j_effective_csr(csr, None), j_effective_csr(new, None)
    js, _ = jdelta.fold_operands(
        jh2, old_eff, new_eff, jdelta.diff_effective(old_eff, new_eff, d))
    assert not np.array_equal(js["rev_binned_pack"].perm_pad, perm0)


def test_fold_ell_overflow_rebuilds():
    csr = rand_csr(n=80, m=300, seed=4)
    width = -(-int(csr.degrees.max()) // 8) * 8
    d = jdelta.GraphDelta(add_src=np.full(width + 3, 7),
                          add_dst=np.arange(width + 3) % 80)
    (rep,) = fold_both(csr, [d])
    assert rep.reshaped["fwd"] and not rep.same_shape


def tile_graph():
    """300 nodes in 384 padded rows (3x3 tiles of 128); tile (2, 2) holds
    one edge, tiles (0, 2) and (1, 2) none."""
    base = erdos_renyi(120, 3.0, seed=2)
    s, t = base.edge_list()
    src = np.concatenate([s, [130, 140, 260]])
    dst = np.concatenate([t, [10, 20, 270]])
    return jcsr.csr_from_edges(300, src, dst)


def test_fold_tiles_free_claim_and_full_list():
    csr = tile_graph()
    reps = fold_both(csr, [
        jdelta.GraphDelta(del_src=[260], del_dst=[270]),  # tile empties
        jdelta.GraphDelta(add_src=[5], add_dst=[290]),  # claims its slot
        jdelta.GraphDelta(add_src=[150], add_dst=[280]),  # no slot left
    ])
    assert [r.changed["blocks"] for r in reps] == [True, True, True]
    assert [r.reshaped["blocks"] for r in reps] == [False, False, True]


@pytest.mark.parametrize("seed", [1, 2])
def test_fold_weighted_scripts(seed):
    csr = with_weights(powerlaw(90, 4.0, seed=seed), seed=seed + 10)
    r = np.random.default_rng(seed)
    s, t = csr.edge_list()
    pick = np.unique(r.integers(0, csr.n_edges, 12))
    deltas = [
        jdelta.random_delta(csr, 10, 10, seed=seed),
        # weight-only churn: the same edges at new weights
        jdelta.GraphDelta(add_src=s[pick], add_dst=t[pick],
                          del_src=s[pick], del_dst=t[pick],
                          add_weights=r.uniform(0.1, 2.0, len(pick))),
        jdelta.GraphDelta(add_src=r.integers(0, 90, 15),
                          add_dst=np.full(15, 3),
                          add_weights=r.uniform(0.1, 2.0, 15)),
    ]
    reps = fold_both(csr, deltas)
    assert reps[1].changed["fwd"]


def test_fold_under_degree_cap():
    csr = rand_csr(n=50, m=600, seed=3)
    fold_both(csr, list(edit_scripts(csr, 6))[:2], max_deg=8)


def test_fold_edgeless_round_trip():
    empty = jcsr.csr_from_edges(50, np.zeros(0, np.int64),
                                np.zeros(0, np.int64))
    rng = np.random.default_rng(5)
    grow = jdelta.GraphDelta(add_src=rng.integers(0, 50, 60),
                             add_dst=rng.integers(0, 50, 60))
    full = jdelta.apply_delta_csr(empty, grow)
    s, t = full.edge_list()
    reps = fold_both(empty, [grow, jdelta.GraphDelta(del_src=s, del_dst=t)])
    assert reps[0].reshaped["fwd"] and reps[0].reshaped["rev"]
    assert reps[0].reshaped["rev_binned"]
    # the edgeless tile list holds one sentinel slot, which the graph's
    # one tile (50 nodes in 128 rows) claims without a rebuild
    assert reps[0].changed["blocks"] and not reps[0].reshaped["blocks"]
    assert reps[1].changed["blocks"] and not reps[1].reshaped["blocks"]
