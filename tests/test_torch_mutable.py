"""Mutable graphs in the port's dispatcher against the JAX package's.

- Update-then-query (``QueryDispatcher.apply_delta``, then a query)
  equals JAX's update-then-query and the port's own rebuild-then-query
  for ``dopt``, ``pull_binned_fused``, ``dopt_fused`` and ``block_mxu``
  (dense and 64-lane). The fused backends are held against JAX's jnp
  twins (``pull_binned``, ``dopt_binned``): the JAX package's Pallas
  ``binned_pull`` body does not run under this JAX. Every folded host
  mirror is bitwise JAX's. ``DeltaReport`` agrees on the edge and row
  counts; ``bundles``, ``structures_changed`` and ``binned_moves`` may
  not, because JAX keys bundles on the policy's graph axes too and can
  hold two bundles (one per hybrid phase) where the port holds one.
- A same-shape delta keeps ``compile_events`` flat; a shape-changing
  delta invalidates exactly the keys JAX invalidates, the stale ones;
  ``EngineCache.invalidate`` and its mapping surface (``keys``, ``items``,
  ``get``, ``in``, ``iter``, ``count_by_kind``).
- A batch in flight keeps its pre-delta bundle (phase 2 included).
- The fence resets the learned state and keeps pinned thresholds.
- After a fold into a ``BinnedPullPack`` that moved rows between buckets,
  its launch record is dropped and rebuilt, and every op equals the same
  op on a pack built fresh from the post-delta graph.
- Random edit scripts against the rebuild, with the binned invariants.
"""
import functools

import numpy as np
import pytest
import torch

from oracle import bfs_levels

import repro.graph.delta as jdelta
from repro.graph.generators import powerlaw
from repro.launch.mesh import make_mesh
from repro.runtime.dispatch import QueryDispatcher as JDispatcher

import repro_torch.graph.delta as tdelta
from repro_torch.core import build_operands
from repro_torch.core.extend import effective_csr
from repro_torch.kernels.binned_pull.binned_pull import LANE_OPS, OPS
from repro_torch.kernels.binned_pull.ops import binned_pull, launch_record
from repro_torch.runtime.dispatch import QueryDispatcher as TDispatcher
from repro_torch.runtime.scheduler import AdaptiveScheduler

from test_torch_delta import port_delta, rand_csr, swap_graph, warm_graph
from test_torch_dispatch import JAX_TWIN
from test_torch_graph import assert_tree_equal, np_of, to_port, with_weights


@functools.lru_cache(maxsize=None)
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def levels(disp, srcs, **kw):
    out = disp.query(srcs, **kw)
    return np_of(out.result.state.levels), np_of(out.result.iterations)


def jax_levels(disp, srcs, backend, **kw):
    out = disp.query(srcs, backend=JAX_TWIN.get(backend, backend), **kw)
    return (np.asarray(out.result.state.levels),
            np.asarray(out.result.iterations))


SCANNED = {"fwd": "fwd", "rev": "needs_rev", "rev_binned": "needs_binned",
           "rev_binned_pack": "needs_binned_pack", "blocks": "needs_blocks"}


def assert_mirrors_equal(jd, td):
    """Every structure of every port bundle's host mirror is bitwise the
    host mirror of each JAX bundle holding that structure at the same row
    padding, with the same epoch."""
    matched = 0
    for tb in td._graphs.values():
        for jb in jd._graphs.values():
            if jb.n_pad != tb.n_pad or jb.host is None:
                continue
            for s in SCANNED:
                js, ts = getattr(jb.host, s), getattr(tb.host, s)
                if js is None or ts is None:
                    continue
                assert_tree_equal(js, ts, s)
                assert jb.epochs.get(s, 0) == tb.epochs.get(s, 0), s
                matched += 1
    assert matched > 0


REPORT_FIELDS = ("version", "n_adds", "n_dels", "changed_edges",
                 "dirty_fwd_rows", "dirty_rev_rows")


@pytest.mark.parametrize("backend,policy", [
    ("dopt", None), ("pull_binned_fused", None), ("dopt_fused", None),
    ("block_mxu", None), ("block_mxu", "ntkms"),
])
def test_update_then_query_matches_jax_and_rebuild(backend, policy):
    csr = rand_csr(n=120, m=900, seed=1)
    delta = jdelta.random_delta(csr, n_adds=25, n_dels=25, seed=7)
    srcs = np.random.default_rng(5).integers(0, 120, 8).astype(np.int32)
    jd = JDispatcher(mesh11(), csr, max_iters=32)
    td = TDispatcher("cpu", to_port(csr), max_iters=32)
    jax_levels(jd, srcs, backend, policy=policy)
    td.query(srcs, backend=backend, policy=policy)
    jrep = jd.apply_delta(delta)
    trep = td.apply_delta(port_delta(delta))
    assert trep.version == td.operands_version == 1
    for f in REPORT_FIELDS:
        assert getattr(jrep, f) == getattr(trep, f), f
    assert jrep.bundles >= trep.bundles and trep.ms > 0
    assert_mirrors_equal(jd, td)
    t_lv, t_it = levels(td, srcs, backend=backend, policy=policy)
    j_lv, j_it = jax_levels(jd, srcs, backend, policy=policy)
    np.testing.assert_array_equal(j_lv, t_lv)
    np.testing.assert_array_equal(j_it, t_it)
    fresh = TDispatcher("cpu", tdelta.apply_delta_csr(to_port(csr),
                                                      port_delta(delta)),
                        max_iters=32)
    r_lv, r_it = levels(fresh, srcs, backend=backend, policy=policy)
    np.testing.assert_array_equal(t_lv, r_lv)
    np.testing.assert_array_equal(t_it, r_it)


def test_weighted_graph_update_then_query():
    csr = rand_csr(n=120, m=900, seed=1, weighted=True)
    delta = jdelta.random_delta(csr, 25, 25, seed=7)
    assert delta.add_weights is not None
    srcs = np.arange(0, 120, 15, dtype=np.int32)
    jd = JDispatcher(mesh11(), csr, max_iters=32)
    td = TDispatcher("cpu", to_port(csr), max_iters=32)
    jax_levels(jd, srcs, "dopt")
    td.query(srcs, backend="dopt")
    jd.apply_delta(delta)
    td.apply_delta(port_delta(delta))
    assert_mirrors_equal(jd, td)
    np.testing.assert_array_equal(jax_levels(jd, srcs, "dopt")[0],
                                  levels(td, srcs, backend="dopt")[0])


@pytest.mark.parametrize("backend", ["pull_binned_fused", "dopt"])
def test_same_shape_delta_keeps_engines_warm(backend):
    jcsr, delta = warm_graph()
    csr = to_port(jcsr)
    d = TDispatcher("cpu", csr, max_iters=32)
    srcs = np.random.default_rng(0).integers(0, 32, 8).astype(np.int32)
    for _ in range(2):  # let the budget model's choice settle
        d.query(srcs, backend=backend)
    before = d.cache.compile_events
    rep = d.apply_delta(port_delta(delta))
    assert rep.same_shape and rep.engines_invalidated == 0
    assert rep.structures_rebuilt == 0 and rep.structures_changed > 0
    lv, _ = levels(d, srcs, backend=backend)
    assert d.cache.compile_events == before
    fresh = TDispatcher("cpu", tdelta.apply_delta_csr(csr, port_delta(delta)),
                        max_iters=32)
    np.testing.assert_array_equal(lv, levels(fresh, srcs, backend=backend)[0])


def test_engine_cache_invalidate_and_public_surface():
    from repro_torch.runtime.dispatch import EngineCache, EngineKey

    def key(i, epoch=0):
        return EngineKey(kind="static" if i % 2 else "gang", policy=("p",),
                         edge_compute="sp", n_nodes_padded=64, max_iters=i,
                         state_layout="replicated", operands_epoch=epoch)

    c = EngineCache(max_entries=8)
    for i in range(4):
        c.get_or_build(key(i, epoch=i % 2), lambda i=i: f"e{i}")
        c.note_shape(key(i, epoch=i % 2), (8,))
    keys = list(c.keys())
    assert list(iter(c)) == keys and [k for k, _ in c.items()] == keys
    assert all(k in c for k in keys) and c.get(keys[0]) == "e0"
    assert c.get("missing", "fallback") == "fallback"
    assert c.count_by_kind("static") == 2 and c.count_by_kind("gang") == 2
    hits = c.hits
    assert c.get(keys[1]) == "e1" and c.hits == hits  # no accounting
    assert c.invalidate(lambda k: k.operands_epoch == 1) == 2
    assert c.invalidations == 2 and len(c) == 2
    assert all(k.operands_epoch == 0 for k in c.keys())
    # an invalidated key's shape ledger went with it: its return is cold
    assert c.note_shape(key(1, epoch=1), (8,)) is True
    assert c.get_or_build(key(1, epoch=1), lambda: "again") == "again"
    assert c.misses == 5


def norm_key(k):
    return (k.kind, k.policy.name, k.edge_compute, k.n_nodes_padded,
            k.max_iters, k.state_layout,
            (k.extend.backend, k.extend.direction, k.extend.pull), k.stats,
            k.operands_epoch)


def test_shape_changing_delta_invalidates_exactly_stale_keys():
    csr = rand_csr(n=100, m=400, seed=2)
    srcs = np.arange(6, dtype=np.int32)
    jd = JDispatcher(mesh11(), csr, max_iters=32)
    td = TDispatcher("cpu", to_port(csr), max_iters=32)
    for b in ("dopt", "block_mxu"):
        jax_levels(jd, srcs, b)
        td.query(srcs, backend=b)
    assert sorted(map(norm_key, jd.cache.keys())) == sorted(
        map(norm_key, td.cache.keys()))
    n_engines = len(td.cache)
    # 60 adds onto one target: its in-degree leaves every reverse bucket
    rng = np.random.default_rng(9)
    delta = jdelta.GraphDelta(add_src=rng.integers(0, 100, 60),
                              add_dst=np.full(60, 3))
    jrep = jd.apply_delta(delta)
    trep = td.apply_delta(port_delta(delta))
    assert not trep.same_shape and 0 < trep.engines_invalidated < n_engines
    assert trep.engines_invalidated == jrep.engines_invalidated
    assert td.cache.invalidations == trep.engines_invalidated
    kept = sorted(map(norm_key, td.cache.keys()))
    assert kept == sorted(map(norm_key, jd.cache.keys()))
    # what survived scans no rebuilt structure
    for k in td.cache.keys():
        assert not td._engine_stale(k)
    assert all(k[6][0] == "block_mxu" for k in kept)
    np.testing.assert_array_equal(jax_levels(jd, srcs, "dopt")[0],
                                  levels(td, srcs, backend="dopt")[0])


@pytest.mark.parametrize("phase1_iters", [None, 1])
def test_inflight_batch_keeps_pre_delta_bundle(phase1_iters):
    jcsr = powerlaw(160, 5.0, seed=0)
    delta = jdelta.random_delta(jcsr, 15, 15, seed=9)
    csr = to_port(jcsr)
    csr2 = tdelta.apply_delta_csr(csr, port_delta(delta))
    d = TDispatcher("cpu", csr, max_iters=64, phase1_iters=phase1_iters)
    srcs = np.random.default_rng(3).integers(0, 160, 4).astype(np.int32)
    inflight = d.begin_batch(srcs, backend="dopt")
    pinned = inflight.payload["g2"]
    d.apply_delta(port_delta(delta))
    assert d._graphs[next(iter(d._graphs))].ops is not pinned
    outcome = d.finalize_batch(d.settle_batch(inflight))
    if phase1_iters == 1:
        assert outcome.redispatched > 0  # phase 2 ran after the delta
    lv = np_of(outcome.result.state.levels)[:, : csr.n_nodes]
    np.testing.assert_array_equal(
        lv, np.stack([bfs_levels(csr, int(s)) for s in srcs]),
        err_msg="the in-flight batch finishes on the old graph")
    lv2 = levels(d, srcs, backend="dopt")[0][:, : csr.n_nodes]
    np.testing.assert_array_equal(
        lv2, np.stack([bfs_levels(csr2, int(s)) for s in srcs]),
        err_msg="a later query sees the new graph")


def test_delta_fence_resets_learned_state_and_keeps_pins():
    jcsr = powerlaw(160, 5.0, seed=0)
    csr = to_port(jcsr)
    kw = dict(max_iters=64, online_adapt=True, refit_every=2,
              backend="dopt", family="powerlaw")
    jd = JDispatcher(mesh11(), jcsr, **kw)
    td = TDispatcher("cpu", csr, **kw)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 160, 6).astype(np.int32) for _ in range(5)]
    for b in batches[:4]:
        jd.query(b)
        td.query(b)
    assert len(td.budget_model) > 0 and td._dir_samples and td._iter_p90s
    td.refit_thresholds()
    assert td.direction_thresholds is not None
    observed = td.budget_model.mispredicts.observed
    delta = jdelta.random_delta(jcsr, 10, 10, seed=5)
    rep = td.apply_delta(port_delta(delta))
    jd.apply_delta(delta)
    assert rep.version == 1 and td.stats.deltas == 1
    assert len(td.budget_model) == 0 and td.budget_model.n_samples == 0
    assert not td._dir_samples and not td._iter_p90s
    assert td.direction_thresholds is None
    assert td.budget_model.mispredicts.observed == observed
    td.query(batches[4])
    jd.query(batches[4])
    assert td.budget_model.n_samples > 0
    assert td.budget_model.budgets(64) == jd.budget_model.budgets(64)
    # an explicit table is a pin: the fence leaves it
    pinned = td.refit_thresholds()
    d2 = TDispatcher("cpu", csr, direction_thresholds=pinned, **kw)
    d2.query(batches[0])
    d2.apply_delta(port_delta(delta))
    assert d2.direction_thresholds is pinned


def test_scheduler_facade_refreshes_admission_degree():
    jcsr = rand_csr(n=100, m=400, seed=2)
    sched = AdaptiveScheduler("cpu", to_port(jcsr), max_iters=32)
    delta = jdelta.GraphDelta(add_src=np.arange(50), add_dst=np.arange(50) + 1)
    sched.apply_delta(port_delta(delta))
    assert sched._admission.avg_degree == pytest.approx(sched.csr.avg_degree)
    assert sched.csr.n_edges > jcsr.n_edges


def pull_inputs(n_pad, rows, op, rng):
    lanes = (n_pad, 5) if op in LANE_OPS else (n_pad,)
    if op == "min_dist":
        g = np.where(rng.random(n_pad) < 0.4, rng.uniform(0, 9, n_pad), np.inf)
        return torch.from_numpy(g.astype(np.float32)), None
    g = torch.from_numpy((rng.random(lanes) < 0.3).astype(np.uint8))
    v = torch.from_numpy(
        (rng.random((rows,) + lanes[1:]) < 0.3).astype(np.uint8))
    return g, v


def test_binned_pull_on_folded_pack_matches_fresh_pack():
    jcsr, delta = swap_graph()
    csr = with_weights(jcsr, seed=3)
    d = tdelta.GraphDelta(delta.add_src, delta.add_dst, delta.del_src,
                          delta.del_dst, add_weights=[0.5, 1.5])
    host, n_pad = build_operands(to_port(csr), "pull_binned_fused")
    pack = host.rev_binned_pack
    rec0 = launch_record(pack)
    perm0 = pack.perm_pad.clone()
    new = tdelta.apply_delta_csr(to_port(csr), d)
    old_eff, new_eff = effective_csr(to_port(csr), None), effective_csr(new,
                                                                         None)
    structs, rep = tdelta.fold_operands(
        host, old_eff, new_eff, tdelta.diff_effective(old_eff, new_eff, d))
    assert structs["rev_binned_pack"] is pack and rep.binned_moves == 2
    assert rep.same_shape and not torch.equal(pack.perm_pad, perm0)
    assert "_derived_record" not in pack.__dict__
    rec1 = launch_record(pack)
    assert rec1 is not rec0 and torch.equal(rec1.perm_pad, pack.perm_pad[0])
    fresh, n_pad2 = build_operands(new, "pull_binned_fused")
    assert n_pad2 == n_pad
    rng = np.random.default_rng(4)
    for op in OPS:
        g, v = pull_inputs(n_pad, pack.rows_local, op, rng)
        got = binned_pull(pack, g, v, op=op)
        exp = binned_pull(fresh.rev_binned_pack, g, v, op=op)
        assert torch.equal(got, exp), op


def check_binned_invariants(disp):
    """perm/inverse round trip and ``deg <= width <= 1.1 deg`` on every
    live host mirror."""
    eff = effective_csr(disp.csr, disp.max_deg)
    indeg = np.diff(eff.reverse().indptr)
    for bundle in disp._graphs.values():
        if bundle.host is None or bundle.host.rev_binned is None:
            continue
        bn = bundle.host.rev_binned
        perm, inv = bn.perm.numpy(), bn.inv.numpy()
        rows_local = inv.shape[-1]
        filled = perm[0][perm[0] < rows_local]
        assert len(np.unique(filled)) == len(filled)
        np.testing.assert_array_equal(perm[0][inv[0]], np.arange(rows_local))
        starts = np.cumsum([0] + [s.shape[1] for s in bn.slabs])
        for b, w in enumerate(s.shape[-1] for s in bn.slabs):
            rows = perm[0][starts[b]:starts[b + 1]]
            for r in rows[rows < rows_local]:
                if r < eff.n_nodes and indeg[r]:
                    assert indeg[r] <= w <= 1.1 * indeg[r] + 1e-9


def test_random_edit_scripts_vs_rebuild():
    jcsr = rand_csr(n=100, m=700, seed=1)
    cur = to_port(jcsr)
    d = TDispatcher("cpu", cur, max_iters=32)
    r = np.random.default_rng(1)
    for step in range(6):
        n = cur.n_nodes
        kind = step % 4
        if kind == 0:
            delta = tdelta.random_delta(cur, int(r.integers(0, 15)),
                                        int(r.integers(0, 15)),
                                        seed=int(r.integers(10**6)))
        elif kind == 1:  # duplicate adds and self-loops
            v = r.integers(0, n, 4)
            delta = tdelta.GraphDelta(add_src=np.concatenate([v, v]),
                                      add_dst=np.concatenate([v, v]))
        elif kind == 2:  # a node loses every out-edge
            u = int(r.integers(0, n))
            s, t = cur.edge_list()
            delta = tdelta.GraphDelta(del_src=np.full((s == u).sum(), u),
                                      del_dst=t[s == u])
        else:  # 20 edges onto one target: a bucket-boundary crossing
            delta = tdelta.GraphDelta(add_src=r.integers(0, n, 20),
                                      add_dst=np.full(20, int(r.integers(n))))
        assert d.apply_delta(delta).version == step + 1
        cur = tdelta.apply_delta_csr(cur, delta)
        check_binned_invariants(d)
        srcs = r.integers(0, n, 5).astype(np.int32)
        fresh = TDispatcher("cpu", cur, max_iters=32)
        np.testing.assert_array_equal(
            levels(d, srcs, backend="dopt")[0],
            levels(fresh, srcs, backend="dopt")[0], err_msg=f"step {step}")
