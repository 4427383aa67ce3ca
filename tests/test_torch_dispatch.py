"""Parity of the port's dispatcher and closed-loop scheduler with the JAX
package on a 1x1 mesh.

- ``run_recursive_query`` under all four morsel policies (replicated
  state): states and per-morsel iteration counts bitwise equal.
- ``AdaptiveScheduler.query`` with the hybrid forced into phase 2 (a
  pinned ``phase1_iters``), with the gang and the serial resume, dense and
  lane morsels: levels, iterations, policy names, re-dispatch and resume
  counters equal JAX's.
- The online learners on a seeded batch stream (budget model, threshold
  refits, sample trace, mispredict counters, engine-cache accounting) and
  the ``submit``/``flush`` admission surface equal JAX's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import repro.core as jcore
from repro.graph.csr import csr_from_edges
from repro.graph.generators import erdos_renyi, powerlaw
from repro.launch.mesh import make_mesh
from repro.runtime.scheduler import AdaptiveScheduler as JScheduler

import repro_torch.core as tcore
from repro_torch.runtime.scheduler import AdaptiveScheduler as TScheduler

from test_torch_graph import assert_tree_equal, np_of, to_port


def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def skew_graph(kind="powerlaw", n_main=160, paths=(40, 28, 22), seed=0):
    """A small-diameter main component plus long-path stragglers: sources
    on the path heads survive a small phase-1 budget. Returns (JAX csr,
    path heads)."""
    main = (powerlaw if kind == "powerlaw" else erdos_renyi)(
        n_main, 5.0, seed=seed)
    src_m, dst_m = main.edge_list()
    srcs, dsts, base, heads = [src_m], [dst_m], n_main, []
    for length in paths:
        p = np.arange(length - 1, dtype=np.int64) + base
        srcs += [p, p + 1]
        dsts += [p + 1, p]
        heads.append(base)
        base += length
    csr = csr_from_edges(base, np.concatenate(srcs), np.concatenate(dsts))
    return csr, tuple(heads)


@pytest.fixture(scope="module")
def skew():
    return skew_graph("powerlaw")


CASES = [
    ("1t1s", "sp_lengths", "ell_push"),
    ("nt1s", "sp_parents", "dopt"),
    ("ntks", "sp_lengths", "pull_binned"),
    ("ntks", "reachability", "dopt_fused"),
    ("ntkms", "msbfs_lengths", "block_mxu"),
    ("ntkms", "msbfs_parents", "dopt_fused"),
]
JAX_TWIN = {"pull_binned_fused": "pull_binned", "dopt_fused": "dopt_binned"}


@pytest.mark.parametrize("policy,ec,backend", CASES)
def test_run_recursive_query_matches_jax(skew, policy, ec, backend):
    csr, heads = skew
    rng = np.random.default_rng(1)
    n_src = 70 if policy == "ntkms" else 5
    srcs = np.concatenate([heads[:2], rng.integers(0, 160, n_src - 2)])
    srcs = srcs.astype(np.int32)
    exp = jcore.run_recursive_query(
        mesh11(), csr, srcs, jcore.POLICIES[policy](), ec, max_iters=64,
        extend=JAX_TWIN.get(backend, backend))
    got = tcore.run_recursive_query(
        "cpu", to_port(csr), srcs, tcore.POLICIES[policy](), ec,
        max_iters=64, extend=backend)
    np.testing.assert_array_equal(np.asarray(exp.iterations),
                                  np_of(got.iterations))
    assert_tree_equal(exp.state, got.state, f"{policy}/{ec}/{backend}")


def outcome_fields(o):
    return (o.policy, o.hybrid, o.redispatched, o.phase1_budget,
            o.resumed_ganged, o.resumed_serial, o.gang_width,
            o.budget_too_low, o.budget_too_high, o.budget_inert_slots,
            o.budget_observed)


def assert_outcome_equal(jo, to, msg):
    assert outcome_fields(jo) == outcome_fields(to), msg
    np.testing.assert_array_equal(np.asarray(jo.result.iterations),
                                  np_of(to.result.iterations), err_msg=msg)
    assert_tree_equal(jo.result.state, to.result.state, msg)


@pytest.mark.parametrize("gang", [True, False])
@pytest.mark.parametrize("lanes", ["dense", "lanes"])
def test_hybrid_phase2_matches_jax(skew, gang, lanes):
    csr, heads = skew
    backend = "dopt" if lanes == "dense" else "block_mxu"
    kw = dict(max_iters=64, phase1_iters=2, backend=backend,
              gang_resume=gang, online_adapt=False)
    js = JScheduler(mesh11(), csr, **kw)
    ts = TScheduler("cpu", to_port(csr), **kw)
    rng = np.random.default_rng(3)
    if lanes == "dense":
        batches = [np.array([heads[0], heads[1], 3, 7, heads[2], 11]),
                   np.array([heads[2], 5]), np.array([2, 9])]
    else:
        fill = rng.integers(0, 160, 66)
        batches = [np.concatenate([heads, fill]),
                   np.concatenate([fill[:60], heads[:1], fill[:69]])]
    for i, b in enumerate(batches):
        b = b.astype(np.int32)
        jo, to = js.query(b), ts.query(b)
        assert_outcome_equal(jo, to, f"{lanes}/{gang}/batch{i}")
    assert js.stats.redispatched == ts.stats.redispatched > 0
    for f in ("gangs", "gang_slots", "resumed_ganged", "resumed_serial"):
        assert getattr(js.stats, f) == getattr(ts.stats, f), f


def replay_stream(heads):
    rng = np.random.default_rng(7)
    out = []
    for b in range(6):
        fill = rng.integers(0, 160, 4).astype(np.int32)
        if b % 2 == 0:
            fill = np.concatenate([[heads[b % len(heads)]], fill[:3]])
        out.append(fill.astype(np.int32))
    out.append(np.concatenate([heads, rng.integers(0, 160, 70)]).astype(
        np.int32))
    return out


def test_online_learning_stream_matches_jax(skew):
    """Learned budgets, refitted thresholds, the live sample trace, the
    mispredict counters and the engine-cache accounting follow JAX's on
    the same seeded stream (slots cost mode, the CPU default of both)."""
    csr, heads = skew
    kw = dict(max_iters=64, backend="recommend", family="powerlaw",
              online_adapt=True, refit_every=2)
    js = JScheduler(mesh11(), csr, **kw)
    ts = TScheduler("cpu", to_port(csr), **kw)
    assert js.cost_mode == ts.cost_mode == "slots"
    for i, b in enumerate(replay_stream(heads)):
        assert_outcome_equal(js.query(b), ts.query(b), f"batch{i}")
    assert js.refit_thresholds() is not None
    ts.refit_thresholds()
    assert dict(js.direction_thresholds.table) == dict(
        ts.direction_thresholds.table)
    assert js.budget_model.budgets(64) == ts.budget_model.budgets(64)
    assert js.online_trace() == ts.online_trace()
    for f in ("queries", "hybrid_runs", "redispatched", "budget_too_low",
              "budget_too_high", "budget_inert_slots", "budget_observed",
              "refits", "gangs", "gang_slots"):
        assert getattr(js.stats, f) == getattr(ts.stats, f), f
    jc, tc = js.cache, ts.cache
    assert (jc.hits, jc.misses, jc.shape_misses, jc.compile_events) == (
        tc.hits, tc.misses, tc.shape_misses, tc.compile_events)
    assert dict(jc.misses_by_kind) == dict(tc.misses_by_kind)


def test_submit_flush_matches_jax(skew):
    csr, heads = skew
    js = JScheduler(mesh11(), csr, max_iters=64, phase1_iters=4)
    ts = TScheduler("cpu", to_port(csr), max_iters=64, phase1_iters=4)
    rng = np.random.default_rng(5)
    for pooled in (False, True):
        n = 40 if pooled else 3
        for q in range(3):
            src = rng.integers(0, csr.n_nodes, n)
            if q == 0:
                src[0] = heads[0]
            js.submit(src, qid=f"q{q}")
            ts.submit(src, qid=f"q{q}")
        jout, tout = js.flush(), ts.flush()
        assert sorted(jout) == sorted(tout)
        for qid in jout:
            np.testing.assert_array_equal(jout[qid], tout[qid], err_msg=qid)
    assert js.admissions == ts.admissions == {"ntkms": 1, "per_query": 1}


def test_chunked_batch_matches_jax(skew):
    """A batch over the in-flight cap runs as a stitched chunk loop."""
    csr, heads = skew
    kw = dict(max_iters=64, phase1_iters=2, max_inflight=2,
              backend="ell_push", online_adapt=False)
    js = JScheduler(mesh11(), csr, **kw)
    ts = TScheduler("cpu", to_port(csr), **kw)
    b = np.array([heads[0], 1, 2, heads[1], 4], np.int32)
    assert_outcome_equal(js.query(b), ts.query(b), "chunked")
