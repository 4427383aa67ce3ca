"""The port's non-reach query kinds and weighted relax against the JAX
package.

``topk_paths``, ``ppr`` and ``pattern_counts`` (and the ``bellman_ford``
compute) go through the same inputs, made from a seed with numpy, in both
packages:

- the registry (``QUERY_KINDS``, ``EDGE_COMPUTES``) field for field;
- the ELL primitives and every backend's ``min_dist``, ``min_topk`` and
  ``push_sum`` (``pull_binned_fused`` runs the ``binned_pull`` kernel's
  plain version here and is held against JAX's ``pull_binned``, whose
  fused twin goes through a Pallas body current jax cannot trace);
- ``run_ife`` per kind and backend, against JAX and ``tests/oracle.py``;
- ``QueryDispatcher.query`` with phase 2 and the gang resume, the lanes
  guard, a mixed-kind ``ServingLoop`` stream and ``serve.main`` (closed
  and open loop, one with ``--mutate-stream``).

Everything is bitwise except PPR's float sums where the summing order
differs: the port adds each destination's contributions in ascending
source order, as JAX's CPU scatter does, up to ``FOLD_WIDTH`` of them; a
destination with more (the hub graph's hub) is summed in groups, and
there the float leaves are held to the JAX suite's own tolerance
(``rtol=1e-5, atol=1e-7``), with equal iteration counts. The tests that
apply it say so. The oracles are float64 (``sssp``) or add in
``np.add.at`` order (``ppr_mass``), so they are met at that tolerance too.

Also here: parity tests of the small public functions the ported modules
lacked (``run_ife_scan``, ``block_extend_lanes`` / ``_dense``,
``scans_saved_factor``, ``frontier_size`` / ``any_active``,
``SettledBatch.finalized``, ``CSRGraph.edge_keys``, ``EllGraph.mask``,
``BlockAdjacency.occupancy``, ``pack_tile_map``, ``chunk_fold``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import pattern_counts, ppr_mass, sssp, topk_dists

import repro.core as jcore
import repro.graph.csr as jcsr
import repro.launch.serve as jserve
from repro.core import build_operands as j_build_operands
from repro.core import edge_compute as jec
from repro.core import extend as jext
from repro.core.extend import ExtendSpec as JExtendSpec
from repro.core.extend import GraphOperands as JGraphOperands
from repro.core.ife import run_ife_jit as j_run_ife
from repro.graph.generators import PAPER_DATASET_FAMILIES, PAPER_DATASETS
from repro.launch.mesh import make_mesh
from repro.runtime.dispatch import QueryDispatcher as JDispatcher
from repro.runtime.service import ServingLoop as JLoop

import repro_torch.core as tcore
from repro_torch.core import edge_compute as tec
from repro_torch.core import extend as text
from repro_torch.core.extend import ExtendCtx, operands_from_numpy
from repro_torch.core.ife import run_ife
from repro_torch.launch import serve
from repro_torch.runtime.dispatch import QueryDispatcher as TDispatcher
from repro_torch.runtime.service import ServingLoop as TLoop

from test_torch_graph import (
    heavy_tail_csr,
    jax_operand_leaves,
    np_of,
    to_port,
    with_weights,
)
from test_torch_service import ManualClock

TOL = dict(rtol=1e-5, atol=1e-7)
K = tec.TopKPaths.K


@functools.lru_cache(maxsize=None)
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def weighted_csr(n=96, m=640, seed=0):
    """``tests/test_queries.py``'s weighted random graph."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 2.0, m).astype(np.float32)
    return jcsr.csr_from_edges(
        n, rng.integers(0, n, m), rng.integers(0, n, m), weights=w
    )


class Corpus:
    """One weighted graph with every operand at a common pad in both
    packages (the port's bundle is rebuilt from the JAX bundle's numpy
    leaves), plus lazily computed JAX ``run_ife`` results."""

    def __init__(self, csr, hub: bool):
        self.csr = csr
        self.hub = hub  # a destination past FOLD_WIDTH in-edges
        b = 128
        pull, n1 = j_build_operands(csr, "dopt_ell", block=b)
        binned, n2 = j_build_operands(csr, "pull_binned_fused", block=b)
        blk, n3 = j_build_operands(
            csr, JExtendSpec(backend="block_mxu", block=b), block=b)
        assert n1 == n2 == n3
        self.jops = JGraphOperands(
            fwd=pull.fwd, rev=pull.rev, rev_binned=binned.rev_binned,
            rev_binned_pack=binned.rev_binned_pack, blocks=blk.blocks,
        )
        self.n_pad = n1
        self.tops = operands_from_numpy(jax_operand_leaves(self.jops))
        rng = np.random.default_rng(csr.n_nodes)
        self.sources = rng.integers(0, csr.n_nodes - 20, 2).astype(np.int32)
        self._ref = {}

    def jax_result(self, ec, backend):
        key = (ec, backend)
        if key not in self._ref:
            self._ref[key] = j_run_ife(
                self.jops, jnp.asarray(self.sources), ec, 512, backend)
        return self._ref[key]


@pytest.fixture(scope="module")
def corpora():
    hub = with_weights(heavy_tail_csr(140, seed=1), seed=5)
    c = {"rand": Corpus(weighted_csr(96, 576, seed=0), hub=False),
         "hub": Corpus(hub, hub=True)}
    # the hub's in-degree is what makes its PPR sums fold in groups
    assert int(np.bincount(hub.indices).max()) > tec.FOLD_WIDTH
    assert int(np.bincount(c["rand"].csr.indices).max()) <= tec.FOLD_WIDTH
    return c


def jax_twin(backend):
    """JAX's backend with the port backend's arithmetic (the fused flavors
    go through JAX's binned pull, bit-identical by JAX's contract)."""
    return {"pull_binned_fused": "pull_binned",
            "dopt_fused": "dopt_binned"}.get(backend, backend)


def spec(backend, jax=False):
    mod = JExtendSpec if jax else text.ExtendSpec
    if backend == "block_mxu":
        return mod(backend="block_mxu", block=128)
    if jax:
        return jext.as_spec(jax_twin(backend))
    return text.as_spec(backend)


def assert_leaves(jstate, tstate, *, exact=True, msg=""):
    for name, a, b in zip(jstate._fields, jstate, tstate):
        a, b = np.asarray(a), np_of(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (msg, name)
        if exact or not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")
        else:
            np.testing.assert_allclose(b, a, **TOL, err_msg=f"{msg} {name}")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_query_kinds_and_edge_computes_match_jax():
    assert tec.QueryKind._fields == jec.QueryKind._fields
    assert tec.QUERY_KINDS == {k: tuple(v) for k, v in jec.QUERY_KINDS.items()}
    assert sorted(tec.EDGE_COMPUTES) == sorted(jec.EDGE_COMPUTES)
    for name, jc in jec.EDGE_COMPUTES.items():
        tc = tec.EDGE_COMPUTES[name]
        assert tc.MERGE == jc.MERGE and tc.LANES_OK == jc.LANES_OK, name
        assert tc.__name__ == jc.__name__, name
    for kind in tec.QUERY_KINDS.values():
        if kind.edge_compute is not None:
            assert tec.EDGE_COMPUTES[kind.edge_compute].LANES_OK \
                == kind.lanes_ok
    assert (tec.TopKPaths.K, tec.PPRDiffusion.ALPHA, tec.PPRDiffusion.EPS,
            tec.PatternCounts.HOPS) == (jec.TopKPaths.K,
                                        jec.PPRDiffusion.ALPHA,
                                        jec.PPRDiffusion.EPS,
                                        jec.PatternCounts.HOPS)
    state = tec.TopKPaths.init(8, torch.tensor([0], dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="pull-only"):
        tec.TopKPaths.local_extend(None, state)


# ---------------------------------------------------------------------------
# primitives and backends
# ---------------------------------------------------------------------------


def random_inputs(n_pad, seed):
    rng = np.random.default_rng(seed)
    frontier = rng.random(n_pad) < 0.4
    dist = np.where(rng.random(n_pad) < 0.7,
                    rng.uniform(0, 5, n_pad), np.inf).astype(np.float32)
    dists = np.sort(np.where(rng.random((n_pad, K)) < 0.6,
                             rng.uniform(0, 5, (n_pad, K)), np.inf),
                    axis=1).astype(np.float32)
    src_mask = rng.random(n_pad) < 0.1
    counts = rng.integers(-3, 2**20, n_pad).astype(np.int32)
    mass = np.where(frontier, rng.random(n_pad), 0.0).astype(np.float32)
    return frontier, dist, dists, src_mask, counts, mass


@pytest.mark.parametrize("graph", ["rand", "hub"])
def test_primitives_match_jax(corpora, graph):
    c = corpora[graph]
    fr, dist, dists, src_mask, counts, mass = random_inputs(c.n_pad, 11)
    jf, tf = c.jops.fwd, c.tops.fwd
    np.testing.assert_array_equal(
        np.asarray(jec.ell_min_dist(jf, jnp.asarray(dist), jnp.asarray(fr))),
        np_of(tec.ell_min_dist(tf, torch.as_tensor(dist),
                               torch.as_tensor(fr))))
    np.testing.assert_array_equal(
        np.asarray(jec.ell_push_sum(jf, jnp.asarray(counts))),
        np_of(tec.ell_push_sum(tf, torch.as_tensor(counts))))
    a = np.asarray(jec.ell_push_sum(jf, jnp.asarray(mass), normalize=True))
    b = np_of(tec.ell_push_sum(tf, torch.as_tensor(mass), normalize=True))
    if c.hub:  # the hub's sum folds in groups: tolerance (see module doc)
        np.testing.assert_allclose(b, a, **TOL)
        hub_row = int(np.argmax(np.bincount(c.csr.indices)))
        keep = np.arange(c.n_pad) != hub_row
        np.testing.assert_array_equal(a[keep], b[keep])
    else:
        np.testing.assert_array_equal(a, b)
    seed = np.where(src_mask, 0.0, np.inf).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jec.ell_min_topk(c.jops.rev, jnp.asarray(dists),
                                    jnp.asarray(seed))),
        np_of(tec.ell_min_topk(c.tops.rev, torch.as_tensor(dists),
                               torch.as_tensor(seed))))


def test_ordered_sum_is_a_left_fold_in_source_order():
    """Below FOLD_WIDTH in-edges a destination's float sum is exactly
    ((0 + x_u0) + x_u1) + ... in ascending source order; past it, the
    group fold, which stays the same from call to call."""
    n = 200
    src = np.concatenate([np.arange(1, 150), np.arange(1, 12)])
    dst = np.concatenate([np.zeros(149, np.int64), np.full(11, 7)])
    csr = tcore.build_operands(
        to_port(jcsr.csr_from_edges(n, src, dst)), "ell_push")[0].fwd
    vals = np.random.default_rng(3).random(n).astype(np.float32)
    out = np_of(tec.ell_push_sum(csr, torch.as_tensor(vals), 224))
    acc = np.float32(0.0)
    for u in range(1, 12):
        acc = np.float32(acc + vals[u])
    assert out[7] == acc
    groups = [np.float32(0.0)] * 3
    for i, u in enumerate(range(1, 150)):
        groups[i // 64] = np.float32(groups[i // 64] + vals[u])
    total = np.float32(0.0)
    for g in groups:
        total = np.float32(total + g)
    assert out[0] == total
    again = np_of(tec.ell_push_sum(csr, torch.as_tensor(vals), 224))
    np.testing.assert_array_equal(out, again)


def test_ppr_mass_update_rounds_once_like_jax():
    """``mass + ALPHA * settled`` is rounded once to float32, as JAX's
    jitted apply (a fused multiply-add) rounds it, also where the float64
    sum lands on a float32 halfway point: the first element is such a
    case, where rounding the float64 sum to float32 is one ulp low."""
    from fractions import Fraction

    rng = np.random.default_rng(11)
    mass = np.concatenate([[np.float32(8.8815137e-16)],
                           rng.random(63).astype(np.float32)])
    settled = np.concatenate([[np.float32(9.387736e-06)],
                              rng.random(63).astype(np.float32)])
    alpha = np.float32(tec.PPRDiffusion.ALPHA)
    exact = Fraction(float(mass[0])) + (Fraction(float(alpha))
                                        * Fraction(float(settled[0])))
    twice = np.float32(np.float64(mass[0])
                       + np.float64(alpha) * np.float64(settled[0]))
    lo, hi = twice, np.nextafter(twice, np.float32(np.inf))
    mid = (Fraction(float(lo)) + Fraction(float(hi))) / 2
    assert mid < exact < Fraction(float(hi))  # once rounded: hi, not lo
    zeros = np.zeros(64, np.float32)
    got = tec.PPRDiffusion.apply(
        tec.PPRState(*(torch.as_tensor(x) for x in (settled, settled,
                                                     mass))),
        torch.as_tensor(zeros), 0).mass.numpy()
    want = np.asarray(jax.jit(jec.PPRDiffusion.apply)(
        jec.PPRState(*(jnp.asarray(x) for x in (settled, settled, mass))),
        jnp.asarray(zeros), jnp.int32(0)).mass)
    assert got[0] == hi and want[0] == hi
    np.testing.assert_array_equal(got, want)


BACKENDS = ["ell_push", "ell_pull", "pull_binned", "pull_binned_fused",
            "block_mxu", "dopt", "dopt_ell", "dopt_binned", "dopt_fused"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_primitives_match_jax(corpora, backend):
    """``min_dist`` (through the direction switch for ``dopt*``, both
    branches), ``min_topk`` and integer ``push_sum`` bitwise; float
    ``push_sum`` bitwise on the random graph, at tolerance on the hub
    graph."""
    jbe = jext.make_backend(spec(backend, jax=True))
    tbe = text.make_backend(spec(backend))
    for graph, c in corpora.items():
        jctx = jext.ExtendCtx(n_out=c.n_pad)
        tctx = ExtendCtx(n_out=c.n_pad)
        for seed in (1, 2):
            fr, dist, dists, src_mask, counts, mass = random_inputs(
                c.n_pad, seed)
            if seed == 2:  # a full frontier: the switch takes the pull
                fr = np.ones_like(fr)
            msg = f"{backend} {graph} {seed}"
            np.testing.assert_array_equal(
                np.asarray(jbe.min_dist(c.jops, jnp.asarray(dist),
                                        jnp.asarray(fr), jctx)),
                np_of(tbe.min_dist(c.tops, torch.as_tensor(dist),
                                   torch.as_tensor(fr), tctx)),
                err_msg=msg)
            np.testing.assert_array_equal(
                np.asarray(jbe.min_topk(c.jops, jnp.asarray(dists),
                                        jnp.asarray(src_mask), jctx)),
                np_of(tbe.min_topk(c.tops, torch.as_tensor(dists),
                                   torch.as_tensor(src_mask), tctx)),
                err_msg=msg)
            np.testing.assert_array_equal(
                np.asarray(jbe.push_sum(c.jops, jnp.asarray(counts), jctx)),
                np_of(tbe.push_sum(c.tops, torch.as_tensor(counts), tctx)),
                err_msg=msg)
            a = np.asarray(jbe.push_sum(c.jops, jnp.asarray(mass), jctx,
                                        normalize=True))
            b = np_of(tbe.push_sum(c.tops, torch.as_tensor(mass), tctx,
                                   normalize=True))
            # JAX's block_mxu sums floats as a tile product, in its own
            # order; every other flavor is JAX's scatter
            if c.hub or backend == "block_mxu":
                np.testing.assert_allclose(b, a, **TOL, err_msg=msg)
            else:
                np.testing.assert_array_equal(a, b, err_msg=msg)
    no_rev = text.GraphOperands(fwd=corpora["rand"].tops.fwd)
    with pytest.raises(ValueError, match="reverse ELL"):
        tbe.min_topk(no_rev, torch.zeros((32, K)),
                     torch.zeros(32, dtype=torch.bool), ExtendCtx(32))


# ---------------------------------------------------------------------------
# run_ife per kind
# ---------------------------------------------------------------------------

RUNS = (
    [("bellman_ford", b) for b in BACKENDS]
    + [("topk_paths", b) for b in ("ell_pull", "ell_push", "dopt_fused")]
    + [("ppr", b) for b in ("ell_push", "block_mxu", "dopt")]
    + [("pattern_counts", b) for b in ("ell_push", "block_mxu",
                                       "pull_binned_fused")]
)


def oracle_check(c, ec, state, iters):
    n = c.csr.n_nodes
    src = c.sources
    if ec == "bellman_ford":
        np.testing.assert_allclose(np_of(state.dist)[:n],
                                   sssp(c.csr, src), **TOL)
    elif ec == "topk_paths":
        np.testing.assert_array_equal(np_of(state.dists)[:n],
                                      topk_dists(c.csr, src, k=K))
    elif ec == "ppr":
        mass, residual, it = ppr_mass(c.csr, src)
        np.testing.assert_allclose(np_of(state.mass)[:n], mass, **TOL)
        np.testing.assert_allclose(np_of(state.residual)[:n], residual,
                                   **TOL)
        assert iters == it
    else:
        wedges, closed = pattern_counts(c.csr, src)
        np.testing.assert_array_equal(np_of(state.wedges)[:n], wedges)
        np.testing.assert_array_equal(np_of(state.closed)[:n], closed)
        assert iters == tec.PatternCounts.HOPS


@pytest.mark.parametrize("ec,backend", RUNS)
def test_run_ife_per_kind_matches_jax_and_oracle(corpora, ec, backend):
    """Every leaf and the iteration count equal JAX's ``run_ife`` on the
    same operands, and the oracle. PPR's float leaves are held at
    tolerance on the hub graph (see the module doc) and on ``block_mxu``,
    where JAX sums floats as a tile product in its own order; its
    iteration counts are equal everywhere."""
    for graph, c in corpora.items():
        j = c.jax_result(ec, jax_twin(backend))
        t = run_ife(c.tops, torch.as_tensor(c.sources), ec, 512,
                    spec(backend))
        assert int(t.iterations) == int(np.asarray(j.iterations)), graph
        order_differs = c.hub or backend == "block_mxu"
        assert_leaves(j.state, t.state,
                      exact=not (order_differs and ec == "ppr"),
                      msg=f"{ec} {backend} {graph}")
        oracle_check(c, ec, t.state, int(t.iterations))


def test_fused_and_block_runs_equal_push_bitwise(corpora):
    """The port against itself: ``bellman_ford`` on the fused kernel's
    backends and ``pattern_counts`` on ``block_mxu`` equal ``ell_push``
    leaf for leaf, also where JAX is only met at tolerance."""
    for c in corpora.values():
        src = torch.as_tensor(c.sources)
        for ec, backends in (("bellman_ford", ("pull_binned_fused",
                                               "dopt_fused")),
                             ("pattern_counts", ("block_mxu",)),
                             ("ppr", ("block_mxu", "dopt_fused"))):
            ref = run_ife(c.tops, src, ec, 512, "ell_push")
            for b in backends:
                got = run_ife(c.tops, src, ec, 512, spec(b))
                assert int(got.iterations) == int(ref.iterations)
                for x, y in zip(ref.state, got.state):
                    assert torch.equal(x, y), (ec, b)


def test_run_ife_scan_matches_jax(corpora):
    c = corpora["rand"]
    src = np.array([3, 17, 40], np.int32)
    for ec in ("sp_lengths", "ppr"):
        j = jcore.run_ife_scan(c.jops, jnp.asarray(src), ec, 512)
        t = tcore.run_ife_scan(c.tops, torch.as_tensor(src), ec, 512)
        np.testing.assert_array_equal(np.asarray(j.iterations),
                                      np_of(t.iterations))
        assert_leaves(j.state, t.state, msg=ec)


# ---------------------------------------------------------------------------
# the dispatcher, the lanes guard, the serving loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    return weighted_csr(96, 640, seed=1)


@pytest.mark.parametrize("kind", ["topk_paths", "ppr", "pattern_counts"])
def test_dispatcher_query_matches_jax(served, kind):
    """Hybrid on with ``phase1_iters`` pinned at 2: phase 1 stops every
    morsel, phase 2 resumes them as one gang (and serially with
    ``gang_resume=False``); leaves and per-morsel iterations equal JAX's
    and the serial resume's."""
    src = np.array([3, 17, 5, 9, 40, 41, 77], np.int32)
    outs = []
    for gang in (True, False):
        jd = JDispatcher(mesh11(), served, max_iters=512, phase1_iters=2,
                         gang_resume=gang)
        td = TDispatcher("cpu", to_port(served), max_iters=512,
                         phase1_iters=2, gang_resume=gang)
        a, b = jd.query(src, query_kind=kind), td.query(src, query_kind=kind)
        assert a.policy == b.policy == "ntks"
        assert a.redispatched == b.redispatched == len(src)
        assert (a.resumed_ganged, a.resumed_serial) == (
            b.resumed_ganged, b.resumed_serial)
        np.testing.assert_array_equal(np.asarray(a.result.iterations),
                                      np_of(b.result.iterations))
        assert_leaves(a.result.state, b.result.state, msg=kind)
        outs.append(b)
    assert outs[0].resumed_ganged == len(src)
    for x, y in zip(outs[0].result.state, outs[1].result.state):
        assert torch.equal(x, y)


def test_lanes_guard_never_lane_packs_a_non_lane_kind(served):
    """Mirror of ``test_lanes_ok_kinds_never_lane_packed``."""
    loop = TLoop("cpu", to_port(served), max_iters=64)
    for i in range(72):
        loop.submit([int(i % served.n_nodes)], query_kind="ppr")
    plan = loop.admission.plan(now=loop.clock())
    assert len(plan.batches) == 72
    assert not any(pb.packed for pb in plan.batches)
    assert all(pb.policy is None and pb.query_kind == "ppr"
               for pb in plan.batches)
    loop2 = TLoop("cpu", to_port(served), max_iters=64)
    for i in range(70):
        loop2.submit([int(i % served.n_nodes)])
    for i in range(3):
        loop2.submit([int(i)], query_kind="topk_paths")
    plan2 = loop2.admission.plan(now=loop2.clock())
    packed = [pb for pb in plan2.batches if pb.packed]
    unpacked = [pb for pb in plan2.batches if not pb.packed]
    assert len(packed) == 1 and packed[0].query_kind == "reach"
    assert len(unpacked) == 3
    assert all(pb.query_kind == "topk_paths" for pb in unpacked)
    d = TDispatcher("cpu", to_port(served), max_iters=64)
    many = np.arange(72, dtype=np.int32) % served.n_nodes
    out = d.query(many, query_kind="ppr")
    assert out.policy == "ntks"
    jout = JDispatcher(mesh11(), served, max_iters=64).query(
        many, query_kind="ppr")
    np.testing.assert_array_equal(np.asarray(jout.result.state.mass),
                                  np_of(out.result.state.mass))
    with pytest.raises(ValueError, match="no lane form"):
        d.query(many, query_kind="ppr", policy="ntkms")


def test_query_kind_validation(served):
    loop = TLoop("cpu", to_port(served), max_iters=32)
    with pytest.raises(ValueError, match="unknown query_kind"):
        loop.submit([1], query_kind="nope")
    assert loop.stats.tenants == {}
    d = TDispatcher("cpu", to_port(served), max_iters=32)
    with pytest.raises(ValueError, match="unknown query_kind"):
        d.query([1], query_kind="nope")
    with pytest.raises(ValueError, match="returns_paths"):
        d.query([1], query_kind="ppr", returns_paths=True)


def test_recommend_backend_routes_the_new_kinds():
    for ec, deg, n in (("bellman_ford", 8.0, 1000), ("topk_paths", 8.0, 1000),
                       ("ppr", 8.0, 1000), ("pattern_counts", 8.0, 1000),
                       ("pattern_counts", 200.0, 1000)):
        assert tcore.recommend_backend(ec, deg, n_nodes=n) == \
            jcore.recommend_backend(ec, deg, n_nodes=n), (ec, deg)
    assert tcore.recommend_backend("topk_paths", 8.0, n_nodes=1000) \
        == "ell_pull"


def test_serving_loop_mixed_kinds_matches_jax(served):
    """Reach and the three kinds in one manual-clock stream, replayed
    through both loops: every delivered result equal, and nothing
    lane-packed (mirror of
    ``test_new_kinds_through_unchanged_stack_both_layouts``, replicated
    layout)."""
    jc, tc = ManualClock(), ManualClock()
    jl = JLoop(mesh11(), served, max_iters=512, clock=jc)
    tl = TLoop("cpu", to_port(served), max_iters=512, clock=tc)
    subs = [([3, 17], "topk_paths"), ([5], "ppr"), ([7, 9], "pattern_counts"),
            ([0, 1], "reach"), ([11, 12, 13], "ppr")]
    for loop, clock in ((jl, jc), (tl, tc)):
        for i, (src, kind) in enumerate(subs):
            loop.submit(np.asarray(src, np.int32), qid=f"q{i}",
                        query_kind=kind)
            clock.advance(0.004)
            if i == 2:
                loop.pump()
        loop.drain()
    assert sorted(jl.results) == sorted(tl.results)
    for qid, jr in jl.results.items():
        tr = tl.results[qid]
        if isinstance(jr, dict):
            assert sorted(jr) == sorted(tr) == ["closed", "wedges"]
            for leaf in jr:
                np.testing.assert_array_equal(jr[leaf], tr[leaf])
        else:
            np.testing.assert_array_equal(jr, tr, err_msg=qid)
    assert tl.results["q0"].shape == (2, served.n_nodes, K)
    assert tl.stats.batches == jl.stats.batches
    assert not any(k.policy.lanes > 1 for k in tl.dispatcher.cache.keys())
    mass, _, _ = ppr_mass(served, [5])
    np.testing.assert_allclose(tl.results["q1"][0], mass, **TOL)


# ---------------------------------------------------------------------------
# serve.main
# ---------------------------------------------------------------------------


def jax_csr(kind, scale=0.1):
    csr = PAPER_DATASETS["ldbc"](scale)
    if kind == "topk_paths":  # JAX's serve weights it the same way
        rng = np.random.default_rng(7)
        csr = jcsr.CSRGraph(
            indptr=csr.indptr, indices=csr.indices,
            weights=rng.uniform(0.1, 2.0, csr.n_edges).astype(np.float32))
    return csr


def leaf_rows(kind, state, a, b, n):
    leaves = tec.QUERY_KINDS[kind].result_leaves
    return {leaf: np.asarray(np_of(getattr(state, leaf)))[a:b, :n]
            for leaf in leaves}


@pytest.mark.parametrize("kind", ["topk_paths", "ppr", "pattern_counts"])
def test_closed_loop_serve_per_kind_matches_jax(kind, capsys):
    records = []
    argv = ["--closed-loop", "--device", "cpu", "--dataset", "ldbc",
            "--scale", "0.1", "--batches", "2", "--sources-per-batch", "3",
            "--query-kind", kind]
    assert serve.main(argv, on_batch=records.append) == 0
    assert "served 2 batches" in capsys.readouterr().out
    csr = jax_csr(kind)
    jsvc = jserve.QueryService(mesh11(), csr,
                               family=PAPER_DATASET_FAMILIES["ldbc"])
    for r in records:
        res, pol = jsvc.query(r.sources, query_kind=kind)
        assert r.policy == pol == "ntks"
        np.testing.assert_array_equal(np.asarray(res.iterations),
                                      np_of(r.result.iterations))
        # the proxy has hubs past FOLD_WIDTH in-edges: PPR's float leaves
        # at tolerance (module doc), its iteration counts equal above
        assert_leaves(res.state, r.result.state, exact=kind != "ppr",
                      msg=kind)
    assert int(np.bincount(csr.indices).max()) > tec.FOLD_WIDTH


@pytest.mark.parametrize("kind,extra", [
    ("topk_paths", ["--mutate-stream", "1"]),
    ("ppr", []),
    ("pattern_counts", ["--no-overlap"]),
])
def test_open_loop_serve_per_kind_matches_jax(kind, extra, capsys):
    """The open loop (the default path): the same arrival schedule as
    JAX's ``serve``, deltas with their weights included, and every query's
    result equal to JAX's ``ServingLoop`` on that schedule."""
    from test_torch_service import assert_same_schedule
    import repro.graph.delta as jdelta

    argv = ["--device", "cpu", "--dataset", "ldbc", "--scale", "0.1",
            "--arrivals", "5", "--rate", "200", "--sources-per-batch", "2",
            "--query-kind", kind, *extra]
    got = []
    assert serve.main(argv, on_stream=got.append) == 0
    assert "open loop: 5 Poisson arrivals" in capsys.readouterr().out
    (rec,) = got
    assert rec.loop.stats.completed == 5
    csr = jax_csr(kind)
    jarr = jserve.poisson_arrivals(csr, 200.0, 5, 2, tenants=2, seed=1,
                                   query_kind=kind)
    if "--mutate-stream" in extra:
        d = jdelta.random_delta(csr, 64, 64, seed=500)
        assert d.add_weights is not None
        jarr.append({"t_ms": jarr[-1]["t_ms"] / 2, "delta": d})
        jarr.sort(key=lambda a: a["t_ms"])
        delta = next(a["delta"] for a in rec.arrivals if "delta" in a)
        np.testing.assert_array_equal(d.add_weights, delta.add_weights)
    assert_same_schedule(jarr, rec.arrivals)
    assert all(a.get("query_kind", kind) == kind for a in rec.arrivals)
    jl = JLoop(mesh11(), csr, family=PAPER_DATASET_FAMILIES["ldbc"])
    jres = jl.run_stream(jarr)
    assert sorted(jres) == sorted(rec.loop.results)
    for qid, jr in jres.items():
        tr = rec.loop.results[qid]
        if isinstance(jr, dict):
            for leaf in jr:
                np.testing.assert_array_equal(jr[leaf], tr[leaf])
        elif kind == "ppr":  # hubs past FOLD_WIDTH: tolerance (module doc)
            np.testing.assert_allclose(tr, jr, **TOL, err_msg=qid)
        else:
            np.testing.assert_array_equal(jr, tr, err_msg=qid)


# ---------------------------------------------------------------------------
# the small public functions
# ---------------------------------------------------------------------------


def test_block_extend_and_scan_economy_match_jax():
    from repro.core import msbfs as jmsbfs
    from repro_torch.core import msbfs as tmsbfs
    from repro_torch.graph import csr as tcsr

    csr = weighted_csr(200, 1400, seed=2)
    jadj = jcsr.blocks_from_csr(csr, block=128)
    tadj = tcsr.blocks_from_csr(to_port(csr), block=128)
    assert tadj.occupancy == jadj.occupancy
    rng = np.random.default_rng(0)
    n = tadj.n_row_blocks * 128
    lanes = (rng.random((n, 64)) < 0.05).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(jmsbfs.block_extend_lanes(jadj, jnp.asarray(lanes))),
        np_of(tmsbfs.block_extend_lanes(tadj, torch.as_tensor(lanes))))
    fr = lanes[:, 0] != 0
    np.testing.assert_array_equal(
        np.asarray(jmsbfs.block_extend_dense(jadj, jnp.asarray(fr))),
        np_of(tmsbfs.block_extend_dense(tadj, torch.as_tensor(fr))))
    assert tmsbfs.scans_saved_factor(tadj, 32) == \
        jmsbfs.scans_saved_factor(jadj, 32) == 32.0


def test_frontier_counters_and_graph_accessors_match_jax(corpora):
    from repro.core import frontier as jfr
    from repro_torch.core import frontier as tfr

    rng = np.random.default_rng(4)
    for x in (rng.random(50) < 0.3,
              (rng.random((40, 64)) < 0.1).astype(np.uint8)):
        assert int(tfr.frontier_size(torch.as_tensor(x))) == \
            int(jfr.frontier_size(jnp.asarray(x)))
        assert bool(tfr.any_active(torch.as_tensor(x))) == \
            bool(jfr.any_active(jnp.asarray(x)))
    assert not bool(tfr.any_active(torch.zeros(5, dtype=torch.bool)))
    c = corpora["hub"]
    np.testing.assert_array_equal(to_port(c.csr).edge_keys(),
                                  c.csr.edge_keys())
    np.testing.assert_array_equal(np.asarray(c.jops.rev.mask),
                                  np_of(c.tops.rev.mask))
    assert tcore.chunk_fold is tec.chunk_fold
    assert tcore.chunk_fold(10, 4, lambda s, w, a: a + [(s, w)], []) == \
        [(0, 4), (4, 4), (8, 2)]


def test_pack_tile_map_matches_jax(corpora):
    from repro.kernels.binned_pull.ops import pack_tile_map as jmap
    from repro_torch.kernels.binned_pull.ops import pack_tile_map as tmap

    for c in corpora.values():
        for a, b in zip(jmap(c.jops.rev_binned_pack),
                        tmap(c.tops.rev_binned_pack)):
            np.testing.assert_array_equal(a, b)


def test_settled_batch_finalized_flag(served):
    d = TDispatcher("cpu", to_port(served), max_iters=64, phase1_iters=1)
    inflight = d.begin_batch(np.array([3, 5], np.int32), query_kind="ppr")
    settled = d.settle_batch(inflight)
    assert not settled.finalized  # phase 2 ran: the stitch is deferred
    out = d.finalize_batch(settled)
    assert settled.finalized and out.result.state is not None
    assert d.finalize_batch(settled) is out
