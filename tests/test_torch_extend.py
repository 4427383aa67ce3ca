"""IFE parity of the port's extension backends with the JAX package.

``run_ife`` for every backend of the slice (``ell_push``, ``ell_pull``,
``pull_binned``, ``pull_binned_fused``, ``block_mxu`` and the ``dopt*``
direction-switch aliases) times every reach-family edge compute: final
states and iteration counts must equal JAX's ``run_ife`` bitwise on the
same operands (the port's bundle is rebuilt from the JAX bundle's numpy
leaves). JAX's fused-kernel backends go through a Pallas body that does
not trace on current jax, so the port's ``pull_binned_fused`` /
``dopt_fused`` are held against JAX's ``pull_binned`` / ``dopt_binned``,
which are bit-identical by JAX's own contract. On the power-law fixture
every port backend meets its JAX twin; on the others, where only the
compile time would grow, each meets JAX's ``ell_push`` (all JAX backends
are bit-identical by that same contract).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import build_operands as j_build_operands
from repro.core.extend import ExtendSpec as JExtendSpec
from repro.core.extend import GraphOperands as JGraphOperands
from repro.core.ife import run_ife_jit as j_run_ife

from repro_torch.core import frontier_stats as t_frontier_stats
from repro_torch.core.extend import ExtendCtx, operands_from_numpy
from repro_torch.core.ife import (
    histogram_lengths,
    reconstruct_paths,
    run_ife,
    run_ife_batch,
    validate_parents,
)
from repro_torch.kernels.binned_pull.binned_pull import fused_binned_pull
from repro_torch.kernels.msbfs_extend.msbfs_extend import msbfs_extend_blocks

from test_torch_graph import (
    assert_tree_equal,
    fixture_csr,
    jax_operand_leaves,
    np_of,
)

BACKENDS = ["ell_push", "ell_pull", "pull_binned", "pull_binned_fused",
            "block_mxu", "dopt", "dopt_ell", "dopt_binned", "dopt_fused"]
#: the JAX backend each port backend is held against ("dopt" is JAX's
#: alias of "dopt_binned": one compile serves both)
JAX_TWIN = {"pull_binned_fused": "pull_binned", "dopt_fused": "dopt",
            "dopt_binned": "dopt"}
DENSE_ECS = ["bfs_levels", "sp_lengths", "sp_parents", "reachability"]
LANE_ECS = ["msbfs_lengths", "msbfs_parents"]


def full_jax_operands(csr, block=128):
    """One JAX bundle carrying every operand at a common pad."""
    pull, n1 = j_build_operands(csr, "dopt_ell", block=block)
    binned, n2 = j_build_operands(csr, "pull_binned_fused", block=block)
    blk, n3 = j_build_operands(
        csr, JExtendSpec(backend="block_mxu", block=block), block=block)
    assert n1 == n2 == n3
    return JGraphOperands(
        fwd=pull.fwd, rev=pull.rev, rev_binned=binned.rev_binned,
        rev_binned_pack=binned.rev_binned_pack, blocks=blk.blocks,
    ), n1


class Corpus:
    """JAX operands and lazily computed JAX ``run_ife`` results."""

    def __init__(self, kind, n, seed, twins):
        self.twins = twins  # False: every backend meets JAX's ell_push
        self.csr = fixture_csr(kind, n=n, seed=seed)
        self.jops, self.n_pad = full_jax_operands(self.csr)
        self.tops = operands_from_numpy(jax_operand_leaves(self.jops))
        rng = np.random.default_rng(seed)
        live = max(self.csr.n_nodes - 9, 1)
        self.dense_src = rng.integers(0, live, 2).astype(np.int32)
        lanes = np.full(64, self.n_pad, np.int32)  # pad lanes are inert
        lanes[:20] = rng.integers(0, live, 20)
        self.lane_src = lanes
        self._ref = {}

    def sources(self, ec):
        return self.lane_src if ec in LANE_ECS else self.dense_src

    def jax_result(self, ec, backend, max_iters=None):
        twin = JAX_TWIN.get(backend, backend) if self.twins else "ell_push"
        # bfs_levels is JAX's alias of sp_lengths: one compile serves both
        ec = "sp_lengths" if ec == "bfs_levels" else ec
        key = (ec, twin, max_iters)
        if key not in self._ref:
            self._ref[key] = j_run_ife(
                self.jops, jnp.asarray(self.sources(ec)), ec, max_iters,
                key[1],
            )
        return self._ref[key]


@pytest.fixture(scope="module")
def corpora():
    return {
        "pl": Corpus("pl", 150, 3, twins=True),
        "hub": Corpus("hub", 140, 1, twins=False),
        "star": Corpus("star", 100, 0, twins=False),
    }


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["pl", "hub", "star"])
def test_run_ife_states_and_iterations_match_jax(corpora, kind, backend):
    c = corpora[kind]
    launches = (fused_binned_pull.launches, msbfs_extend_blocks.launches)
    for ec in DENSE_ECS + LANE_ECS:
        exp = c.jax_result(ec, backend)
        got = run_ife(c.tops, torch.from_numpy(c.sources(ec)), ec,
                      extend=backend)
        msg = f"{kind}/{backend}/{ec}"
        assert int(got.iterations) == int(exp.iterations), msg
        assert_tree_equal(exp.state, got.state, msg)
    # CPU tensors: every kernel wrapper took its plain path
    assert (fused_binned_pull.launches,
            msbfs_extend_blocks.launches) == launches


@pytest.mark.parametrize("backend", ["ell_push", "dopt_fused", "block_mxu"])
def test_run_ife_iteration_cap_matches_jax(corpora, backend):
    c = corpora["hub"]
    for ec in ("sp_parents", "msbfs_lengths"):
        exp = c.jax_result(ec, backend, max_iters=2)
        got = run_ife(c.tops, torch.from_numpy(c.sources(ec)), ec,
                      max_iters=2, extend=backend)
        assert int(got.iterations) == int(exp.iterations) == 2
        assert_tree_equal(exp.state, got.state, f"{backend}/{ec}")


def test_output_helpers_match_jax(corpora):
    from repro.core.ife import histogram_lengths as j_hist
    from repro.core.ife import reconstruct_paths as j_paths
    from repro.core.ife import run_ife_batch as j_batch
    from repro.core.ife import validate_parents as j_valid

    c = corpora["pl"]
    exp = c.jax_result("sp_parents", "ell_push")
    got = run_ife(c.tops, torch.from_numpy(c.dense_src), "sp_parents")
    dests = np.array([0, 5, 77, 149, c.n_pad - 1, -3], np.int32)
    np.testing.assert_array_equal(
        np.asarray(j_paths(exp.state.parents, jnp.asarray(dests), 12)),
        np_of(reconstruct_paths(got.state.parents, torch.from_numpy(dests),
                                12)))
    np.testing.assert_array_equal(np.asarray(j_hist(exp.state.levels)),
                                  np_of(histogram_lengths(got.state.levels)))
    assert bool(j_valid(exp.state.levels, exp.state.parents,
                        jnp.asarray(c.dense_src)))
    assert bool(validate_parents(got.state.levels, got.state.parents,
                                 torch.from_numpy(c.dense_src)))
    lane = c.jax_result("msbfs_lengths", "ell_push")
    np.testing.assert_array_equal(
        np.asarray(j_hist(lane.state.levels)),
        np_of(histogram_lengths(run_ife(
            c.tops, torch.from_numpy(c.lane_src), "msbfs_lengths"
        ).state.levels)))
    batch = c.dense_src[:2]
    jb = j_batch(c.jops, jnp.asarray(batch), "sp_lengths", None, "dopt")
    tb = run_ife_batch(c.tops, torch.from_numpy(batch), "sp_lengths",
                       extend="dopt")
    assert_tree_equal(jb, tb, "run_ife_batch")


def test_frontier_stats_match_jax(corpora):
    from repro.core.dispatcher import _stats_bin_widths as j_widths
    from repro.core.extend import ExtendCtx as JExtendCtx
    from repro.core.extend import frontier_stats as j_stats
    from repro_torch.core.extend import stats_bin_widths as t_widths

    c = corpora["pl"]
    ctx_j, ctx_t = JExtendCtx(n_out=c.n_pad), ExtendCtx(n_out=c.n_pad)
    for ec in ("sp_lengths", "msbfs_parents"):
        for it in (1, 2):
            js = c.jax_result(ec, "ell_push", max_iters=it).state
            ts = run_ife(c.tops, torch.from_numpy(c.sources(ec)), ec,
                         max_iters=it).state
            for bw in (False, True):
                exp = j_stats(c.jops, js, ctx_j,
                              bin_widths=j_widths(c.jops) if bw else None)
                got = t_frontier_stats(
                    c.tops, ts, ctx_t,
                    bin_widths=t_widths(c.tops) if bw else None)
                np.testing.assert_array_equal(np.asarray(exp), np_of(got),
                                              err_msg=f"{ec}/{it}/{bw}")
