"""The port's two kernels: plain versions against the JAX package, and the
CUDA kernels against their plain versions on the card.

- ``binned_pull``: the wrapper's CPU path (``fused_binned_pull_ref``) for
  all five ops, with and without visited suppression, bitwise against
  JAX's ``binned_pull(..., use_ref=True)`` on every fixture class (the JAX
  Pallas body does not trace on current jax and is never called here).
- ``msbfs_extend``: the CPU path for 64-lane and 1-lane frontiers against
  JAX's kernel (interpret mode) and its jnp reference, on the col-sorted
  ``KernelBlocks`` and on the row-sorted ``ShardedBlocks`` with its
  sentinel column, whose JAX counterpart is ``BlockBackend.reach_lanes``.
- The kernels themselves are held against these plain versions on the
  card by ``test_torch_cuda.py``.

Tolerance is exact everywhere: every output is a mask, an id or a float
min.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import build_operands as j_build_operands
from repro.core.extend import BlockBackend as JBlockBackend
from repro.core.extend import ExtendCtx as JExtendCtx
from repro.kernels.binned_pull.ops import binned_pull as j_binned_pull
from repro.kernels.msbfs_extend.ops import (
    kernel_blocks_from_csr as j_kernel_blocks_from_csr,
    msbfs_extend as j_msbfs_extend,
)

from repro_torch.core import build_operands as t_build_operands
from repro_torch.kernels.binned_pull.binned_pull import (
    LANE_OPS,
    OPS,
    fused_binned_pull,
)
from repro_torch.kernels.binned_pull.ops import binned_pull
from repro_torch.kernels.msbfs_extend.msbfs_extend import (
    pack_words,
    unpack_words,
)
from repro_torch.kernels.msbfs_extend.ops import (
    extend_blocks,
    kernel_blocks_from_csr,
    msbfs_extend,
)

from test_torch_graph import KINDS, fixture_csr, np_of, to_port, with_weights


def pull_inputs(op: str, n_pad: int, rows_local: int, seed: int,
                lanes: int = 4):
    """Mid-traversal inputs: a ~30% frontier and a ~40% visited set (or
    finite distances on ~30% of rows for min_dist), as numpy."""
    rng = np.random.default_rng(seed)
    if op == "min_dist":
        d = np.where(rng.random(n_pad) < 0.3, rng.uniform(0.0, 9.0, n_pad),
                     np.inf).astype(np.float32)
        return d, [None]
    shape = (n_pad, lanes) if op in LANE_OPS else (n_pad,)
    vshape = (rows_local, lanes) if op in LANE_OPS else (rows_local,)
    g = (rng.random(shape) < 0.3).astype(np.uint8)
    v = (rng.random(vshape) < 0.4).astype(np.uint8)
    return g, [None, v]


@pytest.mark.parametrize("kind", KINDS)
def test_binned_pull_plain_matches_jax_all_ops(kind):
    csr = with_weights(fixture_csr(kind, seed=3), seed=4)
    jops, n_pad = j_build_operands(csr, "pull_binned_fused")
    tops, _ = t_build_operands(to_port(csr), "pull_binned_fused")
    jpack, tpack = jops.rev_binned_pack, tops.rev_binned_pack
    before = fused_binned_pull.launches
    # one lane width per fixture keeps JAX's compiles down
    lane_width = 64 if kind in ("pl", "hub") else 3
    for op in OPS:
        for lanes in ((lane_width,) if op in LANE_OPS else (1,)):
            g, vs = pull_inputs(op, n_pad, tpack.rows_local, seed=11,
                                lanes=lanes)
            for v in vs:
                exp = j_binned_pull(
                    jpack, jnp.asarray(g),
                    None if v is None else jnp.asarray(v),
                    op=op, use_ref=True,
                )
                got = binned_pull(
                    tpack, torch.from_numpy(g),
                    None if v is None else torch.from_numpy(v), op=op,
                )
                exp = np.asarray(exp)
                assert np_of(got).dtype == exp.dtype, f"{kind}/{op}"
                np.testing.assert_array_equal(
                    np_of(got), exp, err_msg=f"{kind}/{op}/{lanes}")
    assert fused_binned_pull.launches == before


@pytest.mark.parametrize("lanes", [64, 1])
@pytest.mark.parametrize("kind", ["er", "pl", "hub"])
def test_msbfs_extend_plain_matches_jax(kind, lanes):
    csr = fixture_csr(kind, n=260, seed=5)
    block = 128
    n_pad = -(-csr.n_nodes // block) * block
    jkb = j_kernel_blocks_from_csr(csr, block=block)
    tkb = kernel_blocks_from_csr(to_port(csr), block=block)
    rng = np.random.default_rng(2)
    for density in (0.0, 0.02, 0.3):
        f = (rng.random((n_pad, lanes)) < density).astype(np.uint8)
        f[block : 2 * block] = 0  # an empty stripe
        exp_k = np.asarray(j_msbfs_extend(jkb, jnp.asarray(f)))
        exp_r = np.asarray(j_msbfs_extend(jkb, jnp.asarray(f), use_ref=True))
        got = np_of(msbfs_extend(tkb, torch.from_numpy(f)))
        np.testing.assert_array_equal(got, exp_k, err_msg=f"{density}")
        np.testing.assert_array_equal(got, exp_r, err_msg=f"{density}")


@pytest.mark.parametrize("lanes", [64, 1])
def test_msbfs_extend_sharded_blocks_match_jax_block_backend(lanes):
    csr = fixture_csr("pl", n=300, seed=8)
    jops, n_pad = j_build_operands(csr, "block_mxu")
    tops, _ = t_build_operands(to_port(csr), "block_mxu")
    rng = np.random.default_rng(4)
    f = (rng.random((n_pad, lanes)) < 0.05).astype(np.uint8)
    exp = np.asarray(JBlockBackend.reach_lanes(
        jops, jnp.asarray(f), None, JExtendCtx(n_out=n_pad)))
    sb = tops.blocks
    b = sb.block_size
    got = extend_blocks(
        sb.blocks[0], sb.block_rows[0], sb.block_cols[0],
        torch.from_numpy(f).reshape(n_pad // b, b, lanes),
        g_out=n_pad // b,
    )
    np.testing.assert_array_equal(np_of(got).reshape(n_pad, lanes), exp)


@pytest.mark.parametrize("lanes", [1, 63, 64, 130])
def test_lane_word_packing_round_trip(lanes):
    rng = np.random.default_rng(lanes)
    x = (rng.random((37, lanes)) < 0.5).astype(np.uint8)
    words = pack_words(torch.from_numpy(x))
    assert words.shape == (37, -(-lanes // 64)) and words.dtype == torch.int64
    np.testing.assert_array_equal(np_of(unpack_words(words, lanes)), x)
    # lane l is bit l % 64 of word l // 64
    if lanes >= 64:
        bit63 = x[:, 63].astype(bool)
        np.testing.assert_array_equal(np_of(words[:, 0] < 0), bit63)


def test_block_activity_matches_jax():
    """The stripe-activity bitmap the kernel's skip follows."""
    from repro.core.msbfs import active_block_count as j_count
    from repro.core.msbfs import frontier_block_activity as j_act
    from repro.graph.csr import blocks_from_csr as j_blocks
    from repro_torch.core.msbfs import active_block_count as t_count
    from repro_torch.core.msbfs import frontier_block_activity as t_act
    from repro_torch.graph.csr import blocks_from_csr as t_blocks

    csr = fixture_csr("pl", n=256, seed=2)
    ja, ta = j_blocks(csr, 64), t_blocks(to_port(csr), 64)
    rng = np.random.default_rng(6)
    for density in (0.0, 0.01, 0.2):
        f = (rng.random((256, 64)) < density).astype(np.uint8)
        f[64:128] = 0
        np.testing.assert_array_equal(
            np.asarray(j_act(ja, jnp.asarray(f))),
            np_of(t_act(ta, torch.from_numpy(f))))
        assert int(j_count(ja, jnp.asarray(f))) == int(
            t_count(ta, torch.from_numpy(f)))
