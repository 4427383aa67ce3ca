"""The port's block-sparse SpMM against the JAX package, on the CPU.

- ``spmm_blocks_from_csr``: leaves bitwise equal to JAX's (blocks as bit
  patterns, rows, cols, dtypes) on ER, power-law, hub, star and edgeless
  graphs, for normalize None / mean / sym, block 128 (unweighted) and 32
  (weighted), and on a CSR that repeats edges (``dedup=False``).
- ``spmm``'s plain path against JAX's ``spmm`` through its Pallas kernel
  (interpret mode) and through its jnp reference, F in {64, 128, 256}, on
  a graph whose edges leave column blocks empty, within rtol = atol =
  1e-5: the two packages add the float32 products in other orders.
- The chunked plain version gives the same bits as the one-shot one, and
  non-finite features give the same non-finite outputs as JAX's dense
  reference (0 * inf = NaN).
- The kernel itself is held against the plain version on the card by
  ``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.graph.csr as jcsr
from repro.kernels.block_spmm.ops import spmm as j_spmm
from repro.kernels.block_spmm.ops import (
    spmm_blocks_from_csr as j_spmm_blocks_from_csr,
)
from repro.kernels.block_spmm.ref import block_spmm_ref as j_block_spmm_ref

from repro_torch.kernels.block_spmm.block_spmm import block_spmm
from repro_torch.kernels.block_spmm.ops import (
    spmm,
    spmm_blocks_from_csr,
    spmm_blocks_from_numpy,
)
from repro_torch.kernels.block_spmm.ref import block_spmm_ref

from test_torch_graph import KINDS, fixture_csr, np_of, to_port, with_weights

NORMALIZE = [None, "mean", "sym"]
TOL = 1e-5


def assert_blocks_bitwise(jsb, tsb, msg=""):
    jb = np.asarray(jsb.blocks)
    tb = np_of(tsb.blocks)
    assert jb.dtype == tb.dtype == np.float32 and jb.shape == tb.shape, msg
    np.testing.assert_array_equal(jb.view(np.uint32), tb.view(np.uint32),
                                  err_msg=msg)
    for name in ("block_rows", "block_cols"):
        ja = np.asarray(getattr(jsb, name))
        ta = np_of(getattr(tsb, name))
        assert ja.dtype == ta.dtype == np.int32, (msg, name)
        np.testing.assert_array_equal(ja, ta, err_msg=f"{msg} {name}")
    cols = np_of(tsb.block_cols)
    expect = np.searchsorted(cols, np.arange(tsb.g + 1), side="left")
    np.testing.assert_array_equal(np_of(tsb.col_ptr), expect)


@pytest.mark.parametrize("block", [128, 32])
@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("kind", KINDS)
def test_spmm_blocks_bitwise_match_jax(kind, normalize, block):
    csr = fixture_csr(kind, n=300, seed=3)
    if block != 128:
        csr = with_weights(csr, seed=4)
    jsb = j_spmm_blocks_from_csr(csr, block=block, normalize=normalize)
    tsb = spmm_blocks_from_csr(to_port(csr), block=block,
                               normalize=normalize, device="cpu")
    assert tsb.g == -(-csr.n_nodes // block)
    assert_blocks_bitwise(jsb, tsb, f"{kind}/{normalize}/{block}")


@pytest.mark.parametrize("normalize", NORMALIZE)
def test_spmm_blocks_repeated_edges_match_jax(normalize):
    """A CSR built with ``dedup=False`` repeats entries (up to four times
    here); their float32 sums follow ``np.add.at``'s edge order."""
    rng = np.random.default_rng(5)
    n = 200
    src = rng.integers(0, n, 600)
    dst = rng.integers(0, n, 600)
    rep = rng.integers(0, 600, 150)
    src = np.concatenate([src, src[rep], src[rep[:40]], src[rep[:10]]])
    dst = np.concatenate([dst, dst[rep], dst[rep[:40]], dst[rep[:10]]])
    w = rng.uniform(0.1, 2.0, len(src)).astype(np.float32)
    csr = jcsr.csr_from_edges(n, src, dst, weights=w, dedup=False)
    assert csr.n_edges == len(src)
    jsb = j_spmm_blocks_from_csr(csr, block=64, normalize=normalize)
    tsb = spmm_blocks_from_csr(to_port(csr), block=64, normalize=normalize,
                               device="cpu")
    assert_blocks_bitwise(jsb, tsb, f"dup/{normalize}")


def gapped_csr(n=512, seed=6):
    """Edges into node blocks 0 and 2 of 4 only (block 128): column blocks
    1 and 3 hold no edge, so both builders pad them with zero blocks."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 1500)
    dst = rng.integers(0, 128, 1500) + 256 * rng.integers(0, 2, 1500)
    return jcsr.csr_from_edges(n, src, dst)


def features(n_rows, feat, n_live, seed):
    x = np.random.default_rng(seed).standard_normal((n_rows, feat))
    x = x.astype(np.float32)
    x[n_live:] = 0
    return x


@pytest.mark.parametrize("graph", ["er", "gapped"])
@pytest.mark.parametrize("feat", [64, 128, 256])
def test_spmm_plain_matches_jax_kernel_and_ref(feat, graph):
    csr = (with_weights(fixture_csr("er", n=300, seed=2), seed=3)
           if graph == "er" else gapped_csr())
    block = 128
    n_pad = -(-csr.n_nodes // block) * block
    x = features(n_pad, feat, csr.n_nodes, seed=feat)
    jsb = j_spmm_blocks_from_csr(csr, block=block, normalize="mean")
    j_kernel = np.asarray(j_spmm(jsb, jnp.asarray(x)))
    j_ref = np.asarray(j_spmm(jsb, jnp.asarray(x), use_ref=True))
    tsb = spmm_blocks_from_csr(to_port(csr), block=block, normalize="mean",
                               device="cpu")
    got = spmm(tsb, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n_pad, feat)
    np.testing.assert_allclose(got.numpy(), j_kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), j_ref, rtol=TOL, atol=TOL)
    # JAX's own leaves carried across give the same plain result
    carried = spmm_blocks_from_numpy(np.asarray(jsb.blocks),
                                     np.asarray(jsb.block_rows),
                                     np.asarray(jsb.block_cols), "cpu")
    assert torch.equal(spmm(carried, torch.from_numpy(x)), got)
    if graph == "gapped":
        assert not got[128:256].any() and not got[384:].any()


def test_spmm_plain_matches_segment_sum():
    """Independent of both packages: ``np.add.at`` over the edge list."""
    csr = with_weights(fixture_csr("pl", n=250, seed=7), seed=8)
    block = 64
    n_pad = -(-csr.n_nodes // block) * block
    x = features(n_pad, 96, csr.n_nodes, seed=9)
    sb = spmm_blocks_from_csr(to_port(csr), block=block, device="cpu")
    got = spmm(sb, torch.from_numpy(x)).numpy()[: csr.n_nodes]
    src, dst = csr.edge_list()
    expect = np.zeros((csr.n_nodes, x.shape[1]), np.float64)
    np.add.at(expect, dst, csr.weights[:, None].astype(np.float64) * x[src])
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("budget", [1, 3 * 4 * 64 * (2 * 40 + 64)])
def test_spmm_plain_chunked_equals_one_shot(budget):
    csr = with_weights(fixture_csr("pl", n=300, seed=10), seed=11)
    sb = spmm_blocks_from_csr(to_port(csr), block=64, normalize="sym",
                              device="cpu")
    g = sb.g
    x = torch.from_numpy(features(g * 64, 40, csr.n_nodes, seed=12))
    xb = x.view(g, 64, 40)
    assert int(sb.blocks.shape[0]) > 3
    one = block_spmm_ref(sb.blocks, sb.block_rows, sb.block_cols, xb,
                         budget=1 << 62)  # every block in one slice
    chunked = block_spmm_ref(sb.blocks, sb.block_rows, sb.block_cols, xb,
                             budget=budget)
    assert torch.equal(one, chunked)


def test_spmm_plain_nonfinite_features_match_jax_ref():
    """The plain version is dense like JAX's reference: a zero entry times
    inf or NaN is NaN, so the same outputs are non-finite."""
    csr = fixture_csr("er", n=300, seed=13)
    jsb = j_spmm_blocks_from_csr(csr, block=128)
    x = features(384, 64, csr.n_nodes, seed=14)
    x[5, 3] = np.inf
    x[200, 0] = np.nan
    j_out = np.asarray(j_block_spmm_ref(
        jsb.blocks, jsb.block_rows, jsb.block_cols,
        jnp.asarray(x).reshape(3, 128, 64))).reshape(384, 64)
    tsb = spmm_blocks_from_csr(to_port(csr), block=128, device="cpu")
    got = spmm(tsb, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(j_out))
    assert not np.isfinite(got).all()
    fin = np.isfinite(got)
    np.testing.assert_allclose(got[fin], j_out[fin], rtol=TOL, atol=TOL)


def test_spmm_checks_shapes_and_block_lists():
    csr = fixture_csr("er", n=300, seed=15)
    sb = spmm_blocks_from_csr(to_port(csr), block=128, device="cpu")
    with pytest.raises(ValueError, match="n % 128"):
        spmm(sb, torch.zeros((300, 64)))
    with pytest.raises(ValueError, match="F % min"):
        spmm(sb, torch.zeros((384, 192)))
    with pytest.raises(ValueError, match="row blocks"):
        spmm(sb, torch.zeros((256, 64)))
    with pytest.raises(ValueError, match="unknown normalize"):
        spmm_blocks_from_csr(to_port(csr), normalize="max", device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        block_spmm(torch.zeros((1, 12, 12)), torch.zeros(1, dtype=torch.int32),
                   torch.zeros(2, dtype=torch.int64), torch.zeros((1, 12, 8)))
    blocks = np.zeros((2, 8, 8), np.float32)
    with pytest.raises(ValueError, match="sorted"):
        spmm_blocks_from_numpy(blocks, [0, 0], [1, 0], "cpu")
    with pytest.raises(ValueError, match="disagree"):
        spmm_blocks_from_numpy(blocks, [0], [0, 1], "cpu")
    # a list that leaves column 1 empty: g counts the largest id
    sb2 = spmm_blocks_from_numpy(blocks, [0, 2], [0, 2], "cpu")
    assert sb2.g == 3 and sb2.col_ptr.tolist() == [0, 1, 1, 2]
