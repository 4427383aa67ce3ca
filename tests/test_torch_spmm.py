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
- The kernel's compacted view (``SpmmBlocks.nz``), from JAX's leaves
  carried across and from the port's own builder, equals a numpy listing
  of the tiles' nonzeros bitwise (ER, gapped, a star into one node,
  repeated edges; bfloat16 blocks; stored 0, -0 and NaN); its chunk list
  covers every nonzero once, in order, no chunk longer than the limit; a
  plain evaluation of the kernel's chunked two-pass sum equals the plain
  version and JAX's kernel (interpret mode) within 1e-5.
- The kernel itself is held against the plain version on the card by
  ``test_torch_cuda.py``.
"""
import dataclasses

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
    compact_blocks,
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
    # the launcher checks shapes before it looks at the device
    with pytest.raises(ValueError, match="n >= destinations"):
        block_spmm(sb.nz, torch.zeros((256, 64)))
    with pytest.raises(ValueError, match="F % min"):
        block_spmm(sb.nz, torch.zeros((384, 192)))
    with pytest.raises(ValueError, match="CUDA"):
        block_spmm(sb.nz, torch.zeros((384, 64)))
    blocks = np.zeros((2, 8, 8), np.float32)
    with pytest.raises(ValueError, match="sorted"):
        spmm_blocks_from_numpy(blocks, [0, 0], [1, 0], "cpu")
    with pytest.raises(ValueError, match="disagree"):
        spmm_blocks_from_numpy(blocks, [0], [0, 1], "cpu")
    # a list that leaves column 1 empty: g counts the largest id
    sb2 = spmm_blocks_from_numpy(blocks, [0, 2], [0, 2], "cpu")
    assert sb2.g == 3 and sb2.col_ptr.tolist() == [0, 1, 1, 2]


def star_into_one_csr(n=600, seed=16):
    """Every node points at node 0 (one destination with n - 1 sources),
    plus an ER sprinkle: node 0's nonzeros span many chunks."""
    rng = np.random.default_rng(seed)
    v = np.arange(1, n)
    src = np.concatenate([v, rng.integers(0, n, 900)])
    dst = np.concatenate([np.zeros_like(v), rng.integers(0, n, 900)])
    return jcsr.csr_from_edges(n, src, dst)


def repeated_edges_csr(n=200, seed=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 600)
    dst = rng.integers(0, n, 600)
    rep = rng.integers(0, 600, 150)
    src = np.concatenate([src, src[rep], src[rep[:40]]])
    dst = np.concatenate([dst, dst[rep], dst[rep[:40]]])
    w = rng.uniform(0.1, 2.0, len(src)).astype(np.float32)
    return jcsr.csr_from_edges(n, src, dst, weights=w, dedup=False)


VIEW_GRAPHS = {
    "er": lambda: with_weights(fixture_csr("er", n=300, seed=2), seed=3),
    "gapped": gapped_csr,
    "star": star_into_one_csr,
    "repeated": repeated_edges_csr,
}


def numpy_listing(blocks, rows, cols, g):
    """(nz_ptr, src, dst, val) of the tiles' nonzeros by destination, in
    (block, k) order within one: a loop over numpy's own nonzero."""
    blocks = np.asarray(blocks)
    bsz = blocks.shape[1]
    i, k, j = np.nonzero(blocks)  # row-major: (i, k, j) order
    src = rows[i].astype(np.int64) * bsz + k
    dst = cols[i].astype(np.int64) * bsz + j
    val = blocks[i, k, j]
    order = np.argsort(dst, kind="stable")
    ptr = np.searchsorted(dst[order], np.arange(g * bsz + 1), side="left")
    return ptr, src[order], dst[order], val[order]


def assert_view_matches_listing(sb, msg):
    nz = sb.nz
    rows = np_of(sb.block_rows)
    cols = np_of(sb.block_cols)
    blocks = sb.blocks.float().numpy()
    ptr, src, _, val = numpy_listing(blocks, rows, cols, sb.g)
    np.testing.assert_array_equal(np_of(nz.nz_ptr), ptr, err_msg=msg)
    assert nz.nz_ptr.dtype == torch.int64 and nz.nz_src.dtype == torch.int32
    np.testing.assert_array_equal(np_of(nz.nz_src), src, err_msg=msg)
    assert nz.nz_val.dtype == sb.blocks.dtype, msg
    got = nz.nz_val.float().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), val.view(np.uint32),
                                  err_msg=msg)


@pytest.mark.parametrize("source", ["jax_leaves", "port_builder"])
@pytest.mark.parametrize("graph", sorted(VIEW_GRAPHS))
def test_compacted_view_matches_numpy_listing(graph, source):
    csr = VIEW_GRAPHS[graph]()
    block = 128 if graph in ("er", "gapped") else 64
    if source == "jax_leaves":
        jsb = j_spmm_blocks_from_csr(csr, block=block, normalize="mean")
        sb = spmm_blocks_from_numpy(np.asarray(jsb.blocks),
                                    np.asarray(jsb.block_rows),
                                    np.asarray(jsb.block_cols), "cpu")
    else:
        sb = spmm_blocks_from_csr(to_port(csr), block=block,
                                  normalize="mean", device="cpu")
    assert int(sb.nz.nz_src.shape[0]) > 0
    assert_view_matches_listing(sb, f"{graph}/{source}")
    # bfloat16 blocks: the view keeps their weights exactly
    sb16 = dataclasses.replace(sb, blocks=sb.blocks.to(torch.bfloat16))
    assert_view_matches_listing(sb16, f"{graph}/{source}/bf16")


def test_compacted_view_skips_stored_zeros_keeps_nan():
    """A stored 0 or -0 is left out; a stored NaN is a nonzero."""
    blocks = np.zeros((3, 8, 8), np.float32)
    blocks[0, 1, 2] = 1.5
    blocks[0, 3, 2] = -0.0
    blocks[1, 0, 2] = np.nan
    blocks[1, 5, 7] = 0.0
    blocks[2, 6, 0] = -2.0
    sb = spmm_blocks_from_numpy(blocks, [0, 1, 0], [0, 0, 2], "cpu")
    nz = sb.nz
    assert nz.nz_src.tolist() == [1, 8, 6]  # (block, k) order into v 2
    assert nz.nz_ptr[3].item() == 2 and nz.n_dst == 24
    val = nz.nz_val.numpy()
    assert val[0] == 1.5 and np.isnan(val[1]) and val[2] == -2.0
    assert_view_matches_listing(sb, "hand-made")


@pytest.mark.parametrize("chunk", [1, 3, 16, 256])
@pytest.mark.parametrize("graph", ["star", "repeated"])
def test_chunk_list_covers_every_nonzero_in_order(graph, chunk):
    csr = VIEW_GRAPHS[graph]()
    sb = spmm_blocks_from_csr(to_port(csr), block=64, normalize="sym",
                              device="cpu")
    nz = compact_blocks(sb.blocks, sb.block_rows, sb.block_cols, sb.g,
                        chunk=chunk)
    assert nz.chunk == chunk
    ptr = np_of(nz.nz_ptr)
    items = np_of(nz.items).astype(np.int64)
    # launched longest first; stable, so equal lengths keep list order
    lens = items[:, 2] - items[:, 1]
    assert np.all(np.diff(lens) <= 0)
    items = items[np.lexsort((items[:, 1], items[:, 0]))]
    dst, lo, hi, slot = items.T
    # destination then chunk order, every destination at least once
    assert np.all(np.diff(dst) >= 0)
    np.testing.assert_array_equal(np.unique(dst), np.arange(nz.n_dst))
    # contiguous ranges inside each destination's nonzeros, none too long
    assert np.all(hi - lo <= chunk) and np.all(hi >= lo)
    np.testing.assert_array_equal(lo[1:], hi[:-1])
    assert lo[0] == 0 and hi[-1] == ptr[-1]
    np.testing.assert_array_equal(lo[np.r_[True, dst[1:] != dst[:-1]]],
                                  ptr[:-1])
    assert np.all((hi - lo > 0) | (ptr[dst] == ptr[dst + 1]))
    # a partial-sum slot exactly for the destinations with several chunks
    n_of = np.bincount(dst, minlength=nz.n_dst)
    split = n_of[dst] > 1
    np.testing.assert_array_equal(slot[~split], -1)
    np.testing.assert_array_equal(slot[split], np.arange(split.sum()))
    assert nz.n_slots == split.sum()
    spl = np_of(nz.splits).astype(np.int64)
    np.testing.assert_array_equal(spl[:, 0], np.flatnonzero(n_of > 1))
    np.testing.assert_array_equal(spl[:, 2] - spl[:, 1], n_of[n_of > 1])
    if graph == "star" and chunk < 256:  # node 0 spans many chunks
        assert n_of[0] == -(-(ptr[1] - ptr[0]) // chunk) > 1


def two_pass_sum(nz, x):
    """Plain evaluation of the kernel's work list: each item's float32 sum
    in nonzero order, into Y or its partial row, then the partial rows of
    each split destination added in chunk order."""
    n, feat = x.shape
    items = nz.items.long()
    by_start = torch.argsort(items[:, 1], stable=True)  # nonzero order
    owner = torch.repeat_interleave(
        by_start, (items[:, 2] - items[:, 1])[by_start])
    prod = nz.nz_val.float()[:, None] * x[nz.nz_src.long()].float()
    sums = torch.zeros((len(items), feat)).index_add_(0, owner, prod)
    y = torch.zeros((n, feat))
    direct = items[:, 3] < 0
    y[items[direct, 0]] = sums[direct]
    part = torch.zeros((nz.n_slots, feat))
    part[items[~direct, 3]] = sums[~direct]
    for v, lo, hi in nz.splits.tolist():
        acc = torch.zeros(feat)
        for p in range(lo, hi):
            acc = acc + part[p]
        y[v] = acc
    return y


@pytest.mark.parametrize("chunk", [4, 32, 256])
@pytest.mark.parametrize("graph", ["star", "gapped"])
def test_chunked_two_pass_sum_matches_plain_and_jax(graph, chunk):
    csr = VIEW_GRAPHS[graph]()
    block = 128
    n_pad = -(-csr.n_nodes // block) * block
    x = features(n_pad, 64, csr.n_nodes, seed=chunk)
    jsb = j_spmm_blocks_from_csr(csr, block=block, normalize="mean")
    j_kernel = np.asarray(j_spmm(jsb, jnp.asarray(x)))
    sb = spmm_blocks_from_csr(to_port(csr), block=block, normalize="mean",
                              device="cpu")
    nz = compact_blocks(sb.blocks, sb.block_rows, sb.block_cols, sb.g,
                        chunk=chunk)
    got = two_pass_sum(nz, torch.from_numpy(x))
    plain = spmm(sb, torch.from_numpy(x))
    torch.testing.assert_close(got, plain, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), j_kernel, rtol=TOL, atol=TOL)
    if graph == "star":
        assert nz.n_slots > 0
