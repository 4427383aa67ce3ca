"""Per-rank operand builds of the port against the JAX package.

On the LDBC proxy at a small scale and on the hub and star fixtures,
every leaf of the port's ``operand_stream(...).build_shard(k)`` must be
bitwise JAX's ``OperandStream.build_shard(k)``, for every shard ``k``:
the forward and reverse ELL rows (``ell_shard``), the degree-binned
slabs and their kernel pack (``binned_plan`` / ``binned_rev_shard``),
the block tiles (``sharded_blocks_nb`` / ``sharded_blocks_shard``), with
and without weights. A shard equals the matching slice of the port's
own whole-graph build too, and ``partition_bounds``, ``reverse_shard``
and ``slab_edges`` equal JAX's. All numpy builders, in process.
"""
import numpy as np
import pytest

from repro.core.extend import operand_stream as j_operand_stream
from repro.graph import csr as jcsr
from repro.graph import partition as jpart
from repro.graph.generators import PAPER_DATASETS

from repro_torch.core.extend import build_operands, operand_stream
from repro_torch.graph import csr as tcsr
from repro_torch.graph import partition as tpart

from test_torch_graph import fixture_csr, to_port, torch_leaves, with_weights

# (name, spec, row shards, policy shards, block)
SPECS = [
    ("dopt_fused", "dopt_fused", 4, 2, None),
    ("ell_pull", "ell_pull", 4, 4, None),
    ("pull_binned_fused", "pull_binned_fused", 2, 2, None),
    ("block_mxu", "block_mxu", 4, 2, 32),
]


def graphs():
    ldbc = PAPER_DATASETS["ldbc"](0.05)
    return {
        "ldbc": ldbc,
        "hub": fixture_csr("hub", 150, seed=3),
        "star": fixture_csr("star", 120),
        "ldbc_w": with_weights(ldbc, 5),
    }


GRAPHS = graphs()


def _stream(mod_stream, csr, spec, shards, k, block):
    from repro.core.extend import ExtendSpec as JSpec
    from repro_torch.core.extend import ExtendSpec as TSpec

    if block is not None:
        spec = (JSpec if mod_stream is j_operand_stream else TSpec)(
            backend="block_mxu", block=block)
    return mod_stream(csr, spec, shards=shards, binned_shards=k)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name,spec,shards,k,block", SPECS,
                         ids=[s[0] for s in SPECS])
def test_build_shard_matches_jax(graph, name, spec, shards, k, block):
    csr = GRAPHS[graph]
    js = _stream(j_operand_stream, csr, spec, shards, k, block)
    ts = _stream(operand_stream, to_port(csr), spec, shards, k, block)
    assert ts.n_pad == js.n_pad and ts.rows_local == js.rows_local
    for shard in range(k):
        jl, tl = js.build_shard(shard), ts.build_shard(shard)
        assert sorted(jl) == sorted(tl), (sorted(jl), sorted(tl))
        for key in jl:
            a, b = np.asarray(jl[key]), np.asarray(tl[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=f"{key}[{shard}]")


@pytest.mark.parametrize("graph", ["ldbc", "hub"])
def test_build_shard_is_a_slice_of_the_whole_build(graph):
    csr = to_port(GRAPHS[graph])
    whole, n_pad = build_operands(csr, "dopt_fused", shards=4,
                                  binned_shards=2)
    st = operand_stream(csr, "dopt_fused", shards=4, binned_shards=2)
    assert st.n_pad == n_pad
    rl = st.rows_local
    for k in range(2):
        leaves = st.build_shard(k)
        np.testing.assert_array_equal(
            leaves["fwd.indices"],
            whole.fwd.indices[k * rl : (k + 1) * rl].numpy())
        for b, s in enumerate(whole.rev_binned.slabs):
            np.testing.assert_array_equal(leaves[f"bn.slab{b}"],
                                          s[k : k + 1].numpy())
        for b, s in enumerate(whole.rev_binned_pack.slabs):
            np.testing.assert_array_equal(leaves[f"pack.slab{b}"],
                                          s[k : k + 1].numpy())
        np.testing.assert_array_equal(
            leaves["pack.inv_pad"], whole.rev_binned_pack.inv_pad[k : k + 1]
            .numpy())


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partition_helpers_match_jax(graph):
    csr = GRAPHS[graph]
    n_pad = jpart.padded_n(csr.n_nodes, 4, 32)
    np.testing.assert_array_equal(tpart.partition_bounds(n_pad, 4),
                                  jpart.partition_bounds(n_pad, 4))
    rows = n_pad // 4
    for k in range(4):
        a = jpart.reverse_shard(csr, k * rows, (k + 1) * rows)
        b = tpart.reverse_shard(to_port(csr), k * rows, (k + 1) * rows)
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        if a.weights is not None:
            np.testing.assert_array_equal(a.weights, b.weights)
    src, dst = csr.edge_list()
    n = n_pad
    for balance in ("nodes", "edges"):
        for x, y in zip(jpart.slab_edges(src, dst, n, 4, balance),
                        tpart.slab_edges(src, dst, n, 4, balance)):
            np.testing.assert_array_equal(x, y)


def test_per_shard_builders_match_jax_directly():
    csr = GRAPHS["hub"]
    rev_degs = np.bincount(csr.indices, minlength=csr.n_nodes)
    n_pad = 160
    jp = jcsr.binned_plan(rev_degs, n_pad, 2)
    tp = tcsr.binned_plan(rev_degs, n_pad, 2)
    assert jp.widths == tp.widths
    np.testing.assert_array_equal(jp.rows_b, tp.rows_b)
    for k in range(2):
        rev = jpart.reverse_shard(csr, k * 80, (k + 1) * 80)
        jb = jcsr.binned_rev_shard(jp, k, rev)
        tb = tcsr.binned_rev_shard(tp, k, to_port(rev))
        for a, b in zip([*jb.slabs, jb.perm, jb.inv], torch_leaves(tb)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(jcsr.ell_shard(csr, k * 80, (k + 1) * 80, 136, n_pad),
                        tcsr.ell_shard(to_port(csr), k * 80, (k + 1) * 80,
                                       136, n_pad)):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)
    nb = jcsr.sharded_blocks_nb(csr, n_pad, 5, 32)
    assert tcsr.sharded_blocks_nb(to_port(csr), n_pad, 5, 32) == nb
    js = jcsr.sharded_blocks_shard(csr, n_pad, 5, nb, 1, 3, 32)
    ts = tcsr.sharded_blocks_shard(to_port(csr), n_pad, 5, nb, 1, 3, 32)
    for a, b in zip((js.blocks, js.block_rows, js.block_cols),
                    torch_leaves(ts)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
