"""Parity of the PyTorch port's host builders with the JAX package's.

Every builder of ``repro_torch.graph`` (and the kernel packs of
``repro_torch.kernels``) is held bitwise against its ``repro``
counterpart, leaf by leaf, dtype included, on ER, power-law, heavy-tail
hub, star and edgeless fixtures; ``operands_from_numpy`` must rebuild the
port's own bundle from the JAX bundle's leaves. The helpers at the top are
shared by the other ``test_torch_*`` files.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.graph.csr as jcsr
import repro.graph.generators as jgen
import repro.graph.partition as jpart
from repro.core import build_operands as j_build_operands
from repro.core import frontier as jfrontier
from repro.core.extend import ExtendSpec as JExtendSpec
from repro.kernels.binned_pull.ops import build_pack as j_build_pack
from repro.kernels.msbfs_extend.ops import (
    prepare_kernel_blocks as j_prepare_kernel_blocks,
)

import repro_torch.graph.csr as tcsr
import repro_torch.graph.generators as tgen
import repro_torch.graph.partition as tpart
from repro_torch.core import build_operands as t_build_operands
from repro_torch.core import frontier as tfrontier
from repro_torch.core.extend import ExtendSpec as TExtendSpec
from repro_torch.core.extend import operands_from_numpy
from repro_torch.kernels.binned_pull.ops import build_pack as t_build_pack
from repro_torch.kernels.msbfs_extend.ops import (
    prepare_kernel_blocks as t_prepare_kernel_blocks,
)

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

KINDS = ["er", "pl", "hub", "star", "edgeless"]

# The fixtures are a few hundred nodes: one intra-op thread per test worker
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def heavy_tail_csr(n: int, seed: int = 0) -> jcsr.CSRGraph:
    """A hub with in-degree ~n, a ring so BFS takes several hops, the hub
    fanning out to a few nodes, and a fully isolated tail."""
    rng = np.random.default_rng(seed)
    live = n - max(n // 8, 1)
    srcs, dsts = [], []
    for v in range(1, live):
        srcs += [v, v]
        dsts += [0, 1 + (v % (live - 1))]
    for d in rng.choice(np.arange(1, live), size=min(4, live - 1),
                        replace=False):
        srcs.append(0)
        dsts.append(int(d))
    return jcsr.csr_from_edges(n, np.asarray(srcs), np.asarray(dsts))


def fixture_csr(kind: str, n: int = 96, seed: int = 0) -> jcsr.CSRGraph:
    """The JAX package's CSR of one fixture class (numpy only)."""
    if kind == "er":
        return jgen.erdos_renyi(n, 5.0, seed=seed)
    if kind == "pl":
        return jgen.powerlaw(n, 4.0, seed=seed)
    if kind == "hub":
        return heavy_tail_csr(n, seed=seed)
    if kind == "star":
        dsts = np.arange(1, n - 8)
        return jcsr.csr_from_edges(n, np.zeros_like(dsts), dsts)
    assert kind == "edgeless", kind
    return jcsr.truncate_csr(jgen.erdos_renyi(n, 3.0, seed=seed), 0)


def with_weights(csr, seed: int):
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        csr, weights=rng.uniform(0.1, 2.0, csr.n_edges).astype(np.float32)
    )


def to_port(csr) -> tcsr.CSRGraph:
    return tcsr.CSRGraph(indptr=csr.indptr, indices=csr.indices,
                         weights=csr.weights)


def torch_leaves(obj) -> list:
    """Tensor leaves of a port tree in pytree order (dataclass fields and
    NamedTuple/tuple entries in order; None dropped)."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, np.ndarray):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in torch_leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in torch_leaves(v)]
    raise TypeError(f"unexpected leaf {type(obj)}")


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_equal(jax_obj, port_obj, msg=""):
    """Bitwise leaf-by-leaf equality, dtypes and shapes included."""
    ja = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_obj)]
    tb = [np_of(x) for x in torch_leaves(port_obj)]
    assert len(ja) == len(tb), f"{msg}: {len(ja)} vs {len(tb)} leaves"
    for i, (x, y) in enumerate(zip(ja, tb)):
        assert x.dtype == y.dtype, f"{msg} leaf {i}: {x.dtype} vs {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} leaf {i}")


def jax_operand_leaves(ops) -> dict:
    """The numpy leaves of a JAX ``GraphOperands``, under the names
    ``repro_torch.core.extend.operands_from_numpy`` reads."""
    out = {}

    def ell(prefix, g):
        if g is None:
            return
        out[f"{prefix}.indices"] = np.asarray(g.indices)
        out[f"{prefix}.degrees"] = np.asarray(g.degrees)
        if g.weights is not None:
            out[f"{prefix}.weights"] = np.asarray(g.weights)

    ell("fwd", ops.fwd)
    ell("rev", ops.rev)
    bn = ops.rev_binned
    if bn is not None:
        out["bn.perm"] = np.asarray(bn.perm)
        out["bn.inv"] = np.asarray(bn.inv)
        for b, s in enumerate(bn.slabs):
            out[f"bn.slab{b}"] = np.asarray(s)
        for b, w in enumerate(bn.slab_weights or ()):
            out[f"bn.w{b}"] = np.asarray(w)
    pk = ops.rev_binned_pack
    if pk is not None:
        out["pack.inv_pad"] = np.asarray(pk.inv_pad)
        out["pack.perm_pad"] = np.asarray(pk.perm_pad)
        for b, s in enumerate(pk.slabs):
            out[f"pack.slab{b}"] = np.asarray(s)
        for b, w in enumerate(pk.slab_weights or ()):
            out[f"pack.w{b}"] = np.asarray(w)
    if ops.blocks is not None:
        out["blocks.blocks"] = np.asarray(ops.blocks.blocks)
        out["blocks.rows"] = np.asarray(ops.blocks.block_rows)
        out["blocks.cols"] = np.asarray(ops.blocks.block_cols)
    return out


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def test_csr_from_edges_keep_first_dedup_and_int32_guard():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 40, 300)
    dst = rng.integers(0, 40, 300)
    w = rng.uniform(0, 1, 300).astype(np.float32)
    for dedup in (True, False):
        a = jcsr.csr_from_edges(40, src, dst, w, dedup=dedup)
        b = tcsr.csr_from_edges(40, src, dst, w, dedup=dedup)
        for f in ("indptr", "indices", "weights"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="int32"):
        tcsr.csr_from_edges(2**31, src, dst)


@pytest.mark.parametrize("kind", KINDS)
def test_csr_ell_truncate_reverse(kind):
    csr = with_weights(fixture_csr(kind, seed=1), seed=2)
    pc = to_port(csr)
    r1, r2 = csr.reverse(), pc.reverse()
    for f in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
    for cap in (None, 0, 3, 8):
        t1, t2 = jcsr.truncate_csr(csr, cap), tcsr.truncate_csr(pc, cap)
        for f in ("indptr", "indices", "weights"):
            np.testing.assert_array_equal(getattr(t1, f), getattr(t2, f))
        assert_tree_equal(jcsr.ell_from_csr(csr, cap),
                          tcsr.ell_from_csr(pc, cap), f"ell {kind}/{cap}")
    for shards, block in ((1, 8), (2, 32), (4, 128)):
        assert jpart.padded_n(csr.n_nodes, shards, block) == tpart.padded_n(
            csr.n_nodes, shards, block)
        assert_tree_equal(
            jpart.pad_ell(jcsr.ell_from_csr(csr), shards, block),
            tpart.pad_ell(tcsr.ell_from_csr(pc), shards, block),
            f"pad_ell {kind}/{shards}/{block}",
        )


@pytest.mark.parametrize("kind", KINDS)
def test_binned_pack_and_block_builders(kind):
    csr = with_weights(fixture_csr(kind, seed=3), seed=4)
    pc = to_port(csr)
    n_pad = -(-csr.n_nodes // 128) * 128
    for shards in (1, 2):
        jb = jcsr.binned_rev_csr(csr, n_pad, shards)
        tb = tcsr.binned_rev_csr(pc, n_pad, shards)
        assert_tree_equal(jb, tb, f"binned {kind}/{shards}")
        assert jb.capacity_slots == tb.capacity_slots
        np.testing.assert_array_equal(jb.row_widths(), tb.row_widths())
        assert_tree_equal(j_build_pack(jb, n_pad), t_build_pack(tb, n_pad),
                          f"pack {kind}/{shards}")
        assert_tree_equal(
            jcsr.sharded_blocks_from_csr(csr, n_pad, shards, 64),
            tcsr.sharded_blocks_from_csr(pc, n_pad, shards, 64),
            f"sharded blocks {kind}/{shards}",
        )
    ja, ta = jcsr.blocks_from_csr(csr, 32), tcsr.blocks_from_csr(pc, 32)
    assert_tree_equal(ja, ta, f"blocks {kind}")
    assert_tree_equal(j_prepare_kernel_blocks(ja),
                      t_prepare_kernel_blocks(ta), f"kernel blocks {kind}")


def test_generators_and_sources():
    cases = [
        ("erdos_renyi", (120, 4.0), {"seed": 5}),
        ("rmat", (7, 6), {"seed": 2}),
        ("powerlaw", (150, 6.0), {"alpha": 1.9, "seed": 3}),
    ]
    for name, args, kw in cases:
        a = getattr(jgen, name)(*args, **kw)
        b = getattr(tgen, name)(*args, **kw)
        np.testing.assert_array_equal(a.indptr, b.indptr, err_msg=name)
        np.testing.assert_array_equal(a.indices, b.indices, err_msg=name)
    assert sorted(jgen.PAPER_DATASETS) == sorted(tgen.PAPER_DATASETS)
    assert jgen.PAPER_DATASET_FAMILIES == tgen.PAPER_DATASET_FAMILIES
    for name in sorted(jgen.PAPER_DATASETS):
        arg = 8 if name == "graph500" else 0.02
        a = jgen.PAPER_DATASETS[name](arg)
        b = tgen.PAPER_DATASETS[name](arg)
        np.testing.assert_array_equal(a.indptr, b.indptr, err_msg=name)
        np.testing.assert_array_equal(a.indices, b.indices, err_msg=name)
        for k, seed in ((3, 0), (12, 7)):
            np.testing.assert_array_equal(
                jgen.pick_sources(a, k, seed=seed),
                tgen.pick_sources(b, k, seed=seed), err_msg=name)


def test_bfs_depth_probe_matches_jax():
    """``pick_sources``' depth probe, which stops its last level at the
    first unseen neighbour, answers as JAX's full expansion does: sparse
    graphs where probes fail, and a dense block whose last level is read
    in several slices before (or without) finding an unseen node."""
    block = np.arange(1, 301)
    src = np.concatenate([np.zeros(300, np.int64), np.repeat(block, 300)])
    dst = np.concatenate([block, np.tile(block, 300)])
    graphs = [
        jgen.erdos_renyi(200, 1.3, seed=4),
        jcsr.csr_from_edges(302, src, dst),  # the block never leaves itself
        jcsr.csr_from_edges(302, np.append(src, 300), np.append(dst, 301)),
    ]
    for i, g in enumerate(graphs):
        pg = to_port(g)
        for depth in (1, 2, 3, 5):
            for v in range(0, g.n_nodes, 3):
                assert jgen._bfs_depth_at_least(g, v, depth) == (
                    tgen._bfs_depth_at_least(pg, v, depth)), (i, depth, v)
    assert not tgen._bfs_depth_at_least(to_port(graphs[1]), 0, 2)
    assert tgen._bfs_depth_at_least(to_port(graphs[2]), 0, 2)


def test_frontier_lane_layout():
    rng = np.random.default_rng(9)
    src = np.array([3, 0, 77, 5, 200, -1], np.int32)
    assert_tree_equal(jfrontier.dense_from_sources(100, jnp.asarray(src)),
                      tfrontier.dense_from_sources(100, torch.from_numpy(src)))
    assert_tree_equal(jfrontier.lanes_from_sources(100, jnp.asarray(src)),
                      tfrontier.lanes_from_sources(100, torch.from_numpy(src)))
    lanes = (rng.random((50, 64)) < 0.3).astype(np.uint8)
    jp = jfrontier.pack_lanes(jnp.asarray(lanes))
    tp = tfrontier.pack_lanes(torch.from_numpy(lanes))
    np.testing.assert_array_equal(np.asarray(jp).astype(np.int64),
                                  np_of(tp).astype(np.int64))
    assert_tree_equal(jfrontier.unpack_lanes(jp),
                      tfrontier.unpack_lanes(tp))


SPECS = ["ell_push", "dopt_ell", "pull_binned", "pull_binned_fused",
         "dopt_fused", "block_mxu"]


@pytest.mark.parametrize("kind", ["pl", "hub", "edgeless"])
def test_build_operands_and_operands_from_numpy(kind):
    """Every operand bundle bitwise equal to JAX's, and the JAX bundle's
    numpy leaves rebuild the port's bundle exactly."""
    csr = with_weights(fixture_csr(kind, n=150, seed=6), seed=7)
    for spec in SPECS:
        jops, jn = j_build_operands(csr, spec, max_deg=None)
        tops, tn = t_build_operands(to_port(csr), spec, max_deg=None)
        assert jn == tn
        assert_tree_equal(jops, tops, f"{kind}/{spec}")
        back = operands_from_numpy(jax_operand_leaves(jops))
        assert_tree_equal(jops, back, f"round trip {kind}/{spec}")
    jops, _ = j_build_operands(csr, "dopt", max_deg=5)
    tops, _ = t_build_operands(to_port(csr), "dopt", max_deg=5)
    assert_tree_equal(jops, tops, f"{kind}/max_deg")
    jspec = JExtendSpec(backend="block_mxu", block=32)
    tspec = TExtendSpec(backend="block_mxu", block=32)
    assert jspec.pad_block == tspec.pad_block
    assert_tree_equal(j_build_operands(csr, jspec)[0],
                      t_build_operands(to_port(csr), tspec)[0], "block 32")
