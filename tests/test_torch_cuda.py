"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case is marked ``cuda`` and skips (from a fixture) where
``torch.cuda.is_available()`` is False. This file imports only the port,
torch and numpy, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

- ``binned_pull``: all five ops, 64/3 lanes, visited none / partial / all,
  on ER, power-law, hub, star and edgeless fixtures; bitwise equal, and
  each call launches the kernel exactly once.
- ``msbfs_extend``: 64, 1 and 130 lanes (one, one and three packed words)
  at several densities with empty stripes, on the row-sorted
  ``ShardedBlocks`` (sentinel column) and the col-sorted
  ``KernelBlocks``; bitwise equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_operands
from repro_torch.graph.csr import csr_from_edges, truncate_csr
from repro_torch.graph.generators import erdos_renyi, powerlaw
from repro_torch.kernels.binned_pull.binned_pull import (
    LANE_OPS,
    OPS,
    fused_binned_pull,
)
from repro_torch.kernels.binned_pull.ops import binned_pull
from repro_torch.kernels.common import to_device
from repro_torch.kernels.msbfs_extend.msbfs_extend import msbfs_extend_blocks
from repro_torch.kernels.msbfs_extend.ops import (
    extend_blocks,
    kernel_blocks_from_csr,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card")
    return torch.device("cuda")


def fixture_csr(kind: str, n: int = 300, seed: int = 3):
    if kind == "er":
        return erdos_renyi(n, 5.0, seed=seed)
    if kind == "pl":
        return powerlaw(n, 4.0, seed=seed)
    if kind == "hub":  # every live node points at node 0, plus a ring
        live = n - n // 8
        v = np.arange(1, live)
        return csr_from_edges(n, np.concatenate([v, v]),
                              np.concatenate([np.zeros_like(v),
                                              1 + v % (live - 1)]))
    if kind == "star":  # node 0 fans out; 8 isolated nodes at the end
        d = np.arange(1, n - 8)
        return csr_from_edges(n, np.zeros_like(d), d)
    return truncate_csr(erdos_renyi(n, 3.0, seed=seed), 0)


def with_weights(csr, seed: int):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 2.0, csr.n_edges).astype(np.float32)
    return type(csr)(indptr=csr.indptr, indices=csr.indices, weights=w)


@pytest.mark.parametrize("kind", ["er", "pl", "hub", "star", "edgeless"])
def test_binned_pull_kernel_matches_plain(kind, cuda_device):
    csr = with_weights(fixture_csr(kind), seed=4)
    ops, n_pad = build_operands(csr, "pull_binned_fused")
    pack = to_device(ops.rev_binned_pack, cuda_device)
    rows = pack.rows_local
    rng = np.random.default_rng(7)
    for op in OPS:
        for lanes in ((64, 3) if op in LANE_OPS else (1,)):
            shape = (n_pad, lanes) if op in LANE_OPS else (n_pad,)
            vshape = (rows, lanes) if op in LANE_OPS else (rows,)
            if op == "min_dist":
                g = np.where(rng.random(n_pad) < 0.3,
                             rng.uniform(0, 9, n_pad), np.inf)
                g = g.astype(np.float32)
                vlocs = [None]
            else:
                g = (rng.random(shape) < 0.3).astype(np.uint8)
                vlocs = [None, (rng.random(vshape) < 0.4).astype(np.uint8),
                         np.ones(vshape, np.uint8)]
            gd = torch.from_numpy(g).to(cuda_device)
            for v in vlocs:
                vd = None if v is None else torch.from_numpy(v).to(
                    cuda_device)
                before = fused_binned_pull.launches
                got = binned_pull(pack, gd, vd, op=op)
                torch.cuda.synchronize()
                assert fused_binned_pull.launches == before + 1
                exp = binned_pull(pack, gd, vd, op=op, use_ref=True)
                assert torch.equal(got, exp), f"{kind}/{op}/{lanes}"


@pytest.mark.parametrize("lanes", [64, 1, 130])
def test_msbfs_extend_kernel_matches_plain(lanes, cuda_device):
    csr = fixture_csr("pl", n=1000, seed=8)
    ops, n_pad = build_operands(csr, "block_mxu")
    sb = to_device(ops.blocks, cuda_device)
    kb = to_device(kernel_blocks_from_csr(csr), cuda_device)
    b = sb.block_size
    g = n_pad // b
    rng = np.random.default_rng(lanes)
    for name, tiles in (
        ("sharded", (sb.blocks[0], sb.block_rows[0], sb.block_cols[0])),
        ("kernel", (kb.blocks, kb.block_rows, kb.block_cols)),
    ):
        for density in (0.0, 0.02, 0.3):
            f = (rng.random((g, b, lanes)) < density).astype(np.uint8)
            f[1] = 0  # an empty stripe
            fd = torch.from_numpy(f).to(cuda_device)
            before = msbfs_extend_blocks.launches
            got = extend_blocks(*tiles, fd, g_out=g)
            torch.cuda.synchronize()
            assert msbfs_extend_blocks.launches == before + 1
            exp = extend_blocks(*tiles, fd, g_out=g, use_ref=True)
            assert torch.equal(got, exp), f"{name}/{lanes}/{density}"


def skew_graph(n_main=160, paths=(40, 28, 22), seed=0):
    """A power-law main component plus long paths whose heads outlive a
    small phase-1 budget (port of the scheduler tests' fixture)."""
    main = powerlaw(n_main, 5.0, seed=seed)
    src_m, dst_m = main.edge_list()
    srcs, dsts, base, heads = [src_m], [dst_m], n_main, []
    for length in paths:
        p = np.arange(length - 1, dtype=np.int64) + base
        srcs += [p, p + 1]
        dsts += [p + 1, p]
        heads.append(base)
        base += length
    csr = csr_from_edges(base, np.concatenate(srcs), np.concatenate(dsts))
    return csr, heads


@pytest.mark.parametrize("gang", [True, False])
@pytest.mark.parametrize("backend,n_src", [("dopt_fused", 6),
                                           ("block_mxu", 70),
                                           ("dopt", 70)])
def test_hybrid_phase2_on_card_matches_cpu(backend, n_src, gang,
                                           cuda_device):
    """The two-phase hybrid with survivors resumed (gang or serial) gives
    the same outcome on the card as on the CPU."""
    from repro_torch.runtime.scheduler import AdaptiveScheduler

    csr, heads = skew_graph()
    rng = np.random.default_rng(1)
    src = np.concatenate([heads, rng.integers(0, 160, n_src - 3)])
    src = src.astype(np.int32)
    kw = dict(max_iters=64, phase1_iters=2, backend=backend,
              gang_resume=gang, online_adapt=True, refit_every=1)
    outs = [AdaptiveScheduler(dev, csr, **kw).query(src)
            for dev in ("cpu", cuda_device)]
    cpu, card = outs
    assert card.redispatched == cpu.redispatched > 0
    assert (card.resumed_ganged, card.resumed_serial, card.gang_width) == (
        cpu.resumed_ganged, cpu.resumed_serial, cpu.gang_width)
    assert torch.equal(card.result.iterations.cpu(),
                       cpu.result.iterations.cpu())
    for a, b in zip(card.result.state, cpu.result.state):
        assert torch.equal(a.cpu(), b)
