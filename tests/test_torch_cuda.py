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
- ``block_spmm``: F in {64, 128, 256}, float32 and bfloat16, on ragged
  columns with two columns left empty, and tiles of 8, 32 and 256,
  within rtol = atol = 1e-5 (the kernel adds the float32 products in
  another order than the plain version's batched product; bfloat16
  products are exact in float32, so the same bound holds); run-to-run
  bitwise equal; and the kernel's choice
  to skip zero entries: inf/NaN features reach exactly the destinations
  with a stored nonzero from their row.
- ``flash_attention``: D in {16, 64, 128, 256}, causal and full, float32
  and bfloat16, plus a ragged S (block 8) and S = 1024, within rtol =
  atol = 2e-5 in float32 (summation order and the online softmax's
  rescaling) and rtol = 2^-7, atol = 1e-3 in bfloat16 (float32 outputs
  that close may round once to neighbouring bfloat16 values, 2^-7 of the
  value apart at most; the floor covers tiny outputs); each call launches
  the kernel exactly once.
"""
import dataclasses

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
from repro_torch.kernels.block_spmm.block_spmm import block_spmm
from repro_torch.kernels.block_spmm.ops import (
    spmm,
    spmm_blocks_from_csr,
    spmm_blocks_from_numpy,
)
from repro_torch.kernels.common import to_device
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)
from repro_torch.kernels.flash_attention.ops import mha
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
    # the plain versions' float32 products in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
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


def ragged_spmm_blocks(device, bsz=64, empty=(1, 4)):
    """Mean-normalized blocks of a weighted power-law graph (ragged
    columns), without zero pad blocks and without any block of the
    columns in ``empty``: the kernel meets columns that have no block."""
    csr = with_weights(powerlaw(700, 4.0, seed=5), seed=6)
    sb = spmm_blocks_from_csr(csr, block=bsz, normalize="mean",
                              device="cpu")
    cols = sb.block_cols.numpy()
    keep = (sb.blocks.flatten(1) != 0).any(dim=1).numpy()
    keep &= ~np.isin(cols, empty)
    assert cols[keep].max() == sb.g - 1
    return csr, spmm_blocks_from_numpy(sb.blocks.numpy()[keep],
                                       sb.block_rows.numpy()[keep],
                                       cols[keep], device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat", [64, 128, 256])
def test_block_spmm_kernel_matches_plain(feat, dtype, cuda_device):
    _, sb = ragged_spmm_blocks(cuda_device)
    sb = dataclasses.replace(sb, blocks=sb.blocks.to(dtype))
    bsz = int(sb.blocks.shape[1])
    rng = np.random.default_rng(feat)
    x = torch.from_numpy(rng.standard_normal((sb.g * bsz, feat))
                         .astype(np.float32)).to(cuda_device, dtype)
    before = block_spmm.launches
    got = spmm(sb, x)
    torch.cuda.synchronize()
    assert block_spmm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (sb.g * bsz, feat)
    exp = spmm(sb, x, use_ref=True)
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)
    for c in (1, 4):  # empty columns are written as zeros
        assert not got[c * bsz:(c + 1) * bsz].any()
    assert torch.equal(spmm(sb, x), got)  # no atomics: same bits


def test_block_spmm_kernel_rejects_mixed_dtypes(cuda_device):
    """The kernel is built for float32 or bfloat16 blocks and features
    alike; a mix raises before any launch."""
    _, sb = ragged_spmm_blocks(cuda_device)
    x = torch.zeros((sb.g * 64, 64), device=cuda_device,
                    dtype=torch.bfloat16)
    before = block_spmm.launches
    with pytest.raises(ValueError, match="one dtype"):
        spmm(sb, x)
    assert block_spmm.launches == before


@pytest.mark.parametrize("bsz", [8, 32, 256])
def test_block_spmm_kernel_block_sizes(bsz, cuda_device):
    """The smallest and largest tiles the kernel takes (one and 32 columns
    per warp), with the zero pad blocks of empty columns kept."""
    csr = with_weights(powerlaw(900, 4.0, seed=bsz), seed=2)
    sb = spmm_blocks_from_csr(csr, block=bsz, normalize="sym",
                              device=cuda_device)
    rng = np.random.default_rng(bsz)
    x = torch.from_numpy(rng.standard_normal((sb.g * bsz, 64))
                         .astype(np.float32)).to(cuda_device)
    got = spmm(sb, x)
    exp = spmm(sb, x, use_ref=True)
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


def test_block_spmm_kernel_skips_zero_entries(cuda_device):
    """A zero entry contributes nothing, even times inf or NaN: only the
    destinations with a stored nonzero from a non-finite row turn
    non-finite (the dense plain version would give NaN in every column
    of those row blocks); the rest equals the plain version on the
    features before the non-finite values went in."""
    csr, sb = ragged_spmm_blocks(cuda_device)
    n = sb.g * 64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    clean = x.copy()
    has_out = np.flatnonzero(csr.degrees)
    bad = [(int(np.argmax(csr.degrees)), 5, np.inf),
           (int(has_out[3]), 0, np.nan)]
    for u, f, val in bad:
        x[u, f] = val
    got = spmm(sb, torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    src, dst = csr.edge_list()
    stored = ~np.isin(dst // 64, (1, 4))  # the dropped columns
    expect_bad = np.zeros((n, 64), bool)
    for u, f, _ in bad:
        expect_bad[dst[(src == u) & stored], f] = True
    assert expect_bad[:, 0].any() and expect_bad[:, 5].any()
    np.testing.assert_array_equal(~np.isfinite(got), expect_bad)
    ref = spmm(sb, torch.from_numpy(clean).to(cuda_device),
               use_ref=True).cpu().numpy()
    np.testing.assert_allclose(got[~expect_bad], ref[~expect_bad],
                               rtol=1e-5, atol=1e-5)


ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-3)}


def attention_inputs(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_attention_kernel_matches_plain(d, causal, dtype,
                                              cuda_device):
    q, k, v = attention_inputs((2, 3, 256, d), dtype, cuda_device, seed=d)
    before = flash_attention.launches
    got = mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    exp = mha(q, k, v, causal=causal, use_ref=True)
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), exp.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape,block", [((1, 2, 200, 48), 8),
                                         ((1, 2, 1024, 64), 128)])
def test_flash_attention_kernel_ragged_and_long(shape, block, cuda_device):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(shape, dtype, cuda_device, seed=1)
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal, block_q=block,
                                  block_k=block)
            exp = mha(q, k, v, causal=causal, use_ref=True)
            rtol, atol = ATTN_TOL[dtype]
            torch.testing.assert_close(got.float(), exp.float(), rtol=rtol,
                                       atol=atol)
