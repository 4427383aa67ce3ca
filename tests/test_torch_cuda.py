"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case is marked ``cuda`` and skips (from a fixture) where
``torch.cuda.is_available()`` is False. This file imports only the port,
torch and numpy, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

- ``binned_pull``: all five ops, 1/3/64/130 lanes, visited none /
  partial / all, on ER, power-law, hub, star and edgeless fixtures and on
  a star into one node whose row spans at least three hub chunks;
  bitwise equal to the plain version and across two launches, and each
  call launches the kernel exactly once; a call replayed from a CUDA
  graph gives the eager call's bits.
- ``msbfs_extend``: 64, 1 and 130 lanes (one, one and three packed words)
  at several densities with empty stripes, on the row-sorted
  ``ShardedBlocks`` (sentinel column) and the col-sorted
  ``KernelBlocks``; bitwise equal.
- ``block_spmm``: F in {16, 32, 64, 96, 128, 256} (the strided and the
  4-features-a-lane instances), float32 and bfloat16, on ragged
  columns with two columns left empty, and tiles of 8, 32 and 256,
  within rtol = atol = 1e-5 (the kernel adds the float32 products in
  another order than the plain version's batched product; bfloat16
  products are exact in float32, so the same bound holds); run-to-run
  bitwise equal; a star into one node and a hub, whose one destination
  spans many chunks of 32 or 256 (the two-pass sum, through views built
  with ``compact_blocks``), within 1e-5 and bitwise equal
  across two launches; and the kernel's choice
  to skip zero entries: inf/NaN features reach exactly the destinations
  with a stored nonzero from their row.
- ``flash_attention``: D in {16, 64, 128, 256}, causal and full, float32
  and bfloat16, plus a ragged S (block 8) and S = 1024, within rtol =
  atol = 2e-5 in float32 (summation order and the online softmax's
  rescaling) and rtol = 2^-7, atol = 1e-3 in bfloat16 (float32 outputs
  that close may round once to neighbouring bfloat16 values, 2^-7 of the
  value apart at most; the floor covers tiny outputs); each call launches
  the kernel exactly once; bfloat16 at D 36 (zero-padded to 40 for TMA's
  16-byte strides), D 48 and MiniCPM-2B's head width (36 heads of 64) runs the tensor-core instance (route ``wgmma``)
  and float32 the FMA one (route ``f32_fma``), by their launch counts.
- Kernels on operands a graph delta folded (``QueryDispatcher.apply_delta``
  on the card): ``binned_pull`` on a pack whose rows moved between
  buckets (a rewritten ``perm_pad``, a rebuilt launch record), all five
  ops, bitwise; ``msbfs_extend`` on ``ShardedBlocks`` where one tile's
  slot was freed and claimed by another, bitwise; and a short
  ``ServingLoop`` stream with one delta, per query equal to the same
  stream on the CPU.
- The phase-1 worker on the card: its morsel loops run on the worker's
  own stream, not the caller's, and its future carries an event of that
  stream; the open loop's order over the split-phase API with a delta
  between a batch's begin and settle (``test_torch_ranks.pipelined_run``),
  overlapped and serial, equals the CPU bitwise.
- Shard-local operands (the multi-rank layout): ``binned_pull`` on one
  rank's pack (``rows_local < n_out``, a nonzero row base), all five
  ops, and ``msbfs_extend`` on one rank's tiles (``g_out`` above the
  shard's row blocks), bitwise equal to their plain versions; two ranks
  sharing the card over gloo run ``run_recursive_query`` through both
  kernels, stage their messages through host memory, and equal the
  one-device CPU run.
- The weighted relax and the non-reach kinds: ``bellman_ford`` served
  through ``run_recursive_query`` on ``pull_binned_fused`` and
  ``dopt_fused`` launches ``binned_pull``'s ``min_dist`` op and equals
  the CPU run (the op's plain version) and the card's ``ell_push``
  bitwise; ``topk_paths``, ``ppr`` and ``pattern_counts`` through
  ``QueryDispatcher.query`` on the card equal the CPU's bits (the port's
  float sums are elementwise adds in a fixed order on both), and a PPR
  batch run twice gives the same bits.
- The LM serving path: a MiniCPM-smoke-shaped model at S 256 on the card,
  prefill and teacher-forced decode with attention on the kernel route
  (``mha``, one launch a layer, no scan call) against the same model on
  the forced scan route: in float32 within 1e-4 of the largest logit and
  cache magnitude, in bfloat16 a cosine of at least 0.999 per row; and a
  GQA layer (8 query heads on 2 kv heads, ``repeat_interleave`` to 8)
  through ``mha`` against the scan route.
- The LM training path: two MiniCPM-smoke train steps
  (``launch.train.build``'s step: forward on the scan route, backward,
  AdamW) on the card against the same steps on the CPU from the same
  weights, in float32 with TF32 off: losses and gradient norms within
  rtol 1e-5, parameters within 0.1 lr everywhere and 1e-6 for 99.9% of
  them (the products add in other orders; an AdamW step turns a rounding
  difference of a near-zero gradient into up to a tenth of lr); the
  kernel route under autograd on the card raises, forced or chosen by
  default, while ``prefill`` under ``no_grad`` still launches ``mha``;
  a train state of CUDA tensors (bfloat16 parameters, float32 moments)
  through ``CheckpointManager``: saved, overwritten, restored in place on
  the card, bitwise.
- The GNN family: two train steps of ``launch/steps``' smoke cells (the
  four archs on ``molecule``, PNA on a fanout tree, SchNet on a full
  graph) on the card against the CPU from the same weights: the first
  step's loss within rtol 1e-5, its gradient norm within 1e-3, each
  leaf's AdamW moments within 1e-3 plus the larger of 1e-3 and four times
  the CPU's own move under reordered edge lists of the leaf's largest
  moment (the card adds its scatters with atomics, in another order;
  PNA's std aggregator multiplies a rounding difference up to 500-fold,
  and EquiformerV2's first SO(2) weights move by 5e-4 of their largest
  when the CPU's edges are reordered), parameters within 1e-6 where the
  gradient clears that bound and within 2 lr where it does not (a first
  AdamW step moves a parameter by about lr * sign(g), so where the
  gradient is rounding the steps may part); the second step from the
  CPU's first-step state held the same way, its parameters within 0.1
  lr; the card's own second step's loss within rtol 1e-4; the
  sampler on the card equals the CPU's on the same raw slots, bitwise;
  segment max/min and their gradient bitwise the CPU's, sums within
  1e-5 with atomics and bitwise under
  ``torch.use_deterministic_algorithms``.
- The recsys family: the smoke DCN-v2 (``launch/steps``' cells) on the
  card against the CPU from the same weights: logits within 1e-5
  (relative plus a share of the largest), one train step's loss within
  rtol 1e-5 and its gradient norm within 1e-3, each leaf's AdamW moments
  within 1e-3 plus 1e-3 of the leaf's largest (the table's gradient adds
  with atomics), parameters within 2 lr; ``embedding_bag`` sum and mean
  within 1e-6; retrieval top-k indices equal where the scores are
  distinct. ``pipeline_apply`` and ``compressed_psum`` on two gloo ranks
  sharing the card against the same ranks on the CPU: the pipeline
  within 1e-6, the compressed sums and residuals bitwise.
- The paper engine's cell (``launch/steps.build_cell``) on a one-rank
  card mesh against the CPU's on one seeded graph, both state layouts:
  levels and trips bitwise; a card dry-run record (``launch/dryrun``)
  with measured memory and wall ms.
- The LM serving cells on a mesh (``models/transformer_mesh``): the
  prefill cell on a one-rank card mesh through ``mha`` (one launch a
  layer) against the forced scan route, float32 and bfloat16, then
  decode steps; four gloo ranks sharing the card on ``(2, 2)`` against
  the same ranks on the CPU, the logits within 1e-4 of the largest
  magnitude and the same collectives.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import build_operands
from repro_torch.graph.csr import csr_from_edges, truncate_csr
from repro_torch.graph.generators import erdos_renyi, powerlaw
from repro_torch.kernels.binned_pull.binned_pull import (
    CHUNK,
    LANE_OPS,
    OPS,
    fused_binned_pull,
)
from repro_torch.kernels.binned_pull.ops import binned_pull, launch_record
from repro_torch.kernels.block_spmm.block_spmm import block_spmm
from repro_torch.kernels.block_spmm.ops import (
    compact_blocks,
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
from repro_torch.models import transformer
from repro_torch.nn import attention as attn
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
    if kind == "hub_chunks":  # node 0's in-row spans three hub chunks
        v = np.arange(1, 3 * CHUNK + 2)
        ring = np.arange(1, 200)
        return csr_from_edges(3 * CHUNK + 10, np.concatenate([v, ring]),
                              np.concatenate([np.zeros_like(v), ring + 1]))
    return truncate_csr(erdos_renyi(n, 3.0, seed=seed), 0)


def with_weights(csr, seed: int):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 2.0, csr.n_edges).astype(np.float32)
    return type(csr)(indptr=csr.indptr, indices=csr.indices, weights=w)


@pytest.mark.parametrize("kind", ["er", "pl", "hub", "star", "edgeless",
                                  "hub_chunks"])
def test_binned_pull_kernel_matches_plain(kind, cuda_device):
    csr = with_weights(fixture_csr(kind), seed=4)
    ops, n_pad = build_operands(csr, "pull_binned_fused")
    pack = to_device(ops.rev_binned_pack, cuda_device)
    rows = pack.rows_local
    if kind == "hub_chunks":
        assert max(pack.widths) > 2 * CHUNK
    rng = np.random.default_rng(7)
    for op in OPS:
        for lanes in ((1, 3, 64, 130) if op in LANE_OPS else (1,)):
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
                again = binned_pull(pack, gd, vd, op=op)
                assert torch.equal(again, got), f"{kind}/{op}/{lanes} rerun"


@pytest.mark.parametrize("op", ["reach", "min_parent_lanes", "min_dist"])
def test_binned_pull_graph_replay_matches_eager(op, cuda_device):
    csr = with_weights(fixture_csr("hub_chunks"), seed=4)
    ops, n_pad = build_operands(csr, "pull_binned_fused")
    pack = to_device(ops.rev_binned_pack, cuda_device)
    rng = np.random.default_rng(9)
    shape = (n_pad, 64) if op in LANE_OPS else (n_pad,)
    if op == "min_dist":
        g = np.where(rng.random(n_pad) < 0.3, rng.uniform(0, 9, n_pad),
                     np.inf).astype(np.float32)
        vd = None
    else:
        g = (rng.random(shape) < 0.3).astype(np.uint8)
        vshape = (pack.rows_local,) + shape[1:]
        vd = torch.from_numpy(
            (rng.random(vshape) < 0.4).astype(np.uint8)).to(cuda_device)
    gd = torch.from_numpy(g).to(cuda_device)
    launch_record(pack)  # built outside the capture (one host copy)
    eager = binned_pull(pack, gd, vd, op=op)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        binned_pull(pack, gd, vd, op=op)  # warm the capture stream
        with torch.cuda.graph(graph, stream=stream):
            captured = binned_pull(pack, gd, vd, op=op)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager), op


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
@pytest.mark.parametrize("feat", [16, 32, 64, 96, 128, 256])
def test_block_spmm_kernel_matches_plain(feat, dtype, cuda_device):
    """F 128 and its multiples take the 4-features-a-lane instance, every
    other F the strided one."""
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


@pytest.mark.parametrize("chunk", [32, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["star_in", "hub"])
def test_block_spmm_kernel_split_destinations(kind, dtype, chunk,
                                              cuda_device):
    """Node 0 takes an edge from (nearly) every node: its nonzeros span
    many chunks, whose partial sums the second pass adds in order."""
    n = 3000
    if kind == "star_in":
        v = np.arange(1, n)
        csr = csr_from_edges(n, v, np.zeros_like(v))
    else:
        csr = fixture_csr("hub", n=n)
    csr = with_weights(csr, seed=9)
    sb = spmm_blocks_from_csr(csr, block=128, normalize="mean",
                              device=cuda_device)
    sb = dataclasses.replace(sb, blocks=sb.blocks.to(dtype))
    nz = compact_blocks(sb.blocks, sb.block_rows, sb.block_cols, sb.g,
                        chunk=chunk)
    node0 = int(nz.nz_ptr[1] - nz.nz_ptr[0])
    assert node0 > 4 * chunk and nz.n_slots >= -(-node0 // chunk)
    rng = np.random.default_rng(chunk)
    x = torch.from_numpy(rng.standard_normal((sb.g * 128, 128))
                         .astype(np.float32)).to(cuda_device, dtype)
    before = block_spmm.launches
    got = block_spmm(nz, x)
    torch.cuda.synchronize()
    assert block_spmm.launches == before + 1
    exp = spmm(sb, x, use_ref=True)
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)
    assert torch.equal(block_spmm(nz, x), got)  # no atomics: same bits


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 4, 512, 36), (1, 4, 512, 48),
                                   (1, 36, 512, 64)])
def test_flash_attention_routes_by_dtype(shape, causal, cuda_device):
    """bfloat16 launches the tensor-core (wgmma) instance, float32 the FMA
    one; each within its band of the plain version. D 36 has rows of 72
    bytes, so the wrapper zero-pads it to 40 for TMA."""
    for dtype, route in ((torch.bfloat16, "wgmma"),
                         (torch.float32, "f32_fma")):
        q, k, v = attention_inputs(shape, dtype, cuda_device, seed=2)
        before = dict(flash_attention.route_launches)
        got = mha(q, k, v, causal=causal)
        torch.cuda.synchronize()
        after = flash_attention.route_launches
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}
        exp = mha(q, k, v, causal=causal, use_ref=True)
        rtol, atol = ATTN_TOL[dtype]
        torch.testing.assert_close(got.float(), exp.float(), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# Kernels on operands that a graph delta folded in place
# ---------------------------------------------------------------------------


def swap_graph():
    """Targets 0-9 have in-degree 3, targets 10-19 in-degree 5, so the
    reverse slabs hold two buckets with no free slot; the delta gives node
    0 two in-edges and takes two from node 10, swapping their buckets."""
    from repro_torch.graph.delta import GraphDelta

    src = np.array([20 + (t * 5 + j) % 20 for t in range(20)
                    for j in range(3 if t < 10 else 5)])
    dst = np.array([t for t in range(20) for _ in range(3 if t < 10 else 5)])
    csr = with_weights(csr_from_edges(40, src, dst), seed=5)
    new_src = [s for s in range(20, 40) if s not in set(src[dst == 0])][:2]
    delta = GraphDelta(add_src=new_src, add_dst=[0, 0],
                       del_src=src[dst == 10][:2], del_dst=[10, 10],
                       add_weights=[0.5, 1.5])
    return csr, delta


def tile_swap_graph():
    """A lone edge in tile (0, 2) and none in tile (2, 2) of a 300-node
    graph (3x3 tiles of 128): the delta empties the first, freeing its
    slot, and the second claims it."""
    from repro_torch.graph.delta import GraphDelta

    base = erdos_renyi(120, 3.0, seed=2)
    s, t = base.edge_list()
    csr = csr_from_edges(300, np.concatenate([s, [5, 130]]),
                         np.concatenate([t, [290, 10]]))
    return csr, GraphDelta(add_src=[260], add_dst=[270], del_src=[5],
                           del_dst=[290])


def test_binned_pull_on_folded_pack_matches_plain(cuda_device):
    from repro_torch.runtime.dispatch import QueryDispatcher

    csr, delta = swap_graph()
    d = QueryDispatcher(cuda_device, csr, max_iters=16)
    d.query(np.array([20, 25], np.int32), backend="pull_binned_fused")
    (bundle,) = d._graphs.values()
    old = bundle.ops.rev_binned_pack
    launch_record(old)
    rep = d.apply_delta(delta)
    assert rep.same_shape and rep.binned_moves == 2
    pack = bundle.ops.rev_binned_pack
    assert pack is not old and "_derived_record" not in pack.__dict__
    assert not torch.equal(pack.perm_pad, old.perm_pad)
    rec = launch_record(pack)
    assert torch.equal(rec.perm_pad.cpu(), bundle.host.rev_binned_pack
                       .perm_pad[0])
    n_pad, rows = int(bundle.n_pad), pack.rows_local
    rng = np.random.default_rng(11)
    for op in OPS:
        for lanes in ((1, 64, 130) if op in LANE_OPS else (1,)):
            shape = (n_pad, lanes) if op in LANE_OPS else (n_pad,)
            if op == "min_dist":
                g = np.where(rng.random(n_pad) < 0.4,
                             rng.uniform(0, 9, n_pad), np.inf)
                g, v = g.astype(np.float32), None
            else:
                g = (rng.random(shape) < 0.3).astype(np.uint8)
                v = (rng.random((rows,) + shape[1:]) < 0.3).astype(np.uint8)
            gd = torch.from_numpy(g).to(cuda_device)
            vd = None if v is None else torch.from_numpy(v).to(cuda_device)
            before = fused_binned_pull.launches
            got = binned_pull(pack, gd, vd, op=op)
            torch.cuda.synchronize()
            assert fused_binned_pull.launches == before + 1
            exp = binned_pull(pack, gd, vd, op=op, use_ref=True)
            assert torch.equal(got, exp), f"{op}/{lanes}"


def test_msbfs_extend_on_folded_blocks_matches_plain(cuda_device):
    from repro_torch.runtime.dispatch import QueryDispatcher

    csr, delta = tile_swap_graph()
    d = QueryDispatcher(cuda_device, csr, max_iters=16)
    d.query(np.arange(4, dtype=np.int32), backend="block_mxu")
    (bundle,) = d._graphs.values()
    rows0 = bundle.ops.blocks.block_rows[0].cpu().clone()
    rep = d.apply_delta(delta)
    assert rep.same_shape and rep.structures_changed > 0
    sb = bundle.ops.blocks
    rows = sb.block_rows[0].cpu()
    # the freed slot was claimed in place: same slot count, and the slot
    # of tile (0, 2) now holds tile (2, 2)
    assert rows.shape == rows0.shape
    assert int((rows != rows0).sum()) == 1 and int(rows.max()) == 2
    b = sb.block_size
    g = int(bundle.n_pad) // b
    rng = np.random.default_rng(12)
    for density in (0.02, 0.3):
        f = (rng.random((g, b, 64)) < density).astype(np.uint8)
        fd = torch.from_numpy(f).to(cuda_device)
        tiles = (sb.blocks[0], sb.block_rows[0], sb.block_cols[0])
        got = extend_blocks(*tiles, fd, g_out=g)
        torch.cuda.synchronize()
        assert torch.equal(got, extend_blocks(*tiles, fd, g_out=g,
                                              use_ref=True)), density


@pytest.mark.parametrize("backend,per_query", [("dopt_fused", 4),
                                               ("block_mxu", 40)])
def test_serving_loop_with_delta_on_card_matches_cpu(backend, per_query,
                                                     cuda_device):
    """A short open-loop stream with one delta mid-way: every query's
    levels on the card equal the same stream's on the CPU."""
    from repro_torch.graph.delta import random_delta
    from repro_torch.runtime.service import ServingLoop

    csr = powerlaw(300, 5.0, seed=4)
    rng = np.random.default_rng(5)
    arrivals = [{"t_ms": float(i), "qid": f"q{i}", "tenant": f"t{i % 2}",
                 "sources": rng.integers(0, 300, per_query).astype(np.int32)}
                for i in range(8)]
    arrivals.append({"t_ms": 3.5, "delta": random_delta(csr, 30, 30, seed=6)})
    out = {}
    for dev in ("cpu", cuda_device):
        loop = ServingLoop(dev, csr, backend=backend, family="powerlaw",
                           max_iters=64)
        out[str(dev)] = loop.run_stream(arrivals)
        assert loop.stats.deltas_applied == 1
        assert loop.stats.completed == 8
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert sorted(cpu) == sorted(card)
    for qid in cpu:
        np.testing.assert_array_equal(card[qid], cpu[qid], err_msg=qid)


@pytest.mark.parametrize("backend", ["dopt_fused", "block_mxu"])
def test_phase1_worker_stream_on_card_matches_cpu(backend, cuda_device,
                                                  monkeypatch):
    """Phase 1 runs on the worker's stream; the pipelined split-phase
    loop with a delta in flight gives the CPU's bits, overlapped and
    serial."""
    import threading

    import repro_torch.core.dispatcher as cd
    from repro_torch.graph.delta import random_delta
    from repro_torch.runtime.dispatch import QueryDispatcher

    import test_torch_ranks as TR

    streams = set()
    run_morsel = cd._run_morsel

    def recording(*args, **kwargs):
        if threading.current_thread().name == "phase1":
            streams.add(torch.cuda.current_stream().cuda_stream)
        return run_morsel(*args, **kwargs)

    monkeypatch.setattr(cd, "_run_morsel", recording)
    csr = powerlaw(160, 5.0, seed=0)
    delta = random_delta(csr, 15, 15, seed=9)
    batches = TR.overlap_batches()
    d = QueryDispatcher(cuda_device, csr, max_iters=64, phase1_iters=1)
    inflight = d.begin_batch(batches[0][0], policy="ntks", backend=backend)
    _, done = inflight.payload["phase1"].result(timeout=120)
    assert isinstance(done, torch.cuda.Event)
    d.settle_batch(inflight).finalize()
    assert streams and torch.cuda.current_stream().cuda_stream not in streams
    runs = {}
    for dev, overlap in (("cpu", False), (cuda_device, True),
                         (cuda_device, False)):
        d = QueryDispatcher(dev, csr, max_iters=64, phase1_iters=1)
        runs[str(dev), overlap] = TR.pipelined_run(
            d, batches, delta, TR.OVERLAP_DELTA_AT, overlap, backend)
    cpu = runs["cpu", False]
    for key, outs in runs.items():
        for i, (a, b) in enumerate(zip(outs, cpu)):
            assert torch.equal(a.result.iterations.cpu(),
                               b.result.iterations), (key, i)
            for x, y in zip(a.result.state, b.result.state):
                assert torch.equal(x.cpu(), y), (key, i)


@pytest.mark.parametrize("backend", ["pull_binned_fused", "dopt_fused"])
def test_bellman_ford_min_dist_kernel_matches_plain(backend, cuda_device):
    from repro_torch.core import policy_ntks, run_recursive_query

    csr = with_weights(powerlaw(400, 6.0, seed=2), seed=3)
    src = np.array([0, 7, 130], np.int32)
    before = fused_binned_pull.launches
    card = run_recursive_query(cuda_device, csr, src, policy_ntks(),
                               edge_compute="bellman_ford", extend=backend)
    torch.cuda.synchronize()
    assert fused_binned_pull.launches > before
    cpu = run_recursive_query("cpu", csr, src, policy_ntks(),
                              edge_compute="bellman_ford", extend=backend)
    push = run_recursive_query(cuda_device, csr, src, policy_ntks(),
                               edge_compute="bellman_ford",
                               extend="ell_push")
    for got, exp, ref in zip(card.state, cpu.state, push.state):
        assert torch.equal(got.cpu(), exp) and torch.equal(got, ref)
    assert torch.equal(card.iterations.cpu(), cpu.iterations)


@pytest.mark.parametrize("kind", ["ppr", "topk_paths", "pattern_counts"])
def test_query_kinds_on_card_match_cpu_and_repeat(kind, cuda_device):
    from repro_torch.runtime.dispatch import QueryDispatcher

    csr = with_weights(powerlaw(400, 6.0, seed=5), seed=6)
    src = np.array([3, 40, 41, 200, 399], np.int32)
    outs = {}
    for dev in ("cpu", cuda_device, cuda_device):
        d = QueryDispatcher(dev, csr, max_iters=256, phase1_iters=2)
        outs.setdefault(str(dev), []).append(d.query(src, query_kind=kind))
    (cpu,), (a, b) = outs["cpu"], outs[str(cuda_device)]
    for x, y, z in zip(cpu.result.state, a.result.state, b.result.state):
        assert torch.equal(y, z), "two runs on the card differ"
        assert torch.equal(y.cpu(), x), "the card differs from the CPU"
    assert torch.equal(a.result.iterations.cpu(), cpu.result.iterations)
    assert a.redispatched == cpu.redispatched > 0


@pytest.mark.parametrize("k", [0, 3])
def test_kernels_on_shard_local_operands_match_plain(k, cuda_device):
    from repro_torch.core.extend import operand_stream, operands_from_numpy

    csr = with_weights(fixture_csr("pl", n=1200, seed=6), seed=2)
    st = operand_stream(csr, "dopt_fused", shards=4, binned_shards=4)
    pack = operands_from_numpy(st.build_shard(k), cuda_device) \
        .rev_binned_pack
    n_pad, rows = st.n_pad, pack.rows_local
    assert rows == n_pad // 4 < n_pad
    rng = np.random.default_rng(k)
    for op in OPS:
        lanes = 64 if op in LANE_OPS else 1
        shape = (n_pad, lanes) if op in LANE_OPS else (n_pad,)
        vshape = (rows, lanes) if op in LANE_OPS else (rows,)
        if op == "min_dist":
            g = np.where(rng.random(n_pad) < 0.3, rng.uniform(0, 9, n_pad),
                         np.inf).astype(np.float32)
            vd = None
        else:
            g = (rng.random(shape) < 0.3).astype(np.uint8)
            vd = torch.from_numpy(
                (rng.random(vshape) < 0.4).astype(np.uint8)).to(cuda_device)
        gd = torch.from_numpy(g).to(cuda_device)
        before = fused_binned_pull.launches
        got = binned_pull(pack, gd, vd, op=op)
        torch.cuda.synchronize()
        assert fused_binned_pull.launches == before + 1
        assert torch.equal(got, binned_pull(pack, gd, vd, op=op,
                                            use_ref=True)), op
    # the tiles pad rows to 4 x 128: another n_pad than the pack's
    st = operand_stream(csr, "block_mxu", shards=4, binned_shards=4)
    tiles = operands_from_numpy(st.build_shard(k), cuda_device).blocks
    b = tiles.block_size
    g_local, g_out = st.rows_local // b, st.n_pad // b
    assert g_local < g_out
    for lanes in (64, 1):
        f = (rng.random((g_local, b, lanes)) < 0.05).astype(np.uint8)
        fd = torch.from_numpy(f).to(cuda_device)
        args = (tiles.blocks[0], tiles.block_rows[0], tiles.block_cols[0], fd)
        before = msbfs_extend_blocks.launches
        got = extend_blocks(*args, g_out=g_out)
        torch.cuda.synchronize()
        assert msbfs_extend_blocks.launches == before + 1
        assert torch.equal(got, extend_blocks(*args, g_out=g_out,
                                              use_ref=True)), lanes


def test_ranks_sharing_the_card_match_one_cpu_device(cuda_device):
    from repro_torch.core import POLICIES, run_recursive_query
    from repro_torch.launch.mesh import run_ranks

    import test_torch_ranks as TR

    ranks = run_ranks(TR.card_rank, 2, timeout_s=240)
    csr = powerlaw(2000, 6.0, seed=5)
    for r in ranks:
        assert (r["launches"] > 0).all() and int(r["staged"]) > 0
    for pol, ec, be, lay in TR.CARD_CASES:
        srcs = TR.SOURCES_70 if pol == "ntkms" else TR.SOURCES
        one = run_recursive_query("cpu", csr, srcs, POLICIES[pol](), ec)
        n = csr.n_nodes  # two ranks pad rows for two shards
        for f in one.state._fields:
            want = getattr(one.state, f).numpy()[:, :n]
            for r in ranks:
                np.testing.assert_array_equal(r[f"{be}/{f}"][:, :n], want,
                                              err_msg=f"{be}/{f}")


def test_ranks_sharing_the_card_fold_reshaping_deltas(cuda_device):
    """Four gloo ranks on the card fold the edit script (a forward ELL
    overflow and full tile lists rebuild structures on every rank) into
    their own shards; after every delta their levels equal the one-device
    port's on the CPU, and both kernels launch on the folded shards."""
    from repro_torch.graph.delta import GraphDelta, apply_delta_csr
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.runtime.dispatch import QueryDispatcher

    import test_torch_ranks as TR

    ranks = run_ranks(TR.card_delta_rank, 4, timeout_s=300)
    csr = TR.local_graph(csr_from_edges)
    one = QueryDispatcher("cpu", csr, max_iters=64, phase1_iters=2)
    want = {}
    TR.card_delta_queries(one, want, "0", TR.SOURCES_70)
    script = TR.delta_script(csr, GraphDelta, apply_delta_csr)
    for step, (_, d) in enumerate(script, 1):
        one.apply_delta(d)
        TR.card_delta_queries(one, want, f"{step}", TR.SOURCES_70)
    assert any(int(ranks[0][f"{s}/rebuilt"]) for s in range(1, 5))
    for r in ranks:
        assert int(r["staged"]) > 0
        for step in range(1, len(script) + 1):
            assert (r[f"{step}/launches"] > 0).all(), (
                step, r[f"{step}/launches"])
        for key, v in want.items():
            if key.endswith("/levels"):
                n = csr.n_nodes  # ranks pad rows for four shards
                np.testing.assert_array_equal(r[key][:, :n], v[:, :n],
                                              err_msg=key)


# ---------------------------------------------------------------------------
# The LM serving path: attention on the kernel route against the scan route
# ---------------------------------------------------------------------------

def rel_err(got, exp):
    """Max abs difference over the largest magnitude of ``exp``."""
    got, exp = got.double(), exp.double()
    return float((got - exp).abs().max() / exp.abs().max().clamp_min(1e-30))


def row_cosine(got, exp):
    got, exp = got.double(), exp.double()
    return torch.nn.functional.cosine_similarity(got, exp, dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_kernel_route_matches_scan_route(dtype, cuda_device):
    """MiniCPM-smoke (2 layers, 4 MHA heads of 16) at S 256: prefill and 4
    teacher-forced decode steps, kernel route against forced scan route.
    float32: within 1e-4 of the largest magnitude (the two routes add the
    softmax in other orders); bfloat16: per-row cosine >= 0.999 (the
    routes round p and the output to bfloat16 at other places)."""
    from repro_torch.configs.minicpm_2b import smoke_config

    cfg = dataclasses.replace(smoke_config(), dtype=dtype)
    model = transformer.init(cfg, torch.Generator().manual_seed(0),
                             cuda_device)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 260))).to(
        cuda_device)
    v = cfg.vocab
    launches, calls = flash_attention.launches, dict(attn.route_calls)
    got, k_caches = transformer.prefill(model, cfg, toks[:, :256],
                                        max_seq=260)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + cfg.n_layers
    assert attn.route_calls == {"kernel": calls["kernel"] + cfg.n_layers,
                                "scan": calls["scan"]}
    exp, s_caches = transformer.prefill(model, cfg, toks[:, :256],
                                        max_seq=260, route="scan")
    assert flash_attention.launches == launches + cfg.n_layers
    steps = [(got, exp)]
    for p in range(256, 260):
        step = toks[:, p:p + 1]
        g, k_caches = transformer.decode(model, cfg, k_caches, step, p)
        e, s_caches = transformer.decode(model, cfg, s_caches, step, p)
        steps.append((g[:, 0], e[:, 0]))
    for g, e in steps:
        assert torch.isfinite(g[:, :v]).all()
        if dtype == torch.float32:
            assert rel_err(g[:, :v], e[:, :v]) <= 1e-4
        else:
            assert (row_cosine(g[:, :v], e[:, :v]) >= 0.999).all()
    for kc, sc in zip(k_caches, s_caches):
        assert torch.equal(kc.slot_pos, sc.slot_pos)
        for a, b in ((kc.k, sc.k), (kc.v, sc.v)):
            if dtype == torch.float32:
                assert rel_err(a, b) <= 1e-4
            else:
                assert (row_cosine(a.flatten(1), b.flatten(1))
                        >= 0.999).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_attention_through_mha_matches_scan(dtype, cuda_device):
    """8 query heads on 2 kv heads of 64 at S 256: the kernel route expands
    k and v with ``repeat_interleave`` and launches ``mha`` once; against
    the scan route as in the model test above."""
    s = attn.AttnSettings(d_model=256, n_heads=8, n_kv_heads=2, d_head=64,
                          chunk_q=128)
    p = attn.attn_init(torch.Generator().manual_seed(1), s, dtype,
                       cuda_device)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 256, 256)).astype(
        np.float32)).to(cuda_device, dtype)
    pos = torch.arange(256, dtype=torch.int32,
                       device=cuda_device).expand(2, 256)
    assert attn.choose_route(s, x) == "kernel"
    before = flash_attention.launches
    got = attn.attention(p, s, x, pos)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    exp = attn.attention_scan(p, s, x, pos)
    if dtype == torch.float32:
        assert rel_err(got, exp) <= 1e-4
    else:
        assert (row_cosine(got.flatten(1), exp.flatten(1)) >= 0.999).all()


# ---------------------------------------------------------------------------
# The LM training path on the card
# ---------------------------------------------------------------------------

def train_pair(device, lr=1e-3):
    """MiniCPM-smoke trainers on the CPU and on ``device`` holding the same
    weights (``build`` draws them on its own device)."""
    from repro_torch.launch import train

    cpu = train.build("minicpm-2b", True, 2, 64, lr, "cpu")
    card = train.build("minicpm-2b", True, 2, 64, lr, device)
    with torch.no_grad():
        for (name, p), q in zip(cpu[1].named_parameters(),
                                card[1].parameters()):
            q.copy_(p)
    return cpu, card


def test_smoke_train_steps_on_card_match_cpu(cuda_device):
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as tfm

    lr = 1e-3
    runs = []
    for cfg, model, opt, sched, stream, step in train_pair(cuda_device, lr):
        dev = next(model.parameters()).device
        batch = device_batch(stream.batch(0), dev)
        out = []
        for _ in range(2):
            _, opt, loss, gnorm = step(model, opt, batch, 1.0)
            out.append((loss.item(), gnorm.item(),
                        tfm.params_to_numpy(model)))
        runs.append(out)
    for (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) in zip(*runs):
        assert np.isfinite(l_card) and np.isfinite(g_card)
        np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
        np.testing.assert_allclose(g_card, g_cpu, rtol=1e-5)
        n = loose = 0
        for a, b in zip(_flat(p_card), _flat(p_cpu)):
            d = np.abs(a - b)
            assert d.max() <= 0.1 * lr
            n, loose = n + d.size, loose + int((d > 1e-6).sum())
        assert loose <= 1e-3 * n, (loose, n)
    assert runs[1][1][0] < runs[1][0][0]  # the same batch twice descends


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def test_kernel_route_under_grad_raises_on_card(cuda_device):
    from repro_torch.configs.minicpm_2b import smoke_config

    cfg = smoke_config()
    model = transformer.init(cfg, torch.Generator().manual_seed(0),
                             cuda_device)
    model.requires_grad_(True)
    rng = np.random.default_rng(0)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 129))).to(
        cuda_device)
    toks = seq[:, :128]  # S % 128 == 0: the kernel route applies
    for route in (None, "kernel"):  # chosen by default, or forced
        with pytest.raises(RuntimeError, match="no backward"):
            transformer.forward(model, cfg, toks, route=route)
    calls, launches = dict(attn.route_calls), flash_attention.launches
    loss = transformer.loss_fn(model, cfg, {"tokens": toks,
                                            "labels": seq[:, 1:]})
    loss.backward()
    assert attn.route_calls["kernel"] == calls["kernel"]
    assert flash_attention.launches == launches
    assert model.blocks[0].attn.wq.kernel.grad.abs().sum() > 0
    last, _ = transformer.prefill(model, cfg, toks)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + cfg.n_layers
    assert last.grad_fn is None


def test_checkpoint_round_trip_of_cuda_tensors(cuda_device, tmp_path):
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs.minicpm_2b import smoke_config
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = dataclasses.replace(smoke_config(), dtype=torch.bfloat16)
    model = transformer.init(cfg, torch.Generator().manual_seed(0),
                             cuda_device)
    opt = adamw_init(dict(model.named_parameters()), AdamWConfig())
    with torch.no_grad():
        for m in (*opt.mu.values(), *opt.nu.values()):
            m.normal_()
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32))
    saved = transformer.state_to_numpy(model, opt)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, transformer.state_tree(model, opt))
    with torch.no_grad():  # the next step's in-place writes
        for t in (*model.parameters(), *opt.mu.values(), *opt.nu.values(),
                  opt.step):
            t.zero_()
    mgr.wait()
    _, step = mgr.restore(transformer.state_tree(model, opt))
    assert step == 7 and int(opt.step) == 7
    assert model.embed.table.device == opt.mu["embed.table"].device
    assert model.embed.table.device.type == "cuda"
    assert model.embed.table.dtype == torch.bfloat16
    got = transformer.state_to_numpy(model, opt)
    for a, b in zip(_flat(got["params"]) + _flat(got["opt"][1:]),
                    _flat(saved["params"]) + _flat(saved["opt"][1:])):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ GNN family ----

GNN_PERMUTATIONS = (1, 2, 3)  # seeds of the CPU's reordered edge lists
GNN_SPREAD_RATIO = 4.0


def gnn_steps(arch, shape, device, dims=None):
    """A smoke cell's GNN train step from given states, each state a
    snapshot ``(loss, gnorm, params, mu, nu, step)`` on the CPU: the CPU's
    first and second steps, the card's first step and its own second, the
    card's second step from the CPU's first-step state, and the CPU's
    first and second steps again on the edge list reordered (the same
    function, its sums in other orders) once for each of
    ``GNN_PERMUTATIONS``."""
    from repro_torch.launch import steps
    from repro_torch.models.gnn import common as gcom
    from repro_torch.optim.adamw import AdamWState, adamw_init

    cell = steps.gnn_cell(arch, shape, smoke=True, dims=dims)
    batch = steps.batch_to(steps.cell_batch(cell, seed=3), "cpu")
    init = steps.init_model(cell, torch.Generator().manual_seed(0), "cpu")
    tree = gcom.params_to_numpy(init)
    opt = adamw_init(steps.params_dict(init), steps.GNN_ADAMW)
    start = (None, None, dict(init.named_parameters()), opt.mu, opt.nu,
             opt.step)
    step = steps.make_train_step(cell)

    def run(state, b, where):
        model = steps.GNN_MODULES[arch].params_from_jax(
            cell.cfg, tree, where).requires_grad_(True)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(state[2][k])
        opt = AdamWState(step=state[5].clone(),
                         mu={k: v.to(where, copy=True)
                             for k, v in state[3].items()},
                         nu={k: v.to(where, copy=True)
                             for k, v in state[4].items()})
        _, opt, loss, gnorm = step(model, opt, steps.batch_to(b, where))

        def host(d):
            return {k: v.detach().to("cpu", copy=True) for k, v in d.items()}

        return (loss.item(), gnorm.item(),
                host(dict(model.named_parameters())), host(opt.mu),
                host(opt.nu), opt.step)

    cpu1 = run(start, batch, "cpu")
    card1 = run(start, batch, device)
    out = {"cpu": [cpu1, run(cpu1, batch, "cpu")],
           "card": [card1, run(card1, batch, device)],
           "resumed": run(cpu1, batch, device), "reordered": []}
    n_edges = batch["edge_src"].shape[0]
    for seed in GNN_PERMUTATIONS:
        perm = torch.randperm(n_edges,
                              generator=torch.Generator().manual_seed(seed))
        b = dict(batch, edge_src=batch["edge_src"][perm],
                 edge_dst=batch["edge_dst"][perm])
        out["reordered"].append([run(start, b, "cpu"), run(cpu1, b, "cpu")])
    return out


def gnn_spread(cpu, reordered):
    """Each leaf's moments' worst move under the CPU's reordered sums, as a
    share of the leaf's largest: {leaf: [mu share, nu share]}."""
    out = {}
    for k in cpu[3]:
        out[k] = []
        for j in (3, 4):
            e = cpu[j][k]
            top = max(float(e.abs().max()), 1e-30)
            out[k].append(max(float((r[j][k] - e).abs().max()) / top
                              for r in reordered))
    return out


def hold_gnn_step(cpu, card, first, spread):
    """Card step against CPU step from the same state: loss within rtol
    1e-5, gradient norm within 1e-3; each leaf's AdamW moments within 1e-3
    plus a share of the leaf's largest, 1e-3 or ``GNN_SPREAD_RATIO`` times
    the CPU's own move under reordered sums (``spread``), the larger;
    after a first step the parameters within 1e-6 where the gradient
    clears twice that bound and within 2 lr where it does not (a first
    step moves a parameter by about lr * sign(g)), after a later one
    within 0.1 lr everywhere."""
    lr = 1e-3
    (l0, g0, p0, m0, v0, _), (l1, g1, p1, m1, v1, _) = cpu, card
    assert abs(l1 - l0) <= 1e-5 * abs(l0) and np.isfinite(l1)
    assert abs(g1 - g0) <= 1e-3 * abs(g0)
    for k in p0:
        share = [max(1e-3, GNN_SPREAD_RATIO * x) for x in spread[k]]
        for j, (e, g) in enumerate(((m0[k], m1[k]), (v0[k], v1[k]))):
            lim = 1e-3 * e.abs() + share[j] * e.abs().max()
            assert ((g - e).abs() <= lim).all(), (k, j, spread[k])
        d = (p1[k] - p0[k]).abs()
        if not first:
            assert d.max() <= 0.1 * lr, k
            continue
        m = m0[k].abs()
        signal = m > 2 * (1e-3 * m + share[0] * m.max())
        assert not signal.any() or d[signal].max() <= 1e-6, k
        assert d.max() <= 2 * lr + 1e-6, k


@pytest.mark.parametrize("arch,shape", [
    ("schnet", "molecule"), ("pna", "molecule"), ("mace", "molecule"),
    ("equiformer-v2", "molecule"), ("pna", "minibatch_lg"),
    ("schnet", "full_graph_sm")])
def test_gnn_train_steps_on_card_match_cpu(arch, shape, cuda_device):
    dims = {"minibatch_lg": dict(batch_nodes=32, fanout=(5, 3)),
            "full_graph_sm": dict(n_nodes=300, n_edges=1200),
            "molecule": dict(batch=8)}[shape]
    run = gnn_steps(arch, shape, cuda_device, dims)
    cpu, card = run["cpu"], run["card"]
    hold_gnn_step(cpu[0], card[0], True,
                  gnn_spread(cpu[0], [r[0] for r in run["reordered"]]))
    # the second step from the CPU's first-step state: AdamW's moments and
    # bias corrections at step 2 on the card
    hold_gnn_step(cpu[1], run["resumed"], False,
                  gnn_spread(cpu[1], [r[1] for r in run["reordered"]]))
    # the card's own second step starts from parameters that may part by
    # 2 lr where the first gradient was rounding; the loss barely feels
    # those
    l0, l1 = cpu[1][0], card[1][0]
    assert abs(l1 - l0) <= 1e-4 * abs(l0) and np.isfinite(l1)


def test_sampler_on_card_matches_cpu(cuda_device):
    from repro_torch.graph.csr import ell_from_csr
    from repro_torch.graph.sampler import draw_slots, sample_subgraph

    csr = powerlaw(2000, 6.0, seed=3)
    g_cpu = ell_from_csr(csr)
    g = to_device(g_cpu, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    raw = [draw_slots(gen, 64, 10), draw_slots(gen, 640, 5)]
    assert raw[0].device.type == "cuda" and raw[0].dtype == torch.int32
    assert int(raw[1].min()) >= 0 and int(raw[1].max()) < 1 << 30
    seeds = np.arange(0, 2000, 2000 // 64)[:64].astype(np.int32)
    got = sample_subgraph(g, seeds, (10, 5), raw_slots=raw)
    exp = sample_subgraph(g_cpu, seeds, (10, 5),
                          raw_slots=[r.cpu() for r in raw], device="cpu")
    for name in ("nodes", "edge_src", "edge_dst"):
        assert getattr(got, name).device.type == "cuda"
        assert torch.equal(getattr(got, name).cpu(), getattr(exp, name))
    sub = sample_subgraph(g, seeds, (10, 5), gen)
    assert sub.nodes.shape == (64 * (1 + 10 + 50),)
    with pytest.raises(ValueError, match="lies on cuda"):
        sample_subgraph(g, seeds, (2,), gen, device="cpu")


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_gnn_reductions_on_card(op, cuda_device):
    """Extrema and their gradient on the card are the CPU's bits (a max is
    order-free; the tie counts are integers); sums under
    ``torch.use_deterministic_algorithms`` too, and within 1e-5 with
    atomics."""
    from repro_torch.models.gnn import common as gcom

    rng = np.random.default_rng(0)
    dst = torch.from_numpy(rng.integers(0, 900, 20000).astype(np.int32))
    msg = torch.from_numpy(np.round(rng.standard_normal((20000, 16)), 1)
                           .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1000, 16)).astype(np.float32))

    def run(device):
        x = msg.to(device, copy=True).requires_grad_(True)
        out = gcom.aggregate(x, dst.to(device), 1000, op)
        (out * w.to(device)).sum().backward()
        return out.detach().cpu(), x.grad.cpu()

    exp = run("cpu")
    got = run(cuda_device)
    if op in ("max", "min"):
        assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    else:
        torch.testing.assert_close(got[0], exp[0], rtol=1e-5, atol=1e-5)
        torch.use_deterministic_algorithms(True)
        try:
            det = run(cuda_device)
        finally:
            torch.use_deterministic_algorithms(False)
        assert torch.equal(det[0], exp[0]) and torch.equal(det[1], exp[1])


# ------------------------------------------------------------ recsys ----

def _recsys_close(got, exp, tol):
    g = got.detach().double().cpu()
    e = exp.detach().double().cpu()
    lim = tol[0] * e.abs() + tol[1] * float(e.abs().max())
    assert ((g - e).abs() <= lim).all(), float((g - e).abs().max())


def _recsys_pair(shape, device, dims):
    from repro_torch.launch import steps
    from repro_torch.models import dcn_v2
    from repro_torch.models.gnn.common import params_to_numpy

    cell, cpu_model, opt, step = steps.build(
        "dcn-v2", shape, torch.Generator().manual_seed(0), "cpu",
        smoke=True, dims=dims)
    card_model, off = dcn_v2.params_from_jax(params_to_numpy(cpu_model),
                                             cell.cfg, device)
    card_step = steps.recsys_step(cell, off)
    return cell, (cpu_model, opt, step), (card_model, card_step)


def test_dcn_v2_smoke_forward_and_train_step_on_card_match_cpu(cuda_device):
    from repro_torch.launch import steps
    from repro_torch.models import dcn_v2
    from repro_torch.optim.adamw import adamw_init

    cell, (cpu_model, opt, step), (card_model, card_step) = _recsys_pair(
        "train_batch", cuda_device, dict(batch=256))
    batch = steps.recsys_batch(cell, seed=1)
    cpu_b = steps.batch_to(batch, "cpu")
    card_b = steps.batch_to(batch, cuda_device)
    serve = steps.recsys_cell("dcn-v2", "serve_p99", smoke=True,
                              dims=dict(batch=256))
    with torch.no_grad():
        exp = dcn_v2.forward(cpu_model, cell.cfg, cpu_b,
                             dcn_v2.field_offsets(cell.cfg, "cpu"))
    got = steps.recsys_step(serve, dcn_v2.field_offsets(
        cell.cfg, cuda_device))(card_model, card_b)
    _recsys_close(got, exp, (1e-5, 1e-5))
    card_model.requires_grad_(True)
    card_opt = adamw_init(steps.params_dict(card_model), steps.RECSYS_ADAMW)
    _, opt, l0, g0 = step(cpu_model, opt, cpu_b)
    _, card_opt, l1, g1 = card_step(card_model, card_opt, card_b)
    assert abs(l1.item() - l0.item()) <= 1e-5 * abs(l0.item())
    assert abs(g1.item() - g0.item()) <= 1e-3 * abs(g0.item())
    lr = steps.RECSYS_ADAMW.lr
    cpu_p = dict(cpu_model.named_parameters())
    for k, p in card_model.named_parameters():
        for m0, m1 in ((opt.mu[k], card_opt.mu[k]),
                       (opt.nu[k], card_opt.nu[k])):
            _recsys_close(m1, m0, (1e-3, 1e-3))
        assert float((p.detach().cpu() - cpu_p[k].detach()).abs().max()) \
            <= 2 * lr + 1e-6, k


def test_dcn_v2_smoke_retrieval_and_bags_on_card_match_cpu(cuda_device):
    from repro_torch.launch import steps
    from repro_torch.models import dcn_v2
    from repro_torch.nn.embedding_bag import embedding_bag

    cell, (cpu_model, _, step), (card_model, card_step) = _recsys_pair(
        "retrieval_cand", cuda_device, dict(batch=4, n_candidates=20000))
    batch = steps.recsys_batch(cell, seed=2)
    cand = steps.retrieval_candidates(cell, torch.Generator().manual_seed(3))
    v0, i0 = step(cpu_model, steps.batch_to(batch, "cpu"), cand)
    v1, i1 = card_step(card_model, steps.batch_to(batch, cuda_device),
                       cand.to(cuda_device))
    _recsys_close(v1, v0, (1e-5, 1e-5))
    gaps = torch.diff(v0, dim=1).abs()
    distinct = torch.cat([gaps[:, :1], torch.minimum(gaps[:, 1:],
                                                     gaps[:, :-1]),
                          gaps[:, -1:]], dim=1) > 1e-5
    assert torch.equal(i1.cpu()[distinct], i0[distinct])
    rng = np.random.default_rng(4)
    nnz, n_bags = 5000, 300
    fids = torch.from_numpy(rng.integers(0, 26, nnz).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, 97, nnz).astype(np.int32))
    bags = torch.from_numpy(np.sort(rng.integers(0, n_bags, nnz))
                            .astype(np.int32))
    off = dcn_v2.field_offsets(cell.cfg, "cpu")
    for mode in ("sum", "mean"):
        exp = embedding_bag(cpu_model.embed, off, ids, fids, bags, n_bags,
                            mode)
        got = embedding_bag(card_model.embed, off.to(cuda_device),
                            *(t.to(cuda_device) for t in (ids, fids, bags)),
                            n_bags, mode)
        assert float((got.cpu() - exp).abs().max()) <= 1e-6, mode


def test_pipeline_and_compressed_psum_on_card_ranks_match_cpu(cuda_device):
    from repro_torch.launch.mesh import run_ranks

    import test_torch_ranks as TR

    card = run_ranks(TR.card_parallel_rank, 2, timeout_s=240)
    pipe = run_ranks(TR.pipe_rank, 2, timeout_s=120)
    comp = run_ranks(TR.compress_rank, 2, timeout_s=120)
    for r in range(2):
        assert int(card[r]["staged"]) > 0
        for case in TR.PIPE_CASES:
            np.testing.assert_allclose(card[r][case], pipe[r][case],
                                       rtol=0, atol=1e-6)
        for key, want in comp[r].items():
            if "/" in key:
                np.testing.assert_array_equal(card[r][key], want,
                                              err_msg=key)


def test_paper_cell_on_card_matches_cpu(cuda_device, tmp_path):
    """The paper engine's cell (``launch.steps.build_cell``) on a one-rank
    card mesh against the same cell on the CPU, on one seeded graph:
    levels and trips bitwise; and a card dry-run record of a cut cell
    with measured memory and wall ms."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh

    csr = powerlaw(3000, 4.0, alpha=2.1, seed=5)
    shape = ShapeSpec("tiny", "query", dict(n_nodes=3000, n_edges=0,
                                            avg_degree=8))
    spec = steps.cfgbase.get("paper-bfs-engine")
    runs = {}
    for dev in ("cpu", cuda_device):
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        for layout in ("replicated", "sharded"):
            cell = steps._paper_cell(spec, shape, mesh, False,
                                     state_layout=layout)
            bound = steps.bind_cell(cell, mesh, csr)
            assert bound.graph.indices.device.type == mesh.device.type
            res = bound()
            runs[(str(dev), layout)] = (res.state.levels.cpu(),
                                        res.iterations.cpu())
    for layout in ("replicated", "sharded"):
        (a, ia), (b, ib) = runs[("cpu", layout)], runs[(str(cuda_device),
                                                        layout)]
        assert torch.equal(a, b) and torch.equal(ia, ib), layout
    rec = dryrun.run_cell("paper-bfs-engine", "ldbc100", "card",
                          str(tmp_path), cut={"n_nodes": 3000})
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["total_bytes_per_device"] > 0
    assert rec["wall_ms"] > 0 and rec["device"].startswith("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_rank_mesh_prefill_through_mha_matches_scan(dtype, cuda_device):
    """The LM prefill cell (``launch.steps``, ``models.transformer_mesh``)
    on a one-rank card mesh, MiniCPM-smoke at S 256: ``mha`` launches once
    a layer (no scan-route call), and the logits and caches equal the
    forced scan route's (float32 within 1e-4 of the largest magnitude,
    bfloat16 per-row cosine >= 0.999, as the model test above); then 4
    decode steps from each route's caches."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh

    import test_torch_ranks as TR

    mesh = make_mesh((1, 1), ("data", "model"), cuda_device)
    pcell, dcell = TR.lm_cells(mesh, "minicpm-2b", 2, 256, 4, dtype)
    cfg = pcell.config
    assert cfg.dtype == dtype
    model = transformer.init(cfg, torch.Generator().manual_seed(0),
                             cuda_device)
    steps.shard_lm(pcell, model, mesh)
    toks = torch.from_numpy(TR.lm_tokens(cfg.vocab, 2, 260)).to(cuda_device)
    launches, calls = flash_attention.launches, dict(attn.route_calls)
    got, k_caches = pcell.fn(model, toks[:, :256], max_seq=260)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + cfg.n_layers
    assert attn.route_calls == {"kernel": calls["kernel"] + cfg.n_layers,
                                "scan": calls["scan"]}
    exp, s_caches = pcell.fn(model, toks[:, :256], max_seq=260,
                             route="scan")
    assert flash_attention.launches == launches + cfg.n_layers
    pairs = [(got, exp)]
    for p in range(256, 260):
        g, k_caches = dcell.fn(model, k_caches, toks[:, p:p + 1], p)
        e, s_caches = dcell.fn(model, s_caches, toks[:, p:p + 1], p)
        pairs.append((g[:, 0], e[:, 0]))
    v = cfg.vocab
    for g, e in pairs:
        assert torch.isfinite(g[:, :v]).all()
        if dtype == torch.float32:
            assert rel_err(g[:, :v], e[:, :v]) <= 1e-4
        else:
            assert (row_cosine(g[:, :v], e[:, :v]) >= 0.999).all()
    assert mesh.wire.calls == 0


def test_lm_mesh_on_card_ranks_matches_cpu(cuda_device):
    """Four gloo ranks sharing the card serve the smoke LM cells of
    ``test_torch_lm_mesh.py`` on ``(2, 2)`` (``test_torch_ranks.
    lm_mesh_rank``, float32, TF32 off) from one set of weights: each
    case's global logits within 1e-4 of the largest magnitude of the
    same ranks on the CPU, the same collectives by kind, and messages
    staged through host memory."""
    from repro_torch.configs import base
    from repro_torch.launch.mesh import run_ranks

    import test_torch_ranks as TR

    trees = {}
    for arch in ("minicpm-2b", "gemma2-2b"):
        cfg = base.get(arch).smoke_config()
        trees[arch] = transformer.params_to_numpy(transformer.init(
            cfg, torch.Generator().manual_seed(3), "cpu"))
    card = run_ranks(TR.lm_mesh_rank, 4, ((2, 2), trees, "cuda:0"),
                     timeout_s=240)
    cpu = run_ranks(TR.lm_mesh_rank, 4, ((2, 2), trees), timeout_s=240)
    for r in range(4):
        for arch, b, _, _ in TR.LM_MESH_CASES[(2, 2)]:
            c, h = card[r][f"{arch}/{b}"], cpu[r][f"{arch}/{b}"]
            assert c["by_kind"] == h["by_kind"] and c["staged"] > 0
            for g, e in zip(c["logits"], h["logits"]):
                v = base.get(arch).smoke_config().vocab
                assert rel_err(torch.from_numpy(g[:, :v]),
                               torch.from_numpy(e[:, :v])) <= 1e-4


def _mesh_leaves_close(got: dict, exp: dict, what: str, share=1e-3):
    for k, e in exp.items():
        g = got[k]
        top = max(float(np.abs(e).max()), 1e-30)
        assert np.all(np.abs(g - e) <= share * np.abs(e) + share * top), \
            (what, k)


def test_gnn_and_recsys_mesh_on_card_ranks_match_cpu(cuda_device):
    """Four gloo ranks sharing the card run the GNN and DCN-v2 mesh
    cells of ``test_torch_gnn_mesh.py`` and ``test_torch_recsys_mesh.py``
    on ``(2, 2)`` (``test_torch_ranks.gnn_mesh_rank``/``recsys_mesh_rank``,
    float32, TF32 off) from one set of seeded weights, against the same
    ranks on the CPU: losses and norms within 1e-5 relative, moments and
    logits within 1e-3 of the leaf's largest magnitude (the card's
    ``index_add`` adds with atomics; EquiformerV2's first SO(2) weights
    move by up to 1.5e-3 of their largest under reordered sums, ROADMAP
    section 3), the top-100 values within 1e-5, the same collectives by
    axis and kind, and the GNN messages staged through host memory."""
    from repro_torch.configs import base
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import dcn_v2
    from repro_torch.models.gnn import common

    import test_torch_ranks as TR

    trees = {}
    for arch, shape in (("pna", "molecule"), ("schnet", "full_graph_sm"),
                        ("mace", "minibatch_lg"),
                        ("equiformer-v2", "molecule")):
        cell = steps.gnn_cell(arch, shape, smoke=True,
                              dims=TR.GNN_MESH_DIMS[shape])
        trees[arch, shape] = common.params_to_numpy(steps.init_model(
            cell, torch.Generator().manual_seed(3), "cpu"))
    dcn_tree = common.params_to_numpy(dcn_v2.init(
        base.get("dcn-v2").smoke_config(), torch.Generator().manual_seed(3),
        "cpu")[0])
    card = run_ranks(TR.gnn_mesh_rank, 4, ((2, 2), trees, "cuda:0"),
                     timeout_s=300)
    cpu = run_ranks(TR.gnn_mesh_rank, 4, ((2, 2), trees), timeout_s=300)
    rcard = run_ranks(TR.recsys_mesh_rank, 4, ((2, 2), dcn_tree, "cuda:0"),
                      timeout_s=300)
    rcpu = run_ranks(TR.recsys_mesh_rank, 4, ((2, 2), dcn_tree),
                     timeout_s=300)
    for r in range(4):
        for case in cpu[r]:
            c, h = card[r][case], cpu[r][case]
            assert c["wire"] == h["wire"] and c["staged"] > 0, case
            np.testing.assert_allclose(c["steps"], h["steps"], rtol=1e-5)
            for m in ("mu", "nu"):
                _mesh_leaves_close(c[m], h[m], f"{case} {m}")
        for shape, h in rcpu[r].items():
            c = rcard[r][shape]
            assert c["wire"] == h["wire"], shape
            if "steps" in h:
                np.testing.assert_allclose(c["steps"], h["steps"],
                                           rtol=1e-5)
                for m in ("mu", "nu"):
                    _mesh_leaves_close(c[m], h[m], f"{shape} {m}")
            elif "logits" in h:
                _mesh_leaves_close({"x": c["logits"]}, {"x": h["logits"]},
                                   shape)
            else:
                np.testing.assert_allclose(c["values"], h["values"],
                                           rtol=1e-5, atol=1e-5)
