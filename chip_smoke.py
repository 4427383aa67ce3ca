"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build the four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card:
   ``binned_pull`` for all five ops x visited none / partial / all, on the
   LDBC proxy's scale-10 pack and on a star and a hub fixture, and
   ``msbfs_extend`` on the scale-10 ``ShardedBlocks`` and ``KernelBlocks``
   with 64-lane frontiers at several densities, empty stripes included,
   both with ``torch.equal``; ``block_spmm`` on ragged columns with empty
   ones, F 64 and 256, float32 and bfloat16, and ``flash_attention`` at D
   16, 128 and 256, causal and full, within the tolerances of
   ``tests/test_torch_cuda.py`` (1e-5 for ``spmm``; 2e-5 in float32 and
   2e-2 in bfloat16 for attention);
3. serve the LDBC proxy at scale 10 through the closed-loop entry point
   (``repro_torch.launch.serve.main``) twice: ``--backend dopt_fused``
   with 8 sources per batch (nTkS, pulls through ``binned_pull``) and the
   default ``recommend`` with 64 sources per batch (nTkMS on
   ``block_mxu``, through ``msbfs_extend``). Every source's levels are
   checked against a BFS written here with scipy; each kernel's launch
   counter is set to 0 before its run and must be above 0 after it;
4. time ``binned_pull`` and ``msbfs_extend``, their plain versions and a
   one-call PyTorch yardstick (CUDA events) at the shapes the serve runs
   give them, and compute each bound from those inputs; then release
   every serve-run operand;
5. drive the op entry points of the GNN/LM kernels at full width, each
   kernel's launch counter set to 0 just before and read just after:
   ``spmm_blocks_from_csr(ldbc scale 10, block 128, normalize="mean")``
   and ``spmm`` on seeded float32 features ``[44928, 128]`` (122,958
   tiles, 8.06 GB), checked against the plain version (1e-5) and against
   an independent scipy float64 ``A^T X`` (1e-4); ``mha`` at MiniCPM-2B's
   width (B 1, H 36, S 4096, D 64, bfloat16, causal), checked against
   the plain version (2e-2); prints the phase's peak device memory;
6. time both at those shapes beside their plain versions, their bounds
   and a library yardstick: ``torch.sparse.mm`` on a CSR ``A^T`` of the
   same nonzeros (float32, TF32 off) and
   ``F.scaled_dot_product_attention(is_causal=True)``.

Prints the build times, each serve run's warm p50/p99, one ``{"kernels":
[...]}`` JSON line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SCALE = 10.0  # LDBC proxy scale: 44,860 nodes, 1,473,114 edges
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SPMM_FEAT = 128  # GNN hidden width of the spmm phase
MHA_SHAPE = (1, 36, 4096, 64)  # MiniCPM-2B: 36 MHA heads, d 64, train_4k
# (rtol, atol) of a kernel against its plain version
SPMM_TOL = (1e-5, 1e-5)  # float32 sums in another order than the plain one
ORACLE_TOL = 1e-4  # float32 kernel against a float64 oracle
# float32: summation order and the online softmax's rescaling; bfloat16: the
# float32 outputs, that close, may round once to neighbouring bfloat16
# values (2^-7 of the value apart at most), plus a floor for tiny outputs
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-3)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of CUDA-event time for ``reps`` back-to-back
    calls, per call (a warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if torch.equal(a, b):
        return 0.0
    x, y = a.double(), b.double()
    same = (x == y) | (torch.isnan(x) & torch.isnan(y))
    return float(torch.where(same, 0.0, (x - y).abs()).max())


class BFSOracle:
    """Level-synchronous BFS on scipy sparse products, one column per
    source: levels [k, n] int32, -1 = unreached."""

    def __init__(self, csr):
        from scipy.sparse import csr_matrix

        n = csr.n_nodes
        a = csr_matrix(
            (np.ones(csr.n_edges, np.float32), csr.indices, csr.indptr),
            shape=(n, n),
        )
        self.at = a.T.tocsr()
        self.n = n

    def levels(self, sources) -> np.ndarray:
        src = np.asarray(sources, np.int64)
        k = len(src)
        lv = np.full((self.n, k), -1, np.int32)
        cols = np.arange(k)
        lv[src, cols] = 0
        f = np.zeros((self.n, k), np.float32)
        f[src, cols] = 1.0
        visited = f > 0
        d = 0
        while f.any():
            d += 1
            new = ((self.at @ f) > 0) & ~visited
            visited |= new
            lv[new] = d
            f = new.astype(np.float32)
        return lv.T.copy()


def star_csr(n, csr_from_edges):
    dsts = np.arange(1, n - 8)
    return csr_from_edges(n, np.zeros_like(dsts), dsts)


def hub_csr(n, csr_from_edges, seed=0):
    rng = np.random.default_rng(seed)
    live = n - max(n // 8, 1)
    v = np.arange(1, live)
    srcs = np.concatenate([v, v, np.zeros(4, np.int64)])
    fan = rng.choice(np.arange(1, live), size=4, replace=False)
    dsts = np.concatenate([np.zeros_like(v), 1 + (v % (live - 1)), fan])
    return csr_from_edges(n, srcs, dsts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph import csr as gcsr
    from repro_torch.graph.generators import PAPER_DATASETS, powerlaw
    from repro_torch.graph.partition import padded_n
    from repro_torch.kernels import build
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.binned_pull.binned_pull import LANE_OPS, OPS
    from repro_torch.kernels.binned_pull.ops import (
        binned_pull,
        build_pack,
        pack_plan,
    )
    from repro_torch.kernels.block_spmm import block_spmm as bs_mod
    from repro_torch.kernels.block_spmm.ops import (
        spmm,
        spmm_blocks_from_csr,
        spmm_blocks_from_numpy,
    )
    from repro_torch.kernels.common import to_device
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.kernels.msbfs_extend.ops import (
        extend_blocks,
        prepare_kernel_blocks,
    )
    from repro_torch.launch import serve
    from repro_torch.runtime.service import unpack_levels

    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    # float32 products in full float32 (plain versions and yardsticks)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"phase 1: built {sorted(secs)} in "
          f"{time.perf_counter() - t0:.1f} s (per kernel: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(secs.items()))
          + ")", flush=True)

    # -- phase 2: kernels against their plain versions ----------------------
    t0 = time.perf_counter()
    csr = PAPER_DATASETS["ldbc"](SCALE)
    print(f"ldbc proxy scale {SCALE:g}: {csr.n_nodes} nodes, {csr.n_edges} "
          f"edges, max out-degree {int(csr.degrees.max())}", flush=True)
    rng = np.random.default_rng(0)
    names = ("binned_pull", "msbfs_extend", "block_spmm", "flash_attention")
    err = dict.fromkeys(names, 0.0)
    cases = dict.fromkeys(names, 0)

    def check(kernel, got, exp, what, tol=None):
        """Bitwise (``tol`` None) or within ``tol = (rtol, atol)``; returns
        the max abs error."""
        e = max_abs_err(got, exp)
        err[kernel] = max(err[kernel], e)
        cases[kernel] += 1
        ok = (torch.equal(got, exp) if tol is None else
              torch.allclose(got.float(), exp.float(), rtol=tol[0],
                             atol=tol[1]))
        if not ok:
            fail(f"{kernel} differs from its plain version on {what} "
                 f"(max abs err {e})")
        return e

    fixtures = [
        ("ldbc-10", csr),
        ("star", star_csr(5000, gcsr.csr_from_edges)),
        ("hub", hub_csr(3000, gcsr.csr_from_edges)),
    ]
    ldbc_pack = None
    for fname, g in fixtures:
        n_pad = padded_n(g.n_nodes, 1, 32)
        wts = np.random.default_rng(1).uniform(0.1, 2.0, g.n_edges)
        gw = gcsr.CSRGraph(g.indptr, g.indices, wts.astype(np.float32))
        pack = to_device(build_pack(gcsr.binned_rev_csr(gw, n_pad), n_pad),
                         dev)
        if fname == "ldbc-10":
            ldbc_pack = pack
        rows = pack.rows_local
        for op in OPS:
            for lanes in ((64, 3) if op in LANE_OPS else (1,)):
                shape = (n_pad, lanes) if op in LANE_OPS else (n_pad,)
                vshape = (rows, lanes) if op in LANE_OPS else (rows,)
                if op == "min_dist":
                    gsrc = torch.tensor(np.where(
                        rng.random(n_pad) < 0.3, rng.uniform(0, 9, n_pad),
                        np.inf).astype(np.float32), device=dev)
                    vlocs = {"none": None}
                else:
                    gsrc = torch.tensor(
                        (rng.random(shape) < 0.3).astype(np.uint8),
                        device=dev)
                    vlocs = {
                        "none": None,
                        "partial": torch.tensor(
                            (rng.random(vshape) < 0.4).astype(np.uint8),
                            device=dev),
                        "all": torch.ones(vshape, dtype=torch.uint8,
                                          device=dev),
                    }
                for vname, v in vlocs.items():
                    got = binned_pull(pack, gsrc, v, op=op)
                    exp = binned_pull(pack, gsrc, v, op=op, use_ref=True)
                    torch.cuda.synchronize()
                    check("binned_pull", got, exp,
                          f"{fname}/{op}/L{lanes}/vloc {vname}")
        del pack
    n_blk = padded_n(csr.n_nodes, 1, 128)
    sb = to_device(gcsr.sharded_blocks_from_csr(csr, n_blk, 1, 128), dev)
    kb = to_device(prepare_kernel_blocks(gcsr.blocks_from_csr(csr, 128)),
                   dev)
    g_blk = n_blk // 128
    print(f"block operands: {int(sb.blocks.shape[1])} ShardedBlocks tiles, "
          f"{int(kb.blocks.shape[0])} KernelBlocks tiles", flush=True)
    for bname, blocks, brows, bcols in (
        ("ShardedBlocks", sb.blocks[0], sb.block_rows[0], sb.block_cols[0]),
        ("KernelBlocks", kb.blocks, kb.block_rows, kb.block_cols),
    ):
        for density in (0.0, 0.001, 0.02, 0.3):
            f = (rng.random((g_blk, 128, 64)) < density).astype(np.uint8)
            f[::3] = 0  # every third stripe empty
            fl = torch.tensor(f, device=dev)
            got = extend_blocks(blocks, brows, bcols, fl, g_out=g_blk)
            exp = extend_blocks(blocks, brows, bcols, fl, g_out=g_blk,
                                use_ref=True)
            torch.cuda.synchronize()
            check("msbfs_extend", got, exp, f"{bname}/density {density}")
    del kb
    # block_spmm: a power-law graph's mean blocks without zero pads and
    # without columns 1 and 4, so columns are ragged and some are empty
    pl = powerlaw(3000, 6.0, seed=5)
    sbp = spmm_blocks_from_csr(pl, 128, "mean", device="cpu")
    keep = (sbp.blocks.flatten(1) != 0).any(dim=1).numpy()
    keep &= ~np.isin(sbp.block_cols.numpy(), (1, 4))
    sbp = spmm_blocks_from_numpy(sbp.blocks.numpy()[keep],
                                 sbp.block_rows.numpy()[keep],
                                 sbp.block_cols.numpy()[keep], dev)
    for feat in (64, 256):
        for dt in (torch.float32, torch.bfloat16):
            xs = torch.tensor(rng.standard_normal((sbp.g * 128, feat)),
                              dtype=torch.float32, device=dev).to(dt)
            sbd = type(sbp)(sbp.blocks.to(dt), sbp.block_rows,
                            sbp.block_cols, sbp.col_ptr)
            got = spmm(sbd, xs)
            exp = spmm(sbd, xs, use_ref=True)
            torch.cuda.synchronize()
            check("block_spmm", got, exp, f"power-law/F {feat}/{dt}",
                  SPMM_TOL)
    for d in (16, 64, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.tensor(rng.standard_normal((1, 4, 512, d)),
                                    dtype=torch.float32, device=dev).to(dt)
                       for _ in range(3))
            for causal in (True, False):
                got = mha(q, k, v, causal=causal)
                exp = mha(q, k, v, causal=causal, use_ref=True)
                torch.cuda.synchronize()
                check("flash_attention", got, exp,
                      f"D {d}/{dt}/causal {causal}", ATTN_TOL[dt])
    del sbp, sbd, xs, q, k, v, got, exp
    torch.cuda.empty_cache()
    print(f"phase 2: {cases['binned_pull']} binned_pull and "
          f"{cases['msbfs_extend']} msbfs_extend cases bitwise equal to the "
          f"plain versions, {cases['block_spmm']} block_spmm and "
          f"{cases['flash_attention']} flash_attention cases within "
          f"tolerance ({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- phase 3: the main path ---------------------------------------------
    oracle = BFSOracle(csr)
    runs = {
        "dopt_fused x8": (["--backend", "dopt_fused",
                           "--sources-per-batch", "8", "--batches", "6"],
                          "binned_pull"),
        "recommend x64": (["--sources-per-batch", "64", "--batches", "3"],
                          "msbfs_extend"),
    }
    launches = dict.fromkeys(names, 0)
    served = {}
    main_inputs = {}
    for rname, (extra, kernel) in runs.items():
        t0 = time.perf_counter()
        records = []

        def on_batch(r):
            n = csr.n_nodes
            packed = r.policy == "ntkms"
            lv = unpack_levels(r.result.state.levels.cpu().numpy(),
                               {"q": (0, len(r.sources))}, n, packed)["q"]
            ref = oracle.levels(r.sources)
            if not np.array_equal(lv, ref):
                bad = int((lv != ref).any(axis=1).sum())
                fail(f"{rname} batch {r.index}: levels of {bad} source(s) "
                     "differ from the BFS oracle")
            records.append((r.ms, r.cold, r.policy, len(r.sources)))
            if r.index == 0:
                main_inputs[kernel] = (r.sources, ref)

        bp_mod.fused_binned_pull.launches = 0
        mx_mod.msbfs_extend_blocks.launches = 0
        rc = serve.main(["--closed-loop", "--device", str(dev),
                         "--dataset", "ldbc", "--scale", str(SCALE), *extra],
                        on_batch=on_batch)
        counts = {"binned_pull": bp_mod.fused_binned_pull.launches,
                  "msbfs_extend": mx_mod.msbfs_extend_blocks.launches}
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"serve run {rname} exited {rc}")
        if counts[kernel] <= 0:
            fail(f"serve run {rname} never launched {kernel}: {counts}")
        for k, v in counts.items():
            launches[k] += v
        warm = [ms for ms, cold, _, _ in records if not cold]
        served[rname] = {
            "batches": len(records),
            "sources_per_batch": records[0][3],
            "policies": sorted({p for _, _, p, _ in records}),
            "warm_batches": len(warm),
            "warm_p50_ms": float(np.percentile(warm, 50)) if warm else None,
            "warm_p99_ms": float(np.percentile(warm, 99)) if warm else None,
            "cold_ms": float(sum(ms for ms, cold, _, _ in records if cold)),
            "launches": counts,
            "seconds": time.perf_counter() - t0,
        }
        print(f"phase 3: {rname}: " + json.dumps(served[rname]), flush=True)
        torch.cuda.empty_cache()

    # -- phase 4: timings at the main path's shapes --------------------------
    # binned_pull: the dense pull of one nTkS morsel of the first served
    # batch at BFS level 2, where the direction switch pulls
    n = csr.n_nodes
    rows = ldbc_pack.rows_local
    src1, lv1 = main_inputs["binned_pull"]
    level = 2
    front = np.zeros(rows, np.uint8)
    front[:n] = lv1[0] == level
    vis = np.zeros(rows, np.uint8)
    vis[:n] = (lv1[0] >= 0) & (lv1[0] <= level)
    gsrc = torch.tensor(front, device=dev)
    vloc = torch.tensor(vis, device=dev)
    plan = pack_plan(ldbc_pack)
    wpos = np.zeros(plan.rbp, np.int64)
    for b, w in enumerate(plan.widths):
        wpos[plan.astarts[b]: plan.astarts[b] + plan.rows_pad[b]] = w
    widths = wpos[ldbc_pack.inv_pad[0].cpu().numpy()]  # per local row
    need_slots = int(widths[vis == 0].sum())  # visited rows read nothing
    # slab ids of unvisited rows, the source mask, vloc and perm_pad in;
    # one byte per row out
    bp_bytes = (4 * need_slots + gsrc.numel() + vloc.numel()
                + 4 * plan.rbp + rows)
    bp_ops = need_slots  # one compare per slot
    bp = {
        "ms": time_ms(lambda: binned_pull(ldbc_pack, gsrc, vloc, op="reach")),
        "plain_ms": time_ms(lambda: binned_pull(
            ldbc_pack, gsrc, vloc, op="reach", use_ref=True), reps=5),
        "bound_ms": max(bp_bytes / HBM_BYTES_PER_S,
                        bp_ops / INT8_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if bp_bytes / HBM_BYTES_PER_S
                     >= bp_ops / INT8_OPS_PER_S else "operations"),
        "library_ms": None,
        "shape": f"op reach, gsrc [{gsrc.numel()}] u8, vloc [{rows}] u8, "
                 f"{len(plan.widths)} slabs, {int(widths.sum())} slots "
                 f"({need_slots} of unvisited rows)",
    }

    # msbfs_extend: the 64-lane frontier of the first nTkMS batch at level 2
    src2, lv2 = main_inputs["msbfs_extend"]
    fl = np.zeros((n_blk, 64), np.uint8)
    fl[:n, : len(src2)] = (lv2 == level).T
    lanes_t = torch.tensor(fl, device=dev).view(g_blk, 128, 64)
    blocks, brows, bcols = sb.blocks[0], sb.block_rows[0], sb.block_cols[0]
    act = (lanes_t != 0).any(dim=2).any(dim=1)
    valid = bcols < g_blk
    active_tiles = int((act[brows.long()] & valid).sum())
    nb = int(blocks.shape[0])
    # tiles under an active stripe, every tile's coordinates and the lane
    # mask in; the reach mask out
    mx_bytes = active_tiles * 128 * 128 + 8 * nb + 2 * lanes_t.numel()
    mx_ops = active_tiles * 2 * 128 * 128 * 64
    stripes = lanes_t[brows.long()].to(torch.bfloat16)  # [nb, B, L]
    a_t = blocks.to(torch.bfloat16).transpose(1, 2)  # [nb, B(v), B(u)]
    mx = {
        "ms": time_ms(lambda: extend_blocks(blocks, brows, bcols, lanes_t,
                                            g_out=g_blk), reps=5),
        "plain_ms": time_ms(lambda: extend_blocks(
            blocks, brows, bcols, lanes_t, g_out=g_blk, use_ref=True),
            reps=2, rounds=3),
        "bound_ms": max(mx_bytes / HBM_BYTES_PER_S,
                        mx_ops / INT8_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if mx_bytes / HBM_BYTES_PER_S
                     >= mx_ops / INT8_OPS_PER_S else "operations"),
        "library_ms": time_ms(lambda: torch.bmm(a_t, stripes), reps=2,
                              rounds=3),
        "shape": f"{nb} tiles of 128x128 int8 ({active_tiles} with an "
                 f"active stripe), lanes [{g_blk}, 128, 64] u8",
    }
    del stripes, a_t, lanes_t, blocks, brows, bcols, act, valid, sb
    del ldbc_pack, gsrc, vloc, main_inputs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4: serve operands released, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB still allocated",
          flush=True)

    # -- phase 5: the GNN and LM kernels' entry points at full width ------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n_pad = padded_n(n, 1, 128)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n_pad, SPMM_FEAT), generator=gen, device=dev)
    x[n:] = 0
    qkv = [torch.randn(MHA_SHAPE, generator=gen, device=dev,
                       dtype=torch.bfloat16) for _ in range(3)]
    torch.cuda.synchronize()
    bs_mod.block_spmm.launches = 0
    fa_mod.flash_attention.launches = 0
    t1 = time.perf_counter()
    sbs = spmm_blocks_from_csr(csr, 128, "mean", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    y = spmm(sbs, x)
    o = mha(*qkv, causal=True)
    torch.cuda.synchronize()
    launches["block_spmm"] = bs_mod.block_spmm.launches
    launches["flash_attention"] = fa_mod.flash_attention.launches
    for kname in ("block_spmm", "flash_attention"):
        if launches[kname] <= 0:
            fail(f"the entry points never launched {kname}: {launches}")
    if y.shape != x.shape or not torch.isfinite(y).all():
        fail("spmm: output not finite or of the wrong shape")
    if o.shape != qkv[0].shape or not torch.isfinite(o).all():
        fail("mha: output not finite or of the wrong shape")
    s_err = check("block_spmm", y, spmm(sbs, x, use_ref=True),
                  "ldbc-10 mean F 128", SPMM_TOL)
    a_err = check("flash_attention", o, mha(*qkv, causal=True, use_ref=True),
                  f"MiniCPM {MHA_SHAPE} bf16 causal",
                  ATTN_TOL[torch.bfloat16])
    # the same inputs in float32 (the kernel's tiling and masking are those
    # of the bfloat16 run) held at the float32 band: a late row's output is
    # a few hundredths, so a mis-weighted tile shows here and may not at
    # the bfloat16 band
    qkv32 = [t.float() for t in qkv]
    a32_err = check("flash_attention", mha(*qkv32, causal=True),
                    mha(*qkv32, causal=True, use_ref=True),
                    f"MiniCPM {MHA_SHAPE} float32 causal",
                    ATTN_TOL[torch.float32])
    del qkv32
    # an oracle outside the port: scipy float64 A^T X over the edge list
    from scipy.sparse import csr_matrix

    src, dst = csr.edge_list()
    deg_in = np.bincount(dst, minlength=n).astype(np.float64)
    w_mean = 1.0 / deg_in[dst]
    at = csr_matrix((w_mean, (dst, src)), shape=(n, n))
    x_host = x[:n].double().cpu().numpy()
    oracle = at @ x_host
    o_err = float(np.abs(y[:n].double().cpu().numpy() - oracle).max())
    if not np.allclose(y[:n].cpu().numpy(), oracle, rtol=ORACLE_TOL,
                       atol=ORACLE_TOL):
        fail(f"spmm differs from the scipy oracle (max abs err {o_err})")
    nb = int(sbs.blocks.shape[0])
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 5: spmm on {nb} tiles (blocks built in {build_s:.2f} s) "
          f"and mha {MHA_SHAPE} bf16 causal: {launches['block_spmm']} and "
          f"{launches['flash_attention']} launches; max abs err from the "
          f"plain versions: spmm {s_err:.3g}, mha bf16 {a_err:.3g}, mha on "
          f"the same inputs in float32 {a32_err:.3g}; spmm {o_err:.3g} from "
          f"the float64 oracle; peak "
          f"device memory {peak / 1e9:.3f} GB "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- phase 6: timings of the GNN and LM kernels --------------------------
    bsz = 128
    nnz = sum(int(torch.count_nonzero(sbs.blocks[i: i + 8192]))
              for i in range(0, nb, 8192))
    # every tile, its row id, the column offsets, x in and y out
    sp_bytes = (4 * nb * bsz * bsz + 4 * nb + 8 * (sbs.g + 1)
                + 2 * 4 * n_pad * SPMM_FEAT)
    sp_ops = 2 * nnz * SPMM_FEAT  # one multiply-add per stored nonzero
    crow = np.zeros(n_pad + 1, np.int64)
    crow[1:] = np.cumsum(np.bincount(dst, minlength=n_pad))
    order = np.argsort(dst, kind="stable")
    at_t = torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(src[order].astype(np.int64)),
        torch.from_numpy(w_mean[order].astype(np.float32)),
        size=(n_pad, n_pad), check_invariants=True).to(dev)
    if not torch.allclose(torch.sparse.mm(at_t, x), y, rtol=ORACLE_TOL,
                          atol=ORACLE_TOL):
        fail("the torch.sparse.mm yardstick computes another function")
    sp = {
        "ms": time_ms(lambda: spmm(sbs, x), reps=5),
        "plain_ms": time_ms(lambda: spmm(sbs, x, use_ref=True), reps=2,
                            rounds=3),
        "bound_ms": max(sp_bytes / HBM_BYTES_PER_S,
                        sp_ops / F32_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if sp_bytes / HBM_BYTES_PER_S
                     >= sp_ops / F32_OPS_PER_S else "operations"),
        "library_ms": time_ms(lambda: torch.sparse.mm(at_t, x), reps=5),
        "shape": f"{nb} tiles of 128x128 f32 ({nnz} nonzeros), x "
                 f"[{n_pad}, {SPMM_FEAT}] f32; library torch.sparse.mm on "
                 f"a CSR A^T, TF32 off",
    }
    del at_t, sbs, x, y
    torch.cuda.empty_cache()
    b, h, s_len, d = MHA_SHAPE
    pairs = s_len * (s_len + 1) // 2  # causal (query, key) pairs
    fa_ops = 4 * d * pairs * b * h  # two products, a multiply-add each
    fa_bytes = 4 * 2 * qkv[0].numel()  # q, k, v in and o out, bf16
    fa = {
        "ms": time_ms(lambda: mha(*qkv, causal=True), reps=5),
        "plain_ms": time_ms(lambda: mha(*qkv, causal=True, use_ref=True),
                            reps=2, rounds=3),
        "bound_ms": max(fa_bytes / HBM_BYTES_PER_S,
                        fa_ops / BF16_OPS_PER_S) * 1e3,
        "bound_by": ("bytes" if fa_bytes / HBM_BYTES_PER_S
                     >= fa_ops / BF16_OPS_PER_S else "operations"),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *qkv, is_causal=True), reps=5),
        "shape": f"q, k, v {list(MHA_SHAPE)} bf16, causal; library "
                 "F.scaled_dot_product_attention",
    }
    del qkv, o
    kernels = [
        {"name": "binned_pull", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/binned_pull.cu",
         "replaces": "src/repro/kernels/binned_pull/binned_pull.py:198",
         "launches": launches["binned_pull"],
         "max_abs_err": err["binned_pull"], **bp},
        {"name": "msbfs_extend", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/msbfs_extend.cu",
         "replaces": "src/repro/kernels/msbfs_extend/msbfs_extend.py:73",
         "launches": launches["msbfs_extend"],
         "max_abs_err": err["msbfs_extend"], **mx},
        {"name": "block_spmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/block_spmm.cu",
         "replaces": "src/repro/kernels/block_spmm/block_spmm.py:48",
         "launches": launches["block_spmm"],
         "max_abs_err": err["block_spmm"], **sp},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:77",
         "launches": launches["flash_attention"],
         "max_abs_err": err["flash_attention"], **fa},
    ]
    for k in kernels:
        print(f"timed: {k['name']}: {k['ms']:.4f} ms (plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}, library {k['library_ms']}) at {k['shape']}",
              flush=True)
    for rname, s in served.items():
        print(f"serve {rname}: warm p50 {s['warm_p50_ms']} ms, warm p99 "
              f"{s['warm_p99_ms']} ms over {s['warm_batches']} warm "
              f"batch(es)")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
