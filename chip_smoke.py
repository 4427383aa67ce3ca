"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card with
   ``torch.equal``: ``binned_pull`` for all five ops x visited none /
   partial / all, on the LDBC proxy's scale-10 pack and on a star and a
   hub fixture; ``msbfs_extend`` on the scale-10 ``ShardedBlocks`` and
   ``KernelBlocks`` with 64-lane frontiers at several densities, empty
   stripes included;
3. serve the LDBC proxy at scale 10 through the closed-loop entry point
   (``repro_torch.launch.serve.main``) twice: ``--backend dopt_fused``
   with 8 sources per batch (nTkS, pulls through ``binned_pull``) and the
   default ``recommend`` with 64 sources per batch (nTkMS on
   ``block_mxu``, through ``msbfs_extend``). Every source's levels are
   checked against a BFS written here with scipy; each kernel's launch
   counter is set to 0 before its run and must be above 0 after it;
4. time each kernel, its plain version and a one-call PyTorch yardstick
   (CUDA events) at the shapes the main path gives it, and compute its
   bound from those inputs.

Prints the build times, each serve run's warm p50/p99, one ``{"kernels":
[...]}`` JSON line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
    from repro_torch.graph.generators import PAPER_DATASETS
    from repro_torch.graph.partition import padded_n
    from repro_torch.kernels import build
    from repro_torch.kernels.binned_pull import binned_pull as bp_mod
    from repro_torch.kernels.binned_pull.binned_pull import LANE_OPS, OPS
    from repro_torch.kernels.binned_pull.ops import (
        binned_pull,
        build_pack,
        pack_plan,
    )
    from repro_torch.kernels.common import to_device
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx_mod
    from repro_torch.kernels.msbfs_extend.ops import (
        extend_blocks,
        prepare_kernel_blocks,
    )
    from repro_torch.launch import serve
    from repro_torch.runtime.service import unpack_levels

    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
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
    err = {"binned_pull": 0.0, "msbfs_extend": 0.0}
    cases = {"binned_pull": 0, "msbfs_extend": 0}

    def check(kernel, got, exp, what):
        e = max_abs_err(got, exp)
        err[kernel] = max(err[kernel], e)
        cases[kernel] += 1
        if not torch.equal(got, exp):
            fail(f"{kernel} differs from its plain version on {what} "
                 f"(max abs err {e})")

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
    torch.cuda.empty_cache()
    print(f"phase 2: {cases['binned_pull']} binned_pull and "
          f"{cases['msbfs_extend']} msbfs_extend cases bitwise equal to the "
          f"plain versions ({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- phase 3: the main path ---------------------------------------------
    oracle = BFSOracle(csr)
    runs = {
        "dopt_fused x8": (["--backend", "dopt_fused",
                           "--sources-per-batch", "8", "--batches", "6"],
                          "binned_pull"),
        "recommend x64": (["--sources-per-batch", "64", "--batches", "3"],
                          "msbfs_extend"),
    }
    launches = {"binned_pull": 0, "msbfs_extend": 0}
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
    del stripes, a_t
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
    ]
    for k in kernels:
        print(f"phase 4: {k['name']}: {k['ms']:.4f} ms (plain "
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
