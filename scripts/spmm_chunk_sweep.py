"""Time ``spmm`` on the card for several chunk limits of its work list.

    python3 scripts/spmm_chunk_sweep.py [--scale 10] [--feat 128]

Builds ``spmm_blocks_from_csr(ldbc proxy, block 128, normalize="mean")``
on the GPU, then for each chunk limit builds the compacted view
(``compact_blocks(..., chunk=c)``) and times one launch of the kernel
(``block_spmm``, which is what ``spmm`` calls on the card) on seeded
float32 features with CUDA events (median of 5 rounds of 10 calls), each
result checked within 1e-5 of the first limit's (the partial sums group
the terms differently). Prints one JSON object per limit
and, last, the card's name and power limit. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CHUNKS = (64, 128, 192, 256, 384, 512, 1024, 4096)


def time_ms(fn, reps=10, rounds=5):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--feat", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spmm_chunk_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph.generators import PAPER_DATASETS
    from repro_torch.kernels.block_spmm.block_spmm import block_spmm
    from repro_torch.kernels.block_spmm.ops import (
        compact_blocks,
        spmm_blocks_from_csr,
    )

    dev = torch.device("cuda", 0)
    csr = PAPER_DATASETS["ldbc"](args.scale)
    sb = spmm_blocks_from_csr(csr, 128, "mean", device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((sb.g * 128, args.feat), generator=gen, device=dev)
    x[csr.n_nodes:] = 0
    first = None
    for chunk in CHUNKS:
        nz = compact_blocks(sb.blocks, sb.block_rows, sb.block_cols, sb.g,
                            chunk=chunk)
        y = block_spmm(nz, x)
        if first is None:
            first = y
        elif not torch.allclose(y, first, rtol=1e-5, atol=1e-5):
            print(f"spmm_chunk_sweep: chunk {chunk} differs", file=sys.stderr)
            return 1
        print(json.dumps({
            "chunk": chunk,
            "ms": time_ms(lambda: block_spmm(nz, x)),
            "items": int(nz.items.shape[0]),
            "split_destinations": int(nz.splits.shape[0]),
            "partial_rows": nz.n_slots,
            "nnz": int(nz.nz_src.numel()),
            "feat": args.feat,
            "scale": args.scale,
        }), flush=True)
        del nz, y
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
