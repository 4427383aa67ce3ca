"""Time ``binned_pull`` on the card for several row-class boundaries.

    python3 scripts/binned_pull_sweep.py [--scale 10]

Builds the LDBC proxy's binned pull pack on the GPU and two ``reach``
inputs: the level-2 frontier and visited set of a BFS from one seeded
source (the pull the direction switch makes) and the full pass (the same
frontier, no visited rows). For each number of slots a thread takes in
a row below the hub width (the row's thread group is the power of two,
at most a warp, that leaves each about that many), hub width (rows at
least this wide are cut into chunks) and chunk size, it builds a launch
record (``make_record(..., hub_width=, chunk=, row_slots=)``), checks
both outputs bitwise against the defaults' (``ROW_SLOTS``,
``HUB_WIDTH``, ``CHUNK``), and times one launch of the kernel
(``fused_binned_pull``, what ``binned_pull`` calls on the card) as the
device time per call of 20 calls captured in a CUDA graph and as the
kernel's own duration from ``torch.profiler`` (the helpers of
``chip_smoke.py``). Prints one JSON object per configuration and, last,
the card's name and power limit. Needs an NVIDIA GPU.
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
ROW_SLOTS = (1, 2, 4, 8, 16)
HUB_WIDTHS = (512, 1024, 2048, 4096)
CHUNKS = (1024, 2048, 4096)
NO_HUBS = 1 << 30  # no row is cut into chunks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("binned_pull_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import BFSOracle, graph_ms, kernel_us
    from repro_torch.graph import csr as gcsr
    from repro_torch.graph.generators import PAPER_DATASETS, pick_sources
    from repro_torch.graph.partition import padded_n
    from repro_torch.kernels.binned_pull import binned_pull as bp
    from repro_torch.kernels.binned_pull.ops import (
        build_pack,
        launch_record,
    )
    from repro_torch.kernels.common import to_device

    dev = torch.device("cuda", 0)
    csr = PAPER_DATASETS["ldbc"](args.scale)
    n_pad = padded_n(csr.n_nodes, 1, 32)
    pack = to_device(build_pack(gcsr.binned_rev_csr(csr, n_pad), n_pad), dev)
    base = launch_record(pack)
    src = pick_sources(csr, 1, seed=0)
    lv = BFSOracle(csr).levels(src)[0]
    level = 2
    front = np.zeros(n_pad, np.uint8)
    front[:csr.n_nodes] = lv == level
    vis = np.zeros(n_pad, np.uint8)
    vis[:csr.n_nodes] = (lv >= 0) & (lv <= level)
    gsrc = torch.tensor(front, device=dev)
    inputs = {"level2": torch.tensor(vis, device=dev), "full": None}
    expect = {k: bp.fused_binned_pull(base, "reach", gsrc, v)
              for k, v in inputs.items()}
    default = (bp.ROW_SLOTS, bp.HUB_WIDTH, bp.CHUNK)
    configs = [(r, h, c) for r in ROW_SLOTS for h in HUB_WIDTHS
               for c in CHUNKS]
    configs.append((bp.ROW_SLOTS, NO_HUBS, bp.CHUNK))
    for row_slots, hub_width, chunk in configs:
        rec = bp.make_record(base.plan, base.slabs, base.wslabs,
                             base.perm_pad, base.inv_pad, hub_width=hub_width,
                             chunk=chunk, row_slots=row_slots)
        row = {"row_slots": row_slots,
               "hub_width": None if hub_width == NO_HUBS else hub_width,
               "chunk": chunk, "blocks": rec.tasks[False, False][1],
               "hub_chunks": rec.n_parts,
               "default": (row_slots, hub_width, chunk) == default}
        for name, v in inputs.items():
            call = lambda: bp.fused_binned_pull(rec, "reach", gsrc, v)
            ms, got = graph_ms(call)
            if not torch.equal(got, expect[name]):
                print(f"binned_pull_sweep: {row} differs on {name}",
                      file=sys.stderr)
                return 1
            row[f"{name}_graph_us"] = ms * 1e3
            row[f"{name}_kernel_us"] = kernel_us(call, "binned_pull_kernel")
        print(json.dumps(row), flush=True)
        del rec
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
