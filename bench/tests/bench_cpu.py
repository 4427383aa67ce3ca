"""Small runs of the benchmark on the CPU for its tests: the harness
without its look for a card, the cell's files with the graph and the
warm-up cut to seconds."""
from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import cell, manifest  # noqa: E402
from harness.serving import Warmup  # noqa: E402

SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds may be
# four batches, no wait for a steady rate
WARMUP = Warmup(min_batches=4, min_seconds=0, quiet_batches=0,
                steady_bins=0, max_seconds=10, rewarm_batches=2)


def tiny_run(workload: str, n_nodes: int = 600, seconds: float = 1.0,
             trace: bool = False, control: dict | None = None,
             seed: int = SEED) -> dict:
    man = manifest.load(ROOT)
    c = manifest.cell(man, workload)
    cfg = manifest.config(man, c["config"], ROOT)
    cfg["n_nodes"] = n_nodes
    return cell.run_cell(man, workload, seed, seconds, trace,
                         torch.device("cpu"), t_start=time.perf_counter(),
                         config=cfg, control=control, warmup=WARMUP,
                         pool_sources=48)
