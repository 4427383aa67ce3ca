"""Run one phase of ``chip_smoke.py`` alone on the card: 3b (the open
loop with deltas, then one backlog served with overlap on and off), 7
(four gloo ranks sharing the card), 12
(MiniCPM-2B served on a ``(2, 2)`` mesh of gloo ranks), 14 (MiniCPM-2B
trained there, its state checkpointed and restored on ``(1, 4)`` and one
rank) or 15 (olmoe-1b-7b served and trained there). Builds the
kernels first, sets TF32 off, prints the card's name and power limit and
writes the phase's result to ``chiprun_out/phase<N>.json``.

    python3 scripts/chip_phase.py 15
    python3 scripts/chip_phase.py 3b

The body runs under ``if __name__ == "__main__"``: the spawned ranks
import this script again.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

PHASES = ("3b", "7", "12", "14", "15")


def main() -> int:
    phase = sys.argv[1] if len(sys.argv) > 1 else ""
    if phase not in PHASES:
        print(f"usage: chip_phase.py {{{','.join(PHASES)}}}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phase: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.binned_pull import binned_pull as bp
    from repro_torch.kernels.block_spmm import block_spmm as bs
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.msbfs_extend import msbfs_extend as mx

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    counters = {"binned_pull": bp.fused_binned_pull,
                "msbfs_extend": mx.msbfs_extend_blocks,
                "block_spmm": bs.block_spmm,
                "flash_attention": fa.flash_attention}
    before = {k: f.launches for k, f in counters.items()}

    def launched():
        return {k: f.launches - before[k] for k, f in counters.items()}

    t = time.perf_counter()
    if phase in ("3b", "7"):
        from repro_torch.graph.generators import PAPER_DATASETS

        csr = PAPER_DATASETS["ldbc"](cs.SCALE)
        oracle = cs.BFSOracle(csr)
        out = (cs.phase_7(csr, oracle) if phase == "7" else
               cs.phase_3b(dev, csr, oracle, dict.fromkeys(counters, 0)))
    elif phase == "12":
        out = cs.phase_12(dev)
    else:
        out = getattr(cs, f"phase_{phase}")(dev, launched)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"phase{phase}.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(f"phase {phase}: {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
