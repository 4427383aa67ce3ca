"""Time one tree's LM decode step on the card: MiniCPM-2B at full width in
bf16 (seeded weights), 4 prompts of 128 tokens prefilled on the scan
route into caches of 4,128 slots, then 2 x 32 greedy decode steps, each
timed on the host clock between synchronizations (the decode is host
bound). Prints one JSON line: the median, 10th and 90th percentile ms of
the steps after the first 8.

    python3 scripts/decode_step_ms.py [TREE]

``TREE`` (default: this checkout) is a directory holding ``src/``; to
compare two commits, unpack one with ``git archive`` and alternate the
two trees, one run after the other, on one card.
"""
import json
import sys
import time
from pathlib import Path

TREE = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1])
sys.path.insert(0, str(TREE / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import base  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_step_ms: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = base.get("minicpm-2b").full_config()
    model = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 128))).to(dev)
    ms = []
    for _ in range(2):
        last, caches = tfm.prefill(model, cfg, prompts, max_seq=4128,
                                   route="scan")
        tok = last[:, :cfg.vocab].argmax(-1, keepdim=True)
        for t in range(32):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, caches = tfm.decode(model, cfg, caches, tok, 128 + t)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            tok = out[:, 0, :cfg.vocab].argmax(-1, keepdim=True)
    warm = ms[8:]
    print(json.dumps({"tree": str(TREE), "median_ms": float(np.median(warm)),
                      "p10_ms": float(np.percentile(warm, 10)),
                      "p90_ms": float(np.percentile(warm, 90)),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
