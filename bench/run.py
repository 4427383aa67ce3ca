"""The serving benchmark of ``repro_torch``: one run of one cell.

    python3 bench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
The cell's configuration, traffic mix and metric readers are found by
name (``harness/manifest.py``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit, as the last lines
of standard error also give them. With no card, too few cards, or JAX
loaded, it prints no result and exits non-zero.

``--control max_deg=<k>`` runs the program with its adjacency cut to
``k`` neighbours a node, a path that breaks the configuration's exact
levels; its runs must come out not correct.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))
# kernel and compiler caches stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None, metavar="max_deg=K")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness import cell, manifest

    man = manifest.load(ROOT)
    spec = manifest.cell(man, args.workload)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(spec["chips"]):
        print(f"bench: {args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    control = None
    if args.control:
        key, _, value = args.control.partition("=")
        if key != "max_deg" or not value.isdigit():
            print(f"bench: unknown control {args.control!r}",
                  file=sys.stderr)
            return 2
        control = {"max_deg": int(value)}
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = cell.run_cell(man, args.workload, args.seed, args.seconds,
                           bool(args.trace), device, t_start=T_START,
                           control=control)
    bad = cell.forbidden_modules()
    if bad:
        print(f"bench: JAX modules loaded in the serving process: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result["info"]), file=sys.stderr)
    for name, c in result["checks"].items():
        lim = (f"limit {c['limit']}" if "limit" in c
               else f"at least {c['min']}")
        print(f"check {name} {c['value']} {lim}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
