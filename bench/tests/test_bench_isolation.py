"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``repro_torch`` begins with ``repro``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from bench_cpu import BENCH, ROOT
from harness import cell


def test_names_compared_whole():
    assert cell.forbidden_modules(["repro_torch", "repro_torch.core",
                                   "reprox", "jaxtyping", "numpy"]) == []
    assert cell.forbidden_modules(["repro.core.ife", "jax.numpy",
                                   "jaxlib", "flax.linen", "os"]) == [
        "flax", "jax", "jaxlib", "repro"]


SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import bench_cpu
from harness import cell, manifest
man = manifest.load(bench_cpu.ROOT)
for w in man["workloads"]:
    for m in man["end_to_end"] + man["per_layer"]:
        manifest.reader(m["name"], bench_cpu.BENCH)
r = bench_cpu.tiny_run("ldbc-knows-n160k.reach1-c128", n_nodes=400,
                       seconds=0.5, trace=True)
print(json.dumps({"bad": cell.forbidden_modules(), "correct": r["correct"],
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(BENCH / "tests")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    assert "repro_torch" in res["tops"] and res["correct"]


def test_harness_sources_import_no_jax():
    # a scan of the benchmark's own files, beside the run above
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in cell.FORBIDDEN, (path, line)
