"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` is served from three kinds of file, each
found by its name in the manifest, so a later change adds a cell, a
traffic mix or a metric by adding files and entries only:

- ``configs/<config>.json``: the deployment (the ``file`` of the
  configuration's entry);
- ``traffic/<traffic>.json``: the mix the clients send;
- ``metrics/<metric>.py``: one reader per metric, a ``read(run)`` that
  returns the metric's value or None when the run holds nothing for it,
  and optionally ``install(run)``, called in the set-up of a traced run.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    known = [w["name"] for w in manifest["workloads"]]
    raise KeyError(f"unknown workload {name!r} (known: {known})")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"unknown configuration {name!r}")


def traffic(name: str, bench: Path = BENCH) -> dict:
    with open(bench / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(manifest: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    without tracing, the per-layer ones with it; an entry with a
    ``workloads`` key only in the cells it lists."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str, bench: Path = BENCH):
    """The reader module of metric ``name`` (``metrics/<name>.py``)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
