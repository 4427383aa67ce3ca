"""``BENCHMARK.json`` against the rules its readers hold it to, and every
file it names found by name."""
from __future__ import annotations

import json
import re

import pytest

from bench_cpu import BENCH, ROOT
from harness import manifest

MAN = manifest.load(ROOT)
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\n\t]{1,200}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_size():
    assert set(MAN) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert manifest.NAME.match(entry["name"]), entry["name"]
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key]), (key, entry[key])
    if "unit" in entry:
        assert manifest.UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda e: e["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("bench/configs/")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert set(cfg["reduced"]) <= set(data["reduced"])
    assert all(manifest.NAME.match(k) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda e: e["name"])
def test_cells_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] in (1, 4)
    assert manifest.config(MAN, w["config"], ROOT)["n_nodes"] > 0
    tr = manifest.traffic(w["traffic"], BENCH)
    assert tr["kind"] == "reach" and tr["clients"] > 0
    assert tr["sources_per_query"] > 0 and tr["check"]["max_queries"] > 0
    e2e = manifest.metrics_for(MAN, w["name"], trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert manifest.metrics_for(MAN, w["name"], trace=True)


@pytest.mark.parametrize("m", METRICS, ids=lambda e: e["name"])
def test_metric_entries_and_readers(m):
    e2e = {e["name"] for e in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    base = {"name", "unit", "better", "source"}
    if m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == base | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == base | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
        reporting = set(moved.get("workloads", cells))
        assert set(m.get("workloads", cells)) <= reporting
    assert set(m.get("workloads", cells)) <= cells
    assert hasattr(manifest.reader(m["name"], BENCH), "read")


def test_one_layer_name_per_layer():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_setup_bound():
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        manifest.cell(MAN, "no-such.cell")
    with pytest.raises(FileNotFoundError):
        manifest.reader("no_such_metric", BENCH)
