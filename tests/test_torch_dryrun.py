"""The port's roofline and dry-run (``launch/hlo_analysis.py``,
``launch/dryrun.py``) against the JAX package's.

- ``collective_stats`` on records of the ops in
  ``tests/test_system.py::test_hlo_collective_parser`` gives JAX's
  ``parse_collectives`` counts, result bytes and ring-weighted wire bytes;
  a ``Wire``'s records by kind feed it.
- ``roofline_terms`` equals JAX's on the same inputs, each term scaled by
  the ratio of the two hardware constants (H100 against the TPU model).
- ``dryrun --list`` prints JAX's list.
- ``run_cell`` writes records with JAX's keys and ``status: ok``: a card
  run on the CPU (a cut cell) and the analytic ``single``/``multi``
  layouts; a cell still unported on a mesh (an LM train cell on the
  card) records its ``NotImplementedError`` and the run carries on;
  ``--components`` is refused on ``--mesh card``. The LM cells' records
  are held in ``test_torch_lm_dryrun.py``.
- The GNN and recsys cells' records on ``single``/``multi``: status
  ``ok``, analytic (``measured`` false), argument bytes under the
  specs, the family's collective schedule in the roofline, and
  ``ogb_products`` recorded with its per-edge tensors; a GNN cell's
  ``card`` record on the CPU at a cut size.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as jha
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch.mesh import WireStats

ROOT = Path(__file__).resolve().parents[1]
ARCH = "paper-bfs-engine"

#: the ops of test_system.py's HLO, as a Wire records them
HLO = """
  %ag = f32[16,1024]{1,0} all-gather(f32[1,1024] %x), replica_groups=[32,16]<=[512], dimensions={0}
  %ar = bf16[128]{0} all-reduce(bf16[128] %y), replica_groups={{0,1,2,3}}, to_apply=%add
  ROOT %cp = u32[64]{0} collective-permute(u32[64] %z), source_target_pairs={{0,1}}
  %rs = f32[8]{0} reduce-scatter(f32[128] %w), replica_groups=[32,16]<=[512], dimensions={0}
"""
RECORDS = {"all-gather": {16: [1, 16 * 1024 * 4]},
           "all-reduce": {4: [1, 128 * 2]},
           "collective-permute": {2: [1, 64 * 4]},
           "reduce-scatter": {16: [1, 8 * 4]}}

#: JAX's record keys (repro.launch.dryrun.run_cell) the port keeps
RECORD_KEYS = {"arch", "shape", "mesh", "status", "tag", "kind", "notes",
               "n_devices", "memory", "cost", "collective_counts",
               "collective_out_bytes", "collective_wire_bytes", "roofline",
               "fits_80g_hbm"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "generated_code_size_in_bytes", "total_bytes_per_device"}


def test_collective_stats_matches_jax_parser():
    want = jha.parse_collectives(HLO)
    got = ha.collective_stats(RECORDS)
    assert got.counts == want.counts
    assert got.out_bytes == want.out_bytes
    assert got.wire_bytes == want.wire_bytes
    assert got.total_wire_bytes == want.total_wire_bytes
    # a Wire's own records (WireStats.by_kind) read the same, and stay
    # JSON-ready as the rest of the stats
    w = WireStats()
    for kind, groups in RECORDS.items():
        for k, (calls, b) in groups.items():
            w.record(kind, b, k)
    assert w.by_kind == RECORDS
    assert ha.collective_stats(w).wire_bytes == want.wire_bytes
    json.dumps(dataclasses.asdict(w))
    w.reset()
    assert w.by_kind == {} and w.calls == 0


@pytest.mark.parametrize("cost,flops_total", [
    ({"flops": 1e12, "bytes accessed": 1e9}, 2.56e14),  # compute bound
    ({"flops": 1e9, "bytes accessed": 5e11}, 1e12),  # memory bound
    ({"flops": 1e6, "bytes accessed": 1e6}, 1e9),  # collective bound
])
def test_roofline_terms_scale_jax_by_the_card_constants(cost, flops_total):
    coll = jha.parse_collectives(HLO)
    j = jha.roofline_terms(cost, coll, 256, flops_total, iters_scale=2.0)
    t = ha.roofline_terms(cost, ha.collective_stats(RECORDS), 256,
                          flops_total, iters_scale=2.0)
    assert (t.flops, t.hbm_bytes, t.wire_bytes, t.model_flops_per_device,
            t.iters_scale) == (j.flops, j.hbm_bytes, j.wire_bytes,
                               j.model_flops_per_device, j.iters_scale)
    assert t.useful_fraction == j.useful_fraction
    assert t.compute_s == pytest.approx(
        j.compute_s * jha.PEAK_FLOPS / ha.PEAK_FLOPS, rel=1e-12)
    assert t.memory_s == pytest.approx(
        j.memory_s * jha.HBM_BW / ha.HBM_BW, rel=1e-12)
    assert t.collective_s == pytest.approx(
        j.collective_s * jha.ICI_BW / ha.NVLINK_BW, rel=1e-12)
    assert t.bound_s == max(t.compute_s, t.memory_s, t.collective_s)
    assert t.roofline_fraction == pytest.approx(
        t.model_flops_per_device / ha.PEAK_FLOPS / t.bound_s, rel=1e-12)
    assert set(t.as_dict()) == set(j.as_dict())
    assert (ha.PEAK_FLOPS, ha.HBM_BW, ha.NVLINK_BW) == (989e12, 3.35e12,
                                                        450e9)


def test_dryrun_list_matches_jax():
    """Both CLIs in fresh processes (the registry's order follows import
    history)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = []
    for pkg in ("repro", "repro_torch"):
        r = subprocess.run([sys.executable, "-m", f"{pkg}.launch.dryrun",
                            "--list"], env=env, capture_output=True,
                           text=True, timeout=120, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        out.append(r.stdout)
    assert out[0] == out[1]
    assert f"{ARCH:28s} graph500_28\n" in out[1]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def test_cpu_card_record_has_jax_keys(tmp_path):
    keep = {}
    rec = dryrun.run_cell(ARCH, "ldbc100", "card", str(tmp_path),
                          device="cpu", cut={"n_nodes": 2000}, keep=keep)
    assert rec["status"] == "ok", rec.get("traceback")
    assert RECORD_KEYS <= set(rec) and set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == set(
        jha.Roofline(0, 0, 0, 1, 1, 1, 0, 1).as_dict())
    assert _load(tmp_path / f"{ARCH}__ldbc100__card.json") == json.loads(
        json.dumps(rec, default=float))
    assert rec["measured"] and rec["n_devices"] == 1
    assert rec["reduced"] == {"n_nodes": 2000}
    # one rank moves nothing over a wire
    assert rec["collective_counts"] == {} and rec["device"] == "cpu"
    assert rec["memory"]["total_bytes_per_device"] is None  # no card here
    assert rec["memory"]["argument_size_in_bytes"] == \
        keep["bound"].argument_bytes
    assert len(rec["wall_ms_runs"]) == dryrun.REPS
    assert rec["wall_ms"] == sorted(rec["wall_ms_runs"])[dryrun.REPS // 2]
    res = keep["result"]
    assert rec["iterations"] == res.iterations.tolist()
    assert rec["n_nodes"] == 2000 and rec["n_edges_cut"] <= \
        rec["n_edges_generated"]
    # edges scanned: every row's cut out-degree once a trip it is active
    lv = res.state.levels[0].numpy()
    deg = np.diff(keep["bound"].csr.indptr)
    it = rec["iterations"][0]
    want = sum(int(deg[u]) * len({int(x) for x in lv[u] if x < it})
               for u in range(2000))
    assert rec["edges_scanned"] == want > 0
    assert rec["roofline"]["iters_scale"] == 32.0
    cached = dryrun.run_cell(ARCH, "ldbc100", "card", str(tmp_path),
                             device="cpu", cut={"n_nodes": 2000})
    assert cached["wall_ms"] == rec["wall_ms"]  # read back, not rerun


def test_card_record_binds_a_graph_made_beforehand(tmp_path):
    from repro_torch.launch.steps import paper_graph

    made = {}
    rec = dryrun.run_cell(ARCH, "ldbc100", "card", str(tmp_path),
                          device="cpu", cut={"n_nodes": 2000}, keep=made)
    given = {}
    csr = paper_graph("ldbc100", 2000)
    rec2 = dryrun.run_cell(ARCH, "ldbc100", "card", str(tmp_path),
                           force=True, device="cpu", cut={"n_nodes": 2000},
                           keep=given, csr=csr)
    assert rec2["status"] == "ok", rec2.get("traceback")
    for k in ("n_nodes", "n_edges_generated", "n_edges_cut", "iterations",
              "edges_scanned"):
        assert rec2[k] == rec[k], k
    assert all(torch.equal(a, b) for a, b in zip(
        made["result"].state, given["result"].state))
    bad = dryrun.run_cell(ARCH, "ldbc100", "card", str(tmp_path),
                          force=True, device="cpu", cut={"n_nodes": 2048},
                          csr=csr)
    assert bad["status"] == "error" and "2000 nodes" in bad["error"]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_layout_records_are_analytic(mesh, tmp_path):
    for shape in ("ldbc100", "graph500_28"):
        rec = dryrun.run_cell(ARCH, shape, mesh, str(tmp_path))
        assert rec["status"] == "ok", rec.get("traceback")
        assert RECORD_KEYS <= set(rec) and set(rec["memory"]) == MEMORY_KEYS
        assert rec["measured"] is False
        assert rec["memory"]["temp_size_in_bytes"] is None
        for k in ("collective_counts", "collective_out_bytes",
                  "collective_wire_bytes"):
            assert rec[k] is None
        d = rec["decisions"]
        assert rec["n_devices"] == (512 if mesh == "multi" else 256)
        assert d["source_shards"] == (32 if mesh == "multi" else 16)
        assert d["graph_shards"] == 16
        rows = d["n_pad"] // 16
        state_rows = rows if d["state_layout"] == "sharded" else d["n_pad"]
        assert rec["memory"]["argument_size_in_bytes"] == \
            rows * 65 * 4 + 64 * 4
        assert rec["memory"]["output_size_in_bytes"] == state_rows * 192 + 4
        rl = rec["roofline"]
        assert rl["iters_scale"] == 32.0 and rl["collective_s"] > 0
        assert rl["memory_s"] == pytest.approx(
            rec["cost"]["bytes accessed"] * 32 / ha.HBM_BW)
        assert rec["fits_80g_hbm"] is True
    assert d["state_layout"] == "sharded"  # Graph500-28


def test_unported_cells_record_errors_and_components_raise(tmp_path):
    """A cell that cannot run records its error and the exit code counts
    it: olmoe's train state (AdamW moments and float32 gradient sums
    over 6.9B parameters) outgrows one card, named in bytes before
    anything is allocated, at the one-card cut split into its 4
    microbatches."""
    rc = dryrun.main(["--arch", "olmoe-1b-7b", "--shape", "train_4k",
                      "--mesh", "card", "--device", "cpu", "--out",
                      str(tmp_path)])
    assert rc == 1
    rec = _load(tmp_path / "olmoe-1b-7b__train_4k__card.json")
    assert rec["status"] == "error"
    assert rec["error"].startswith("ValueError") and "bytes" in rec["error"]
    assert "NotImplementedError" not in rec["error"]
    assert rec["reduced"]["global_batch"] == 4  # n_micro 4, a row each
    # --components counts JAX's layouts: refused on the card, and for a
    # family without components
    with pytest.raises(SystemExit):
        dryrun.main(["--all", "--components", "--mesh", "card", "--out",
                     str(tmp_path)])
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", ARCH, "--shape", "spotify", "--components",
                     "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="production layouts"):
        dryrun.run_components("minicpm-2b", "prefill_32k", "card",
                              str(tmp_path))
    assert dryrun.main(["--arch", ARCH, "--shape", "spotify", "--mesh",
                        "both", "--out", str(tmp_path)]) == 0
    assert {p.name for p in tmp_path.glob(f"{ARCH}*")} == {
        f"{ARCH}__spotify__single.json", f"{ARCH}__spotify__multi.json"}


def test_paper_collectives_count_the_ring():
    """The analytic schedule a trip: a replicated ring OR is 2 (K - 1)
    steps of 1/K of the packed words, the sharded one K steps, plus one
    loop-condition all-reduce an axis."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh

    layout = make_production_mesh()
    for shape, steps_k in (("ldbc100", 2 * 15), ("graph500_28", 16)):
        cell = steps.build_cell(ARCH, shape, layout, False)
        st = dryrun.paper_collectives(cell, layout.shape)
        n_pad = cell.decisions["n_pad"]
        assert st.counts["collective-permute"] == steps_k
        assert st.out_bytes["collective-permute"] == \
            steps_k * n_pad * 64 // 8 // 16
        assert st.counts["all-reduce"] == 2
        assert st.wire_bytes["all-reduce"] == pytest.approx(
            2 * 15 / 16 * 4 * 2)
    assert torch.device("meta") == cell.args[0].indices.device


@pytest.mark.parametrize("arch,shape", [
    ("pna", "ogb_products"), ("equiformer-v2", "ogb_products"),
    ("schnet", "molecule"), ("mace", "minibatch_lg"),
    ("dcn-v2", "train_batch"), ("dcn-v2", "retrieval_cand")])
def test_gnn_and_recsys_records_on_both_layouts(tmp_path, arch, shape):
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh

    assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both",
                        "--out", str(tmp_path)]) == 0
    for tag, multi in (("single", False), ("multi", True)):
        rec = _load(tmp_path / f"{arch}__{shape}__{tag}.json")
        assert rec["status"] == "ok" and rec["measured"] is False
        assert rec["n_devices"] == (512 if multi else 256)
        layout = make_production_mesh(multi_pod=multi)
        cell = steps.build_cell(arch, shape, layout, multi)
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] == dryrun._tree_bytes(
            cell.args, cell.in_shardings, layout.shape)
        assert mem["temp_size_in_bytes"] is None
        rl = rec["roofline"]
        assert rl["model_flops_per_device"] == pytest.approx(
            cell.model_flops / layout.size)
        assert rl["collective_s"] > 0
        if cell.decisions.get("e_pad") is not None:
            edges = cell.decisions["e_pad"] // layout.size
            assert rec["edges_a_device"] == edges
            assert rec["edge_tensor_bytes"] == \
                edges * dryrun._edge_width(cell) * 4
            assert mem["total_bytes_per_device"] == (
                mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                + rec["edge_tensor_bytes"])
    if arch == "equiformer-v2":  # l_max 6: 49 x 128 floats an edge
        assert rec["edge_tensor_bytes"] == 120_819 * 49 * 128 * 4


def test_gnn_card_record_on_the_cpu(tmp_path):
    rec = dryrun.run_cell("schnet", "molecule", "card", str(tmp_path),
                          device="cpu", cut={"batch": 2})
    assert rec["status"] == "ok", rec.get("error")
    assert rec["measured"] is True and rec["device"] == "cpu"
    assert rec["reduced"] == {"batch": 2}
    assert len(rec["wall_ms_runs"]) == dryrun.REPS
    assert rec["notes"] == "n=60 e=128"
    assert rec["collective_counts"] == {}
