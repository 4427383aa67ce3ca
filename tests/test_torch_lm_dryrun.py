"""The dry-run's LM cells (``launch/dryrun.py``: ``run_cell`` and
``--components`` for the ``lm`` family).

- ``single``/``multi``: every LM cell records ``status: ok`` with JAX's
  record keys, analytic (``measured: false``): per-device argument bytes
  equal to the parameters, moments, caches and tokens cut by the cell's
  specs, and a wire term from the port's collective schedule
  (``collective_schedule``), which the ranks' ``Wire`` records match
  (``test_torch_lm_mesh.py``).
- ``--components``: every LM cell on both layouts, one component a
  ``steps.lm_components`` entry, trips x terms summed.
- ``card``: a prefill, a decode and a train cell of the smoke config on
  a one-rank CPU mesh (a cut shape, recorded in ``reduced``), measured;
  the same cells with no device argument raise without CUDA (a train
  cell's record carries ``LM_CARD_CUTS["train"]``); an MoE train cell
  runs at the cut split into its microbatches, and llama4 at full width
  records the bytes it would need.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import base
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn.module import set_activation_rules

import test_torch_dryrun as TD

LM_CELLS = [c for c in base.all_cells()[0] if base.get(c[0]).family == "lm"]


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_lm_layout_records(mesh, tmp_path):
    multi = mesh == "multi"
    layout = make_production_mesh(multi_pod=multi)
    for arch, shape in LM_CELLS:
        rec = dryrun.run_cell(arch, shape, mesh, str(tmp_path))
        assert rec["status"] == "ok", rec.get("traceback")
        assert TD.RECORD_KEYS <= set(rec)
        assert set(rec["memory"]) == TD.MEMORY_KEYS
        assert rec["measured"] is False and rec["n_devices"] == layout.size
        cell = steps.build_cell(arch, shape, layout, multi)
        assert rec["notes"] == cell.notes and rec["kind"] == cell.kind
        # arguments: every leaf's block under its spec
        sizes = layout.shape
        want = 0
        for tree, specs in zip(cell.args, cell.in_shardings):
            leaves = (list(tree.items()) if isinstance(tree, dict) else
                      [(None, tree)])
            for key, t in leaves:
                if isinstance(t, torch.Tensor):
                    sp = specs[key] if key is not None else specs
                    want += dryrun._dev_bytes(t, sp, sizes)
                else:
                    want += dryrun._tree_bytes(t, specs[key] if key
                                               is not None else specs, sizes)
        assert rec["memory"]["argument_size_in_bytes"] == want
        rl = rec["roofline"]
        assert rl["collective_s"] > 0 and rl["compute_s"] > 0
        assert rl["model_flops_per_device"] == pytest.approx(
            cell.model_flops / layout.size)
        for k in ("collective_counts", "collective_out_bytes"):
            assert rec[k] is None
    # minicpm's decode_32k cache: 40 layers of 2 x [128, 32768, 36, 64]
    # bf16, the batch over 16 data ranks and the slots over 16 model ranks
    rec = json.loads((tmp_path / f"minicpm-2b__decode_32k__{mesh}.json")
                     .read_text())
    cache = 40 * 2 * 128 * 32768 * 36 * 64 * 2 // (
        (32 if multi else 16) * 16)
    params = steps.build_cell("minicpm-2b", "decode_32k", layout,
                              multi).args[0]
    assert rec["memory"]["argument_size_in_bytes"] > cache
    assert rec["memory"]["argument_size_in_bytes"] - cache < sum(
        t.numel() * 2 for t in params.values()) // 16


def test_lm_components_for_every_cell(tmp_path):
    assert dryrun.main(["--all", "--components", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    for arch, shape in LM_CELLS:
        for mesh in ("single", "multi"):
            rec = json.loads((tmp_path / f"{arch}__{shape}__{mesh}__comp"
                              ".json").read_text())
            assert rec["status"] == "ok" and rec["measured"] is False
            comps = steps.lm_components(arch, shape, make_production_mesh(
                multi_pod=mesh == "multi"), mesh == "multi")
            assert [(c["component"], c["trips"]) for c in
                    rec["components"]] == [(c.notes, c.iters_scale)
                                           for c in comps]
            rl = rec["roofline"]
            assert rl["flops_per_device"] == pytest.approx(
                sum(c["flops"] for c in rec["components"]))
            assert rl["wire_bytes_per_device"] > 0
            # useful FLOPs: the model's count over what the components
            # count (train adds the recompute and AdamW)
            assert 0.5 < rl["useful_fraction"] < 1.3, (arch, shape, mesh)


def _smoke(monkeypatch, arch):
    spec = base.get(arch)
    monkeypatch.setitem(base.REGISTRY, arch, dataclasses.replace(
        spec, full_config=spec.smoke_config))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_lm_card_record_on_the_cpu(monkeypatch, tmp_path, shape):
    _smoke(monkeypatch, "gemma2-2b")
    cut = {"global_batch": 2, "seq_len": 128}
    keep = {}
    rec = dryrun.run_cell("gemma2-2b", shape, "card", str(tmp_path),
                          device="cpu", cut=cut, keep=keep)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["measured"] and rec["reduced"] == cut
    assert rec["collective_counts"] == {}  # one rank sends nothing
    assert len(rec["wall_ms_runs"]) == dryrun.REPS and rec["wall_ms"] > 0
    assert rec["mha_launches"] == 0  # a CPU tensor takes the scan route
    # four layers' attention scans; a train step's again in the recompute
    n = {"prefill_32k": 4, "decode_32k": 0, "train_4k": 8}[shape]
    assert rec["route_calls"] == {"kernel": 0, "scan": n}
    if shape == "train_4k":
        loss, gnorm = keep["result"]
        assert torch.isfinite(loss) and float(gnorm) > 0
        assert rec["decisions"]["remat"] == "minimal"
    else:
        logits = keep["result"][0]
        assert logits.shape[0] == 2 and torch.isfinite(
            logits[..., :512]).all()
    assert rec["tokens_per_s"] > 0 and rec["bound_ms"] > 0


def test_lm_card_needs_cuda_and_train_cells_record_errors(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = dryrun.run_cell("minicpm-2b", "prefill_32k", "card",
                          str(tmp_path))
    assert rec["status"] == "error"
    assert "CUDA is not available" in rec["error"]
    assert rec["reduced"]["global_batch"] == 4  # the one-card cut, recorded
    rec = dryrun.run_cell("minicpm-2b", "train_4k", "card", str(tmp_path))
    assert rec["status"] == "error"
    assert "CUDA is not available" in rec["error"]
    assert rec["reduced"] == dict(dryrun.LM_CARD_CUTS["train"],
                                  why=dryrun.LM_CUT_WHY)
    # an MoE train cell runs on the card mesh: its one-card cut splits
    # into olmoe's 4 microbatches (the smoke model, at a CPU length)
    _smoke(monkeypatch, "olmoe-1b-7b")
    monkeypatch.setitem(dryrun.LM_CARD_CUTS, "train",
                        dict(dryrun.LM_CARD_CUTS["train"], seq_len=32))
    keep = {}
    rec = dryrun.run_cell("olmoe-1b-7b", "train_4k", "card", str(tmp_path),
                          device="cpu", keep=keep)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["reduced"]["global_batch"] == 4
    assert rec["decisions"]["n_micro"] == 4
    loss, gnorm = keep["result"]
    assert torch.isfinite(loss) and float(gnorm) > 0
    # llama4 at full width: the record names the bytes it needs
    rec = dryrun.run_cell("llama4-maverick-400b-a17b", "prefill_32k",
                          "card", str(tmp_path), device="cpu")
    assert rec["status"] == "error" and "bytes" in rec["error"]
    assert dryrun.lm_state_bytes(keep["cell"]) < dryrun.HBM_BYTES
