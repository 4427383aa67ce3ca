"""The paper engine's cells (``configs/paper_bfs.py``, ``_paper_cell`` and
``build_cell`` of ``launch/steps.py``) against the JAX package.

- The registry: ``all_cells()`` and the ``paper-bfs-engine`` spec (full
  and smoke configs, shapes, skips) equal JAX's.
- ``_paper_cell`` on a ~3,000-node shape on a one-device mesh in both
  packages (JAX's ``make_mesh((1, 1), ("data", "model"))``, the port's
  CPU ``Mesh``): kind, notes, model FLOPs, iteration scale and the
  arguments' shapes and dtypes are equal, and both cells' engines on one
  seeded forward ELL (``steps.bind_cell``'s) give bitwise-equal levels
  and per-morsel trips, for the full config (nTkMS, ``msbfs_lengths``, 64
  lanes, ring) and the smoke config (nTkS, ``sp_lengths``), under the
  default and both ``state_layout`` overrides.
- On 2 and 4 gloo ranks (``test_torch_ranks.paper_cell_rank``) the cell
  equals the one-rank result: the same levels, and trips in lockstep
  across source groups (``sync="global"``: a morsel runs as long as its
  partners in the other source groups, as JAX's does).
- The four published cells' decisions on JAX's production meshes (16 x
  16, 2 x 16 x 16) equal JAX's ``build_cell``, computed in a subprocess
  that forces 512 host devices as ``launch/dryrun.py`` does (building
  does not lower).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.graph.csr import EllGraph as JaxEll
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh as jax_mesh
from repro_torch.configs import base
from repro_torch.graph.generators import powerlaw
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh, run_ranks

import test_torch_ranks as TR

ROOT = Path(__file__).resolve().parents[1]
ARCH = "paper-bfs-engine"
SHAPES = ("ldbc100", "livejournal", "spotify", "graph500_28")


def test_registry_equals_jax():
    # registration order follows a process's import history (a test that
    # imports one config module first moves it up), so compare as sets
    # here; a fresh process lists both in one order (test_torch_dryrun)
    cells, skips = base.all_cells()
    jcells, jskips = jbase.all_cells()
    assert sorted(cells) == sorted(jcells)
    assert sorted(skips) == sorted(jskips)
    assert set(base.all_archs()) == set(jbase.all_archs())
    assert [(ARCH, s) for s in SHAPES] == [c for c in cells if c[0] == ARCH]


def test_paper_spec_equals_jax():
    import dataclasses

    t, j = base.get(ARCH), jbase.get(ARCH)
    assert (t.family, t.source, t.skips, t.notes, t.schedule) == \
        (j.family, j.source, j.skips, j.notes, j.schedule)
    for fn in ("full_config", "smoke_config"):
        assert dataclasses.asdict(getattr(t, fn)()) == \
            dataclasses.asdict(getattr(j, fn)())
    assert [(s.name, s.kind, s.dims) for s in t.shapes] == \
        [(s.name, s.kind, s.dims) for s in j.shapes]


def _one_rank(config, layout):
    """The port's cell on a one-rank CPU mesh, bound to the shared graph,
    and its result."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    kw = {} if layout is None else dict(state_layout=layout)
    cell = steps._paper_cell(TR.paper_spec(base, config),
                             TR.paper_shape(base.ShapeSpec), mesh, False,
                             **kw)
    bound = steps.bind_cell(cell, mesh, TR.paper_graph(powerlaw))
    return cell, bound, bound()


@pytest.mark.parametrize("layout", [None, "replicated", "sharded"])
@pytest.mark.parametrize("config", ["full", "smoke"])
def test_paper_cell_matches_jax(config, layout):
    kw = {} if layout is None else dict(state_layout=layout)
    jcell = jsteps._paper_cell(TR.paper_spec(jbase, config),
                               TR.paper_shape(jbase.ShapeSpec),
                               jax_mesh((1, 1), ("data", "model")), False,
                               **kw)
    cell, bound, res = _one_rank(config, layout)
    assert (cell.kind, cell.notes, cell.model_flops, cell.iters_scale) == \
        (jcell.kind, jcell.notes, jcell.model_flops, jcell.iters_scale)
    targs = (cell.args[0].indices, cell.args[0].degrees, cell.args[1])
    jargs = (jcell.args[0].indices, jcell.args[0].degrees, jcell.args[1])
    assert all(t.device.type == "meta" for t in targs)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in targs] \
        == [(tuple(j.shape), str(j.dtype)) for j in jargs]
    assert jcell.args[0].weights is None and cell.args[0].weights is None
    g = bound.graph
    assert (tuple(g.indices.shape), tuple(bound.morsels.shape)) == \
        (tuple(targs[0].shape), tuple(targs[2].shape))
    jres = jcell.fn(
        JaxEll(indices=jnp.asarray(g.indices.numpy()),
               degrees=jnp.asarray(g.degrees.numpy()), weights=None),
        jnp.asarray(bound.morsels))
    for f in res.state._fields:
        np.testing.assert_array_equal(getattr(res.state, f).numpy(),
                                      np.asarray(getattr(jres.state, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jres.iterations))
    cap = cell.config.max_iters
    assert 0 < int(res.iterations.min()) <= int(res.iterations.max()) <= cap


def _lockstep(one_it: np.ndarray, n_morsels: int, groups: int) -> np.ndarray:
    """Trips under ``sync="global"``: morsel ``j`` of a source group runs
    with the same-position morsels of the other groups."""
    it = np.zeros(n_morsels, np.int64)
    it[: len(one_it)] = one_it
    per = n_morsels // groups
    return it.reshape(groups, per).max(axis=0)[np.arange(n_morsels) % per]


@pytest.mark.parametrize("world", [2, 4])
def test_paper_cell_on_gloo_ranks_matches_one_rank(world):
    reps = run_ranks(TR.paper_cell_rank, world, timeout_s=150)
    n = TR.PAPER_N
    for shape, config, layout in TR.PAPER_CASES[world]:
        name = f"{shape[0]}x{shape[1]}/{config}/{layout}"
        _, _, one = _one_rank(config, layout)
        lv1, it1 = one.state.levels.numpy(), one.iterations.numpy()
        unreached = 255 if lv1.dtype == np.uint8 else -1
        for r in range(world):
            lv, it = reps[r][f"{name}/levels"], reps[r][f"{name}/iterations"]
            np.testing.assert_array_equal(lv, reps[0][f"{name}/levels"])
            assert lv.shape[0] % shape[0] == 0
            np.testing.assert_array_equal(lv[: lv1.shape[0], :n],
                                          lv1[:, :n], err_msg=name)
            assert (lv[lv1.shape[0]:] == unreached).all(), name
            assert (lv[:, n:] == unreached).all(), name
            np.testing.assert_array_equal(
                it, _lockstep(it1, lv.shape[0], shape[0]), err_msg=name)
            counts = reps[r][f"{name}/counts"]
            # the OR merge over the graph axis: ring steps (collective-
            # permute) for the full config's ring and the smoke config's
            assert counts.get("collective-permute", 0) > 0, (name, counts)
            assert counts.get("all-reduce", 0) > 0, (name, counts)
            assert f"state={layout}" in reps[r][f"{name}/notes"]


JAX_DECISIONS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_cell
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for shape in ("ldbc100", "livejournal", "spotify", "graph500_28"):
        c = build_cell("paper-bfs-engine", shape, mesh, multi)
        out[f"{shape}/{multi}"] = dict(
            kind=c.kind, notes=c.notes, model_flops=c.model_flops,
            iters_scale=c.iters_scale, graph=list(c.args[0].indices.shape),
            morsels=list(c.args[1].shape), n_devices=int(mesh.size))
print("JSON" + json.dumps(out))
"""


def test_production_layout_decisions_match_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", JAX_DECISIONS], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.split("JSON", 1)[1])
    for multi in (False, True):
        layout = make_production_mesh(multi_pod=multi)
        assert layout.size == (512 if multi else 256)
        for shape in SHAPES:
            cell = steps.build_cell(ARCH, shape, layout, multi)
            w = want[f"{shape}/{multi}"]
            assert cell.fn is None
            assert cell.notes.startswith(w["notes"] + " (fn=None")
            assert (cell.kind, cell.model_flops, cell.iters_scale) == \
                (w["kind"], w["model_flops"], w["iters_scale"])
            assert [list(cell.args[0].indices.shape),
                    list(cell.args[1].shape)] == [w["graph"], w["morsels"]]
            d = cell.decisions
            assert d["n_morsels"] == w["morsels"][0]
            assert d["lanes"] == w["morsels"][1]
            assert d["n_pad"] == w["graph"][0]
            assert f"state={d['state_layout']} " in w["notes"]
    # Table 2's sizes: only Graph500-28 outgrows JAX's 8 GB replicated state
    layouts = {s: steps.build_cell(ARCH, s, make_production_mesh(),
                                   False).decisions["state_layout"]
               for s in SHAPES}
    assert layouts == {"ldbc100": "replicated", "livejournal": "replicated",
                       "spotify": "replicated", "graph500_28": "sharded"}


def test_build_cell_raises_on_skips_and_unported_families():
    layout = make_production_mesh()
    with pytest.raises(ValueError, match="documented skip"):
        steps.build_cell("minicpm-2b", "long_500k", layout, False)
    # every family builds on a layout (decisions only); on a Mesh every
    # family runs, MoE included
    lm = steps.build_cell("minicpm-2b", "train_4k", layout, False)
    assert lm.kind == "train" and lm.fn is None
    for arch, shape in (("pna", "molecule"), ("dcn-v2", "serve_p99")):
        assert steps.build_cell(arch, shape, layout, False).fn is None
    assert callable(steps.build_cell(
        "olmoe-1b-7b", "train_4k", make_mesh((1, 1), ("data", "model"),
                                             "cpu"), False).fn)
    cell = steps.build_cell(ARCH, "ldbc100", layout, False)
    with pytest.raises(ValueError, match="no engine"):
        steps.bind_cell(cell, make_mesh((1, 1), ("data", "model"), "cpu"))


def test_paper_graphs_follow_the_published_laws():
    """``paper_graph`` is each proxy's generator at the asked node count
    (the proxies' own seeds), and RMAT takes powers of two only."""
    from repro_torch.graph.generators import PAPER_DATASETS

    g = steps.paper_graph("ldbc100", 4486)
    want = PAPER_DATASETS["ldbc"](1.0)
    np.testing.assert_array_equal(g.indptr, want.indptr)
    np.testing.assert_array_equal(g.indices, want.indices)
    g5 = steps.paper_graph("graph500_28", 1 << 12)
    want = PAPER_DATASETS["graph500"]()
    np.testing.assert_array_equal(g5.indices, want.indices)
    with pytest.raises(ValueError, match="power of two"):
        steps.paper_graph("graph500_28", 5000)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    cell = steps._paper_cell(base.get(ARCH),
                             TR.paper_shape(base.ShapeSpec), mesh, False)
    with pytest.raises(ValueError, match="does not fit"):
        steps.bind_cell(cell, mesh, powerlaw(4000, 3.0))
