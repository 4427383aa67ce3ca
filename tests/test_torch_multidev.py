"""The port on a mesh of ranks against the JAX package on a mesh of fake
devices.

Two JAX subprocesses (``--xla_force_host_platform_device_count=4``, as
``tests/test_multidev.py`` runs its own) share the cases on
``make_mesh((2, 2), ("data", "model"))`` and write ``.npz`` files; while
they run, four gloo ranks of the port (``test_torch_ranks.engines_rank``) run the
same cases on a ``(2, 2)`` mesh of processes:

- ``run_recursive_query`` for 1T1S, nT1S, nTkS (``allgather``, ``ring``,
  ``pmax``) and nTkMS, lengths and parents, ``bellman_ford``'s min merge;
- the backends ``ell_push``, ``ell_pull``, ``pull_binned``,
  ``pull_binned_fused``, ``dopt``, ``dopt_fused`` and ``block_mxu`` in
  both state layouts (the fused two against JAX's ``pull_binned`` /
  ``dopt``: JAX's fused Pallas body does not trace on current jax);
- the gang phase 2 of ``tests/test_multidev.py`` (three long-path
  stragglers, ``phase1_iters=2``) in both layouts;
- the divergent ``sync="shard"`` hybrid (``topk_paths`` budget 14,
  ``ppr`` budget 48) in both layouts;
- on ``serve``'s ``(1, 4)`` mesh (a size-1 source axis inside
  collectives over both axes): nT1S parents and the gang phase 2.

Final states and per-morsel iteration counts equal JAX's bitwise, PPR's
mass at rtol 1e-5 / atol 1e-7 with equal counts, and every rank returns
the same global result. Then closed-loop ``serve.main`` on two gloo
ranks must equal JAX's ``QueryService`` on two fake devices batch for
batch, and a dispatcher whose measured cost rates differ on every rank
must log the same plans on every rank. Every rank group joins under a
timeout, so a hang fails instead of running into the suite's clock.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch.mesh import run_ranks

import test_torch_ranks as TR

ROOT = Path(__file__).resolve().parents[1]

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
sys.path.insert(0, sys.argv[2])
import test_torch_ranks as TR
from repro.core import POLICIES, run_recursive_query
from repro.graph.csr import csr_from_edges
from repro.graph.generators import (PAPER_DATASET_FAMILIES, PAPER_DATASETS,
                                    pick_sources, powerlaw)
from repro.launch.mesh import make_mesh
from repro.launch.serve import QueryService
from repro.runtime.dispatch import QueryDispatcher
from repro.runtime.scheduler import AdaptiveScheduler

mesh = make_mesh(*TR.MESH)
out = {}
part = int(sys.argv[3])  # two processes share the cases
inputs = TR.query_case_inputs(powerlaw, csr_from_edges)
for name, pol, impl, ec, lay, be, src in TR.QUERY_CASES[part::2]:
    csr, sources = inputs[src]
    policy = POLICIES[pol]() if impl is None else POLICIES[pol](or_impl=impl)
    res = run_recursive_query(mesh, csr, sources, policy, ec,
                              state_layout=lay,
                              extend=TR.JAX_TWIN.get(be, be))
    for f in res.state._fields:
        out[f"{name}/{f}"] = np.asarray(getattr(res.state, f))
    out[f"{name}/iterations"] = np.asarray(res.iterations)
if part == 0:
    np.savez(sys.argv[1], **out)
    print("JAX_MULTIDEV_DONE")
    raise SystemExit(0)
skew, gsrcs = TR.skew_graph(csr_from_edges, powerlaw)
for lay in ("replicated", "sharded"):
    o = AdaptiveScheduler(mesh, skew, max_iters=64, phase1_iters=2).query(
        gsrcs, state_layout=lay)
    out[f"gang_{lay}/levels"] = np.asarray(o.result.state.levels)
    out[f"gang_{lay}/iterations"] = np.asarray(o.result.iterations)
    out[f"gang_{lay}/counts"] = np.array(
        [o.hybrid, o.resumed_ganged, o.gang_width, o.resumed_serial])
wcsr = TR.weighted_graph(csr_from_edges)
srcs = np.array([0, 3, 17, 44], dtype=np.int32)
for kind, leaf, budget in (("topk_paths", "dists", 14), ("ppr", "mass", 48)):
    dq = QueryDispatcher(mesh, wcsr, max_iters=512, phase1_iters=budget)
    for lay in ("replicated", "sharded"):
        o = dq.query(srcs, query_kind=kind, state_layout=lay)
        out[f"{kind}_{lay}/{leaf}"] = np.asarray(getattr(o.result.state, leaf))
        out[f"{kind}_{lay}/iterations"] = np.asarray(o.result.iterations)
        out[f"{kind}_{lay}/counts"] = np.array([o.hybrid, o.redispatched])
line = make_mesh(*TR.LINE_MESH)
csr = powerlaw(300, 5.0, seed=1)
for lay in ("replicated", "sharded"):
    res = run_recursive_query(line, csr, TR.SOURCES,
                              POLICIES["nt1s"](or_impl="ring"), "sp_parents",
                              state_layout=lay, extend="dopt")
    for f in res.state._fields:
        out[f"line_nt1s_{lay}/{f}"] = np.asarray(getattr(res.state, f))
    out[f"line_nt1s_{lay}/iterations"] = np.asarray(res.iterations)
for lay in ("replicated", "sharded"):
    o = AdaptiveScheduler(line, skew, max_iters=64, phase1_iters=2).query(
        gsrcs, state_layout=lay)
    out[f"line_gang_{lay}/levels"] = np.asarray(o.result.state.levels)
    out[f"line_gang_{lay}/iterations"] = np.asarray(o.result.iterations)
    out[f"line_gang_{lay}/counts"] = np.array(
        [o.hybrid, o.resumed_ganged, o.gang_width, o.resumed_serial])
mesh2 = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                          ("data", "model"))
csr = PAPER_DATASETS["ldbc"](0.1)
svc = QueryService(mesh2, csr, family=PAPER_DATASET_FAMILIES["ldbc"])
for b in range(3):
    sources = pick_sources(csr, 8, seed=100 + b)
    res, pol = svc.query(sources)
    out[f"serve/{b}/sources"] = np.asarray(sources)
    out[f"serve/{b}/policy"] = np.array(pol)
    out[f"serve/{b}/levels"] = np.asarray(res.state.levels)
    out[f"serve/{b}/iterations"] = np.asarray(res.iterations)
np.savez(sys.argv[1], **out)
print("JAX_MULTIDEV_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multidev")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    paths = [tmp / f"jax{p}.npz" for p in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(path), str(ROOT / "tests"),
         str(p)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p, path in enumerate(paths)]
    try:
        port = run_ranks(TR.engines_rank, 4, timeout_s=150)
        line = run_ranks(TR.line_rank, 4, timeout_s=120)
        for p, q in zip(port, line):
            p.update(q)
        serve = run_ranks(TR.serve_rank, 2, (TR.SERVE_ARGV,), timeout_s=120)
        plans = run_ranks(TR.plans_rank, 4, timeout_s=120)
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    jax_out = {}
    for p, err, path in zip(procs, errs, paths):
        assert p.returncode == 0, err[-3000:]
        with np.load(path) as z:
            jax_out.update(z)
    return {"port": port, "jax": jax_out, "serve": serve, "plans": plans}


def _keys(runs, prefix):
    keys = [k for k in runs["jax"] if k.split("/")[0] == prefix]
    assert keys, prefix
    return keys


def _check(runs, prefix, float_leaves=()):
    port = runs["port"]
    for key in _keys(runs, prefix):
        want = runs["jax"][key]
        got = port[0][key]
        for r in range(1, len(port)):  # every rank holds the global result
            np.testing.assert_array_equal(port[r][key], got, err_msg=key)
        assert got.shape == want.shape, (key, got.shape, want.shape)
        if key.split("/")[1] in float_leaves:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("case", [c[0] for c in TR.QUERY_CASES])
def test_run_recursive_query_on_mesh_matches_jax(runs, case):
    _check(runs, case)


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_gang_phase2_on_mesh_matches_jax(runs, layout):
    _check(runs, f"gang_{layout}")
    hybrid, ganged, width, serial = runs["port"][0][f"gang_{layout}/counts"]
    assert hybrid and ganged >= 3 and width >= ganged and serial == 0
    np.testing.assert_array_equal(runs["port"][0]["gang_sharded/levels"],
                                  runs["port"][0]["gang_replicated/levels"])


@pytest.mark.parametrize("case", ["line_nt1s_replicated",
                                  "line_nt1s_sharded",
                                  "line_gang_replicated",
                                  "line_gang_sharded"])
def test_line_mesh_with_a_size_one_axis_matches_jax(runs, case):
    """The serving mesh's shape (1, 4): the source axis of size 1 moves
    nothing inside collectives over both axes."""
    _check(runs, case)
    if case.startswith("line_gang"):
        hybrid, ganged, width, serial = runs["port"][0][f"{case}/counts"]
        assert hybrid and ganged >= 3 and serial == 0


@pytest.mark.parametrize("kind", ["topk_paths", "ppr"])
@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_divergent_shard_sync_matches_jax(runs, kind, layout):
    _check(runs, f"{kind}_{layout}", float_leaves=("mass",))
    hybrid, redispatched = runs["port"][0][f"{kind}_{layout}/counts"]
    assert hybrid and redispatched >= 1


def test_gloo_ranks_on_cpu_stage_nothing(runs):
    assert all(int(r["wire/staged_bytes"]) == 0 for r in runs["port"])


def test_two_rank_closed_loop_serve_matches_jax(runs):
    lead, follower = runs["serve"]
    assert follower == [] and len(lead) == 3
    for b, rec in enumerate(lead):
        j = runs["jax"]
        np.testing.assert_array_equal(rec["sources"], j[f"serve/{b}/sources"])
        assert rec["policy"] == str(j[f"serve/{b}/policy"])
        np.testing.assert_array_equal(rec["iterations"],
                                      j[f"serve/{b}/iterations"])
        np.testing.assert_array_equal(rec["levels"], j[f"serve/{b}/levels"])


def test_rank_dependent_cost_rates_give_identical_plans(runs):
    logs = runs["plans"]
    assert len(logs[0]) == 6
    assert any(p[-1] is not None for p in logs[0])  # the refits ran
    for r in range(1, len(logs)):
        assert logs[r] == logs[0], (r, logs[r], logs[0])
