"""Graph deltas on a mesh of ranks: the port against the JAX package.

Two JAX subprocesses (``--xla_force_host_platform_device_count=4``, as
``tests/test_torch_multidev.py`` runs its own) run the edit script of
``test_torch_ranks.delta_script`` through ``QueryDispatcher.apply_delta``,
one on ``(2, 2)`` and one on ``(1, 4)``: a same-shape delta (double edge
swaps), a rebinning move, a forward-ELL overflow, a delta that fills the
tile lists, then a weighted delta and a reweighting on a weighted graph.
Each records, after every delta, the host mirror of every bundle
(``pull_binned``, ``dopt``, ``block_mxu``, ``ell_pull`` and the fused
pack, split by ``('model',)`` and by ``('data', 'model')``, and the
replicated bundle of 1T1S), each bundle's fold report, and the reach
cases' levels and iterations in both state layouts (the fused two against
JAX's ``pull_binned`` / ``dopt``: JAX's fused Pallas body does not trace
on current jax) and the ``topk_paths`` / ``ppr`` results. Meanwhile four
gloo ranks of the port (``test_torch_ranks.delta_rank``) run the same
script, each folding its own shard only.

What must hold, after every delta:

- each rank's mirror leaves equal JAX's ``[k]`` slice of the global
  mirror bitwise, and hold the shard's rows and no more;
- every rank returns the same per-bundle report (``changed``,
  ``reshaped``, ``binned_moves``), equal to JAX's bundle of the same
  split (the port keeps one bundle where JAX keeps two of one layout on
  ``(1, 4)``), and the same epochs and cache size;
- levels and iteration counts equal JAX's bitwise and are the same on
  every rank; PPR mass within rtol 1e-5 / atol 1e-7 with equal counts.

Then open-loop ``serve.main --mutate-stream 2`` on two gloo ranks must
equal, query for query, JAX's ``ServingLoop`` on two fake devices over
the same schedule and each query's BFS on the graph it was admitted
under, with the follower's replayed batches equal to rank 0's. Every rank
group joins under a timeout.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from oracle import bfs_levels

from repro_torch.graph.csr import csr_from_edges
from repro_torch.graph.delta import apply_delta_csr
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
import repro.runtime.dispatch as jdispatch
from repro.core import POLICIES, as_spec, hybrid_phases
from repro.graph.csr import csr_from_edges
from repro.graph.delta import GraphDelta, apply_delta_csr, random_delta
from repro.launch.mesh import make_mesh

mesh_name = sys.argv[3]
mesh = make_mesh(*TR.MESHES[mesh_name])
shape = dict(mesh.shape)
out = {}
folds = []
real_fold = jdispatch.fold_operands


def recording_fold(*args, **kwargs):
    structs, rep = real_fold(*args, **kwargs)
    folds.append(rep)
    return structs, rep


jdispatch.fold_operands = recording_fold


def leaves(ops):
    o = {}
    for p, g in (("fwd", ops.fwd), ("rev", ops.rev)):
        if g is not None:
            o[f"{p}.indices"] = np.asarray(g.indices)
            o[f"{p}.degrees"] = np.asarray(g.degrees)
            if g.weights is not None:
                o[f"{p}.weights"] = np.asarray(g.weights)
    for p, x, rows in (("bn", ops.rev_binned, ("perm", "inv")),
                       ("pack", ops.rev_binned_pack, ("inv_pad", "perm_pad"))):
        if x is None:
            continue
        for f in rows:
            o[f"{p}.{f}"] = np.asarray(getattr(x, f))
        for b, s in enumerate(x.slabs):
            o[f"{p}.slab{b}"] = np.asarray(s)
        for b, w in enumerate(x.slab_weights or ()):
            o[f"{p}.w{b}"] = np.asarray(w)
    if ops.blocks is not None:
        o["blocks.blocks"] = np.asarray(ops.blocks.blocks)
        o["blocks.rows"] = np.asarray(ops.blocks.block_rows)
        o["blocks.cols"] = np.asarray(ops.blocks.block_cols)
    return o


def put(key, a):
    # JAX keeps ('model',) and ('data', 'model') apart where the port keys
    # one bundle: both must hold the same arrays. A copy: later folds
    # write the mirror in place
    a = np.array(a)
    if key in out:
        np.testing.assert_array_equal(out[key], a, err_msg=key)
    out[key] = a


def record(dq, prefix):
    keys = list(dq._graphs)
    for key, rep in zip(keys, folds):
        put(f"{prefix}/fold/{TR.bundle_name(key, shape)}", TR.fold_row(rep))
    for key, bundle in dq._graphs.items():
        name = TR.bundle_name(key, shape)
        for leaf, a in leaves(bundle.host).items():
            put(f"{prefix}/host/{name}/{leaf}", a)
    folds.clear()


def pack_bundles(dq, spec):
    # the fused pack's bundles (JAX's fused kernel does not trace here;
    # its operands build and fold all the same)
    p1 = POLICIES["ntks"]()
    _, p2 = hybrid_phases(p1.source_axes, p1.graph_axes, lanes=p1.lanes,
                          or_impl=p1.or_impl)
    for pol in (p1, p2):
        dq._graph_for(pol, as_spec(spec))


csr = TR.local_graph(csr_from_edges)
dq = jdispatch.QueryDispatcher(mesh, csr, max_iters=64, phase1_iters=2)
script = TR.delta_script(csr, GraphDelta, apply_delta_csr)
for step in range(len(script) + 1):
    if step:
        dq.apply_delta(script[step - 1][1])
        record(dq, f"{step}")
    for be, lay in TR.DELTA_CASES:
        o = dq.query(TR.DELTA_SOURCES, policy="ntks",
                     backend=TR.JAX_TWIN.get(be, be), state_layout=lay)
        out[f"{step}/{be}/{lay}/levels"] = np.asarray(o.result.state.levels)
        out[f"{step}/{be}/{lay}/iterations"] = np.asarray(o.result.iterations)
    o = dq.query(TR.DELTA_SOURCES, policy="1t1s", backend="pull_binned")
    out[f"{step}/1t1s/levels"] = np.asarray(o.result.state.levels)
    out[f"{step}/1t1s/iterations"] = np.asarray(o.result.iterations)
    if step == 0:
        pack_bundles(dq, "pull_binned_fused")
wcsr = TR.local_graph(csr_from_edges, weighted=True)
wq = jdispatch.QueryDispatcher(mesh, wcsr, max_iters=512, phase1_iters=14)
wscript = TR.weighted_script(wcsr, GraphDelta, apply_delta_csr, random_delta)
srcs = TR.DELTA_SOURCES[:4]
for step in range(len(wscript) + 1):
    if step:
        wq.apply_delta(wscript[step - 1][1])
        record(wq, f"w{step}")
    for kind, leaf in TR.WEIGHTED_KINDS:
        for lay in ("replicated", "sharded"):
            o = wq.query(srcs, query_kind=kind, state_layout=lay)
            out[f"w{step}/{kind}/{lay}/{leaf}"] = np.asarray(
                getattr(o.result.state, leaf))
            out[f"w{step}/{kind}/{lay}/iterations"] = np.asarray(
                o.result.iterations)
    o = wq.query(srcs, policy="ntks", backend="pull_binned",
                 state_layout="sharded")
    out[f"w{step}/reach/levels"] = np.asarray(o.result.state.levels)
    if step == 0:
        pack_bundles(wq, "pull_binned_fused")
if mesh_name == "1x4":
    import repro.graph.delta as jdelta
    import repro.launch.serve as jserve
    from repro.graph.generators import PAPER_DATASET_FAMILIES, PAPER_DATASETS
    from repro.runtime.service import ServingLoop
    mesh2 = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                              ("data", "model"))
    csr = PAPER_DATASETS["ldbc"](0.1)
    arr = jserve.poisson_arrivals(csr, 200.0, 10, 8, tenants=2, seed=1)
    span, cur = arr[-1]["t_ms"], csr
    for i in range(2):
        d = jdelta.random_delta(cur, 64, 64, seed=500 + i)
        cur = jdelta.apply_delta_csr(cur, d)
        arr.append({"t_ms": span * (i + 1) / 3, "delta": d})
    arr.sort(key=lambda a: a["t_ms"])
    loop = ServingLoop(mesh2, csr, family=PAPER_DATASET_FAMILIES["ldbc"])
    res = loop.run_stream(arr)
    for qid, lv in res.items():
        out[f"stream/{qid}"] = np.asarray(lv)
np.savez(sys.argv[1], **out)
print("JAX_MESH_DELTA_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_delta")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    names = list(TR.MESHES)
    paths = {m: tmp / f"jax_{m}.npz" for m in names}
    procs = {m: subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(paths[m]), str(ROOT / "tests"),
         m], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for m in names}
    # a delta group takes 36-140 s alone on 8 CPUs, one thread a rank;
    # under the whole suite's six workers a group ran 3.5 times longer
    # (210 s for one of 60 s), so each gets 3.5 x 140 s, rounded up
    try:
        port = {m: run_ranks(TR.delta_rank, 4, (m,), timeout_s=500)
                for m in names}
        stream = run_ranks(TR.stream_rank, 2, (TR.STREAM_ARGV,),
                           timeout_s=180)
        errs = {m: p.communicate(timeout=600)[1] for m, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    jax_out = {}
    for m in names:
        assert procs[m].returncode == 0, errs[m][-3000:]
        with np.load(paths[m]) as z:
            jax_out[m] = dict(z)
    return {"port": port, "jax": jax_out, "stream": stream}


MESH_NAMES = list(TR.MESHES)
STEPS = [str(s) for s in range(1, 5)] + ["w1", "w2"]


def _split_axes(name: str) -> list:
    """The mesh axes a bundle name says its graph is split over."""
    return [a for a in name.split(":")[0].split("+") if a != "whole"]


def _shard_of(axes, coords, shape) -> tuple[int, int]:
    """A rank's shard index and the shard count over ``axes`` (major to
    minor, as the port's ``Axes.index``)."""
    k, K = 0, 1
    for a in axes:
        k = k * shape[a] + coords[a]
        K *= shape[a]
    return k, K


def _coords(rank: int, shape: dict) -> dict:
    names = list(shape)
    idx = np.unravel_index(rank, [shape[a] for a in names])
    return {a: int(i) for a, i in zip(names, idx)}


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_rank_mirrors_are_jax_shard_slices(runs, mesh, step):
    """Every rank's folded mirror is bitwise the ``[k]`` slice of JAX's
    global mirror, with the shard's rows and no more."""
    from repro_torch.core.extend import operands_shard_from_numpy

    shape = dict(zip(*TR.MESHES[mesh][::-1]))
    jax_out = runs["jax"][mesh]
    prefix = f"{step}/host/"
    names = sorted({k[len(prefix):].split("/")[0]
                    for k in runs["port"][mesh][0] if k.startswith(prefix)})
    assert len(names) >= 3, names
    for name in names:
        jl = {k[len(prefix) + len(name) + 1:]: v for k, v in jax_out.items()
              if k.startswith(f"{prefix}{name}/")}
        assert jl, (step, name)
        n_pad = jl["fwd.indices"].shape[0]
        for rank, port in enumerate(runs["port"][mesh]):
            k, K = _shard_of(_split_axes(name), _coords(rank, shape),
                             shape)
            want = TR.operand_leaves(operands_shard_from_numpy(jl, k, K))
            got = {lf: port[f"{prefix}{name}/{lf}"] for lf in want}
            assert sorted(want) == sorted(
                k2[len(prefix) + len(name) + 1:] for k2 in port
                if k2.startswith(f"{prefix}{name}/"))
            assert got["fwd.indices"].shape[0] == n_pad // K
            for lf in want:
                assert got[lf].dtype == want[lf].dtype, (name, lf)
                np.testing.assert_array_equal(
                    got[lf], want[lf], err_msg=f"{mesh} {step} rank {rank} "
                    f"{name} {lf}")


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_bundle_reports_match_jax_and_agree_across_ranks(runs, mesh):
    port, jax_out = runs["port"][mesh], runs["jax"][mesh]
    seen = {"reshaped": 0, "moves": 0, "same_shape": 0}
    for step in STEPS:
        keys = [k for k in port[0] if k.startswith(f"{step}/fold/")]
        assert keys, step
        for key in keys:
            for r in range(1, len(port)):
                np.testing.assert_array_equal(port[r][key], port[0][key],
                                              err_msg=f"rank {r} {key}")
            np.testing.assert_array_equal(port[0][key], jax_out[key],
                                          err_msg=key)
            row = port[0][key]
            seen["reshaped"] += int(row[5:10].any())
            seen["moves"] += int(row[10] > 0 and not row[7])
            seen["same_shape"] += int(row[:5].any() and not row[5:10].any())
        for key in [k for k in port[0] if k.startswith(
                (f"{step}/epochs/", f"{step}/report"))]:
            for r in range(1, len(port)):
                np.testing.assert_array_equal(port[r][key], port[0][key],
                                              err_msg=f"rank {r} {key}")
    # the script covers folds in place, moves and rebuilds
    assert all(v > 0 for v in seen.values()), seen
    # the shape-changing deltas: the forward ELL overflow rebuilds every
    # bundle's forward ELL, the full tile lists the tiles
    for name in ("model:fwd+blocks:128",):
        assert port[0][f"3/fold/{name}"][5] == 1
        assert port[0][f"4/fold/{name}"][9] == 1


@pytest.mark.parametrize("step", ["0"] + STEPS[:4])
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_reach_after_each_delta_matches_jax(runs, mesh, step):
    port, jax_out = runs["port"][mesh], runs["jax"][mesh]
    keys = [k for k in jax_out if k.split("/")[0] == step
            and k.endswith(("/levels", "/iterations"))]
    assert len(keys) == 2 * (len(TR.DELTA_CASES) + 1)
    for key in keys:
        for r in range(1, len(port)):
            np.testing.assert_array_equal(port[r][key], port[0][key],
                                          err_msg=f"rank {r} {key}")
        np.testing.assert_array_equal(port[0][key], jax_out[key],
                                      err_msg=key)


@pytest.mark.parametrize("step", ["w0", "w1", "w2"])
@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_weighted_kinds_after_each_delta_match_jax(runs, mesh, step):
    port, jax_out = runs["port"][mesh], runs["jax"][mesh]
    keys = [k for k in jax_out if k.split("/")[0] == step
            and k.split("/")[1] not in ("fold", "host")]
    assert len(keys) == 9, keys
    for key in keys:
        for r in range(1, len(port)):
            np.testing.assert_array_equal(port[r][key], port[0][key],
                                          err_msg=f"rank {r} {key}")
        if key.endswith("/mass"):
            np.testing.assert_allclose(port[0][key], jax_out[key],
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(port[0][key], jax_out[key],
                                          err_msg=key)


def test_two_rank_mutate_stream_matches_jax_and_bfs(runs):
    lead, follower = runs["stream"]
    jax_out = runs["jax"]["1x4"]
    results = lead["results"]
    assert len(results) == 10
    assert [r[0] for r in lead["reports"]] == [1, 2]
    assert all(r[-1] for r in lead["reports"])  # slowest rank >= own
    # the follower replayed every batch, with the same results
    assert sorted(follower["batches"]) == sorted(lead["batches"])
    for seq, (lv, its) in lead["batches"].items():
        np.testing.assert_array_equal(follower["batches"][seq][0], lv)
        np.testing.assert_array_equal(follower["batches"][seq][1], its)
    # each query on the graph version it was admitted under
    from repro_torch.graph.generators import PAPER_DATASETS

    g = PAPER_DATASETS["ldbc"](0.1)
    q = 0
    for a in lead["arrivals"]:
        if "delta" in a:
            g = apply_delta_csr(g, a["delta"])
            continue
        qid = f"q{q}"
        q += 1
        np.testing.assert_array_equal(results[qid], jax_out[f"stream/{qid}"],
                                      err_msg=qid)
        np.testing.assert_array_equal(
            results[qid], np.stack([bfs_levels(g, int(s))
                                    for s in a["sources"]]), err_msg=qid)
    assert q == 10
    assert lead["avg_degree"] == pytest.approx(g.avg_degree)
