"""The GNN train step on a mesh of ranks (``launch/steps.py``'s
``_gnn_cell`` on a ``Mesh``, ``models/gnn/common.py``'s slab layout
across ranks) against JAX's unsharded step.

Four gloo CPU ranks a mesh, ``(2, 2)``, ``(4, 1)`` and ``(1, 4)`` over
``("data", "model")`` (``test_torch_ranks.gnn_mesh_rank``), run two
AdamW steps of every arch's smoke config on each shape kind
(``full_graph``, ``minibatch``, ``batched``; ``GNN_MESH_DIMS``) from
JAX's weights. Rank ``(d, m)`` holds node block ``d`` and the ``m``-th
part of slab ``d``; on ``(1, 4)`` there is one slab (``k_slabs`` 1,
JAX's slab path off) split over ``model``. Each case holds:

- the loss and gradient norm of both steps to JAX's ``_gnn_cell`` step
  on one device (jitted) at ``TOL``; the moments after two steps at the
  gradient tolerance; each parameter leaf within 0.1 lr of JAX's but for
  one entry or 1% of them, and all of it within 2 lr (an AdamW step moves a parameter by at most
  about lr, and where a step's gradient is rounding-sized the ranks'
  other sum order can flip its sign: EquiformerV2's attention weights
  moved 0.115 lr on ``(4, 1)``);
- every rank's collectives, by axis and kind, equal to twice
  ``steps.gnn_collective_schedule``'s count;
- every parameter block and node-array block equal to its spec's slice,
  and the real slab layout no shorter than JAX's analytic ``e_pad``.

EquiformerV2 on ``minibatch`` keeps JAX's NaN gradient (a fanout tree's
leaves have no in-edge; ROADMAP section 3): both packages give NaN
there, compared as equal.

Tolerances (``test_torch_gnn.py``'s): ``TOL`` 1e-5 + 1e-5 of the largest
magnitude (loss, norm); moments 1e-4 + 1e-4, PNA's 1e-3 + 1e-3 (the
ranks sum in other orders than one device, and PNA's std aggregator
multiplies a rounding difference up to 500-fold).
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models.gnn import common as jc
from repro.nn.module import set_activation_rules as jset_rules
from repro.nn.module import split_boxed
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.launch import steps
from repro_torch.launch.mesh import run_ranks
from repro_torch.nn.module import set_activation_rules

import test_torch_ranks as TR

TOL = (1e-5, 1e-5)
GRAD_TOL = (1e-4, 1e-4)
PNA_GRAD_TOL = (1e-3, 1e-3)
LR = 1e-3
MESHES = ((2, 2), (4, 1), (1, 4))
CASES = [(a, s) for a in TR.GNN_MESH_ARCHS for s in TR.GNN_MESH_DIMS]


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)
    steps.gnn_common.set_edge_slabs(None)


def close(got, exp, tol, what=""):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    both_nan = np.isnan(got) & np.isnan(exp)
    got, exp = np.where(both_nan, 0, got), np.where(both_nan, 0, exp)
    rtol, share = tol
    finite = exp[np.isfinite(exp)]
    scale = max(float(np.abs(finite).max()), 1e-30) if finite.size else 1.0
    bad = ~(np.abs(got - exp) <= rtol * np.abs(exp) + share * scale)
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} off, worst "
        f"{float(np.nanmax(np.abs(got - exp)))} at scale {scale}")


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def jax_case(arch, shape):
    """JAX's one-device ``_gnn_cell`` from the smoke config: its weights
    (PRNGKey 0) and two jitted steps on ``gnn_mesh_batches``."""
    spec = jbase.get(arch)
    sh = next(s for s in spec.shapes if s.name == shape)
    cell = jsteps._gnn_cell(
        dataclasses.replace(spec, full_config=spec.smoke_config),
        dataclasses.replace(sh, dims={**sh.dims, **TR.GNN_MESH_DIMS[shape]}),
        jmake_mesh((1, 1), ("data", "model")), False)
    jset_rules(None)
    jc.set_edge_slabs(None)
    tcell = steps.gnn_cell(arch, shape, smoke=True,
                           dims=TR.GNN_MESH_DIMS[shape])
    jcfg = type(spec.smoke_config())(**dataclasses.asdict(tcell.cfg))
    params, _ = split_boxed(jsteps.GNN_MODULES[arch].init(
        jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(lambda x: np.asarray(x).copy(), params)
    opt = jadamw_init(params, JAdamWConfig(lr=LR, weight_decay=0.0))
    step = jax.jit(cell.fn)
    res = []
    for b in TR.gnn_mesh_batches(arch, shape):
        params, opt, loss, gnorm = step(
            params, opt, {k: jnp.asarray(v) for k, v in b.items()})
        res.append((float(loss), float(gnorm)))
    state = {"params": flat(params), "mu": flat(opt.mu), "nu": flat(opt.nu)}
    return tree, res, state


@pytest.fixture(scope="module")
def jax_ref():
    return {c: jax_case(*c) for c in CASES}


@pytest.fixture(scope="module")
def ranks(jax_ref):
    trees = {c: r[0] for c, r in jax_ref.items()}
    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {m: pool.submit(run_ranks, TR.gnn_mesh_rank, 4, (m, trees),
                               timeout_s=400) for m in MESHES}
        return {m: r.result() for m, r in runs.items()}


@pytest.mark.parametrize("arch", TR.GNN_MESH_ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gnn_mesh_steps_match_jax(ranks, jax_ref, mesh, arch):
    gtol = PNA_GRAD_TOL if arch == "pna" else GRAD_TOL
    for shape in TR.GNN_MESH_DIMS:
        _, jsteps_, jstate = jax_ref[arch, shape]
        got = ranks[mesh][0][f"{arch}/{shape}"]
        what = f"{arch} {shape} {mesh}"
        for i, ((tl, tn), (jl, jn)) in enumerate(zip(got["steps"], jsteps_)):
            close(tl, jl, TOL, f"{what} loss {i}")
            close(tn, jn, TOL, f"{what} grad norm {i}")
        for m in ("mu", "nu"):
            assert set(got[m]) == set(jstate[m])
            for k, v in jstate[m].items():
                close(got[m][k], v, gtol, f"{what} {m} {k}")
        for k, v in jstate["params"].items():
            d = np.abs(got["params"][k].astype(np.float64) - v)
            d = np.where(np.isnan(d) & np.isnan(v), 0.0, d)
            assert not (d > 2 * LR).any(), (what, k, np.nanmax(d))
            assert (d > 0.1 * LR).sum() <= max(1, 0.01 * d.size), (
                what, k, np.nanmax(d))
        # every rank ran the same step: the same losses and norms
        for r in ranks[mesh][1:]:
            assert np.allclose(r[f"{arch}/{shape}"]["steps"], got["steps"],
                               equal_nan=True)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gnn_mesh_collectives_match_the_schedule(ranks, mesh):
    for rank, out in enumerate(ranks[mesh]):
        for case, rec in out.items():
            want = {a: {k: [TR.MESH_STEPS * c, TR.MESH_STEPS * b]
                        for k, (c, b) in d.items()}
                    for a, d in rec["schedule"].items()}
            assert rec["wire"] == want, (mesh, rank, case)
            assert rec["blocks_ok"] and rec["batch_blocks_ok"], (
                mesh, rank, case)
            lay = rec["layout"]
            assert lay["edges"] >= lay["e_pad"] or mesh == (1, 4)
            assert lay["edges_a_rank"] * 4 == lay["edges"]
    # a (1, 4) mesh has one slab: no node gather, every reduce over model
    pna = ranks[(1, 4)][0]["pna/molecule"]["wire"]
    assert set(pna) == {"model"}
    # a (4, 1) mesh: node gathers and their transposes over data only
    assert set(ranks[(4, 1)][0]["pna/molecule"]["wire"]) == {"data"}
    assert "reduce-scatter" in ranks[(2, 2)][0]["mace/molecule"]["wire"][
        "data"]


def test_gnn_mesh_cell_refuses_other_slabs():
    """On a mesh the slabs must be the mesh's node blocks, uniform."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.gnn import common as tc
    from repro_torch.nn.module import sharding_rules, using_rules

    class FakeMesh(Mesh):
        def __init__(self):
            self.axis_names, self.axis_sizes = ("data", "model"), (2, 2)
            self.size, self._coords = 4, (0, 0)

    with using_rules(sharding_rules(), FakeMesh()):
        tc.set_edge_slabs(4)
        with pytest.raises(ValueError, match="uniform edge slabs"):
            tc._mesh_view()
        tc.set_edge_slabs(2, bounds=np.array([0, 3, 8]))
        with pytest.raises(ValueError, match="with bounds"):
            tc._mesh_view()
        tc.set_edge_slabs(2)
        assert tc._mesh_view().k == 2
