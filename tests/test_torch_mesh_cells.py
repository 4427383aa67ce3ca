"""The GNN and recsys cells' decisions (``launch/steps.py``: ``_gnn_cell``,
``_gnn_batch_specs``, ``_recsys_cell``, ``build_cell``) against the JAX
package's on its two production meshes.

All 16 GNN cells and 4 recsys cells on 16 x 16 and 2 x 16 x 16: kind,
model FLOPs, notes, donation, ``iters_scale``, every spec of the
arguments (each parameter's sanitized spec, AdamW's step and moments,
every batch leaf, the candidates) and every argument's shape and dtype
(which carry ``n_pad``, ``e_pad``, the padded candidate count, PNA's
``d_feat`` and ``n_out``, the targets, ``graph_ids`` and seeds) equal
JAX's, computed in a subprocess that forces 512 host devices as
``launch/dryrun.py`` does (building lowers nothing). On a
``MeshLayout`` every cell's ``fn`` is None; the decisions JAX's shapes
carry are spelled out too.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import base
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.nn.module import set_activation_rules

ROOT = Path(__file__).resolve().parents[1]
CELLS = [c for c in base.all_cells()[0]
         if base.get(c[0]).family in ("gnn", "recsys")]

JAX_CELLS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import NamedSharding
from repro.launch import steps
from repro.launch.mesh import make_production_mesh


def key(path):
    out = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return "/".join(out)


def specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {key(p): [list(e) if isinstance(e, tuple) else e
                     for e in leaf.spec] for p, leaf in leaves}


def shapes(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {key(p): [list(x.shape), str(x.dtype)] for p, x in leaves}


out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape in CELLS:
        c = steps.build_cell(arch, shape, mesh, multi)
        out[f"{arch}/{shape}/{multi}"] = dict(
            kind=c.kind, model_flops=c.model_flops, notes=c.notes,
            donate=list(c.donate), iters_scale=c.iters_scale,
            specs=specs(c.in_shardings), shapes=shapes(c.args))
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = f"CELLS = {CELLS!r}\n" + JAX_CELLS
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.split("JSON", 1)[1])


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)
    steps.gnn_common.set_edge_slabs(None)


def _flat(tree, prefix, leaf):
    """The port's argument tree keyed as JAX's flattened one: tuples by
    position, AdamW by ``step``/``mu``/``nu``, dotted parameter names
    as paths."""
    if isinstance(tree, steps.AdamWState):
        out = {f"{prefix}step": leaf(tree.step)}
        for f in ("mu", "nu"):
            out.update(_flat(getattr(tree, f), f"{prefix}{f}/", leaf))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + k.replace(".", "/") + "/", leaf))
        return out
    if isinstance(tree, tuple) and tree and isinstance(
            tree[0], (dict, steps.AdamWState, torch.Tensor)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/", leaf))
        return out
    return {prefix.rstrip("/"): leaf(tree)}


def port_record(c):
    spec = lambda s: [list(e) if isinstance(e, tuple) else e for e in s]
    shape = lambda t: [list(t.shape), str(t.dtype).split(".")[-1]]
    specs = {}
    for i, part in enumerate(c.in_shardings):
        specs.update(_flat(part, f"{i}/", spec))
    return dict(kind=c.kind, model_flops=c.model_flops, notes=c.notes,
                donate=list(c.donate), iters_scale=c.iters_scale,
                specs=specs, shapes=_flat(c.args, "", shape))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("family", ["gnn", "recsys"])
def test_cells_match_jax_on_production_meshes(jax_cells, multi, family):
    layout = make_production_mesh(multi_pod=multi)
    n = 0
    for arch, shape in CELLS:
        if base.get(arch).family != family:
            continue
        cell = steps.build_cell(arch, shape, layout, multi)
        assert cell.fn is None and "cannot hold" in cell.decisions["fn"]
        got, want = port_record(cell), jax_cells[f"{arch}/{shape}/{multi}"]
        assert got == want, (arch, shape, multi)
        n += 1
    assert n == {"gnn": 16, "recsys": 4}[family]


def test_gnn_and_recsys_decisions():
    """The decisions JAX's shapes carry, spelled out on 16 x 16."""
    layout = make_production_mesh()
    d = {(a, s): steps.build_cell(a, s, layout, False)
         for a, s in CELLS}
    ogb = d["pna", "ogb_products"]
    assert ogb.decisions["k_slabs"] == 16
    assert ogb.decisions["n_pad"] == 2_449_040  # 2,449,029 up to 16
    assert ogb.decisions["e_pad"] == 61_859_328  # up to lcm(256, 16)
    assert ogb.args[2]["targets"].shape == (2_449_040, 47)
    assert d["pna", "full_graph_sm"].args[2]["targets"].shape[1] == 40
    assert d["pna", "minibatch_lg"].args[2]["node_feat"].shape[1] == 100
    assert d["schnet", "molecule"].args[2]["targets"].shape == (128,)
    assert d["mace", "minibatch_lg"].args[2]["targets"].shape == (1024, 8)
    # the sanitized specs: PNA's d_feat 1433 and 100 do not split over
    # 16 data ranks, 16 does; DCN-v2's 429-wide cross kernels never split
    for shape, spec in (("full_graph_sm", (None, None)),
                        ("minibatch_lg", (None, None)),
                        ("molecule", ("data", None))):
        assert d["pna", shape].in_shardings[0]["feat_proj.kernel"] == spec
    dcn = d["dcn-v2", "train_batch"].in_shardings[0]
    assert dcn["cross.w_0.kernel"] == (None, None)
    assert dcn["mlp.w_0.kernel"] == (None, "model")
    assert dcn["mlp.w_1.kernel"] == ("data", "model")
    assert dcn["embed.table"] == ("model", None)
    ret = d["dcn-v2", "retrieval_cand"]
    assert ret.decisions["batch_shards"] is None
    assert ret.decisions["n_candidates_padded"] == 1_000_192
    assert ret.in_shardings[2] == (("data", "model"), None)


def test_mesh_cells_run_on_a_mesh():
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    for arch, shape in (("pna", "molecule"), ("dcn-v2", "serve_p99")):
        cell = steps.build_cell(arch, shape, mesh, False, smoke=True)
        assert callable(cell.fn) and cell.decisions["fn"] is None
        assert cell.args[0][next(iter(cell.args[0]))].device == \
            torch.device("meta")
