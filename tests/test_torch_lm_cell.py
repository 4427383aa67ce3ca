"""The LM cells (``launch/steps.py``: ``_lm_cell``, ``lm_components``,
``build_cell``) against the JAX package's.

Every non-skipped LM cell and every ``lm_components`` entry on JAX's two
production meshes (16 x 16 and 2 x 16 x 16): kind, model FLOPs, notes,
donation, ``iters_scale`` and every spec of the arguments and outputs
equal JAX's, computed in a subprocess that forces 512 host devices as
``launch/dryrun.py`` does (building lowers nothing). JAX's block leaves
carry a leading ``"stack"`` dim the port's per-layer parameters do not
have, and a group dim on the caches; the port's spec of every layer must
equal JAX's less that leading ``None``. The cells' other decisions (the
remat choice for training, ``n_micro``, the moment type, the decode
cache's ``seq_axes``) show in those notes, FLOPs and specs. On a
``MeshLayout`` every cell's ``fn`` is None; on a ``Mesh`` every cell,
MoE and train cells included, runs the rank's part.
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
from repro_torch.models import transformer as tfm
from repro_torch.nn.module import set_activation_rules

ROOT = Path(__file__).resolve().parents[1]
LM_CELLS = [c for c in base.all_cells()[0] if base.get(c[0]).family == "lm"]

JAX_CELLS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import NamedSharding
from repro.configs import base
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


def flat(tree):
    if tree is None:
        return None
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {key(p): [list(e) if isinstance(e, tuple) else e
                     for e in leaf.spec] for p, leaf in leaves}


def record(c):
    return dict(kind=c.kind, model_flops=c.model_flops, notes=c.notes,
                donate=list(c.donate), iters_scale=c.iters_scale,
                specs=flat(c.in_shardings), out=flat(c.out_shardings))


out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape in CELLS:
        out[f"{arch}/{shape}/{multi}"] = record(
            steps.build_cell(arch, shape, mesh, multi))
        out[f"{arch}/{shape}/{multi}/comps"] = [
            record(c) for c in steps.lm_components(arch, shape, mesh, multi)]
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = f"CELLS = {LM_CELLS!r}\n" + JAX_CELLS
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.split("JSON", 1)[1])


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)


def _spec(spec, lead=False):
    return ([None] if lead else []) + [list(e) if isinstance(e, tuple)
                                       else e for e in spec]


def jax_view(tree, cfg, prefix, grouped=False) -> dict:
    """A port spec tree keyed as JAX's flattened tree: parameters by
    ``jax_path`` (block leaves with JAX's leading stack ``None``, or as
    one group's ``layer_{j}`` without it), caches by ``layer_{j}`` with
    the group dim, AdamW by ``step``/``mu``/``nu``. Every layer of a
    slot must give the same spec."""
    out = {}

    def put(k, s):
        assert out.setdefault(k, s) == s, (k, out[k], s)

    if isinstance(tree, steps.AdamWState):
        put(prefix + "step", _spec(tree.step))
        for f in ("mu", "nu"):
            out.update(jax_view(getattr(tree, f), cfg, f"{prefix}{f}/"))
    elif isinstance(tree, list):  # caches, one a layer
        for i, c in enumerate(tree):
            for f in c._fields:
                put(f"{prefix}layer_{i % cfg.group_size}/{f}",
                    _spec(getattr(c, f), lead=not grouped))
    elif isinstance(tree, dict) and any("." in k for k in tree):
        for name, s in tree.items():
            path, g = tfm.jax_path(cfg, name)
            if grouped:
                put(prefix + "/".join(path[1:]), _spec(s))
            else:
                put(prefix + "/".join(path), _spec(s, lead=g is not None))
    elif isinstance(tree, dict):  # a batch
        for k, s in tree.items():
            put(prefix + k, _spec(s))
    else:
        put(prefix.rstrip("/"), _spec(tree))
    return out


def port_record(c, grouped=False):
    cfg = c.config

    def flat(t):
        if t is None:
            return None
        out = {}
        for i, part in enumerate(t):
            g = grouped and i < 2 and c.decisions["component"] in (
                "layer_group_fwd_bwd", "layer_group_prefill", "decode_group")
            out.update(jax_view(part, cfg, f"{i}/", g))
        return out

    return dict(kind=c.kind, model_flops=c.model_flops, notes=c.notes,
                donate=list(c.donate), iters_scale=c.iters_scale,
                specs=flat(c.in_shardings), out=flat(c.out_shardings))


@pytest.mark.parametrize("multi", [False, True])
def test_lm_cells_match_jax_on_production_meshes(jax_cells, multi):
    layout = make_production_mesh(multi_pod=multi)
    for arch, shape in LM_CELLS:
        cell = steps.build_cell(arch, shape, layout, multi)
        assert cell.fn is None and "cannot hold" in cell.decisions["fn"]
        got, want = port_record(cell), jax_cells[f"{arch}/{shape}/{multi}"]
        assert got == want, (arch, shape, multi)
        comps = steps.lm_components(arch, shape, layout, multi)
        want = jax_cells[f"{arch}/{shape}/{multi}/comps"]
        assert [port_record(c, grouped=True) for c in comps] == want, \
            (arch, shape, multi)


def test_lm_cell_decisions():
    """The decisions JAX's notes and specs carry, spelled out."""
    layout = make_production_mesh()
    d = {(a, s): steps.build_cell(a, s, layout, False).decisions
         for a, s in LM_CELLS}
    # the saved sublayer outputs stay under 6 GB a device for every arch
    # at 256 x 4,096 (deepseek's 62 layers: 2.73 GB), so none takes "full"
    assert {d[a, s]["remat"] for a, s in LM_CELLS if s == "train_4k"} == \
        {"minimal"}
    assert d["llama4-maverick-400b-a17b", "train_4k"]["moment_dtype"] == \
        "bfloat16"
    assert d["minicpm-2b", "train_4k"]["moment_dtype"] == "float32"
    assert d["llama4-maverick-400b-a17b", "train_4k"]["n_micro"] == 8
    assert d["gemma2-2b", "decode_32k"]["seq_axes"] == ("model",)
    assert d["gemma2-2b", "decode_32k"]["cache_batch"] == ("data",)
    assert d["gemma2-2b", "long_500k"]["seq_axes"] == ("data", "model")
    assert d["gemma2-2b", "long_500k"]["cache_batch"] is None
    assert d["minicpm-2b", "prefill_32k"]["seq_parallel"]
    assert not d["minicpm-2b", "decode_32k"]["seq_parallel"]


def test_mesh_cells_raise_for_train_and_moe():
    """Every cell runs on a ``Mesh`` now: the dense archs' train cells
    and every MoE cell, train included, build a runnable ``fn`` (nothing
    raises; the MoE runs are ``test_torch_moe_mesh.py``'s)."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    assert not hasattr(steps, "TRAIN_ITEM")
    assert not hasattr(steps.tmesh, "MOE_ITEM")
    for arch in ("minicpm-2b", "gemma2-2b", "deepseek-coder-33b"):
        cell = steps.build_cell(arch, "train_4k", mesh, False)
        assert callable(cell.fn) and cell.decisions["fn"] is None
    for arch in ("olmoe-1b-7b", "llama4-maverick-400b-a17b"):
        for shape in ("prefill_32k", "decode_32k", "train_4k"):
            cell = steps.build_cell(arch, shape, mesh, False)
            assert callable(cell.fn) and cell.decisions["fn"] is None
    assert steps.build_cell("olmoe-1b-7b", "train_4k", mesh,
                            False).decisions["n_micro"] == 4
    cell = steps.build_cell("minicpm-2b", "prefill_32k", mesh, False)
    assert callable(cell.fn) and cell.decisions["fn"] is None
    assert cell.args[0]["embed.table"].device == torch.device("meta")
