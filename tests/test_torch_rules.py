"""The logical-axis rules (``nn/module.py``) against the JAX package's.

- ``sharding_rules`` and ``logical_to_spec`` equal JAX's for every
  ``multi_pod`` x ``seq_parallel`` combination, the ``None`` key
  included, on every logical axis and on every parameter's axes.
- ``param_axes`` of the five LM archs' full configs (built on ``meta``)
  equals JAX's ``split_boxed`` axes tree by ``jax_path``; a block leaf's
  axes are JAX's less the leading ``"stack"``.
- ``shard_params`` cuts every parameter of three smoke models (MHA,
  GQA with local layers, MoE) to JAX's ``devices_indices_map`` block of
  the device at the rank's coordinates on a 2 x 2 ``("data", "model")``
  mesh of fake devices (a JAX subprocess gives the indices under JAX's
  ``_sanitize``d shardings), and its specs equal ``steps._sanitize``'s.
- ``shard_activation`` is the identity without rules or without a mesh
  of several ranks, and asks for the layout a tensor has otherwise.
"""
import copy
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as jtfm
from repro.nn import module as jmod
from repro_torch.configs import base
from repro_torch.models import transformer as tfm
from repro_torch.nn import module as tmod

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["deepseek-coder-33b", "gemma2-2b", "llama4-maverick-400b-a17b",
         "minicpm-2b", "olmoe-1b-7b"]
SHARD_ARCHS = ["minicpm-2b", "gemma2-2b", "olmoe-1b-7b"]
COMBOS = [(m, s) for m in (False, True) for s in (False, True)]


@pytest.fixture(autouse=True)
def no_rules():
    yield
    tmod.set_activation_rules(None)


@pytest.mark.parametrize("multi,sp", COMBOS)
def test_rules_and_specs_equal_jax(multi, sp):
    t, j = tmod.sharding_rules(multi, sp), jmod.sharding_rules(multi, sp)
    assert t == j and None in t
    every = [(a,) for a in t] + [("embed", "mlp"), ("vocab", "embed"),
                                 ("batch", "res_seq", None),
                                 ("experts", None, "embed"),
                                 ("seq_shard", "act_model", None),
                                 ("unknown", "batch")]
    for axes in every:
        assert tmod.logical_to_spec(axes, t) == \
            tuple(jmod.logical_to_spec(axes, j)), axes
    tree = {"a.kernel": ("embed", "mlp"), "b.scale": (None,)}
    assert tmod.specs_from_axes(tree, t) == {
        k: tuple(jmod.logical_to_spec(v, j)) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_jax(arch):
    jcfg = jbase.get(arch).full_config()
    boxed = jax.eval_shape(lambda: jtfm.init(jax.random.PRNGKey(0), jcfg))
    _, jaxes = jmod.split_boxed(boxed)
    cfg = base.get(arch).full_config()
    axes = tmod.param_axes(tfm.init(cfg, None, "meta"))
    assert len(axes) > 0
    for name, a in axes.items():
        path, g = tfm.jax_path(cfg, name)
        want = jaxes
        for k in path:
            want = want[k]
        if g is not None:
            assert want[0] == "stack", name
            want = want[1:]
        assert a == tuple(want), name
    with pytest.raises(KeyError, match="without logical axes"):
        tmod.param_axes(torch.nn.Linear(2, 2))


JAX_BLOCKS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import base
from repro.launch.mesh import make_mesh
from repro.launch.steps import _sanitize
from repro.models import transformer as tfm
from repro.nn.module import sharding_rules, shardings_from_axes, split_boxed

mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch in ARCHS:
    cfg = base.get(arch).smoke_config()
    boxed = jax.eval_shape(lambda: tfm.init(jax.random.PRNGKey(0), cfg))
    params, axes = split_boxed(boxed)
    rules = sharding_rules(False, False)
    sh = _sanitize(params, shardings_from_axes(axes, mesh, rules), mesh)
    leaves = jax.tree_util.tree_flatten_with_path(sh)[0]
    shapes = dict((jax.tree_util.keystr(p), l.shape)
                  for p, l in jax.tree_util.tree_flatten_with_path(params)[0])
    rec = {}
    for path, s in leaves:
        key = "/".join(str(k.key) for k in path)
        idx = s.devices_indices_map(shapes[jax.tree_util.keystr(path)])
        blocks = {}
        for i in range(2):
            for j in range(2):
                sl = idx[mesh.devices[i, j]]
                blocks[f"{i},{j}"] = [[x.start, x.stop] for x in sl]
        rec[key] = {"spec": [list(e) if isinstance(e, tuple) else e
                             for e in s.spec], "blocks": blocks}
    out[arch] = rec
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_blocks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = f"ARCHS = {SHARD_ARCHS!r}\n" + JAX_BLOCKS
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.split("JSON", 1)[1])


def stub_mesh(i: int, j: int):
    """The coordinates of rank (i, j) of a 2 x 2 mesh (``shard_params``
    reads shape and coordinates only; nothing is sent)."""
    coords = {"data": i, "model": j}
    return types.SimpleNamespace(shape={"data": 2, "model": 2},
                                 axis_names=("data", "model"),
                                 coord=coords.__getitem__)


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_shard_params_blocks_equal_devices_indices_map(jax_blocks, arch):
    jcfg = jbase.get(arch).smoke_config()
    params, _ = jmod.split_boxed(jtfm.init(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, params)
    cfg = base.get(arch).smoke_config()
    full = tfm.params_from_jax(cfg, tree, device="cpu")
    rules = tmod.sharding_rules(False, False)
    want = jax_blocks[arch]
    sharded = 0
    for i in range(2):
        for j in range(2):
            model = copy.deepcopy(full)
            specs = tmod.shard_params(model, stub_mesh(i, j), rules)
            assert model.shard_specs is specs
            for name, p in model.named_parameters():
                path, g = tfm.jax_path(cfg, name)
                w = want["/".join(path)]
                jspec = w["spec"][1:] if g is not None else w["spec"]
                assert [list(e) if isinstance(e, tuple) else e
                        for e in specs[name]] == jspec, name
                sl = tuple(slice(a, b) for a, b in w["blocks"][f"{i},{j}"])
                leaf = tree
                for k in path:
                    leaf = leaf[k]
                exp = leaf[sl] if g is None else leaf[sl][g]
                np.testing.assert_array_equal(p.detach().numpy(), exp,
                                              err_msg=f"{name} @ {i},{j}")
                sharded += p.shape != full.get_parameter(name).shape
    assert sharded > 0


def test_sanitize_and_shard_activation():
    # a dim that does not divide its axes stays replicated, as JAX's
    assert tmod.sanitize_spec((6, 8), ("data", "model"),
                              {"data": 4, "model": 2}) == (None, "model")
    assert tmod.sanitize_spec((8,), ("data",), {"data": 1}) == (None,)
    assert tmod.sanitize_spec((4, 4), (("data", "model"),),
                              {"data": 2, "model": 2}) == (
                                  ("data", "model"), None)
    x = torch.arange(12.0).reshape(3, 4)
    assert tmod.shard_activation(x, ("batch", None)) is x  # no rules
    rules = tmod.sharding_rules()
    tmod.set_activation_rules(rules)  # rules without a mesh
    assert tmod.shard_activation(x, ("batch", None)) is x
    one = types.SimpleNamespace(size=1)
    tmod.set_activation_rules(rules, one)
    assert tmod.shard_activation(x, ("batch", None)) is x
    tmod.set_activation_rules(rules, types.SimpleNamespace(size=4))
    with pytest.raises(ValueError, match="have="):
        tmod.shard_activation(x, ("batch", None))
    assert tmod.activation_rules()[0] is rules
    tmod.set_activation_rules(None, one)
    assert tmod.activation_rules() == (None, None)
