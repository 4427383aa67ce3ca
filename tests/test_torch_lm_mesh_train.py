"""LM training on a mesh of ranks (``launch/steps.py``'s ``_lm_cell``
train step on a ``Mesh``, ``models/transformer_mesh.py``'s ``loss_fn``)
against JAX's unsharded step and the port's one-rank run.

Four gloo CPU ranks a mesh, ``(2, 2)`` and ``(1, 4)`` over ``("data",
"model")`` (``test_torch_ranks.lm_train_rank``), train the float32
smoke configs of ``minicpm-2b``, ``gemma2-2b`` and
``deepseek-coder-33b`` (its ``n_micro`` of 4 at global batch 8, two
rows a microbatch over ``data``) for two steps from JAX's train state,
the cell's remat (``minimal``) and a cross-entropy chunk of 8 (two
chunks of 16 tokens); ``(2, 2)`` also trains MiniCPM in bfloat16. The
reference is JAX's ``train_step`` of ``_lm_cell`` run unsharded and
jitted: ``value_and_grad(loss_fn)`` under the ``n_micro`` scan (float32
sums, divided by ``n_micro``), then ``adamw_update`` at lr 3e-4. Each
case holds, after each step:

- the loss and the gradient norm at rtol 1e-5;
- each moment leaf within 1e-5 of its largest magnitude;
- the parameters within 1e-6 for at least 99.9% of them, and within
  0.1 lr everywhere but where the step's gradient is rounding-sized
  or zero (below 1e-6 of its leaf's largest magnitude; zero on the
  table rows no token reads):
  a first AdamW step moves a parameter by ``lr g / (|g| + 1e-8)``, so
  a gradient whose true value is about 1e-9 moves by a tenth of lr for
  each 1e-9 of rounding, and the ranks (or the one-rank cell's
  cross-entropy) add in other orders than JAX; there, within 2 lr a
  step (no AdamW step moves further);
- the same against the port's one-rank cell (a ``(1, 1)`` mesh: every
  collective the identity);
- every rank's ``Wire`` records, by kind and group, equal to
  ``collective_schedule(kind="train")``'s count for the two steps.

bfloat16 (both packages round every intermediate to bfloat16, in other
places): each leaf of the state after a step within 2^-5 of its largest
magnitude with a cosine of at least 0.999 to JAX's, the loss at rtol
1e-3.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as jtfm
from repro.nn.module import split_boxed
from repro.optim import adamw as jadam
from repro_torch.configs import base
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models import transformer as ttfm
from repro_torch.nn.module import set_activation_rules

import test_torch_ranks as TR

LR = 3e-4
RTOL = 1e-5
MOMENT_TOL = 1e-5
PARAM_ABS = 1e-6
PARAM_LOOSE = 1e-3
ROUNDING = 1e-6  # a gradient below this share of its leaf's largest
BF16_TOL = 2 ** -5
BF16_COS = 0.999
CASES = [(shape, arch, dtype) for shape, cases in TR.LM_TRAIN_CASES.items()
         for arch, dtype, _, _ in cases]
F32 = [c for c in CASES if c[2] == "float32"]


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)


def _dims(arch, dtype):
    """(global batch, length) of a case (the same on every mesh)."""
    return next(c[2:] for cs in TR.LM_TRAIN_CASES.values() for c in cs
                if c[:2] == (arch, dtype))


def jax_config(arch, dtype):
    return dataclasses.replace(
        jbase.get(arch).smoke_config(), ce_chunk=TR.LM_TRAIN_CE,
        remat="minimal", dtype=getattr(jnp, dtype))


def port_config(arch, dtype):
    return dataclasses.replace(
        base.get(arch).smoke_config(), ce_chunk=TR.LM_TRAIN_CE,
        dtype=getattr(torch, dtype))


def jax_state(arch, dtype):
    """JAX's init and fresh AdamW state as numpy (float32 leaves: the
    bfloat16 values exactly)."""
    params, _ = split_boxed(jtfm.init(jax.random.PRNGKey(0),
                                      jax_config(arch, dtype)))
    opt = jadam.adamw_init(params, jadam.AdamWConfig(lr=LR))
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        {"params": params, "opt": opt})


@pytest.fixture(scope="module")
def trees():
    return {(a, d): jax_state(a, d) for _, a, d in CASES}


@pytest.fixture(scope="module")
def ranks(trees):
    """Both meshes' rank groups, started in threads while JAX steps."""
    pool = ThreadPoolExecutor(len(TR.LM_TRAIN_CASES))
    runs = {shape: pool.submit(run_ranks, TR.lm_train_rank, 4,
                               (shape, trees), timeout_s=300)
            for shape in TR.LM_TRAIN_CASES}
    yield runs
    pool.shutdown(wait=True)


def _flat(cfg, tree) -> dict:
    """JAX's tree (blocks stacked by group) by the port's names."""
    model = ttfm.init(cfg, None, "meta")
    out = {}
    for name, _ in model.named_parameters():
        path, g = ttfm.jax_path(cfg, name)
        leaf = tree
        for k in path:
            leaf = leaf[k]
        out[name] = np.asarray(leaf if g is None else leaf[g], np.float32)
    return out


_JAX: dict = {}


def jax_steps(arch, dtype, trees):
    """JAX's train step of ``_lm_cell`` (unsharded, jitted), twice on the
    case's batch: (loss, norm, {"params", "mu", "nu"} by the port's
    names) after each."""
    key = (arch, dtype)
    if key not in _JAX:
        jc, tc = jax_config(arch, dtype), port_config(arch, dtype)
        b, seq = _dims(arch, dtype)
        n_micro = steps._N_MICRO.get(arch, 1)
        ocfg = jadam.AdamWConfig(lr=LR)
        tree = trees[key]
        params = jax.tree.map(lambda a: jnp.asarray(a, jc.dtype),
                              tree["params"])
        opt = jadam.adamw_init(params, ocfg)

        @jax.jit
        def step(params, opt, batch):
            if n_micro == 1:
                loss, grads = jax.value_and_grad(jtfm.loss_fn)(params, jc,
                                                               batch)
            else:
                mb = jax.tree.map(lambda a: a.reshape(
                    n_micro, b // n_micro, *a.shape[1:]), batch)

                def micro(acc, bt):
                    l, g = jax.value_and_grad(jtfm.loss_fn)(params, jc, bt)
                    return jax.tree.map(jnp.add, acc, g), l

                zeros = jax.tree.map(
                    lambda p: jnp.zeros(p.shape, jnp.float32), params)
                grads, losses = jax.lax.scan(micro, zeros, mb)
                grads = jax.tree.map(lambda g: g / n_micro, grads)
                loss = losses.mean()
            params, opt, gnorm = jadam.adamw_update(grads, opt, params, ocfg)
            return params, opt, loss, gnorm

        batch = jax.tree.map(jnp.asarray, TR.lm_train_batch(jc.vocab, b,
                                                            seq))
        out = []
        for _ in range(TR.LM_TRAIN_STEPS):
            params, opt, loss, gnorm = step(params, opt, batch)
            state = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 {"params": params, "mu": opt.mu,
                                  "nu": opt.nu})
            out.append((float(loss), float(gnorm),
                        {k: _flat(tc, v) for k, v in state.items()}))
        _JAX[key] = out
    return _JAX[key]


_ONE: dict = {}


def one_rank(arch, dtype, trees):
    """The port's cell on a ``(1, 1)`` mesh, the same steps."""
    if (arch, dtype) not in _ONE:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        cell = TR.lm_train_cell(mesh, arch, *_dims(arch, dtype), dtype)
        _ONE[arch, dtype] = TR.lm_train_run(cell, mesh, trees[arch, dtype])
        assert mesh.wire.calls == 0
    return _ONE[arch, dtype]


def leaf_tol(part: str, name: str, exp: dict) -> float:
    """A moment leaf's tolerance: ``MOMENT_TOL`` of its largest
    magnitude."""
    return MOMENT_TOL * float(np.abs(exp[part][name]).max())


def check_state(got: dict, exp: dict, what: str, tiny: dict,
                moment_tol=leaf_tol) -> None:
    """``got`` against ``exp`` after a step (the module docstring's
    list); ``tiny``: by name, where a step so far had a rounding-sized
    gradient; ``moment_tol(part, name, exp)``: a moment leaf's
    tolerance."""
    for part in ("mu", "nu"):
        for name, e in exp[part].items():
            tol = moment_tol(part, name, exp)
            np.testing.assert_allclose(got[part][name], e, rtol=0, atol=tol,
                                       err_msg=f"{what} {part} {name}")
    n = loose = 0
    for name, e in exp["params"].items():
        d = np.abs(got["params"][name] - e)
        assert (d[~tiny[name]] <= 0.1 * LR).all(), (what, name,
                                                    float(d.max()))
        assert (d <= 2 * LR).all(), (what, name, float(d.max()))
        n, loose = n + d.size, loose + int((d > PARAM_ABS).sum())
    assert loose <= PARAM_LOOSE * n, (what, loose, n)


def check_run(run, want, what, moment_tol=leaf_tol):
    """Each step of ``run`` against ``want``'s (loss, norm, state); a
    step's gradient (clipped) is ``(mu - b1 mu_before) / (1 - b1)``."""
    tiny, mu0 = None, None
    for i, ((loss, gnorm), (el, eg, state)) in enumerate(zip(run["steps"],
                                                             want)):
        np.testing.assert_allclose([loss, gnorm], [el, eg], rtol=RTOL,
                                   err_msg=f"{what} step {i}")
        grads = {k: (v - (0 if mu0 is None else 0.9 * mu0[k])) / 0.1
                 for k, v in state["mu"].items()}
        now = {k: np.abs(g) <= ROUNDING * np.abs(g).max()
               for k, g in grads.items()}
        tiny = now if tiny is None else {k: tiny[k] | now[k] for k in now}
        mu0 = state["mu"]
        check_state(run["states"][i], state, f"{what} step {i}", tiny,
                    moment_tol)


@pytest.mark.parametrize("shape,arch,dtype", F32)
def test_mesh_train_matches_jax(ranks, trees, shape, arch, dtype):
    want = jax_steps(arch, dtype, trees)
    for r, rep in enumerate(ranks[shape].result()):
        check_run(rep[arch, dtype], want, f"{shape} {arch} rank {r}")
    assert want[1][0] < want[0][0]  # the same batch twice: it descends


@pytest.mark.parametrize("shape,arch,dtype", F32)
def test_mesh_train_matches_one_rank(ranks, trees, shape, arch, dtype):
    one = one_rank(arch, dtype, trees)
    want = [(l, g, s) for (l, g), s in zip(one["steps"], one["states"])]
    for r, rep in enumerate(ranks[shape].result()):
        check_run(rep[arch, dtype], want, f"{shape} {arch} rank {r}")


def test_one_rank_train_cell_matches_jax(trees):
    """The ``(1, 1)`` cell (what ``dryrun --mesh card`` runs) against
    JAX, for every arch: nothing is sent."""
    for arch in {a for _, a, _ in F32}:
        check_run(one_rank(arch, "float32", trees),
                  jax_steps(arch, "float32", trees), f"one rank {arch}")


def test_bfloat16_mesh_train_matches_jax(ranks, trees):
    want = jax_steps("minicpm-2b", "bfloat16", trees)
    for r, rep in enumerate(ranks[2, 2].result()):
        run = rep["minicpm-2b", "bfloat16"]
        for i, ((loss, _), (el, _, state)) in enumerate(zip(run["steps"],
                                                            want)):
            np.testing.assert_allclose(loss, el, rtol=1e-3)
            for part, leaves in state.items():
                for name, e in leaves.items():
                    t = run["states"][i][part][name]
                    np.testing.assert_allclose(
                        t, e, rtol=0, atol=BF16_TOL * np.abs(e).max(),
                        err_msg=f"rank {r} step {i} {part} {name}")
                    cos = float((t * e).sum() / max(
                        np.linalg.norm(t) * np.linalg.norm(e), 1e-30))
                    assert cos >= BF16_COS, (r, i, part, name, cos)


@pytest.mark.parametrize("shape,arch,dtype", CASES)
def test_mesh_train_collectives_follow_the_schedule(ranks, shape, arch,
                                                    dtype):
    """Each rank's ``Wire`` records equal the schedule exactly: FSDP
    gathers and the gradients' reduce-scatters on ``data``, the SP
    gathers, reduce-scatters and their transposes, the cross-entropy's
    all-reduces and sums on ``model``."""
    for rep in ranks[shape].result():
        run = rep[arch, dtype]
        assert run["wire"]["by_kind"] == run["schedule"]
        model = run["wire"]["by_axis"]["model"]
        assert model["reduce-scatter"][0] > 0 and model["all-reduce"][0] > 0
        if shape[0] > 1:
            assert run["wire"]["by_axis"]["data"]["reduce-scatter"][0] > 0
        assert run["n_micro"] == steps._N_MICRO.get(arch, 1)


def test_train_cell_refuses_a_batch_off_its_microbatches():
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    cell = TR.lm_train_cell(mesh, "deepseek-coder-33b", 6, 16, "float32")
    model = ttfm.init(cell.config, torch.Generator().manual_seed(0), "cpu")
    model.requires_grad_(True)
    steps.shard_lm(cell, model, mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             TR.lm_train_batch(cell.config.vocab, 6, 16).items()}
    with pytest.raises(ValueError, match="n_micro=4"):
        cell.fn(model, None, batch)
