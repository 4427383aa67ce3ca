"""The port's training loss, gradients and AdamW steps against the JAX
package, per smoke arch, on the CPU.

JAX's weights are carried across (``transformer.state_from_jax``), the
batch is seeded numpy, and the port's ``loss_fn`` runs forward and
backward on the CPU (the scan attention route, per-layer checkpoints,
the streamed cross-entropy):

Each arch runs with ``remat="dots"`` and a cross-entropy chunk of 8 on
both sides (two chunks of the 16-token sequence), and JAX's side is one
jitted step (``jax.value_and_grad(transformer.loss_fn)``, then
``adamw_update``) called twice, shared by the two tests of the arch:

- the loss and every gradient leaf of the first step. Tolerance: the
  loss at rtol 1e-6; each leaf at 1e-5 of its own largest magnitude,
  except a leaf whose largest magnitude is below 1% of its layer's
  largest gradient: such a leaf (the MoE routers of llama4's interleaved
  layers: they reach the loss only through the renormalized top-k gates
  and the 0.01-weighted aux term, so their gradient is a small difference
  of products of O(1) activations) carries the same absolute rounding as
  the rest of its layer, and is held at 1e-6 of the layer's largest
  magnitude; the test lists those leaves. One bfloat16 case (MiniCPM):
  both packages round every intermediate to bfloat16, at other places;
  each leaf within 2^-5 of its largest magnitude with a cosine of at
  least 0.999 to JAX's, the loss at rtol 1e-3.
- the two steps of JAX's ``test_lm_smoke.py::test_train_step`` (AdamW lr
  1e-3, the same batch twice): loss1 and loss2 at rtol
  1e-6, the gradient norm at rtol 1e-5, and the parameters after each
  step within 0.1 lr everywhere and within 1e-6 for at least 99.9% of
  them. An AdamW step moves a parameter by about lr * mhat / (sqrt(vhat)
  + eps): where a gradient is within a few hundred times the packages'
  1e-7 rounding difference of zero, that ratio (and so the step) moves by
  up to a tenth of lr. The update rule itself is held bitwise against
  JAX's in ``tests/test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as jtfm
from repro.nn.module import split_boxed
from repro.optim import adamw as jadam

from repro_torch.configs import base as tbase
from repro_torch.models import transformer as ttfm
from repro_torch.nn import attention as tattn
from repro_torch.optim import adamw as tadam

ARCHS = ["deepseek-coder-33b", "gemma2-2b", "llama4-maverick-400b-a17b",
         "minicpm-2b", "olmoe-1b-7b"]
LR = 1e-3


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree, np.float32)


def at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


def configs(arch, **replace):
    jc = dataclasses.replace(jbase.get(arch).smoke_config(), **replace)
    tc = dataclasses.replace(tbase.get(arch).smoke_config(), **{
        k: (torch.bfloat16 if v == jnp.bfloat16 else v)
        for k, v in replace.items()})
    return jc, tc


def batch_of(cfg, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def carried(jc, tc, ocfg):
    """JAX's init and AdamW state, and the port's model and state holding
    the same values."""
    params, _ = split_boxed(jtfm.init(jax.random.PRNGKey(0), jc))
    opt = jadam.adamw_init(params, ocfg)
    tree = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    model, topt = ttfm.state_from_jax(tc, tree, "cpu")
    return params, opt, model, topt


_JAX_STEPS: dict = {}


def jax_two_steps(arch):
    """JAX's two jitted steps of an arch (computed once per process):
    (loss, grads, params, grad norm) after each, as numpy."""
    if arch not in _JAX_STEPS:
        jc, tc = configs(arch, ce_chunk=8, remat="dots")
        jcfg = jadam.AdamWConfig(lr=LR)
        params, opt, _, _ = carried(jc, tc, jcfg)

        @jax.jit
        def step(params, opt, batch):
            loss, grads = jax.value_and_grad(jtfm.loss_fn)(params, jc, batch)
            params, opt, gnorm = jadam.adamw_update(grads, opt, params, jcfg)
            return params, opt, loss, grads, gnorm

        jb = jax.tree.map(jnp.asarray, batch_of(jc))
        out = []
        for _ in range(2):
            params, opt, loss, grads, gnorm = step(params, opt, jb)
            out.append(jax.tree.map(np.asarray, (loss, grads, params,
                                                 gnorm)))
        _JAX_STEPS[arch] = out
    return _JAX_STEPS[arch]


def port_loss_and_grads(model, cfg, batch):
    calls = dict(tattn.route_calls)
    loss = ttfm.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert tattn.route_calls["kernel"] == calls["kernel"]
    assert tattn.route_calls["scan"] > calls["scan"]  # by name, the scan
    loss.backward()
    return loss.item(), ttfm.grads_to_numpy(model)


def layer_of(path):
    return path[:2] if path[0] == "blocks" else path


def check_grads(got, exp, own_rel=1e-5, layer_rel=1e-6):
    """Every leaf within ``own_rel`` of its largest magnitude, or, for a
    leaf below 1% of its layer's largest gradient, within ``layer_rel`` of
    the layer's. Returns the paths of the latter."""
    layer_max: dict = {}
    for path, g in leaves(exp):
        key = layer_of(path)
        layer_max[key] = max(layer_max.get(key, 0.0), float(np.abs(g).max()))
    small = []
    for path, g in leaves(exp):
        own, lay = float(np.abs(g).max()), layer_max[layer_of(path)]
        if own >= 0.01 * lay:
            tol = own_rel * own
        else:
            small.append(path)
            tol = layer_rel * lay
        np.testing.assert_allclose(at(got, path), g, rtol=0, atol=tol,
                                   err_msg="/".join(path))
    return small


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jc, tc = configs(arch, ce_chunk=8, remat="dots")
    _, _, model, _ = carried(jc, tc, jadam.AdamWConfig())
    (exp_loss, exp, _, _), _ = jax_two_steps(arch)
    loss, got = port_loss_and_grads(model, tc, batch_of(jc))
    np.testing.assert_allclose(loss, float(exp_loss), rtol=1e-6)
    small = check_grads(got, exp)
    assert all(path[-2] == "router" for path in small), small
    # padded vocab rows get no gradient, as through JAX's concatenate
    table = "embed" if tc.tie_embeddings else "unembed"
    assert not at(got, (table, "table"))[tc.vocab:].any()


def test_bfloat16_loss_and_grads_match_jax():
    jc, tc = configs("minicpm-2b", dtype=jnp.bfloat16, ce_chunk=8)
    params, _, model, _ = carried(jc, tc, jadam.AdamWConfig())
    assert model.embed.table.dtype == torch.bfloat16
    batch = batch_of(jc)
    exp_loss, exp = jax.value_and_grad(jtfm.loss_fn)(
        params, jc, jax.tree.map(jnp.asarray, batch))
    loss, got = port_loss_and_grads(model, tc, batch)
    np.testing.assert_allclose(loss, float(exp_loss), rtol=1e-3)
    for path, g in leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       exp)):
        t = at(got, path)
        np.testing.assert_allclose(t, g, rtol=0,
                                   atol=2 ** -5 * np.abs(g).max(),
                                   err_msg="/".join(path))
        cos = float((t * g).sum() / max(np.linalg.norm(t) * np.linalg.norm(g),
                                        1e-30))
        assert cos >= 0.999, (path, cos)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch):
    """``test_lm_smoke.py::test_train_step`` in both packages."""
    jc, tc = configs(arch, ce_chunk=8, remat="dots")
    tcfg = tadam.AdamWConfig(lr=LR)
    _, _, model, topt = carried(jc, tc, jadam.AdamWConfig(lr=LR))
    (loss1, _, p1, g1), (loss2, _, p2, _) = jax_two_steps(arch)
    before = ttfm.params_to_numpy(model)
    tb = {k: torch.from_numpy(v) for k, v in batch_of(jc).items()}
    got = []
    for _ in range(2):
        loss = ttfm.loss_fn(model, tc, tb)
        loss.backward()
        named = dict(model.named_parameters())
        _, topt, gnorm = tadam.adamw_update(
            {k: p.grad for k, p in named.items()}, topt, named, tcfg)
        model.zero_grad()
        got.append((loss.item(), gnorm.item(), ttfm.params_to_numpy(model)))
    (t1, tg1, tp1), (t2, _, tp2) = got
    np.testing.assert_allclose([t1, t2], [float(loss1), float(loss2)],
                               rtol=1e-6)
    assert t2 < t1 and float(loss2) < float(loss1)  # same-batch overfit
    np.testing.assert_allclose(tg1, float(g1), rtol=1e-5)
    assert np.isfinite(tg1) and tg1 > 0
    assert int(topt.step) == 2
    for tp, jp in ((tp1, p1), (tp2, p2)):
        n = loose = 0
        for path, exp in leaves(jp):
            d = np.abs(at(tp, path) - exp)
            assert d.max() <= 0.1 * LR, "/".join(path)
            n, loose = n + d.size, loose + int((d > 1e-6).sum())
        assert loose <= 1e-3 * n, (loose, n)
    moved = max(float(np.abs(at(tp1, p) - b).max())
                for p, b in leaves(before))
    assert moved > 0  # params actually changed
