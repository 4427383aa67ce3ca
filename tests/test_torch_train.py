"""The port's training substrate against the JAX package, on the CPU.

Seeded numpy inputs go through ``repro``'s function and the port's
counterpart (``repro_torch.optim``, ``.data``, ``.checkpoint``,
``.runtime.fault_tolerance``, ``.launch.train``):

- both LR schedules over every step of several runs: bitwise (the port
  calls the C library's ``cosf``/``powf``, which XLA's CPU backend uses);
- ``adamw_update`` on random trees against JAX's, evaluated eagerly (as
  op-by-op XLA, no fusion), for float32 and bfloat16 moments, clipping
  off, on but not reached, and active, ``lr_scale`` at 0, in between and
  1: bitwise wherever the clip scale is 1; where clipping is active, the
  scale is ``clip / norm`` and the norm is a float32 sum of squares that
  the packages add in other orders (one ulp apart), so parameters and
  moments are held at rtol 1e-6 plus 1e-6 of the leaf's largest
  magnitude (a moment that sums gradients of both signs loses relative
  precision near zero); ``lr_scale`` 0 leaves parameters
  bitwise unchanged; JAX's quadratic-convergence case (300 steps, the
  trajectory bitwise JAX's eager one) and bfloat16-moment case;
- all three data streams over seeds, steps and shards: bitwise;
- JAX's checkpoint round trip, mirrored; the snapshot taken at ``save``;
  a smoke train state (float32, and bfloat16 parameters and moments)
  written by JAX and restored by the port, and the reverse: manifest keys,
  shapes and dtypes equal, every leaf bitwise;
- ``TrainGuard``'s injected failures and ``StragglerDetector``'s decisions
  on JAX's timing sequences: the same states, steps, incidents and EWMA;
- gradients with remat on and off: bitwise equal on the CPU, every arch;
- ``launch.train.main --device cpu`` with a crash-restart (JAX's
  ``examples/train_lm.py`` protocol) against JAX's ``main`` on the same
  arguments and weights: every logged loss within 2e-4 (printed to four
  decimals), gradient norm and lr scale as printed.

Per-arch losses, gradients and two-step training against JAX are in
``tests/test_torch_train_grads.py``.
"""
import dataclasses
import json
import re
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import base as jbase
from repro.data import pipeline as jdata
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro.nn.module import split_boxed
from repro.optim import adamw as jadam
from repro.optim import schedules as jsched
from repro.runtime import fault_tolerance as jft

from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadam
from repro_torch.optim import schedules as tsched
from repro_torch.runtime import fault_tolerance as tft

ARCHS = ["deepseek-coder-33b", "gemma2-2b", "llama4-maverick-400b-a17b",
         "minicpm-2b", "olmoe-1b-7b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def f32(x) -> np.ndarray:
    """A JAX array, numpy array or tensor as float32 numpy (bf16 exact)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def tree_paths(tree, prefix=()):
    """(path, leaf) of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def assert_trees_equal(got, exp, what=""):
    paths = [p for p, _ in tree_paths(exp)]
    assert paths == [p for p, _ in tree_paths(got)], what
    for p in paths:
        np.testing.assert_array_equal(f32(at(got, p)), f32(at(exp, p)),
                                      err_msg=f"{what} {p}")


# --------------------------------------------------------------- schedules --

SCHEDULE_RUNS = [(20, 10_000, {}), (10, 100, {"decay_frac": 0.2}),
                 (0, 50, {}), (7, 1000, {"min_ratio": 0.05})]


@pytest.mark.parametrize("name", ["cosine", "wsd"])
@pytest.mark.parametrize("run", range(len(SCHEDULE_RUNS)))
def test_schedules_match_jax_bitwise(name, run):
    warmup, total, kw = SCHEDULE_RUNS[run]
    if name == "cosine":
        kw = {k: v for k, v in kw.items() if k != "decay_frac"}
    jf = jsched.SCHEDULES[name](warmup, total, **kw)
    tf = tsched.SCHEDULES[name](warmup, total, **kw)
    steps = range(0, total + 5, max(1, total // 2000))
    exp = np.array([np.float32(jf(s)) for s in steps])
    got = torch.stack([tf(s) for s in steps])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exp)
    if name == "wsd" and warmup:
        assert float(tf(0)) == 0.0  # the first step updates nothing


# ------------------------------------------------------------------ adamw --

SHAPES = {"a": (5, 7), "b": (33,), "c": (4, 4, 3)}


def jax_and_port_cfgs(moment, clip, lr=1e-2):
    jd, td = DTYPES[moment]
    return (jadam.AdamWConfig(lr=lr, clip_norm=clip, moment_dtype=jd),
            tadam.AdamWConfig(lr=lr, clip_norm=clip, moment_dtype=td))


@pytest.mark.parametrize("lr_scale", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("clip", [None, 100.0, 1.0])
@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment, clip, lr_scale):
    """Four steps on a random tree; JAX's update evaluated eagerly."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = jax_and_port_cfgs(moment, clip)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jo, to = jadam.adamw_init(jp, jcfg), tadam.adamw_init(tp, tcfg)
    assert {t.dtype for t in to.mu.values()} == {DTYPES[moment][1]}
    active = False
    for _ in range(4):
        g = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()}
        scale = jnp.float32(lr_scale)
        jp, jo, jn = jadam.adamw_update({k: jnp.asarray(v)
                                         for k, v in g.items()},
                                        jo, jp, jcfg, scale)
        _, to, tn = tadam.adamw_update({k: torch.from_numpy(v)
                                        for k, v in g.items()},
                                       to, tp, tcfg, torch.tensor(lr_scale))
        assert int(to.step) == int(jo.step) and to.step.dtype == torch.int32
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        active |= clip is not None and float(jn) > clip
        for k in SHAPES:
            for got, exp in ((tp[k], jp[k]), (to.mu[k], jo.mu[k]),
                             (to.nu[k], jo.nu[k])):
                exp = f32(exp)
                tol = (1e-6, 1e-6 * np.abs(exp).max()) if active else (0, 0)
                np.testing.assert_allclose(f32(got), exp, err_msg=k,
                                           rtol=tol[0], atol=tol[1])
            assert to.mu[k].dtype == DTYPES[moment][1]
        if lr_scale == 0.0:
            for k in SHAPES:
                np.testing.assert_array_equal(tp[k].numpy(), p0[k])
    assert active == (clip == 1.0)  # the cases reach what they name


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(3)
    g = {k: (3 * rng.standard_normal(s)).astype(np.float32)
         for k, s in SHAPES.items()}
    g["d"] = rng.standard_normal((8, 8)).astype(np.float32)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    np.testing.assert_allclose(tadam.global_norm(tg).item(),
                               float(jadam.global_norm(jg)), rtol=1e-6)
    jc, jn = jadam.clip_by_global_norm(jg, 1.0)
    tc, tn = tadam.clip_by_global_norm(tg, 1.0)
    for k in g:
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), rtol=1e-6)
    # a bfloat16 gradient is scaled in float32 and rounded back once
    gb = torch.from_numpy(g["a"]).bfloat16()
    out, _ = tadam.clip_by_global_norm({"a": gb}, 1.0)
    exp, _ = jadam.clip_by_global_norm({"a": jnp.asarray(g["a"]).astype(
        jnp.bfloat16)}, 1.0)
    assert out["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(out["a"]), f32(exp["a"]))


def test_adamw_converges_quadratic_like_jax():
    """JAX's ``test_adamw_converges_quadratic``: 300 steps on
    ``sum((w - target)^2)``; the port converges, on JAX's trajectory bit
    for bit (JAX's step evaluated eagerly: under ``jit`` XLA contracts
    products into fused multiply-adds, and this oscillating descent
    carries a one-ulp difference to 3e-4 in 300 steps)."""
    target = np.asarray([1.0, -2.0, 3.0], np.float32)
    jcfg = jadam.AdamWConfig(lr=0.1, weight_decay=0.0)
    tcfg = tadam.AdamWConfig(lr=0.1, weight_decay=0.0)
    jparams = {"w": jnp.zeros(3)}
    jopt = jadam.adamw_init(jparams, jcfg)

    def jstep(p, o):
        loss, g = jax.value_and_grad(
            lambda p: jnp.sum((p["w"] - target) ** 2))(p)
        p, o, _ = jadam.adamw_update(g, o, p, jcfg)
        return p, o, loss

    w = torch.zeros(3, requires_grad=True)
    params = {"w": w}
    opt = tadam.adamw_init(params, tcfg)
    tt = torch.from_numpy(target)
    for _ in range(300):
        jparams, jopt, _ = jstep(jparams, jopt)
        loss = torch.sum((w - tt) ** 2)
        loss.backward()
        _, opt, _ = tadam.adamw_update({"w": w.grad}, opt, params, tcfg)
        w.grad = None
    np.testing.assert_allclose(w.detach().numpy(), target, atol=1e-2)
    np.testing.assert_array_equal(w.detach().numpy(),
                                  np.asarray(jparams["w"]))
    assert int(opt.step) == 300


def test_adamw_bf16_moments_like_jax():
    """JAX's ``test_adamw_bf16_moments``, and the step bitwise JAX's."""
    jcfg = jadam.AdamWConfig(lr=0.01, moment_dtype=jnp.bfloat16)
    tcfg = tadam.AdamWConfig(lr=0.01, moment_dtype=torch.bfloat16)
    jp, jo = {"w": jnp.ones(4)}, None
    jo = jadam.adamw_init(jp, jcfg)
    tp = {"w": torch.ones(4)}
    to = tadam.adamw_init(tp, tcfg)
    assert to.mu["w"].dtype == torch.bfloat16
    jp, jo, _ = jadam.adamw_update({"w": jnp.ones(4)}, jo, jp, jcfg)
    _, to, _ = tadam.adamw_update({"w": torch.ones(4)}, to, tp, tcfg)
    assert to.mu["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(tp["w"]).all())
    np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    np.testing.assert_array_equal(f32(to.mu["w"]), f32(jo.mu["w"]))
    np.testing.assert_array_equal(f32(to.nu["w"]), f32(jo.nu["w"]))


# ------------------------------------------------------------------- data --

STREAMS = {
    "TokenStream": lambda m, **kw: m.TokenStream(
        vocab=515, seq_len=16, global_batch=8, **kw),
    "RecsysStream": lambda m, **kw: m.RecsysStream(
        field_vocabs=tuple(range(3, 29)), global_batch=8, **kw),
    "GraphSeedStream": lambda m, **kw: m.GraphSeedStream(
        n_nodes=1000, batch_nodes=8, **kw),
}


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_streams_match_jax_bitwise(kind):
    for seed in (0, 1, 12345):
        for n_shards in (1, 2, 4):
            for shard in range(n_shards):
                kw = dict(seed=seed, shard=shard, n_shards=n_shards)
                js = STREAMS[kind](jdata, **kw)
                ts = STREAMS[kind](tdata, **kw)
                for step in (0, 1, 7, 1000):
                    exp, got = js.batch(step), ts.batch(step)
                    assert sorted(got) == sorted(exp)
                    for k in exp:
                        assert got[k].dtype == exp[k].dtype, (kind, k)
                        np.testing.assert_array_equal(got[k], exp[k])


# ------------------------------------------------------------ checkpoints --

def test_checkpoint_roundtrip_mirrors_jax(tmp_path):
    """JAX's ``test_checkpoint_roundtrip`` in the port, and the same saves
    made by JAX's manager: manifests and arrays equal."""
    def tree(mult):
        return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)
                * mult,
                "b": {"c": torch.ones(4, dtype=torch.bfloat16) * mult,
                      "d": torch.tensor(7 * mult, dtype=torch.int32)}}

    def jtree(mult):
        return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3) * mult,
                "b": {"c": jnp.ones(4, jnp.bfloat16) * mult,
                      "d": jnp.int32(7 * mult)}}

    mgr = tckpt.CheckpointManager(str(tmp_path / "port"), keep=2)
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"), keep=2)
    for step, mult in ((10, 1), (20, 2), (30, 3)):
        mgr.save(step, tree(mult))
        jmgr.save(step, jtree(mult))
    mgr.wait()
    jmgr.wait()
    assert mgr.all_steps() == [20, 30]  # pruned to keep=2
    like = {"a": torch.zeros(2, 3),
            "b": {"c": torch.zeros(4, dtype=torch.bfloat16),
                  "d": torch.tensor(0, dtype=torch.int32)}}
    restored, step = mgr.restore(like)
    assert step == 30 and restored["a"] is like["a"]  # written in place
    assert_trees_equal(restored, tree(3))
    assert restored["b"]["c"].dtype == torch.bfloat16
    restored20, _ = mgr.restore(like, step=20)
    assert_trees_equal(restored20, tree(2))
    for s in (20, 30):
        mp = json.loads((tmp_path / "port" / f"step_{s}" /
                         "manifest.json").read_text())
        mj = json.loads((tmp_path / "jax" / f"step_{s}" /
                         "manifest.json").read_text())
        assert mp["step"] == mj["step"] == s
        assert mp["leaves"] == mj["leaves"]
        with np.load(tmp_path / "port" / f"step_{s}" / "shards.npz") as a, \
                np.load(tmp_path / "jax" / f"step_{s}" / "shards.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                assert a[f].dtype == b[f].dtype
                np.testing.assert_array_equal(a[f], b[f])
    # a tree of another dtype or shape is refused
    with pytest.raises(ValueError, match="checkpoint holds"):
        mgr.restore({"a": torch.zeros(2, 3, dtype=torch.float64),
                     "b": like["b"]})
    with pytest.raises(ValueError, match="checkpoint holds"):
        mgr.restore({"a": torch.zeros(3, 2), "b": like["b"]})
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore(like)


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """``save`` copies to the host before it returns: the next optimizer
    step writes the state in place while the writer thread runs."""
    x = torch.arange(8, dtype=torch.float32)
    stacked = tckpt.Stacked([torch.ones(3), 2 * torch.ones(3)])
    mgr = tckpt.CheckpointManager(str(tmp_path))
    gate = threading.Event()
    write = mgr._write

    def slow_write(step, leaves):
        gate.wait(timeout=30)
        write(step, leaves)

    mgr._write = slow_write
    mgr.save(1, {"x": x, "s": stacked})
    x.add_(100.0)  # the in-place update of the next step
    stacked.tensors[1].zero_()
    gate.set()
    mgr.wait()
    like = {"x": torch.zeros(8), "s": tckpt.Stacked([torch.zeros(3),
                                                    torch.zeros(3)])}
    restored, _ = mgr.restore(like)
    np.testing.assert_array_equal(restored["x"].numpy(), np.arange(8))
    assert [t.tolist() for t in restored["s"].tensors] == [[1.0] * 3,
                                                           [2.0] * 3]
    manifest = json.loads((tmp_path / "step_1" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["['s']"]["shape"] == [2, 3]


def jax_train_state(arch, dtype, moment, seed=0):
    """A JAX smoke train state after one AdamW update with seeded random
    gradients (eager; no model compile)."""
    jd = DTYPES[dtype][0]
    cfg = dataclasses.replace(jbase.get(arch).smoke_config(), dtype=jd)
    params, _ = split_boxed(jtfm.init(jax.random.PRNGKey(seed), cfg))
    ocfg = jadam.AdamWConfig(lr=1e-2, moment_dtype=DTYPES[moment][0])
    opt = jadam.adamw_init(params, ocfg)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
    params, opt, _ = jadam.adamw_update(grads, opt, params, ocfg)
    return {"params": params, "opt": opt}


def port_cfg(arch, dtype):
    return dataclasses.replace(tbase.get(arch).smoke_config(),
                               dtype=DTYPES[dtype][1])


def state_numpy_of_jax(state):
    """JAX's train state as the port's ``state_to_numpy`` lays it out."""
    o = state["opt"]
    return {"params": jax.tree.map(f32, state["params"]),
            "opt": (np.asarray(o.step), jax.tree.map(f32, o.mu),
                    jax.tree.map(f32, o.nu))}


def assert_states_equal(got, exp):
    assert_trees_equal(got["params"], exp["params"], "params")
    assert int(got["opt"][0]) == int(exp["opt"][0])
    assert_trees_equal(got["opt"][1], exp["opt"][1], "mu")
    assert_trees_equal(got["opt"][2], exp["opt"][2], "nu")


@pytest.mark.parametrize("arch,dtype,moment", [
    ("minicpm-2b", "float32", "float32"),
    ("llama4-maverick-400b-a17b", "bfloat16", "bfloat16"),
])
def test_train_state_checkpoint_crosses_packages(arch, dtype, moment,
                                                 tmp_path):
    """A smoke train state written by JAX restores in the port, and one
    written by the port restores in JAX: manifests equal, leaves
    bitwise."""
    jstate = jax_train_state(arch, dtype, moment)
    exp = state_numpy_of_jax(jstate)
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"))
    jmgr.save(3, jstate, blocking=True)
    # the port's state: another init, to be overwritten in place
    cfg = port_cfg(arch, dtype)
    model = ttfm.init(cfg, torch.Generator().manual_seed(1), "cpu")
    opt = tadam.adamw_init(dict(model.named_parameters()),
                           tadam.AdamWConfig(moment_dtype=DTYPES[moment][1]))
    tree = ttfm.state_tree(model, opt)
    restored, step = tckpt.CheckpointManager(str(tmp_path / "jax")).restore(
        tree)
    assert step == 3 and restored["opt"].step is opt.step
    assert model.embed.table.dtype == DTYPES[dtype][1]
    assert_states_equal(ttfm.state_to_numpy(model, opt), exp)
    # the port writes it back: JAX restores the same bits
    tckpt.CheckpointManager(str(tmp_path / "port")).save(
        5, ttfm.state_tree(model, opt), blocking=True)
    mp, mj = (json.loads((tmp_path / d / f"step_{s}" / "manifest.json")
                         .read_text())["leaves"]
              for d, s in (("port", 5), ("jax", 3)))
    assert mp == mj
    like = jax_train_state(arch, dtype, moment, seed=2)
    back, step = jckpt.CheckpointManager(str(tmp_path / "port")).restore(
        like)
    assert step == 5
    assert_states_equal(state_numpy_of_jax(back), exp)
    assert jax.tree.map(lambda a: a.dtype, back) == jax.tree.map(
        lambda a: a.dtype, jstate)
    # and state_from_jax carries the same state without a file
    model2, opt2 = ttfm.state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                       "cpu")
    assert all(p.requires_grad for p in model2.parameters())
    assert_states_equal(ttfm.state_to_numpy(model2, opt2), exp)


# --------------------------------------------------------- fault tolerance --

def test_train_guard_recovers_like_jax(tmp_path):
    """JAX's ``test_train_guard_recovers_from_failures`` in both packages:
    step 7 fails twice; every increment applied exactly once, the same
    checkpoints kept; a step that keeps failing raises in both."""
    def run(ft, ckpt, state, zero, tmp):
        mgr = ckpt.CheckpointManager(str(tmp), keep=3, async_write=False)
        failures = {7: 2}

        def step_fn(state, step):
            if failures.get(step, 0) > 0:
                failures[step] -= 1
                raise RuntimeError("simulated node failure")
            return {"x": state["x"] + 1}

        guard = ft.TrainGuard(ckpt=mgr, save_every=2, max_retries=5,
                              detector=ft.StragglerDetector())
        state, step = guard.run(state, step_fn, n_steps=10)
        always = ft.TrainGuard(ckpt=ckpt.CheckpointManager(
            str(tmp / "broken"), async_write=False), max_retries=2)
        calls = []

        def broken(state, step):
            calls.append(step)
            raise RuntimeError("permanent failure")

        with pytest.raises(RuntimeError, match="permanent"):
            always.run({"x": zero}, broken, n_steps=3)
        assert calls == [0, 0, 0]  # the first try and max_retries more
        return int(state["x"]), step, mgr.all_steps()

    exp = run(jft, jckpt, {"x": jnp.int32(0)}, jnp.int32(0), tmp_path / "j")
    got = run(tft, tckpt, {"x": torch.tensor(0, dtype=torch.int32)},
              torch.tensor(0, dtype=torch.int32), tmp_path / "t")
    assert got == exp == (10, 10, [6, 8, 10])


STRAGGLER_SEQUENCES = {
    "steady_then_spike": (dict(warmup=3, threshold=2.0),
                          [1.0 + 0.01 * (s % 3) for s in range(20)] + [5.0]),
    "warmup_constant": (dict(warmup=4, threshold=2.0, alpha=0.25),
                        [2.0] * 4),
    "warmup_ramp": (dict(warmup=4, threshold=2.0, alpha=0.25),
                    [1.0, 1.2, 1.4, 1.6]),
    "wild_warmup": (dict(warmup=3, threshold=2.0), [1.0, 50.0, 1.0]),
    "slow_regime": (dict(warmup=3, threshold=2.0, alpha=0.2),
                    [1.0] * 10 + [10.0] * 60 + [25.0]),
    "seeded_spikes": (dict(), list(np.where(
        np.random.default_rng(5).random(200) < 0.05, 4.0, 1.0)
        * np.random.default_rng(6).uniform(0.9, 1.1, 200))),
}


@pytest.mark.parametrize("seq", sorted(STRAGGLER_SEQUENCES))
def test_straggler_detector_matches_jax(seq):
    kw, times = STRAGGLER_SEQUENCES[seq]
    jd, td = jft.StragglerDetector(**kw), tft.StragglerDetector(**kw)
    flags = [(jd.observe(s, float(dt)), td.observe(s, float(dt)))
             for s, dt in enumerate(times)]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert td.incidents == jd.incidents and td.ewma == jd.ewma
    if seq in ("steady_then_spike", "slow_regime", "seeded_spikes"):
        assert td.incidents  # the sequence flags something


# ------------------------------------------------------------------ remat --

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient_bit(arch):
    """Per-layer checkpointing (every policy but ``none``) against none:
    the loss and every gradient bitwise equal on the CPU."""
    base = dataclasses.replace(tbase.get(arch).smoke_config(), ce_chunk=8)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, base.vocab, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat in ttfm.REMAT_POLICIES:
        cfg = dataclasses.replace(base, remat=remat)
        model = ttfm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        model.requires_grad_(True)
        loss = ttfm.loss_fn(model, cfg, batch)
        loss.backward()
        out[remat] = (loss.detach(), ttfm.grads_to_numpy(model))
    loss0, g0 = out["none"]
    for remat in ttfm.REMAT_POLICIES[1:]:
        assert torch.equal(out[remat][0], loss0), remat
        assert_trees_equal(out[remat][1], g0, remat)
    with pytest.raises(ValueError, match="remat"):
        bad = dataclasses.replace(base, remat="most")
        ttfm.loss_fn(ttfm.init(bad, torch.Generator().manual_seed(0), "cpu"),
                     bad, batch)


# ------------------------------------------------------------ entry point --

LINE = re.compile(r"step\s+(\d+)\s+loss (\S+)\s+gnorm (\S+)\s+lr x(\S+)")


def logged(text):
    return {int(m[1]): (float(m[2]), float(m[3]), m[4])
            for m in LINE.finditer(text)}


def test_train_main_crash_restart_matches_jax(tmp_path, capsys,
                                              monkeypatch):
    """``examples/train_lm.py``'s protocol at a small size: train to step
    20 (checkpoints at 10 and 20), then a fresh ``main`` resumes to 40, in
    both packages from JAX's ``PRNGKey(0)`` weights (carried into the
    port's ``build``). Every step is logged; losses within 2e-4 (four
    printed decimals, float32 sums in other orders over 40 steps),
    gradient norms within 2e-3 (three decimals), lr scales as printed."""
    jcfg = jbase.get("minicpm-2b").smoke_config()
    weights = jax.tree.map(np.asarray, split_boxed(
        jtfm.init(jax.random.PRNGKey(0), jcfg))[0])
    monkeypatch.setattr(ttfm, "init", lambda cfg, gen, dev: (
        ttfm.params_from_jax(cfg, weights, dev)))
    common = ["--arch", "minicpm-2b", "--batch", "4", "--seq", "32",
              "--save-every", "10", "--log-every", "1"]
    out = {}
    for name, main, extra in (("jax", jtrain.main, []),
                              ("port", ttrain.main, ["--device", "cpu"])):
        d = str(tmp_path / name)
        text = ""
        for steps in (20, 40):
            assert main([*common, "--steps", str(steps), "--ckpt-dir", d,
                         *extra]) == 0
            text += capsys.readouterr().out
        assert "resumed from step 20" in text
        out[name] = logged(text)
    exp, got = out["jax"], out["port"]
    assert sorted(got) == sorted(exp) == list(range(40))
    for s in exp:
        np.testing.assert_allclose(got[s][0], exp[s][0], rtol=0, atol=2e-4,
                                   err_msg=f"loss at step {s}")
        np.testing.assert_allclose(got[s][1], exp[s][1], rtol=0, atol=2e-3,
                                   err_msg=f"gnorm at step {s}")
        assert got[s][2] == exp[s][2], s
    assert got[39][0] < got[0][0]  # the run descends
    for name in ("jax", "port"):
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == [
            "step_20", "step_30", "step_40"]
    manifests = [json.loads((tmp_path / n / "step_40" / "manifest.json")
                            .read_text())["leaves"] for n in ("jax", "port")]
    assert manifests[0] == manifests[1]


def test_build_cuts_depth_and_keeps_widths():
    """``build(n_layers=k)``: the smoke config with ``k`` layers, its
    widths JAX's, the model's stack ``k`` deep, one finite step."""
    jcfg = jbase.get("minicpm-2b").smoke_config()
    cfg, model, opt, sched, stream, step = ttrain.build(
        "minicpm-2b", True, 2, 16, 1e-3, "cpu", n_layers=1)
    whole = ttrain.build("minicpm-2b", True, 2, 16, 1e-3, "cpu")[0]
    assert jcfg.n_layers > 1 and cfg.n_layers == 1
    assert dataclasses.replace(whole, n_layers=1) == cfg
    assert (cfg.d_model, cfg.n_heads, cfg.vocab) == (
        jcfg.d_model, jcfg.n_heads, jcfg.vocab)
    n_cut = sum(p.numel() for p in model.parameters())
    n_whole = sum(p.numel() for p in ttrain.build(
        "minicpm-2b", True, 2, 16, 1e-3, "cpu")[1].parameters())
    assert n_cut < n_whole
    batch = ttrain.device_batch(stream.batch(0), "cpu")
    _, opt, loss, gnorm = step(model, opt, batch, sched(1))
    assert np.isfinite(float(loss)) and np.isfinite(float(gnorm))
