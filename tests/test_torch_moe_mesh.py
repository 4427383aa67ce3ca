"""MoE layers on a mesh of ranks (``models/transformer_mesh.py``'s
expert-parallel ``_moe`` through ``launch/steps.py``'s LM cells) against
JAX's unsharded ``prefill``, ``decode`` and ``train_step`` and the
port's one-rank run.

Four gloo CPU ranks a mesh, ``(2, 2)`` and ``(1, 4)`` over ``("data",
"model")`` (``test_torch_ranks.moe_mesh_rank``), run the float32 smoke
configs of ``olmoe-1b-7b`` (8 experts, top-2, every layer) and
``llama4-maverick-400b-a17b`` (8 experts, top-1, a shared expert, MoE
every second layer between chunked-local layers) from JAX's weights:

- **Serving.** A 32-token prefill of a batch of 4, then 4 decode steps:
  each step's global logits equal JAX's and the one-rank port's
  (``nn/moe.py``), the prefill's cache blocks rebuild JAX's caches.
- **Capacity.** A prefill with both packages' ``MoESettings`` at
  ``dropless_threshold=0`` and ``capacity_factor=0.5``, so that about
  half of the slots drop and which ones depends on the global order of
  the call's slots: the logits equal JAX's, each rank's routing equals
  JAX's routing of its data block, and each rank's kept-slot mask equals
  a numpy oracle of JAX's ``keep`` over JAX's global routing (positions
  from a cumulative count over all slots in global token-major order).
  On ``(2, 2)`` a per-rank capacity would keep other slots: the oracle
  of that mistake differs, so the case tells them apart.
- **Training** (``(2, 2)``). olmoe at batch 8 (``n_micro`` 4) and llama4
  at batch 16 (``n_micro`` 8), sequence 16, two AdamW steps from JAX's
  train state, against JAX's ``train_step`` of ``_lm_cell`` (unsharded,
  jitted) and the port's one-rank cell, at
  ``test_torch_lm_mesh_train.py``'s tolerances (loss with the aux term,
  norm, moments, parameters), but for llama4's top-1 routers, whose
  moments are below 1% of their layer's largest: they reach the loss
  only through the gates ``p / p`` and the aux term, so their gradient
  is mostly the layer's rounding, and they are held at 1e-6 of the
  layer's largest moment (``test_torch_train_grads.py``'s rule); each
  microbatch's aux term alone (the layers' sum) against JAX's
  ``hidden_states`` aux at the same parameters, at rtol 1e-5.
- **Schedule.** Every rank's ``Wire`` records, by kind and group, equal
  ``collective_schedule``'s count for prefill, decode and train: the
  expert counts' all-gather over ``data`` where a call can drop, the
  aux's ``psum`` in training, no all-to-all.

A one-rank MoE cell computes ``transformer.prefill``/``decode``
bitwise. Tolerance: 1e-5 relative plus 1e-5 of the tensor's largest
magnitude (``test_torch_lm.py``'s).
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
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models import transformer as ttfm
from repro_torch.models import transformer_mesh as tmesh
from repro_torch.nn.module import block_slices, set_activation_rules

import test_torch_ranks as TR
from test_torch_lm_mesh_train import (
    LR,
    _flat,
    check_run,
    jax_config,
    jax_state,
    leaf_tol,
    port_config,
)

TOL = 1e-5
#: an MoE router leaf whose largest moment is below this share of its
#: layer's largest is held at ``ROUTER_TOL`` of the layer's largest
#: (``test_torch_train_grads.py``'s rule for llama4's routers)
ROUTER_SMALL = 0.01
ROUTER_TOL = 1e-6
SHAPES = ((2, 2), (1, 4))
SERVE = [(shape, arch) for shape in SHAPES for arch in TR.MOE_ARCHS]
TRAIN = [arch for arch, _, _ in TR.MOE_TRAIN]


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)


def close(got, exp, what):
    exp = np.asarray(exp, np.float32)
    scale = max(1.0, float(np.abs(exp).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), exp, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


def jax_cfg(arch, capacity=False):
    cfg = jbase.get(arch).smoke_config()
    if capacity:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **TR.MOE_CAPACITY))
    return cfg


@pytest.fixture(scope="module")
def trees():
    """JAX's smoke weights (numpy) by arch, and its float32 train state
    by (arch, "float32")."""
    out = {}
    for arch in TR.MOE_ARCHS:
        params, _ = split_boxed(jtfm.init(jax.random.PRNGKey(0),
                                          jax_cfg(arch)))
        out[arch] = jax.tree.map(np.asarray, params)
        out[arch, "float32"] = jax_state(arch, "float32")
    return out


@pytest.fixture(scope="module")
def ranks(trees):
    """Both meshes' rank groups, started in threads while JAX runs."""
    pool = ThreadPoolExecutor(len(SHAPES))
    runs = {shape: pool.submit(run_ranks, TR.moe_mesh_rank, 4,
                               (shape, trees), timeout_s=300)
            for shape in SHAPES}
    yield runs
    pool.shutdown(wait=True)


_CACHE: dict = {}


def _once(fn):
    """One run a key for the whole module."""
    def run(*key):
        if (fn.__name__, *key[1:]) not in _CACHE:
            _CACHE[(fn.__name__, *key[1:])] = fn(*key)
        return _CACHE[(fn.__name__, *key[1:])]
    return run


@_once
def jax_serve(trees, arch):
    """JAX's prefill of ``MOE_SERVE``'s tokens and its decode steps:
    (logits of each, the prefill's caches)."""
    b, seq, n = TR.MOE_SERVE
    cfg = jax_cfg(arch)
    params = jax.tree.map(jnp.asarray, trees[arch])
    toks = TR.lm_tokens(cfg.vocab, b, seq + n)
    logits, caches = jtfm.prefill(params, cfg, toks[:, :seq],
                                  max_seq=seq + n)
    first = jax.tree.map(np.asarray, caches)
    outs = [np.asarray(logits)]
    for t in range(n):
        o, caches = jtfm.decode(params, cfg, caches,
                                toks[:, seq + t:seq + t + 1],
                                np.int32(seq + t))
        outs.append(np.asarray(o)[:, 0])
    return outs, first


@_once
def jax_capacity(trees, arch):
    """JAX's prefill at ``MOE_CAPACITY``, op by op, with each MoE
    layer's routing (``lax.top_k`` of its router's softmax over the
    global [T, K] slots) recorded: (logits, [idx a layer], C)."""
    b, seq, _ = TR.MOE_SERVE
    cfg = jax_cfg(arch, capacity=True)
    params = jax.tree.map(jnp.asarray, trees[arch])
    routing = []
    real = jtfm.moe

    def recording(p, m, x):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(
            (xt @ p["router"]["kernel"]).astype(jnp.float32), axis=-1)
        routing.append(np.asarray(jax.lax.top_k(probs, m.top_k)[1]))
        return real(p, m, x)

    jtfm.moe = recording
    try:
        with jax.disable_jit():
            logits, _ = jtfm.prefill(
                params, cfg, TR.lm_tokens(cfg.vocab, b, seq), max_seq=seq)
    finally:
        jtfm.moe = real
    m = cfg.moe
    cap = max(int(m.capacity_factor * b * seq * m.top_k / m.n_experts), 1)
    return np.asarray(logits), routing, cap


def keep_oracle(idx: np.ndarray, cap: int, n_experts: int) -> np.ndarray:
    """JAX's ``keep`` of the slots ``idx`` [T, K] (token-major): a slot's
    position is the running count of its expert over the slots before
    it."""
    e = idx.reshape(-1)
    onehot = np.eye(n_experts, dtype=np.int64)[e]
    pos = (np.cumsum(onehot, axis=0) - 1)[np.arange(e.size), e]
    return pos < cap


@_once
def port_serve(trees, arch):
    """The port's one-card ``transformer.prefill``/``decode`` (through
    ``nn/moe.py``) from the same weights."""
    b, seq, n = TR.MOE_SERVE
    cfg = port_cfg(arch)
    model = ttfm.params_from_jax(cfg, trees[arch], device="cpu")
    toks = torch.from_numpy(TR.lm_tokens(cfg.vocab, b, seq + n))
    logits, caches = ttfm.prefill(model, cfg, toks[:, :seq], max_seq=seq + n)
    outs = [logits.numpy()]
    for t in range(n):
        o, caches = ttfm.decode(model, cfg, caches,
                                toks[:, seq + t:seq + t + 1], seq + t)
        outs.append(o[:, 0].numpy())
    return outs


def port_cfg(arch):
    from repro_torch.configs import base

    return base.get(arch).smoke_config()


@_once
def jax_train(trees, arch):
    """JAX's ``train_step`` of ``_lm_cell`` (unsharded, jitted) twice on
    the case's batch: [(loss, norm, state by the port's names)] and each
    step's microbatch aux terms (``hidden_states``' aux at the step's
    parameters)."""
    _, b, seq = next(c for c in TR.MOE_TRAIN if c[0] == arch)
    jc, tc = jax_config(arch, "float32"), port_config(arch, "float32")
    n_micro = steps._N_MICRO[arch]
    ocfg = jadam.AdamWConfig(lr=LR)
    params = jax.tree.map(jnp.asarray, trees[arch, "float32"]["params"])
    opt = jadam.adamw_init(params, ocfg)

    @jax.jit
    def step(params, opt, batch):
        mb = jax.tree.map(lambda a: a.reshape(
            n_micro, b // n_micro, *a.shape[1:]), batch)

        def micro(acc, bt):
            l, g = jax.value_and_grad(jtfm.loss_fn)(params, jc, bt)
            return jax.tree.map(jnp.add, acc, g), l

        zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             params)
        grads, losses = jax.lax.scan(micro, zeros, mb)
        grads = jax.tree.map(lambda g: g / n_micro, grads)
        params, opt, gnorm = jadam.adamw_update(grads, opt, params, ocfg)
        return params, opt, losses.mean(), gnorm

    aux_of = jax.jit(lambda p, t: jtfm.hidden_states(p, jc, t)[1])
    batch = jax.tree.map(jnp.asarray, TR.lm_train_batch(jc.vocab, b, seq))
    out, auxs = [], []
    for _ in range(TR.LM_TRAIN_STEPS):
        rows = b // n_micro
        auxs += [float(aux_of(params, batch["tokens"][i:i + rows]))
                 for i in range(0, b, rows)]
        params, opt, loss, gnorm = step(params, opt, batch)
        state = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             {"params": params, "mu": opt.mu, "nu": opt.nu})
        out.append((float(loss), float(gnorm),
                    {k: _flat(tc, v) for k, v in state.items()}))
    return out, auxs


@_once
def one_rank_train(trees, arch):
    """The port's train cell on a ``(1, 1)`` mesh, the same steps."""
    _, b, seq = next(c for c in TR.MOE_TRAIN if c[0] == arch)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    cell = TR.lm_train_cell(mesh, arch, b, seq, "float32")
    run = TR.lm_train_run(cell, mesh, trees[arch, "float32"])
    set_activation_rules(None)
    assert mesh.wire.calls == 0
    return run


@pytest.mark.parametrize("shape,arch", SERVE)
def test_moe_mesh_logits_match_jax_and_one_rank(ranks, trees, shape, arch):
    want, _ = jax_serve(trees, arch)
    one = port_serve(trees, arch)
    cfg = port_cfg(arch)
    b, _, n = TR.MOE_SERVE
    for r, rep in enumerate(ranks[shape].result()):
        got = rep["serve", arch]["logits"]
        assert len(got) == n + 1
        for t, (g, w, o) in enumerate(zip(got, want, one)):
            assert g.shape == (b, cfg.vocab_padded)
            close(g, w, f"{shape} {arch} rank {r} step {t} vs JAX")
            close(g, o, f"{shape} {arch} rank {r} step {t} vs port")


@pytest.mark.parametrize("shape,arch", SERVE)
def test_moe_mesh_prefill_caches_match_jax(ranks, trees, shape, arch):
    """Every rank's cache blocks, placed at their coordinates under the
    decode cell's specs, rebuild JAX's prefill caches."""
    _, want = jax_serve(trees, arch)
    cfg = port_cfg(arch)
    b = TR.MOE_SERVE[0]
    mesh_shape = dict(zip(("data", "model"), shape))
    reps = ranks[shape].result()
    seq_axes = tuple(reps[0]["serve", arch]["seq_axes"])
    _, cache_batch = tmesh.decode_seq_axes(b, mesh_shape, ("data",))
    for i in range(cfg.n_layers):
        g, j = divmod(i, cfg.group_size)
        exp = {f: np.asarray(v)[g] for f, v in
               zip(("k", "v", "slot_pos"), want[f"layer_{j}"])}
        full = {f: np.zeros_like(exp[f]) for f in exp}
        seen = {f: np.zeros(exp[f].shape, bool) for f in exp}
        for rep in reps:
            blk = rep["serve", arch]["caches"][i]
            for f in exp:
                spec = ((seq_axes,) if f == "slot_pos"
                        else (cache_batch, seq_axes, None, None))
                sl = block_slices(exp[f].shape, spec, mesh_shape,
                                  rep["coords"])
                full[f][sl] = blk[f]
                seen[f][sl] = True
        for f in exp:
            assert seen[f].all(), (i, f)
            if f == "slot_pos":
                np.testing.assert_array_equal(full[f], exp[f])
            else:
                close(full[f], exp[f], f"{shape} {arch} layer {i} {f}")


@pytest.mark.parametrize("case", ["serve", "capacity"])
@pytest.mark.parametrize("shape,arch", SERVE)
def test_moe_mesh_collectives_follow_the_schedule(ranks, shape, arch, case):
    """Each rank's ``Wire`` records equal ``collective_schedule``'s count
    exactly. Where a call can drop slots (the capacity case) the expert
    counts go over ``data``; nothing else moves on ``data`` but the FSDP
    gathers, and no token is exchanged."""
    for rep in ranks[shape].result():
        r = rep[case, arch]
        assert r["by_kind"] == r["schedule"]
        assert set(r["by_kind"]) <= {"all-gather", "reduce-scatter",
                                     "all-reduce"}
        model = r["by_axis"]["model"]
        assert model["all-gather"][0] > 0 and model["reduce-scatter"][0] > 0
        if shape[0] > 1:
            assert r["by_axis"]["data"]["all-gather"][0] > 0


@pytest.mark.parametrize("shape,arch", SERVE)
def test_capacity_drops_match_jax(ranks, trees, shape, arch):
    """At ``MOE_CAPACITY`` the logits equal JAX's, each rank's routing is
    JAX's on its data block and its kept slots are JAX's ``keep``."""
    logits, routing, cap = jax_capacity(trees, arch)
    cfg = port_cfg(arch)
    k = cfg.moe.top_k
    b, seq, _ = TR.MOE_SERVE
    rows = b // shape[0]
    dropped = 0
    for r, rep in enumerate(ranks[shape].result()):
        run = rep["capacity", arch]
        close(run["logits"][0], logits, f"{shape} {arch} rank {r}")
        assert len(run["routing"]) == len(routing)
        lo = rep["coords"]["data"] * rows * seq  # the block's first token
        for layer, (got, idx) in enumerate(zip(run["routing"], routing)):
            keep = keep_oracle(idx, cap, cfg.moe.n_experts)
            np.testing.assert_array_equal(
                got["experts"], idx[lo:lo + rows * seq],
                err_msg=f"{shape} {arch} rank {r} layer {layer}")
            np.testing.assert_array_equal(
                got["keep"], keep[lo * k:(lo + rows * seq) * k],
                err_msg=f"{shape} {arch} rank {r} layer {layer}")
            assert got["capacity"] == cap
            dropped += int((~keep).sum())
    assert dropped > 0


def test_capacity_case_tells_global_from_per_rank_capacity(trees):
    """On ``(2, 2)`` a per-rank capacity (positions counted within a
    data block) keeps other slots than JAX's global order in every
    arch: the capacity case would catch it."""
    b, seq, _ = TR.MOE_SERVE
    tokens = b // 2 * seq
    for arch in TR.MOE_ARCHS:
        _, routing, cap = jax_capacity(trees, arch)
        e = port_cfg(arch).moe.n_experts
        assert any(
            (keep_oracle(idx, cap, e) != np.concatenate(
                [keep_oracle(idx[i * tokens:(i + 1) * tokens], cap, e)
                 for i in range(2)])).any() for idx in routing), arch


def moment_tol(part: str, name: str, exp: dict) -> float:
    """``leaf_tol``, but a router whose moments are below
    ``ROUTER_SMALL`` of its layer's largest (llama4's top-1 routers
    reach the loss only through the gates ``p / p`` and the aux term,
    so their gradient is mostly the layer's rounding) is held at
    ``ROUTER_TOL`` of the layer's largest."""
    top = float(np.abs(exp[part][name]).max())
    if not name.endswith("moe.router.kernel"):
        return leaf_tol(part, name, exp)
    layer = name.split(".moe.")[0] + "."
    big = max(float(np.abs(v).max()) for k, v in exp[part].items()
              if k.startswith(layer))
    if top >= ROUTER_SMALL * big:
        return leaf_tol(part, name, exp)
    return ROUTER_TOL * big


@pytest.mark.parametrize("arch", TRAIN)
def test_moe_mesh_train_matches_jax(ranks, trees, arch):
    want, _ = jax_train(trees, arch)
    for r, rep in enumerate(ranks[2, 2].result()):
        check_run(rep["train", arch], want, f"(2, 2) {arch} rank {r}",
                  moment_tol)
    check_run(one_rank_train(trees, arch), want, f"one rank {arch}",
              moment_tol)
    assert want[1][0] < want[0][0]  # the same batch twice: it descends


@pytest.mark.parametrize("arch", TRAIN)
def test_moe_mesh_train_matches_one_rank(ranks, trees, arch):
    one = one_rank_train(trees, arch)
    want = [(l, g, s) for (l, g), s in zip(one["steps"], one["states"])]
    for r, rep in enumerate(ranks[2, 2].result()):
        check_run(rep["train", arch], want, f"(2, 2) {arch} rank {r}",
                  moment_tol)


@pytest.mark.parametrize("arch", TRAIN)
def test_moe_mesh_train_aux_matches_jax(ranks, trees, arch):
    """Each microbatch's aux term (the layers' sum, JAX's product of two
    global means) equals JAX's, on every rank and on one rank."""
    _, want = jax_train(trees, arch)
    n_micro = steps._N_MICRO[arch]
    assert len(want) == TR.LM_TRAIN_STEPS * n_micro
    assert min(want) > 0
    one = one_rank_train(trees, arch)["aux"]
    np.testing.assert_allclose(one, want, rtol=TOL, err_msg="one rank")
    for r, rep in enumerate(ranks[2, 2].result()):
        np.testing.assert_allclose(rep["train", arch]["aux"], want,
                                   rtol=TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("arch", TRAIN)
def test_moe_mesh_train_collectives_follow_the_schedule(ranks, arch):
    """Each rank's ``Wire`` records of the two steps equal
    ``collective_schedule(kind="train")``'s count: with the aux's
    probability sums over ``data`` (forward, recompute, backward)."""
    for rep in ranks[2, 2].result():
        run = rep["train", arch]
        assert run["wire"]["by_kind"] == run["schedule"]
        assert run["wire"]["by_axis"]["data"]["reduce-scatter"][0] > 0
        assert run["n_micro"] == steps._N_MICRO[arch]


def test_one_rank_moe_cells_equal_the_one_rank_model(trees):
    """A MoE cell on a one-rank mesh (what ``dryrun --mesh card`` runs)
    computes ``transformer.prefill``/``decode`` bitwise: every
    collective is the identity."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    b, seq, n = TR.MOE_SERVE
    for arch in TR.MOE_ARCHS:
        pcell, dcell = TR.lm_cells(mesh, arch, b, seq, n)
        cfg = pcell.config
        model = ttfm.params_from_jax(cfg, trees[arch], device="cpu")
        steps.shard_lm(pcell, model, mesh)
        toks = torch.from_numpy(TR.lm_tokens(cfg.vocab, b, seq + n))
        logits, caches = pcell.fn(model, toks[:, :seq], max_seq=seq + n)
        ref = port_serve(trees, arch)
        np.testing.assert_array_equal(logits.numpy(), ref[0])
        for t in range(n):
            o, caches = dcell.fn(model, caches, toks[:, seq + t:seq + t + 1],
                                 seq + t)
            np.testing.assert_array_equal(o[:, 0].numpy(), ref[t + 1])
        set_activation_rules(None)
    assert mesh.wire.calls == 0
