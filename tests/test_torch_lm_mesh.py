"""The dense LM's prefill and decode on a mesh of ranks
(``models/transformer_mesh.py`` through ``launch/steps.py``'s LM cells)
against JAX's unsharded ``prefill``/``decode`` and the port's one-rank
run.

Four gloo CPU ranks a mesh, ``(2, 2)`` and ``(1, 4)`` over ``("data",
"model")`` (``test_torch_ranks.lm_mesh_rank``), serve the smoke configs
of ``minicpm-2b`` and ``gemma2-2b`` (local and global layers, softcaps,
GQA) in float32 from JAX's weights: a 32-token prefill of a batch of 4,
then 4 decode steps fed seeded tokens. On ``(2, 2)`` gemma2 also runs a
``long_500k``-style batch of 1, its decode cache over both axes. Each
case's global logits (prefill's last position and each step) equal
JAX's and the one-rank port's; the prefill's cache blocks, put together
from the ranks' coordinates, equal JAX's caches; and every rank's
collectives, by kind and group, equal ``collective_schedule``'s count:
FSDP all-gathers on ``data``, all-gathers and reduce-scatters on
``model``. A GQA variant whose kv projection (one head of 6) does not
divide the model axis keeps ``wk``/``wv`` replicated and equals the
unsharded model on ``(1, 4)``. MoE archs' cells run on a ``Mesh`` too,
train cells included (their mesh runs: ``test_torch_moe_mesh.py``;
dense training on a mesh: ``test_torch_lm_mesh_train.py``). Tolerance:
1e-5 relative plus 1e-5 of the tensor's largest magnitude
(``test_torch_lm.py``'s).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as jtfm
from repro.nn.module import split_boxed
from repro_torch.configs import base
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models import transformer as ttfm
from repro_torch.models import transformer_mesh as tmesh
from repro_torch.nn.module import block_slices, set_activation_rules

import test_torch_ranks as TR

TOL = 1e-5
ARCHS = ("minicpm-2b", "gemma2-2b")
CASES = [(shape, arch, b) for shape, cases in TR.LM_MESH_CASES.items()
         for arch, b, _, _ in cases]


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)


def close(got, exp, what):
    exp = np.asarray(exp, np.float32)
    scale = max(1.0, float(np.abs(exp).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), exp, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for arch in ARCHS:
        cfg = jbase.get(arch).smoke_config()
        params, _ = split_boxed(jtfm.init(jax.random.PRNGKey(0), cfg))
        out[arch] = (cfg, params, jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def ranks(jax_models):
    trees = {a: m[2] for a, m in jax_models.items()}
    with ThreadPoolExecutor(len(TR.LM_MESH_CASES)) as pool:  # both groups
        runs = {shape: pool.submit(run_ranks, TR.lm_mesh_rank, 4,
                                   (shape, trees), timeout_s=200)
                for shape in TR.LM_MESH_CASES}
        return {shape: r.result() for shape, r in runs.items()}


def _case(shape, arch, b):
    return next(c for c in TR.LM_MESH_CASES[shape] if c[:2] == (arch, b))


_RUNS: dict = {}


def _cached(fn):
    """One run a case for the whole module (JAX traces each anew)."""
    def run(jax_models, *key):
        if (fn.__name__, *key) not in _RUNS:
            _RUNS[(fn.__name__, *key)] = fn(jax_models, *key)
        return _RUNS[(fn.__name__, *key)]
    return run


@_cached
def jax_run(jax_models, arch, b, seq, n):
    cfg, params, _ = jax_models[arch]
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


@_cached
def port_run(jax_models, arch, b, seq, n):
    """The port's one-rank prefill and decode from the same weights."""
    cfg = base.get(arch).smoke_config()
    model = ttfm.params_from_jax(cfg, jax_models[arch][2], device="cpu")
    toks = torch.from_numpy(TR.lm_tokens(cfg.vocab, b, seq + n))
    logits, caches = ttfm.prefill(model, cfg, toks[:, :seq], max_seq=seq + n)
    outs = [logits.numpy()]
    for t in range(n):
        o, caches = ttfm.decode(model, cfg, caches,
                                toks[:, seq + t:seq + t + 1], seq + t)
        outs.append(o[:, 0].numpy())
    return outs


@pytest.mark.parametrize("shape,arch,b", CASES)
def test_mesh_logits_match_jax_and_one_rank(ranks, jax_models, shape, arch,
                                            b):
    _, _, seq, n = _case(shape, arch, b)
    want, _ = jax_run(jax_models, arch, b, seq, n)
    one = port_run(jax_models, arch, b, seq, n)
    cfg = base.get(arch).smoke_config()
    for r, rep in enumerate(ranks[shape]):
        got = rep[f"{arch}/{b}"]["logits"]
        assert len(got) == n + 1
        for t, (g, w, o) in enumerate(zip(got, want, one)):
            assert g.shape == (b, cfg.vocab_padded)
            close(g, w, f"{shape} {arch} b{b} rank {r} step {t} vs JAX")
            close(g, o, f"{shape} {arch} b{b} rank {r} step {t} vs port")
            assert (g[:, cfg.vocab:] == np.float32(-1e30)).all()


@pytest.mark.parametrize("shape,arch,b", CASES)
def test_mesh_prefill_caches_match_jax(ranks, jax_models, shape, arch, b):
    """Every rank's cache blocks, placed at their coordinates under the
    decode cell's specs, rebuild JAX's prefill caches."""
    _, _, seq, n = _case(shape, arch, b)
    _, want = jax_run(jax_models, arch, b, seq, n)
    cfg = base.get(arch).smoke_config()
    mesh_shape = dict(zip(("data", "model"), shape))
    seq_axes = tuple(ranks[shape][0][f"{arch}/{b}"]["seq_axes"])
    _, cache_batch = tmesh.decode_seq_axes(b, mesh_shape, ("data",))
    for i in range(cfg.n_layers):
        g, j = divmod(i, cfg.group_size)
        exp = {f: np.asarray(v)[g] for f, v in
               zip(("k", "v", "slot_pos"), want[f"layer_{j}"])}
        full = {f: np.zeros_like(exp[f]) for f in exp}
        seen = {f: np.zeros(exp[f].shape, bool) for f in exp}
        for rep in ranks[shape]:
            blk = rep[f"{arch}/{b}"]["caches"][i]
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
                close(full[f], exp[f], f"{shape} {arch} b{b} layer {i} {f}")


@pytest.mark.parametrize("shape,arch,b", CASES)
def test_mesh_collectives_follow_the_schedule(ranks, shape, arch, b):
    """Each rank's ``Wire`` records equal ``collective_schedule``'s count
    exactly; FSDP gathers run on ``data``, the SP gathers and the
    row-parallel reduce-scatters on ``model``."""
    for rep in ranks[shape]:
        r = rep[f"{arch}/{b}"]
        want = {k: {int(g): list(v) for g, v in d.items()}
                for k, d in r["schedule"].items()}
        assert r["by_kind"] == want
        model = r["by_axis"]["model"]
        assert model["all-gather"][0] > 0 and model["reduce-scatter"][0] > 0
        if shape[0] > 1:
            assert r["by_axis"]["data"]["all-gather"][0] > 0
        seq_axes = tuple(r["seq_axes"])
        assert seq_axes == (("data", "model") if b < shape[0]
                            else ("model",))
        if b < shape[0]:  # the flash-decoding max over both axes
            assert r["by_axis"]["data"]["all-reduce"][0] > 0


def test_moe_and_train_on_a_mesh_raise():
    """MoE and train cells build and run on a ``Mesh`` (nothing raises
    there any more); the mesh path still refuses a model that was not
    cut, and runs only with the rules installed."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    for arch in ("olmoe-1b-7b", "llama4-maverick-400b-a17b", "minicpm-2b"):
        spec = TR.lm_smoke_spec(base, arch)
        for name in ("prefill_32k", "train_4k"):
            shape = next(s for s in spec.shapes if s.name == name)
            assert callable(steps._lm_cell(spec, shape, mesh, False).fn)
        set_activation_rules(None)
    # an MoE smoke model cut by its cell runs the mesh prefill
    pcell, _ = TR.lm_cells(mesh, "olmoe-1b-7b", 1, 8, 0)
    cfg = pcell.config
    model = ttfm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    steps.shard_lm(pcell, model, mesh)
    logits, caches = pcell.fn(model, torch.zeros((1, 8), dtype=torch.long))
    assert logits.shape == (1, cfg.vocab_padded) and len(caches) == 2
    assert torch.isfinite(logits[:, :cfg.vocab]).all()
    # a model not cut is refused
    cfg = base.get("minicpm-2b").smoke_config()
    model = ttfm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    set_activation_rules({"embed": ("data",)}, mesh)
    with pytest.raises(ValueError, match="shard_params"):
        tmesh.prefill(model, cfg, torch.zeros((1, 8), dtype=torch.long))
    set_activation_rules(None)
    with pytest.raises(RuntimeError, match="set_activation_rules"):
        tmesh.decode(model, cfg, [], torch.zeros((1, 1), dtype=torch.long),
                     0)


def test_one_rank_cell_equals_the_one_rank_model(jax_models):
    """A cell on a one-rank mesh (what ``dryrun --mesh card`` runs)
    computes ``transformer.prefill``/``decode`` exactly: every
    collective is the identity."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    b, seq, n = 2, 32, 3
    pcell, dcell = TR.lm_cells(mesh, "gemma2-2b", b, seq, n)
    cfg = pcell.config
    model = ttfm.params_from_jax(cfg, jax_models["gemma2-2b"][2],
                                 device="cpu")
    steps.shard_lm(pcell, model, mesh)
    toks = torch.from_numpy(TR.lm_tokens(cfg.vocab, b, seq + n))
    logits, caches = pcell.fn(model, toks[:, :seq], max_seq=seq + n)
    ref = port_run(jax_models, "gemma2-2b", b, seq, n)
    np.testing.assert_array_equal(logits.numpy(), ref[0])
    for t in range(n):
        o, caches = dcell.fn(model, caches, toks[:, seq + t:seq + t + 1],
                             seq + t)
        np.testing.assert_array_equal(o[:, 0].numpy(), ref[t + 1])
    assert mesh.wire.calls == 0


def test_replicated_kv_weights_on_a_mesh():
    """A GQA config whose ``KV * d_head`` (one head of 6) does not divide
    the model axis: ``wk``/``wv`` stay replicated and the column-parallel
    code uses them whole; four ranks equal the unsharded model."""
    reps = run_ranks(TR.lm_replicated_kv_rank, 4, timeout_s=120)
    for rep in reps:
        assert rep["wk"] == (None, None) and rep["wq"] == (None, "model")
        v = rep["vocab"]
        for t, (g, w) in enumerate(zip(rep["got"], rep["ref"])):
            close(g[:, :v], w[:, :v], f"step {t}")
