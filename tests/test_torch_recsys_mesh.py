"""DCN-v2 on a mesh of ranks (``launch/steps.py``'s ``_recsys_cell`` on a
``Mesh``; ``models/dcn_v2.py`` and ``nn/embedding_bag.py`` over a rank's
blocks) against JAX's unsharded functions.

Four gloo CPU ranks a mesh, ``(2, 2)``, ``(4, 1)`` and ``(1, 4)`` over
``("data", "model")`` (``test_torch_ranks.recsys_mesh_rank``), run the
smoke config's four kinds from JAX's weights (``RECSYS_MESH_DIMS``):
two AdamW steps of ``train_batch`` (batch 64 over ``data``), the
``serve_p99`` and ``serve_bulk`` logits (batches 16 and 32) and one
``retrieval_cand`` query (batch 1, replicated) against 1,002 candidates
padded to 1,004 and sharded over every axis. The smoke table's 2,522
rows split over ``model`` on ``(2, 2)`` and stay replicated on ``(1,
4)`` (``sanitize_spec``); the MLP is column-parallel over ``model``
with FSDP over ``data``; the cross kernels (221 wide) stay replicated.

- train: loss and gradient norm of both steps at ``TOL`` against JAX's
  ``value_and_grad`` of ``loss_fn`` and ``adamw_update`` (jitted), the
  moments after at ``GRAD_TOL``, each parameter leaf within 0.1 lr but
  for one entry or 1% of them and all of it within 2 lr;
- serve and bulk: the logits gathered whole at ``TOL`` against JAX's
  ``forward``;
- retrieval: the top 100 values at ``TOL`` against JAX's
  ``retrieval_scores`` (``lax.top_k``) on the same padded candidates,
  the indices equal wherever a value stands clear of its neighbours by
  more than the tolerance (the merge breaks ties to the lower index, as
  ``lax.top_k`` does);
- every rank's collectives, by axis and kind, equal
  ``steps.recsys_collective_schedule``'s count (twice for the two train
  steps), and every parameter block its spec's slice.

Tolerances (``test_torch_recsys.py``'s): ``TOL`` 1e-5 + 1e-5 of the
largest magnitude; ``GRAD_TOL`` 1e-4 + 1e-4 (XLA contracts the cross
layer into an FMA, and the ranks add in other orders).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.dcn_v2 import smoke_config as j_smoke_config
from repro.models import dcn_v2 as jdcn
from repro.nn.module import split_boxed
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update
from repro_torch.launch.mesh import run_ranks
from repro_torch.nn.module import set_activation_rules

import test_torch_ranks as TR

TOL = (1e-5, 1e-5)
GRAD_TOL = (1e-4, 1e-4)
LR = 1e-3
MESHES = ((2, 2), (4, 1), (1, 4))
TOP_K = 100


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)


def close(got, exp, tol, what=""):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    rtol, share = tol
    scale = max(float(np.abs(exp).max()), 1e-30) if exp.size else 1.0
    bad = np.abs(got - exp) > rtol * np.abs(exp) + share * scale
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} off, worst "
        f"{float(np.abs(got - exp).max())} at scale {scale}")


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_ref():
    cfg = j_smoke_config()
    boxed, offsets = jdcn.init(jax.random.PRNGKey(0), cfg)
    params, _ = split_boxed(boxed)
    tree = jax.tree.map(lambda x: np.asarray(x).copy(), params)
    # the cell's offsets: int32, as _recsys_cell passes them
    joff = jnp.asarray(np.concatenate(
        [[0], np.cumsum(cfg.field_vocabs)[:-1]]).astype(np.int32))
    ocfg = JAdamWConfig(lr=LR, weight_decay=0.0)

    @jax.jit
    def step(p, o, b):
        loss, grads = jax.value_and_grad(jdcn.loss_fn)(p, cfg, b, joff)
        new_p, new_o, gnorm = jadamw_update(grads, o, p, ocfg)
        return new_p, new_o, loss, gnorm

    p, o, res = params, jadamw_init(params, ocfg), []
    for i in range(TR.MESH_STEPS):
        p, o, loss, gnorm = step(p, o, jbatch(TR.recsys_mesh_batch(
            "train_batch", i)))
        res.append((float(loss), float(gnorm)))
    out = {"tree": tree, "train": (res, {"params": flat(p),
                                         "mu": flat(o.mu),
                                         "nu": flat(o.nu)})}
    for shape in ("serve_p99", "serve_bulk"):
        out[shape] = np.asarray(jdcn.forward(
            params, cfg, jbatch(TR.recsys_mesh_batch(shape)), joff))
    dims = TR.RECSYS_MESH_DIMS["retrieval_cand"]
    nc = -(-dims["n_candidates"] // 4) * 4
    cand = TR.recsys_candidates(nc, cfg.retrieval_dim)
    vals, idx = jdcn.retrieval_scores(
        params, cfg, jbatch(TR.recsys_mesh_batch("retrieval_cand")), joff,
        jnp.asarray(cand), top_k=TOP_K)
    out["retrieval_cand"] = (np.asarray(vals), np.asarray(idx), nc)
    return out


@pytest.fixture(scope="module")
def ranks(jax_ref):
    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {m: pool.submit(run_ranks, TR.recsys_mesh_rank, 4,
                               (m, jax_ref["tree"]), timeout_s=300)
                for m in MESHES}
        return {m: r.result() for m, r in runs.items()}


ids = lambda m: f"{m[0]}x{m[1]}"  # noqa: E731


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_train_steps_match_jax(ranks, jax_ref, mesh):
    jres, jstate = jax_ref["train"]
    got = ranks[mesh][0]["train_batch"]
    for i, ((tl, tn), (jl, jn)) in enumerate(zip(got["steps"], jres)):
        close(tl, jl, TOL, f"loss {i}")
        close(tn, jn, TOL, f"grad norm {i}")
    for m in ("mu", "nu"):
        assert set(got[m]) == set(jstate[m])
        for k, v in jstate[m].items():
            close(got[m][k], v, GRAD_TOL, f"{mesh} {m} {k}")
    for k, v in jstate["params"].items():
        d = np.abs(got["params"][k].astype(np.float64) - v)
        assert (d <= 2 * LR).all(), (mesh, k, d.max())
        assert (d > 0.1 * LR).sum() <= max(1, 0.01 * d.size), (mesh, k)
    for r in ranks[mesh][1:]:
        assert r["train_batch"]["steps"] == got["steps"]


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_serve_logits_match_jax(ranks, jax_ref, mesh, shape):
    want = jax_ref[shape]
    for r in ranks[mesh]:
        assert r[shape]["logits"].shape == want.shape
        close(r[shape]["logits"], want, TOL, f"{mesh} {shape}")


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_retrieval_merges_to_lax_top_k(ranks, jax_ref, mesh):
    jv, ji, nc = jax_ref["retrieval_cand"]
    scale = float(np.abs(jv).max())
    gap = TOL[0] * scale + TOL[1] * scale
    clear = np.ones(jv.shape, bool)
    d = np.diff(jv, axis=1) > -2 * gap  # a neighbour within the tolerance
    clear[:, 1:] &= ~d
    clear[:, :-1] &= ~d
    for r in ranks[mesh]:
        rec = r["retrieval_cand"]
        assert rec["cand_rows"] * 4 == nc
        assert rec["values"].shape == rec["indices"].shape == (1, TOP_K)
        close(rec["values"], jv, TOL, f"{mesh} top-k values")
        np.testing.assert_array_equal(rec["indices"][clear], ji[clear])
        assert (np.diff(rec["values"], axis=1) <= 0).all()
    assert clear.mean() > 0.9


@pytest.mark.parametrize("mesh", MESHES, ids=ids)
def test_recsys_collectives_and_blocks(ranks, mesh):
    for rank, out in enumerate(ranks[mesh]):
        for shape, rec in out.items():
            n = TR.MESH_STEPS if shape == "train_batch" else 1
            want = {a: {k: [n * c, n * b] for k, (c, b) in d.items()}
                    for a, d in rec["schedule"].items()}
            assert rec["wire"] == want, (mesh, rank, shape)
            assert rec["blocks_ok"], (mesh, rank, shape)
    wire = ranks[(2, 2)][0]["train_batch"]["wire"]
    # FSDP kernels' transposes over data, column-parallel ones over model
    assert "reduce-scatter" in wire["data"]
    assert "reduce-scatter" in wire["model"]
    # the replicated table on (1, 4) needs no lookup psum: one fewer
    # gather than on (2, 2) over model in serving
    assert ranks[(1, 4)][0]["serve_p99"]["wire"]["model"]["all-gather"][0] \
        == ranks[(2, 2)][0]["serve_p99"]["wire"]["model"]["all-gather"][0] - 1
