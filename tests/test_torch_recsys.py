"""The port's recsys family (EmbeddingBag, DCN-v2, its config and the
recsys part of ``launch/steps``) against the JAX package, on the CPU.

Seeded numpy inputs go through ``repro``'s function and the port's
counterpart; the model carries JAX's weights across
(``dcn_v2.params_from_jax``).

- ``nn/embedding_bag``: ``lookup_single`` and ``embedding_bag`` (sum and
  mean), forward and the table's gradient, bitwise: ``index_select``
  gathers and ``index_add`` adds in nnz order, XLA's scatter order on the
  CPU; both also against the one-hot oracle of ``tests/test_recsys.py``.
- The smoke DCN-v2: ``features``, logits, loss, every gradient leaf and
  one AdamW step of the recsys train step against the step JAX's
  ``_recsys_cell`` composes (``value_and_grad`` of ``loss_fn``,
  ``adamw_update`` with lr 1e-3, no weight decay), jitted; the
  cross-layer identity at W = 0, b = 0; ``query_embedding``, and
  ``retrieval_scores`` indices equal to ``lax.top_k``'s.
- The full config on ``meta``: every parameter shape equal to
  ``jax.eval_shape(dcn_v2.init)``'s, the same count (576,998,850), and
  each cell's FLOPs equal to JAX's ``_recsys_cell``'s.

Tolerances (relative plus a share of the tensor's largest magnitude, as
the LM and GNN tests state them): ``TOL`` 1e-5 + 1e-5 for the features
(``log1p``), logits, loss and norms: XLA contracts the cross layer's
``x0 * y + x`` into a fused multiply-add and divides the mean by a
reciprocal product, PyTorch's ``log1p``/``exp`` are a last bit from
XLA's, and the products add in other orders; ``GRAD_TOL`` 1e-4 + 1e-4
for gradients and AdamW's moments; parameters after a step within 0.1 lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dcn_v2 import smoke_config as j_smoke_config
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models import dcn_v2 as jdcn
from repro.nn import embedding_bag as jeb
from repro.nn.module import set_activation_rules, split_boxed
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update

from repro_torch.configs import base as tbase
from repro_torch.launch import steps as tsteps
from repro_torch.models import dcn_v2 as tdcn
from repro_torch.nn import embedding_bag as teb

TOL = (1e-5, 1e-5)
GRAD_TOL = (1e-4, 1e-4)
LR = 1e-3
B = 32


def close(got, exp, tol, what=""):
    """|got - exp| <= rtol |exp| + share max|exp|, elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    scale = max(float(np.abs(exp).max()), 1e-30) if exp.size else 1.0
    bad = np.abs(got - exp) > tol[0] * np.abs(exp) + tol[1] * scale
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} off, worst "
        f"{float(np.abs(got - exp).max())} at scale {scale}")


def bitwise(got, exp, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(exp), err_msg=what)


def leaves(tree, prefix=()):
    """(dotted name, leaf) in JAX's tree order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), tree


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)


# --------------------------------------------------------- embedding bag ----

VOCABS = np.array([7, 11, 5])


def bag_inputs(seed=1, nnz=40, n_bags=6):
    """``tests/test_recsys.py``'s bags, more of them; the last bag empty."""
    rng = np.random.default_rng(seed)
    field_ids = rng.integers(0, 3, nnz).astype(np.int32)
    ids = np.array([rng.integers(0, VOCABS[f]) for f in field_ids], np.int32)
    bag_ids = np.sort(rng.integers(0, n_bags - 1, nnz)).astype(np.int32)
    return ids, field_ids, bag_ids, n_bags


def jax_table(dim=4):
    boxed, offsets = jeb.fused_table_init(jax.random.PRNGKey(0), VOCABS, dim)
    params, _ = split_boxed(boxed)
    return np.asarray(params["table"]).copy(), offsets


def port_table(table):
    t, off = teb.fused_table_init(VOCABS, table.shape[1],
                                  torch.Generator().manual_seed(0))
    with torch.no_grad():
        t.table.copy_(torch.from_numpy(table))
    return t, off


def test_fused_table_init_layout():
    table, offsets = jax_table()
    t, off = teb.fused_table_init(VOCABS, 4, torch.Generator().manual_seed(0))
    assert tuple(t.table.shape) == table.shape == (23, 4)
    assert off.dtype == torch.int64 and off.device.type == "cpu"
    bitwise(off, offsets)
    # 0.01 * N(0, 1), as JAX's boxed_param(scale=0.01)
    assert 0.002 < float(t.table.std()) < 0.03


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_bitwise_and_against_onehot(mode):
    table, offsets = jax_table()
    ids, fids, bags, n = bag_inputs()
    exp = jeb.embedding_bag({"table": jnp.asarray(table)}, offsets,
                            jnp.asarray(ids), jnp.asarray(fids),
                            jnp.asarray(bags), n, mode=mode)
    t, off = port_table(table)
    got = teb.embedding_bag(t, off, torch.from_numpy(ids),
                            torch.from_numpy(fids), torch.from_numpy(bags),
                            n, mode=mode)
    bitwise(got, exp, mode)
    # the one-hot oracle of tests/test_recsys.py
    flat = ids + offsets[fids]
    onehot = np.zeros((n, int(VOCABS.sum())), np.float32)
    for b, f in zip(bags, flat):
        onehot[b, f] += 1
    want = onehot @ table
    if mode == "mean":
        want = want / np.maximum(onehot.sum(1, keepdims=True), 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert not got[-1].any()  # an empty bag reads 0


def test_embedding_bag_table_gradient_bitwise():
    table, offsets = jax_table()
    ids, fids, bags, n = bag_inputs(seed=2, nnz=200)
    w = np.random.default_rng(3).standard_normal((n, 4)).astype(np.float32)
    jg = jax.grad(lambda tb: (jeb.embedding_bag(
        {"table": tb}, offsets, jnp.asarray(ids), jnp.asarray(fids),
        jnp.asarray(bags), n) * w).sum())(jnp.asarray(table))
    t, off = port_table(table)
    t.table.requires_grad_(True)
    out = teb.embedding_bag(t, off, torch.from_numpy(ids),
                            torch.from_numpy(fids), torch.from_numpy(bags), n)
    (out * torch.from_numpy(w)).sum().backward()
    bitwise(t.table.grad, jg)


def test_lookup_single_bitwise_with_gradient():
    table, offsets = jax_table(dim=5)
    rng = np.random.default_rng(4)
    ids = np.stack([rng.integers(0, v, 50) for v in VOCABS], 1).astype(
        np.int32)
    w = rng.standard_normal((50, 3, 5)).astype(np.float32)
    jout, jg = jax.value_and_grad(lambda tb: (jeb.lookup_single(
        {"table": tb}, offsets, jnp.asarray(ids)) * w).sum())(
        jnp.asarray(table))
    exp = jeb.lookup_single({"table": jnp.asarray(table)}, offsets,
                            jnp.asarray(ids))
    t, off = port_table(table)
    t.table.requires_grad_(True)
    got = teb.lookup_single(t, off, torch.from_numpy(ids))
    (got * torch.from_numpy(w)).sum().backward()
    bitwise(got, exp)
    bitwise(t.table.grad, jg)
    bitwise(got, table[ids + offsets[None, :]])  # the one-hot rows


def test_embedding_bag_refuses_an_unknown_mode():
    t, off = port_table(jax_table()[0])
    ids, fids, bags, n = bag_inputs()
    with pytest.raises(ValueError, match="mode"):
        teb.embedding_bag(t, off, torch.from_numpy(ids),
                          torch.from_numpy(fids), torch.from_numpy(bags), n,
                          mode="max")


# ---------------------------------------------------------------- DCN-v2 ----

def make_batch(cfg, b=B, seed=0):
    """``tests/test_recsys.py``'s batch (numpy)."""
    rng = np.random.default_rng(seed)
    return {"dense": (rng.random((b, cfg.n_dense)) * 100).astype(np.float32),
            "sparse": rng.integers(0, 97, (b, cfg.n_sparse)).astype(np.int32),
            "labels": rng.integers(0, 2, b).astype(np.int32)}


@pytest.fixture(scope="module")
def smoke():
    """JAX's smoke DCN-v2 (PRNGKey 0) and the port's model holding its
    weights."""
    cfg = j_smoke_config()
    boxed, offsets = jdcn.init(jax.random.PRNGKey(0), cfg)
    params, _ = split_boxed(boxed)
    tree = jax.tree.map(lambda x: np.asarray(x).copy(), params)
    tcfg = tbase.get("dcn-v2").smoke_config()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return cfg, params, offsets, tree, tcfg


def port_model(smoke, grad=False):
    _, _, _, tree, tcfg = smoke
    model, off = tdcn.params_from_jax(tree, tcfg, "cpu")
    return model.requires_grad_(grad), off


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_params_from_jax_keys_and_values(smoke):
    _, params, offsets, tree, _ = smoke
    model, off = port_model(smoke)
    named = dict(model.named_parameters())
    jl = dict(leaves(tree))
    assert sorted(named) == sorted(jl)
    assert {"embed.table", "cross.w_0.kernel", "cross.w_0.bias",
            "mlp.w_0.kernel", "head.kernel",
            "retrieval_proj.kernel"} <= set(named)
    for k, v in jl.items():
        bitwise(named[k], v, k)
    bitwise(off, offsets)
    bad = dict(tree, head={"kernel": np.zeros((3, 1), np.float32)})
    with pytest.raises(ValueError, match="head.kernel"):
        tdcn.params_from_jax(bad, smoke[4], "cpu")


def test_features_logits_and_query_embedding_match_jax(smoke):
    cfg, params, offsets, _, tcfg = smoke
    batch = make_batch(cfg)
    model, off = port_model(smoke)
    with torch.no_grad():
        close(tdcn.features(model, tcfg, tbatch(batch), off),
              jdcn.features(params, cfg, jbatch(batch), offsets), TOL,
              "features")
        close(tdcn.forward(model, tcfg, tbatch(batch), off),
              jdcn.forward(params, cfg, jbatch(batch), offsets), TOL,
              "logits")
        q = tdcn.query_embedding(model, tcfg, tbatch(batch), off)
    close(q, jdcn.query_embedding(params, cfg, jbatch(batch), offsets), TOL,
          "query embedding")
    np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=-1).numpy(),
                               1.0, rtol=1e-6)


def test_loss_gradients_and_adamw_step_match_jax_cell(smoke):
    """The recsys train step against the step JAX's ``_recsys_cell``
    composes, jitted."""
    cfg, params, _, _, tcfg = smoke
    batch = make_batch(cfg, seed=5)
    # the cell's offsets: int32, as _recsys_cell passes them
    joff = jnp.asarray(np.concatenate(
        [[0], np.cumsum(cfg.field_vocabs)[:-1]]).astype(np.int32))
    ocfg = JAdamWConfig(lr=LR, weight_decay=0.0)

    @jax.jit
    def jstep(p, o, b):
        loss, grads = jax.value_and_grad(jdcn.loss_fn)(p, cfg, b, joff)
        new_p, new_o, gnorm = jadamw_update(grads, o, p, ocfg)
        return new_p, new_o, loss, gnorm, grads

    jp, jo, jloss, jgn, jgrads = jstep(params, jadamw_init(params, ocfg),
                                       jbatch(batch))
    cell = tsteps.recsys_cell("dcn-v2", "train_batch", smoke=True,
                              dims=dict(batch=B))
    model, off = port_model(smoke, grad=True)
    loss = tdcn.loss_fn(model, tcfg, tbatch(batch), off)
    close(loss.detach(), jloss, TOL, "loss")
    loss.backward()
    for k, g in leaves(jax.tree.map(np.asarray, jgrads)):
        p = dict(model.named_parameters())[k]
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        close(got, g, GRAD_TOL, f"gradient {k}")
    assert not dict(model.named_parameters())["retrieval_proj.kernel"] \
        .grad_fn and dict(model.named_parameters())[
            "retrieval_proj.kernel"].grad is None
    model.zero_grad(set_to_none=True)
    opt = tsteps.adamw_init(tsteps.params_dict(model), tsteps.RECSYS_ADAMW)
    step = tsteps.recsys_step(cell, off)
    _, opt, tloss, tgn = step(model, opt, tbatch(batch))
    close(tloss, jloss, TOL, "step loss")
    close(tgn, jgn, TOL, "gradient norm")
    assert int(opt.step) == int(jo.step) == 1
    named = dict(model.named_parameters())
    for k, v in leaves(jax.tree.map(np.asarray, jo.mu)):
        close(opt.mu[k], v, GRAD_TOL, f"mu {k}")
    for k, v in leaves(jax.tree.map(np.asarray, jo.nu)):
        close(opt.nu[k], v, GRAD_TOL, f"nu {k}")
    for k, v in leaves(jax.tree.map(np.asarray, jp)):
        d = np.abs(named[k].detach().numpy().astype(np.float64) - v)
        assert d.max() <= 0.1 * LR, (k, d.max())
        assert named[k].grad is None
    # retrieval_proj (no gradient) did not move
    bitwise(named["retrieval_proj.kernel"],
            smoke[3]["retrieval_proj"]["kernel"])


def test_cross_layers_are_the_identity_at_zero(smoke):
    cfg, _, _, _, tcfg = smoke
    model, off = port_model(smoke)
    with torch.no_grad():
        for m in model.cross.values():
            m.kernel.zero_()
            m.bias.zero_()
        x0 = tdcn.features(model, tcfg, tbatch(make_batch(cfg)), off)
        x = x0
        for i in range(tcfg.n_cross_layers):
            p = model.cross[f"w_{i}"]
            x = x0 * (x @ p.kernel + p.bias) + x
        bitwise(x, x0.numpy())
        no_cross = dataclasses.replace(tcfg, n_cross_layers=0)
        bitwise(tdcn.interaction(model, tcfg, x0),
                tdcn.interaction(model, no_cross, x0).numpy())


def test_retrieval_topk_indices_match_lax_top_k(smoke):
    cfg, params, offsets, _, tcfg = smoke
    batch = make_batch(cfg, b=2)
    cands = np.random.default_rng(3).standard_normal(
        (1000, cfg.retrieval_dim)).astype(np.float32)
    jv, ji = jdcn.retrieval_scores(params, cfg, jbatch(batch), offsets,
                                   jnp.asarray(cands), top_k=10)
    model, off = port_model(smoke)
    with torch.no_grad():
        tv, ti = tdcn.retrieval_scores(model, tcfg, tbatch(batch), off,
                                       torch.from_numpy(cands), top_k=10)
    assert tv.shape == ti.shape == (2, 10)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert (np.diff(jv, axis=1) < 0).all()  # distinct scores
    bitwise(ti, ji)
    close(tv, jv, TOL, "top-k scores")
    # and the step of the retrieval cell
    cell = tsteps.recsys_cell("dcn-v2", "retrieval_cand", smoke=True,
                              dims=dict(batch=2, n_candidates=1000))
    sv, si = tsteps.recsys_step(cell, off)(model, tbatch(batch),
                                           torch.from_numpy(cands))
    assert si.shape == (2, tsteps.RETRIEVAL_TOP_K)
    bitwise(si[:, :10], ji)


def test_full_config_on_meta_matches_jax_shapes():
    jcfg = jdcn.DCNv2Config()
    shapes = jax.eval_shape(lambda: jdcn.init(jax.random.PRNGKey(0),
                                              jcfg)[0])
    jparams, _ = split_boxed(shapes)
    want = {k: tuple(s.shape) for k, s in leaves(jparams)}
    cfg = tbase.get("dcn-v2").full_config()
    model, off = tdcn.init(cfg, None, "meta")
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
    n = sum(int(np.prod(s)) for s in want.values())
    assert sum(p.numel() for p in model.parameters()) == n == 576_998_850
    assert sum(cfg.field_vocabs) == 35_900_000
    assert off.device.type == "meta"
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_recsys_cell_flops_and_batch_match_jax(shape):
    from repro.configs import base as jbase
    from repro.data.pipeline import RecsysStream as JRecsysStream

    spec = jbase.get("dcn-v2")
    jshape = next(s for s in spec.shapes if s.name == shape)
    jcell = jsteps._recsys_cell(spec, jshape, make_mesh((1, 1),
                                                        ("data", "model")),
                                False)
    cell = tsteps.recsys_cell("dcn-v2", shape)
    assert cell.kind == jcell.kind and cell.flops == jcell.model_flops
    assert cell.batch == jshape.dims["batch"]
    assert tsteps.dcn_flops(cell.cfg, 7) == jsteps._dcn_flops(cell.cfg, 7)
    small = tsteps.recsys_cell("dcn-v2", shape, smoke=True,
                               dims=dict(batch=16))
    got = tsteps.recsys_batch(small, step=3, seed=2)
    want = JRecsysStream(small.cfg.field_vocabs, 16, seed=2).batch(3)
    assert set(got) == ({"dense", "sparse", "labels"} if cell.kind == "train"
                        else {"dense", "sparse"})
    for k in got:
        bitwise(got[k], want[k], k)


def test_serve_step_is_the_forward(smoke):
    cfg, params, offsets, _, tcfg = smoke
    cell = tsteps.recsys_cell("dcn-v2", "serve_p99", smoke=True,
                              dims=dict(batch=B))
    model, off = port_model(smoke)
    batch = tsteps.recsys_batch(cell, seed=4)
    got = tsteps.recsys_step(cell, off)(model, tbatch(batch))
    assert got.shape == (B,) and not got.requires_grad
    close(got, jdcn.forward(params, cfg, jbatch(batch), offsets), TOL,
          "served logits")
