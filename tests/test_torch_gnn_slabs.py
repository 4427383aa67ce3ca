"""The port's destination-aligned edge slabs (``models/gnn/common.py``:
``set_edge_slabs``, the slab view and reduce, ``segment_softmax``'s slab
branch) against JAX's, in one process on the CPU.

JAX's ``tests/test_system.py::test_slab_aggregation_matches_flat``
extended to MACE and to the backward. A seeded 32-node, 120-edge graph
is laid out by ``graph/partition.slab_edges`` into ``K`` slabs, both
balances (uniform node ranges, edge-balanced ``bounds``), and each of
the four archs' smoke configs (JAX's weights carried across) runs on the
flat batch and on each slab batch in both packages:

- the aggregates (sum, mean, max, min), ``degree`` and
  ``segment_softmax`` on the slab layout are bitwise JAX's slab path (the
  slabs' segment sums add in the same edge order), gradients included;
- each model's ``node_out`` is JAX's slab path's at ``TOL``, and every
  gradient leaf of ``sum(node_out ** 2)`` is JAX's slab path's at the
  GNN tests' gradient tolerances where JAX's leaf is finite;
- JAX's ``jnp.take`` fills NaN at a pad edge's ``dst == N`` (PNA's
  ``hi``, EquiformerV2's ``xi_scal``), and 0 x NaN makes those leaves NaN
  in JAX's slab path. The port's ``take`` clamps as JAX's ``x[ids]``
  does: those leaves must be NaN in JAX, finite in the port, and equal
  to JAX's flat path on the unpadded graph (the same function);
- the fall-backs are JAX's: ``K`` None or 1, ``E % K``, ``N % K`` and
  bounds that do not match run the flat path, bitwise.

Tolerances: ``TOL`` 1e-5 + 1e-5 of the largest magnitude (forward);
gradients 1e-4 + 1e-4, PNA's 1e-3 + 1e-3 (``test_torch_gnn.py``'s, for
the float32 transcendentals and PNA's std aggregator).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.graph.partition import slab_edges
from repro.models.gnn import common as jc
from repro.nn.module import split_boxed

from repro_torch.configs import base as tbase
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn import common as tc

TOL = (1e-5, 1e-5)
GRAD_TOL = (1e-4, 1e-4)
PNA_GRAD_TOL = (1e-3, 1e-3)
ARCHS = ["equiformer-v2", "mace", "pna", "schnet"]
N, E, K = 32, 120, 4
#: the leaves JAX's NaN fill reaches on a padded slab batch
JAX_NAN = {"pna": {("layer_0", "pre", "kernel"), ("layer_1", "pre", "kernel")}}


def close(got, exp, tol, what=""):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    rtol, share = tol
    scale = max(float(np.abs(exp).max()), 1e-30) if exp.size else 1.0
    bad = np.abs(got - exp) > rtol * np.abs(exp) + share * scale
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} off, worst "
        f"{float(np.abs(got - exp).max())} at scale {scale}")


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(autouse=True)
def no_slabs():
    yield
    jc.set_edge_slabs(None)
    tc.set_edge_slabs(None)


def graph(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    batch = {
        "edge_src": src, "edge_dst": dst,
        "node_feat": rng.standard_normal((N, 16)).astype(np.float32),
        "positions": (rng.standard_normal((N, 3)) * 2).astype(np.float32),
        "species": rng.integers(0, 8, N).astype(np.int32),
    }
    return batch


def layouts(batch):
    """{name: (batch, K, bounds)}: flat, uniform slabs, edge-balanced."""
    src, dst = batch["edge_src"], batch["edge_dst"]
    us, ud, _ = slab_edges(src, dst, N, K)
    bs, bd, bounds = slab_edges(src, dst, N, K, balance="edges")
    assert len(bs) <= len(us) and len(us) % K == 0 and len(bs) % K == 0
    return {"flat": (batch, None, None),
            "nodes": (dict(batch, edge_src=us, edge_dst=ud), K, None),
            "edges": (dict(batch, edge_src=bs, edge_dst=bd), K, bounds)}


def jax_run(mod, params, cfg, batch, k, bounds):
    jc.set_edge_slabs(k, bounds=bounds)
    jb = {key: jnp.asarray(v) for key, v in batch.items()}

    def fwd(p):
        return mod.apply(p, cfg, jb)["node_out"]

    # traced once a layout (the slab count is read at trace time)
    out, vjp = jax.vjp(jax.jit(fwd), params)
    (grads,) = vjp(2.0 * out)  # d sum(out ** 2)
    jc.set_edge_slabs(None)
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def port_run(arch, cfg, tree, batch, k, bounds):
    tc.set_edge_slabs(k, bounds=bounds)
    mod = tsteps.GNN_MODULES[arch]
    model = mod.params_from_jax(cfg, tree, device="cpu").requires_grad_(True)
    tb = tsteps.batch_to(batch, "cpu")
    out = mod.apply(model, cfg, tb)["node_out"]
    torch.sum(torch.square(out)).backward()
    tc.set_edge_slabs(None)
    return out.detach().numpy(), tc.grads_to_numpy(model)


def smoke(arch):
    cfg = tbase.get(arch).smoke_config()
    jcfg = jbase.get(arch).smoke_config()
    if arch != "pna":
        cfg = dataclasses.replace(cfg, d_feat=16)
        jcfg = dataclasses.replace(jcfg, d_feat=16)
    return cfg, jcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_models_on_slabs_match_jax_forward_and_gradients(arch):
    cfg, jcfg = smoke(arch)
    jmod = {"pna": __import__("repro.models.gnn.pna", fromlist=["x"]),
            "schnet": __import__("repro.models.gnn.schnet", fromlist=["x"]),
            "mace": __import__("repro.models.gnn.mace", fromlist=["x"]),
            "equiformer-v2": __import__("repro.models.gnn.equiformer_v2",
                                        fromlist=["x"])}[arch]
    params, _ = split_boxed(jmod.init(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, params)
    gtol = PNA_GRAD_TOL if arch == "pna" else GRAD_TOL
    runs = {}
    for name, (b, k, bounds) in layouts(graph()).items():
        runs[name] = (jax_run(jmod, params, jcfg, b, k, bounds),
                      port_run(arch, cfg, tree, b, k, bounds))
    (_, jflat), _ = runs["flat"]
    for name in ("nodes", "edges"):
        (jout, jg), (tout, tg) = runs[name]
        close(tout, jout, TOL, f"{arch} {name} node_out")
        nan = set()
        for (path, want), (tpath, got) in zip(leaves(jg), leaves(tg)):
            assert path == tpath
            assert np.isfinite(got).all(), (arch, name, path)
            if np.isfinite(want).all():
                close(got, want, gtol, f"{arch} {name} d{path}")
            else:
                nan.add(path)
                close(got, dict(leaves(jflat))[path], gtol,
                      f"{arch} {name} d{path} (JAX's flat path)")
        if arch == "equiformer-v2":
            # the NaN reaches every leaf upstream of the first logits
            assert ("layer_0", "alpha", "kernel") in nan
        else:
            assert nan == JAX_NAN.get(arch, set()), (arch, name, nan)


def _aggregate_inputs(seed=1):
    rng = np.random.default_rng(seed)
    b = graph(seed)
    us, ud, _ = slab_edges(b["edge_src"], b["edge_dst"], N, K)
    bs, bd, bounds = slab_edges(b["edge_src"], b["edge_dst"], N, K,
                                balance="edges")
    # a few ties, so the extrema's gradient splits
    msgs = lambda e: np.round(rng.standard_normal((e, 3)), 1).astype(
        np.float32)
    return [(ud, msgs(len(ud)), None), (bd, msgs(len(bd)), bounds)]


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "softmax",
                                "degree"])
def test_slab_aggregates_bitwise_jax(op):
    for dst, msg, bounds in _aggregate_inputs():
        jc.set_edge_slabs(K, bounds=bounds)
        tc.set_edge_slabs(K, bounds=bounds)
        w = np.random.default_rng(2).standard_normal(
            (N, 3) if op != "softmax" else msg.shape).astype(np.float32)

        def jfn(m):
            if op == "softmax":
                return jc.segment_softmax(m, jnp.asarray(dst), N)
            if op == "degree":
                return jc.degree(jnp.asarray(dst), N)
            return jc.aggregate(m, jnp.asarray(dst), N, op)

        def tfn(m):
            d = torch.from_numpy(dst).long()
            if op == "softmax":
                return tc.segment_softmax(m, d, N)
            if op == "degree":
                return tc.degree(d, N)
            return tc.aggregate(m, d, N, op)

        jout = np.asarray(jfn(jnp.asarray(msg)))
        m = torch.from_numpy(msg).requires_grad_(True)
        tout = tfn(m)
        if op == "softmax":  # exp's last bit: PyTorch's against XLA's
            close(tout.detach().numpy(), jout, TOL, op)
        else:
            np.testing.assert_array_equal(tout.detach().numpy(), jout,
                                          err_msg=f"{op} bounds={bounds}")
        if op == "degree":
            continue
        jgrad = np.asarray(jax.grad(
            lambda x: jnp.sum(jfn(x) * jnp.asarray(w)))(jnp.asarray(msg)))
        torch.sum(tout * torch.from_numpy(w)).backward()
        if op == "softmax":
            close(m.grad.numpy(), jgrad, TOL, f"d{op}")
        else:
            np.testing.assert_array_equal(m.grad.numpy(), jgrad,
                                          err_msg=f"d{op} bounds={bounds}")


@pytest.mark.parametrize("case", ["none", "one", "edges_indivisible",
                                  "nodes_indivisible", "bounds_mismatch"])
def test_slab_fallbacks_run_the_flat_path(case):
    """JAX's ``_slab_view`` returns None in each case; the port's reduce
    is then the flat one, bitwise."""
    rng = np.random.default_rng(3)
    n, e, k, bounds = N, E, K, None
    if case == "none":
        k = None
    elif case == "one":
        k = 1
    elif case == "edges_indivisible":
        e = E + 1
    elif case == "nodes_indivisible":
        n = N + 1
    else:
        bounds = np.array([0, 8, 16, N + 5])  # K + 1 entries wanted, 4 given
    dst = torch.from_numpy(rng.integers(0, n, e)).long()
    msg = torch.from_numpy(rng.standard_normal((e, 2)).astype(np.float32))
    assert tc._slab_view(dst, n) is None or case == "none"
    tc.set_edge_slabs(None)
    flat = tc.aggregate(msg, dst, n, "max")
    tc.set_edge_slabs(k, bounds=bounds)
    assert tc._slab_view(dst, n) is None
    torch.testing.assert_close(tc.aggregate(msg, dst, n, "max"), flat,
                               rtol=0, atol=0)
    jc.set_edge_slabs(k, bounds=bounds)
    assert jc._slab_view(jnp.asarray(msg), jnp.asarray(dst), n) is None
