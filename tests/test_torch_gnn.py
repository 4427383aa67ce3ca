"""The port's GNN substrate, sampler, SchNet, PNA and GNN train step against
the JAX package, on the CPU.

Seeded numpy inputs go through ``repro``'s function and the port's
counterpart; models carry JAX's weights across (``params_from_jax``).

- ``models/gnn/common``: ``aggregate`` (sum, mean, max, min), ``degree``
  and ``segment_sum``, forward and gradient, bitwise: ``index_add`` on the
  CPU adds in edge order as XLA's scatter does, and the extrema's gradient
  splits among ties as ``lax.scatter_max``'s transpose does (a tie of
  three and a tie at 0 included); a node with no in-edge reads 0; pad
  edges at ``dst == N`` (``slab_edges``' layout at K = 2 and 4, uniform
  and edge-balanced) dropped, bitwise; ``edge_vectors`` with zero-length edges and
  the Gaussian centers bitwise. ``segment_softmax``, the radial bases and
  ``shifted_softplus`` go through float32 ``exp``/``sin``/``log1p``,
  whose last bit differs between XLA and PyTorch: held at ``TOL``.
- ``graph/sampler``: fed the raw slots JAX draws inside its
  ``sample_subgraph`` (``jax.random.randint`` on the ``jax.random.split``
  keys), the subgraph is bitwise JAX's; the generator path on its own:
  range, shapes, child -> parent edges that exist, and the zero-degree
  self-loop.
- SchNet and PNA: forward and every gradient leaf at ``TOL`` and
  ``GRAD_TOL``/``PNA_GRAD_TOL``; every arch's full-width config on
  ``meta`` against JAX's parameter shapes.
- ``launch/steps``: the train step of every arch on each shape kind
  (``full_graph``, ``minibatch``, ``batched``) at smoke sizes, against the
  step JAX's ``_gnn_cell`` composes on a one-device mesh (``module.apply``,
  the MSE, ``adamw_update`` with lr 1e-3, no weight decay): loss and
  gradient norm at ``TOL``, AdamW's moments (the clipped gradient's
  running mean and square) at the gradient tolerance, parameters within
  0.1 lr (an early AdamW step moves a parameter by about ``lr *
  sign(g)``, and a rounding difference of a near-zero gradient moves that
  ratio), the analytic FLOPs equal.
  The equivariant archs' cases are in ``test_torch_gnn_equivariant.py``.
- The slice end to end: two sampled PNA train steps on subgraphs JAX
  samples from an ELL, the port sampling the same subgraphs from JAX's
  slots.

Tolerances (relative plus a share of the tensor's largest magnitude, as
the LM tests state them): ``TOL`` 1e-5 + 1e-5 (forward, loss, norms);
``GRAD_TOL`` 1e-4 + 1e-4 for gradients, whose float32 sums of products
PyTorch and XLA order differently; ``PNA_GRAD_TOL`` 1e-3 + 1e-3 for
PNA's: its std aggregator's gradient is ``(d sq - 2 mean d mean) / (2
sqrt(var + 1e-6))``, and where a node's messages have no variance (one
in-edge) the numerator is a difference of equal rounded products, which
the 1e-3 denominator multiplies 500-fold (measured: 1.7e-4 of a leaf's
largest magnitude).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.graph import csr as jcsr
from repro.graph import sampler as jsampler
from repro.graph.generators import erdos_renyi as j_erdos_renyi
from repro.graph.partition import slab_edges as j_slab_edges
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models.gnn import common as jc
from repro.nn.module import set_activation_rules, split_boxed
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init

from repro_torch.configs import base as tbase
from repro_torch.graph import csr as tcsr
from repro_torch.graph import sampler as tsampler
from repro_torch.graph.generators import erdos_renyi
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn import common as tc
from repro_torch.optim.adamw import adamw_init

TOL = (1e-5, 1e-5)
GRAD_TOL = (1e-4, 1e-4)
PNA_GRAD_TOL = (1e-3, 1e-3)
LR = 1e-3
GNN_ARCHS = ["equiformer-v2", "mace", "pna", "schnet"]
# smaller cells of each shape kind
SMALL = {"full_graph_sm": dict(n_nodes=40, n_edges=120, d_feat=24),
         "minibatch_lg": dict(batch_nodes=4, fanout=(3, 2)),
         "molecule": dict(batch=3, n_nodes=6, n_edges=10)}


def close(got, exp, tol, what=""):
    """|got - exp| <= rtol |exp| + atol max|exp|, elementwise."""
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    rtol, share = tol
    scale = max(float(np.abs(exp).max()), 1e-30) if exp.size else 1.0
    bad = np.abs(got - exp) > rtol * np.abs(exp) + share * scale
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} off, worst "
        f"{float(np.abs(got - exp).max())} at scale {scale}")


def bitwise(got, exp, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(exp), err_msg=what)


def tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def trees_close(got, exp, tol, what):
    exp_leaves = list(tree_leaves(exp))
    assert [p for p, _ in tree_leaves(got)] == [p for p, _ in exp_leaves]
    for path, e in exp_leaves:
        close(at(got, path), e, tol, f"{what} {'/'.join(path)}")


def params_after_step(got, exp, lr, what):
    """Every parameter within 0.1 lr."""
    for path, e in tree_leaves(exp):
        d = np.abs(np.asarray(at(got, path), np.float64) - e)
        assert d.max() <= 0.1 * lr, f"{what} {'/'.join(path)}: {d.max()}"


@pytest.fixture(autouse=True)
def flat_layout():
    """JAX's slab mode off around every test (the port has none)."""
    jc.set_edge_slabs(None)
    yield
    jc.set_edge_slabs(None)
    set_activation_rules(None)


# ------------------------------------------------------------- common ----

def edges(seed=0, n=50, e=600, isolated=5):
    """Edges into the first ``n - isolated`` nodes (the rest have no
    in-edge), messages rounded to one decimal (many ties), some at 0."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n - isolated, e).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    msg = np.round(rng.standard_normal((e, 7)), 1).astype(np.float32)
    msg[rng.random((e, 7)) < 0.3] = 0.0
    return src, dst, msg


def jax_value_and_grad(fn, x, w):
    return jax.value_and_grad(lambda v: (fn(v) * w).sum())(jnp.asarray(x))


def port_value_and_grad(fn, x, w):
    t = torch.from_numpy(x).requires_grad_(True)
    out = fn(t)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), t.grad


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_aggregate_bitwise_with_gradient(op):
    src, dst, msg = edges()
    n = 50
    w = np.random.default_rng(1).standard_normal((n, 7)).astype(np.float32)
    exp = np.asarray(jc.aggregate(jnp.asarray(msg), jnp.asarray(dst), n, op))
    _, jg = jax_value_and_grad(
        lambda v: jc.aggregate(v, jnp.asarray(dst), n, op), msg, w)
    got, tg = port_value_and_grad(
        lambda v: tc.aggregate(v, torch.from_numpy(dst), n, op), msg, w)
    bitwise(got, exp, op)
    bitwise(tg, jg, f"{op} gradient")
    assert (exp[-5:] == 0).all()  # no in-edge: 0, not the -inf base


def test_extremum_tie_gradient_splits_like_jax():
    """Three and two edges tie for one node's max, all tie at 0 for
    another: JAX scales the cotangent by 1/ties (1/3 rounds)."""
    msg = np.array([[0.7], [0.7], [0.7], [0.2], [0.0], [0.0], [0.5], [0.5]],
                   np.float32)
    dst = np.array([0, 0, 0, 0, 1, 1, 2, 2], np.int32)
    w = np.array([[0.3], [1.1], [-2.9]], np.float32)
    for op in ("max", "min"):
        _, jg = jax_value_and_grad(
            lambda v: jc.aggregate(v, jnp.asarray(dst), 3, op), msg, w)
        got, tg = port_value_and_grad(
            lambda v: tc.aggregate(v, torch.from_numpy(dst), 3, op), msg, w)
        bitwise(tg, jg, op)
    assert float(tg[0, 0]) == 0.0 and float(jg[0, 0]) == 0.0  # min: 0.2
    _, jg = jax_value_and_grad(
        lambda v: jc.aggregate(v, jnp.asarray(dst), 3, "max"), msg, w)
    assert float(jg[0, 0]) == np.float32(0.3) * np.float32(1 / 3)


def test_degree_and_segment_sum_bitwise():
    src, dst, msg = edges(seed=2)
    bitwise(tc.degree(torch.from_numpy(dst), 50),
            jc.degree(jnp.asarray(dst), 50))
    ids = np.random.default_rng(3).integers(0, 9, 50).astype(np.int32)
    x = np.random.default_rng(4).standard_normal((50, 3)).astype(np.float32)
    bitwise(tc.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), 9),
            jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids), 9))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("balance", ["nodes", "edges"])
def test_pad_edges_dropped_bitwise(k, balance):
    """Edges laid out by ``slab_edges`` (pad edges at dst == N) through
    both packages' flat reductions: every reduce and its gradient bitwise,
    the softmax at TOL; the pad edges change no node's result."""
    n = 48
    src, dst, msg = edges(seed=5, n=n, e=500, isolated=4)
    s, d, _ = j_slab_edges(src, dst, n, k, balance=balance)
    assert (d == n).any()
    rng = np.random.default_rng(6)
    m = np.round(rng.standard_normal((len(d), 5)), 1).astype(np.float32)
    w = rng.standard_normal((n, 5)).astype(np.float32)
    live = d < n
    for op in ("sum", "mean", "max", "min"):
        _, jg = jax_value_and_grad(
            lambda v: jc.aggregate(v, jnp.asarray(d), n, op), m, w)
        exp = np.asarray(jc.aggregate(jnp.asarray(m), jnp.asarray(d), n, op))
        got, tg = port_value_and_grad(
            lambda v: tc.aggregate(v, torch.from_numpy(d), n, op), m, w)
        bitwise(got, exp, f"padded {op}")
        bitwise(tg, jg, f"padded {op} gradient")
        assert not tg[torch.from_numpy(~live)].any(), (
            f"padded {op}: a pad edge has a gradient")
        unpadded = tc.aggregate(torch.from_numpy(m[live]),
                                torch.from_numpy(d[live]), n, op)
        bitwise(got, unpadded.numpy(), f"padded {op} against unpadded")
    bitwise(tc.degree(torch.from_numpy(d), n), jc.degree(jnp.asarray(d), n))
    lg = rng.standard_normal((len(d), 3)).astype(np.float32)
    got = tc.segment_softmax(torch.from_numpy(lg), torch.from_numpy(d), n)
    close(got, jc.segment_softmax(jnp.asarray(lg), jnp.asarray(d), n), TOL,
          "padded softmax")
    close(got[torch.from_numpy(live)],
          tc.segment_softmax(torch.from_numpy(lg[live]),
                             torch.from_numpy(d[live]), n), TOL,
          "padded softmax against unpadded")


def test_segment_softmax_and_its_gradient():
    src, dst, _ = edges(seed=7)
    lg = np.random.default_rng(8).standard_normal((600, 4)).astype(
        np.float32) * 3
    w = np.random.default_rng(9).standard_normal((600, 4)).astype(np.float32)
    exp, jg = jax_value_and_grad(
        lambda v: jc.segment_softmax(v, jnp.asarray(dst), 50), lg, w)
    exp = np.asarray(jc.segment_softmax(jnp.asarray(lg), jnp.asarray(dst), 50))
    got, tg = port_value_and_grad(
        lambda v: tc.segment_softmax(v, torch.from_numpy(dst), 50), lg, w)
    close(got, exp, TOL, "softmax")
    close(tg, jg, GRAD_TOL, "softmax gradient")


def test_edge_vectors_bitwise_with_zero_length_edges():
    rng = np.random.default_rng(10)
    pos = rng.standard_normal((30, 3)).astype(np.float32)
    pos[7] = pos[3]  # coincident atoms
    src = rng.integers(0, 30, 200).astype(np.int32)
    dst = rng.integers(0, 30, 200).astype(np.int32)
    src[:5] = dst[:5]  # self-loops
    src[5], dst[5] = 3, 7
    exp = jc.edge_vectors(jnp.asarray(pos), jnp.asarray(src),
                          jnp.asarray(dst))
    got = tc.edge_vectors(torch.from_numpy(pos), torch.from_numpy(src),
                          torch.from_numpy(dst))
    for g, e, what in zip(got, exp, ("unit", "dist", "valid")):
        bitwise(g, e, what)
    assert not got[2][:6].any() and got[2][6:].any()
    bitwise(got[0][:6], np.tile([[0.0, 0.0, 1.0]], (6, 1)).astype(np.float32))


def test_radial_bases_and_softplus():
    r = np.abs(np.random.default_rng(11).standard_normal(4000)).astype(
        np.float32) * 6
    r[:3] = [0.0, 1e-5, 12.0]
    for n_rbf, cutoff in ((300, 10.0), (32, 8.0), (16, 10.0)):
        bitwise(tc.rbf_centers(n_rbf, cutoff),
                jnp.linspace(0.0, cutoff, n_rbf))
        close(tc.gaussian_rbf(torch.from_numpy(r), n_rbf, cutoff),
              jc.gaussian_rbf(jnp.asarray(r), n_rbf, cutoff), TOL, "gauss")
    for n_rbf, cutoff in ((8, 5.0), (4, 5.0)):
        close(tc.bessel_rbf(torch.from_numpy(r), n_rbf, cutoff),
              jc.bessel_rbf(jnp.asarray(r), n_rbf, cutoff), TOL, "bessel")
    x = np.concatenate([np.linspace(-60, 60, 2001),
                        [0.0, 19.9, 20.1, 40.0]]).astype(np.float32)
    close(tc.shifted_softplus(torch.from_numpy(x)),
          jc.shifted_softplus(jnp.asarray(x)), TOL, "shifted softplus")
    # above F.softplus's threshold of 20 JAX's formula still adds log1p
    assert float(tc.shifted_softplus(torch.tensor([20.5]))) == float(
        jc.shifted_softplus(jnp.float32(20.5)))


# ------------------------------------------------------------ sampler ----

def jax_raw_slots(key, frontier_sizes, fanouts):
    """The slots ``sample_subgraph`` draws: ``randint`` on each hop's key
    of ``jax.random.split(rng, len(fanouts))``."""
    keys = jax.random.split(key, len(fanouts))
    return [np.asarray(jax.random.randint(keys[h], (n, f), 0, 1 << 30))
            for h, (n, f) in enumerate(zip(frontier_sizes, fanouts))]


@pytest.mark.parametrize("max_deg", [None, 16])
def test_sampler_bitwise_on_jax_slots(max_deg):
    csr = erdos_renyi(500, 8.0, seed=3)
    jcsr_ = j_erdos_renyi(500, 8.0, seed=3)
    # two zero-degree rows: self-loops
    keep = ~np.isin(np.repeat(np.arange(500), csr.degrees), [5, 250])
    src, dst = csr.edge_list()
    csr = tcsr.csr_from_edges(500, src[keep], dst[keep])
    jcsr_ = jcsr.csr_from_edges(500, src[keep], dst[keep])
    seeds = np.array([5, 100, 250, 499, 250], np.int32)
    fanouts = (4, 3)
    key = jax.random.PRNGKey(0)
    exp = jsampler.sample_subgraph(jcsr.ell_from_csr(jcsr_, max_deg),
                                   jnp.asarray(seeds), fanouts, key)
    raw = jax_raw_slots(key, (5, 20), fanouts)
    got = tsampler.sample_subgraph(tcsr.ell_from_csr(csr, max_deg), seeds,
                                   fanouts, raw_slots=raw, device="cpu")
    for name in ("nodes", "edge_src", "edge_dst"):
        bitwise(getattr(got, name), getattr(exp, name), name)
        assert getattr(got, name).dtype == torch.int32
    assert got.seed_count == exp.seed_count == 5
    nodes = got.nodes.numpy()
    assert nodes[5] == 5 and (nodes[5:9] == 5).all()  # zero degree


def test_sampler_generator_path():
    csr = erdos_renyi(400, 6.0, seed=4)
    g = tcsr.ell_from_csr(csr)
    gen = torch.Generator().manual_seed(0)
    raw = tsampler.draw_slots(gen, 1000, 7)
    assert raw.dtype == torch.int32 and raw.shape == (1000, 7)
    assert int(raw.min()) >= 0 and int(raw.max()) < 1 << 30
    assert int(raw.max()) > 1 << 29  # spans the range
    seeds = np.arange(0, 400, 37, dtype=np.int32)
    sub = tsampler.sample_subgraph(g, seeds, (5, 3),
                                   torch.Generator().manual_seed(1),
                                   device="cpu")
    n = len(seeds)
    assert sub.nodes.shape == (n * (1 + 5 + 15),)
    assert sub.edge_src.shape == sub.edge_dst.shape == (n * (5 + 15),)
    bitwise(sub.nodes[:n], seeds)
    nodes = sub.nodes.numpy()
    for s, d in zip(sub.edge_src.numpy(), sub.edge_dst.numpy()):
        child, parent = int(nodes[s]), int(nodes[d])
        nbrs = csr.neighbors(parent)
        assert child in nbrs or (child == parent and len(nbrs) == 0)
    again = tsampler.sample_subgraph(g, seeds, (5, 3),
                                     torch.Generator().manual_seed(1),
                                     device="cpu")
    bitwise(again.nodes, sub.nodes.numpy())


def test_sampler_zero_width_ell_self_loops():
    csr = tcsr.csr_from_edges(6, np.zeros(0, np.int32), np.zeros(0, np.int32))
    g = tcsr.ell_from_csr(csr)
    assert g.max_deg == 0
    sub = tsampler.sample_subgraph(g, [1, 4], (2,),
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    bitwise(sub.nodes, np.array([1, 4, 1, 1, 4, 4], np.int32))


# ------------------------------------------------------- SchNet and PNA ----

def carried(arch, cfg_change=None, smoke=True):
    """(JAX module, JAX cfg, JAX params, port cfg, port model)."""
    spec = jbase.get(arch)
    jcfg = spec.smoke_config() if smoke else spec.full_config()
    if cfg_change:
        jcfg = dataclasses.replace(jcfg, **cfg_change)
    jmod = jsteps.GNN_MODULES[arch]
    tmod = tsteps.GNN_MODULES[arch]
    tcfg_cls = type(tbase.get(arch).smoke_config())
    tcfg = tcfg_cls(**dataclasses.asdict(jcfg))
    params, _ = split_boxed(jmod.init(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, params)
    return jmod, jcfg, params, tcfg, tmod.params_from_jax(tcfg, tree, "cpu")


def toy_batch(seed=0, n=24, e=80, d_feat=16, graphs=None):
    """JAX's ``test_gnn_smoke.toy_batch`` shapes, as numpy."""
    rng = np.random.default_rng(seed)
    b = {"edge_src": rng.integers(0, n, e).astype(np.int32),
         "edge_dst": rng.integers(0, n - 2, e).astype(np.int32),
         "node_feat": rng.standard_normal((n, d_feat)).astype(np.float32),
         "positions": (rng.standard_normal((n, 3)) * 2.0).astype(np.float32),
         "species": rng.integers(0, 8, n).astype(np.int32)}
    b["edge_src"][:2] = b["edge_dst"][:2]  # zero-length edges
    if graphs:
        b["graph_ids"] = np.repeat(np.arange(graphs), n // graphs).astype(
            np.int32)
    return b


def forward_and_grads(arch, cfg_change, batch, n_graphs=None):
    jmod, jcfg, params, tcfg, model = carried(arch, cfg_change)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if n_graphs:
        jb["n_graphs"] = tb["n_graphs"] = n_graphs
    exp = jmod.apply(params, jcfg, jb)
    target = np.random.default_rng(1).standard_normal(
        exp["node_out"].shape).astype(np.float32)

    def jloss(p):
        return jnp.mean(jnp.square(jmod.apply(p, jcfg, jb)["node_out"]
                                   - target))

    jl, jg = jax.value_and_grad(jloss)(params)
    model.requires_grad_(True)
    got = model(tb)
    loss = torch.mean(torch.square(got["node_out"]
                                   - torch.from_numpy(target)))
    loss.backward()
    return exp, got, float(jl), loss.item(), jg, tc.grads_to_numpy(model)


@pytest.mark.parametrize("arch,change", [
    ("schnet", {"d_feat": 16}), ("schnet", {}), ("pna", {})])
def test_schnet_pna_forward_and_gradients(arch, change):
    exp, got, jl, tl, jg, tg = forward_and_grads(
        arch, change, toy_batch(graphs=2), n_graphs=2)
    for key in ("node_out", "graph_out"):
        close(got[key].detach(), exp[key], TOL, key)
    close(tl, jl, TOL, "loss")
    trees_close(tg, jax.tree.map(np.asarray, jg), grad_tol(arch), "gradient")


def test_graph_readout_sums_nodes():
    _, got, *_ = forward_and_grads("schnet", {}, toy_batch(graphs=2), 2)
    close(got["graph_out"].detach().sum(0), got["node_out"].detach().sum(0),
          TOL, "readout")
    with torch.no_grad():
        b = {k: torch.from_numpy(v) for k, v in toy_batch().items()}
        assert "graph_out" not in carried("schnet")[4](b)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_full_configs_on_meta_match_jax_shapes(arch):
    spec = tbase.get(arch)
    jcfg = jbase.get(arch).full_config()
    assert dataclasses.asdict(spec.full_config()) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(spec.smoke_config()) == dataclasses.asdict(
        jbase.get(arch).smoke_config())
    model = tsteps.GNN_MODULES[arch].init(spec.full_config(), None, "meta")
    boxed = jax.eval_shape(
        lambda: jsteps.GNN_MODULES[arch].init(jax.random.PRNGKey(0), jcfg))
    shapes = {"/".join(p): tuple(v.shape) for p, v in tree_leaves(
        jax.tree.map(lambda b: np.zeros(b.shape, np.int8),
                     split_boxed(boxed)[0]))}
    assert {k.replace(".", "/"): tuple(p.shape)
            for k, p in model.named_parameters()} == shapes


def test_gnn_registry_matches_jax():
    cells, skips = tbase.all_cells()
    jcells, jskips = jbase.all_cells()
    assert sorted(c for c in cells if c[0] in GNN_ARCHS) == sorted(
        c for c in jcells if c[0] in GNN_ARCHS)
    assert not [s for s in skips if s[0] in GNN_ARCHS]
    assert sorted(a for a, s in tbase.all_archs().items()
                  if s.family == "gnn") == GNN_ARCHS
    for arch in GNN_ARCHS:
        t, j = tbase.get(arch), jbase.get(arch)
        assert (t.source, t.notes, t.skips) == (j.source, j.notes, j.skips)
        assert [dataclasses.asdict(x) for x in t.shapes] == [
            dataclasses.asdict(x) for x in j.shapes]


# -------------------------------------------------------- train steps ----

def jax_cell(arch, shape, dims):
    """JAX's ``_gnn_cell`` on a one-device mesh, from the smoke config and
    a smaller shape of the same kind."""
    spec = jbase.get(arch)
    sh = next(s for s in spec.shapes if s.name == shape)
    cell = jsteps._gnn_cell(
        dataclasses.replace(spec, full_config=spec.smoke_config),
        dataclasses.replace(sh, dims={**sh.dims, **dims}),
        make_mesh((1, 1), ("data", "model")), False)
    set_activation_rules(None)  # the one-device step needs no constraints
    jc.set_edge_slabs(None)
    return cell


def run_steps(arch, shape, batches, dims):
    """JAX's cell step and the port's on the same weights and batches:
    [(jax loss, gnorm, params), ...], [(port loss, gnorm, params), ...]."""
    cell = jax_cell(arch, shape, dims)
    tcell = tsteps.gnn_cell(arch, shape, smoke=True, dims=dims)
    assert cell.model_flops == tcell.flops
    jmod = jsteps.GNN_MODULES[arch]
    jcfg = type(jbase.get(arch).smoke_config())(
        **dataclasses.asdict(tcell.cfg))
    params, _ = split_boxed(jmod.init(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.map(lambda a: a.shape, params) == jax.tree.map(
        lambda a: a.shape, cell.args[0])
    for b in batches:
        assert {k: v.shape for k, v in b.items()} == {
            k: v.shape for k, v in cell.args[2].items()}
    model = tsteps.GNN_MODULES[arch].params_from_jax(
        tcell.cfg, jax.tree.map(np.asarray, params), "cpu")
    model.requires_grad_(True)
    opt = adamw_init(tsteps.params_dict(model), tsteps.GNN_ADAMW)
    step = tsteps.make_train_step(tcell)
    jopt = jadamw_init(params, JAdamWConfig(lr=LR, weight_decay=0.0))
    jstep = jax.jit(cell.fn)
    jout, tout = [], []
    for b in batches:
        params, jopt, jl, jn = jstep(params, jopt,
                                     {k: jnp.asarray(v) for k, v in b.items()})
        jout.append((float(jl), float(jn), jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, (jopt.mu, jopt.nu))))
        _, opt, tl, tn = step(model, opt, tsteps.batch_to(b, "cpu"))
        tout.append((tl.item(), tn.item(), tc.params_to_numpy(model),
                     tuple(tc.named_tree({k: v.numpy().copy()
                                          for k, v in m.items()})
                           for m in (opt.mu, opt.nu))))
    return jout, tout


def grad_tol(arch):
    return PNA_GRAD_TOL if arch == "pna" else GRAD_TOL


def check_steps(jout, tout, what, gtol=GRAD_TOL):
    """Loss and gradient norm at TOL; the moments (the clipped gradient's
    running mean and square) at ``gtol``; parameters within 0.1 lr (an
    AdamW step moves a parameter by about lr * sign(g) early on, and by
    a ratio a rounding difference moves where g is near 0)."""
    for i, (j, t) in enumerate(zip(jout, tout)):
        close(t[0], j[0], TOL, f"{what} loss {i}")
        close(t[1], j[1], TOL, f"{what} grad norm {i}")
        for name, tm, jm in zip(("mu", "nu"), t[3], j[3]):
            trees_close(tm, jm, gtol, f"{what} step {i} {name}")
        params_after_step(t[2], j[2], LR, f"{what} step {i}")


@pytest.mark.parametrize("shape", sorted(SMALL))
@pytest.mark.parametrize("arch", ["pna", "schnet"])
def test_train_step_matches_jax_cell(arch, shape):
    cell = tsteps.gnn_cell(arch, shape, smoke=True, dims=SMALL[shape])
    jout, tout = run_steps(arch, shape, [tsteps.cell_batch(cell, 1)],
                           SMALL[shape])
    check_steps(jout, tout, f"{arch} {shape}", grad_tol(arch))


def test_sampled_pna_steps_end_to_end():
    """Two PNA train steps of the minibatch cell on subgraphs sampled from
    an ELL: JAX's ``sample_subgraph`` on its key, the port's on JAX's raw
    slots (bitwise the same subgraphs), node features from a seeded
    table, one-hot targets of ``GraphSeedStream``'s labels."""
    from repro_torch.data.pipeline import GraphSeedStream

    dims = dict(batch_nodes=8, fanout=(4, 3))
    csr = erdos_renyi(300, 6.0, seed=4)
    jg = jcsr.ell_from_csr(j_erdos_renyi(300, 6.0, seed=4))
    g = tcsr.ell_from_csr(csr)
    table = np.random.default_rng(2).standard_normal((300, 100)).astype(
        np.float32)
    stream = GraphSeedStream(n_nodes=300, batch_nodes=8, n_classes=47)
    batches = []
    for step in range(2):
        sb = stream.batch(step)
        key = jax.random.PRNGKey(10 + step)
        exp = jsampler.sample_subgraph(jg, jnp.asarray(sb["seeds"]), (4, 3),
                                       key)
        sub = tsampler.sample_subgraph(
            g, sb["seeds"], (4, 3),
            raw_slots=jax_raw_slots(key, (8, 32), (4, 3)), device="cpu")
        for name in ("nodes", "edge_src", "edge_dst"):
            bitwise(getattr(sub, name), getattr(exp, name), name)
        batches.append({
            "edge_src": sub.edge_src.numpy(),
            "edge_dst": sub.edge_dst.numpy(),
            "node_feat": table[sub.nodes.numpy()],
            "targets": np.eye(47, dtype=np.float32)[sb["labels"]]})
    jout, tout = run_steps("pna", "minibatch_lg", batches, dims)
    check_steps(jout, tout, "sampled pna", PNA_GRAD_TOL)
    assert all(np.isfinite(t[0]) and np.isfinite(t[1]) for t in tout)
