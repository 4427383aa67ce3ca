"""The port's irreps machinery, MACE and EquiformerV2 against the JAX
package, on the CPU.

- ``models/gnn/irreps`` host tables: ``_factorial_ratio``, ``_jy_eig``,
  ``_complex_to_real`` and ``_dy_real_parts`` bitwise (the same numpy
  code). ``gaunt_tensor``/``gaunt_full`` integrate SH values that JAX
  evaluates through XLA in float32 and the port through PyTorch in
  float32: within 1e-7 of the table's largest entry (``GAUNT_ATOL``).
- ``sph_harm_real``, ``align_matrices`` and ``rotate_irreps`` at ``TOL``
  (float32 ``sin``/``cos``/``atan2``/``exp`` are XLA's on one side and
  PyTorch's on the other); on the port alone: the alignment property
  ``blockdiag(W(n)) @ Y(n) == Y(z)``, orthogonality of every block, and
  a rotation of irreps undone by its inverse, each within 1e-5.
- MACE and EquiformerV2 (smoke configs, with and without node features):
  ``node_out`` and ``graph_out`` at ``TOL``, every gradient leaf at
  ``GRAD_TOL``; ``graph_out`` invariant under a random rotation of the
  positions (2e-3, JAX's own bound in ``test_gnn_smoke.py``) and MACE's
  under a translation (1e-4).
- The train step of ``launch/steps.py`` for both archs on each shape
  kind against JAX's ``_gnn_cell`` step (as in ``test_torch_gnn.py``).
  EquiformerV2 on a fanout tree: the tree's leaves have no in-edge, so
  their l >= 1 features stay 0 and ``_eq_layernorm``'s ``sqrt`` at 0
  makes the gradient NaN in JAX; the port computes the same function and
  its gradient is NaN too. That case holds the loss and the NaN norm.

Tolerances as in ``test_torch_gnn.py``: ``TOL`` 1e-5 relative plus 1e-5
of the tensor's largest magnitude, ``GRAD_TOL`` 1e-4 plus 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import irreps as ji

from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn import irreps as ti

from test_torch_gnn import (
    GRAD_TOL,
    SMALL,
    TOL,
    bitwise,
    carried,
    check_steps,
    close,
    flat_layout,  # noqa: F401  (autouse fixture)
    forward_and_grads,
    run_steps,
    toy_batch,
    trees_close,
)

GAUNT_ATOL = 1e-7


def unit_vectors(n=500, seed=0):
    v = np.random.default_rng(seed).standard_normal((n, 3))
    v[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1e-4, 1]]  # poles
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("l", range(7))
def test_host_tables_bitwise(l):
    for a in range(l + 1):
        assert ti._factorial_ratio(l - a, l + a) == ji._factorial_ratio(
            l - a, l + a)
    for name in ("_jy_eig", "_dy_real_parts"):
        for got, exp in zip(getattr(ti, name)(l), getattr(ji, name)(l)):
            bitwise(got, exp, name)
    bitwise(ti._complex_to_real(l), ji._complex_to_real(l))


@pytest.mark.parametrize("l_max", [2, 3])
def test_gaunt_tables(l_max):
    exp, got = ji.gaunt_full(l_max), ti.gaunt_full(l_max)
    assert got.shape == exp.shape and got.dtype == exp.dtype
    assert np.abs(got - exp).max() <= GAUNT_ATOL * np.abs(exp).max()
    # the selection rules leave the same blocks zero
    assert ((got == 0) == (exp == 0)).all()


def test_sph_harm_align_and_rotate_match_jax():
    v = unit_vectors()
    close(ti.sph_harm_real(6, torch.from_numpy(v)),
          ji.sph_harm_real(6, jnp.asarray(v)), TOL, "sh")
    got = ti.align_matrices(6, torch.from_numpy(v))
    exp = ji.align_matrices(6, jnp.asarray(v))
    for l, (g, e) in enumerate(zip(got, exp)):
        close(g, e, TOL, f"W_{l}")
    f = np.random.default_rng(1).standard_normal((500, 49, 4)).astype(
        np.float32)
    for inverse in (False, True):
        close(ti.rotate_irreps(got, torch.from_numpy(f), 6, inverse),
              ji.rotate_irreps(exp, jnp.asarray(f), 6, inverse), TOL,
              f"rotate inverse={inverse}")


def test_alignment_property_and_orthogonality():
    # not [0, 1e-4, 1]: in float32 sph_harm_real reads its z as 1 (JAX's
    # table misses the property there by 4.7e-4 too)
    v = torch.from_numpy(unit_vectors(seed=2)[[0, 1, 2, *range(4, 500)]])
    mats = ti.align_matrices(6, v)
    y = ti.sph_harm_real(6, v)[..., None]
    z = ti.sph_harm_real(6, torch.tensor([[0.0, 0.0, 1.0]]))[..., None]
    torch.testing.assert_close(ti.rotate_irreps(mats, y, 6),
                               z.expand_as(y), rtol=0, atol=1e-5)
    for l, w in enumerate(mats):
        eye = torch.eye(2 * l + 1).expand_as(w)
        torch.testing.assert_close(w @ w.transpose(-1, -2), eye, rtol=0,
                                   atol=1e-5)
    f = torch.randn(v.shape[0], 49, 3,
                    generator=torch.Generator().manual_seed(0))
    back = ti.rotate_irreps(mats, ti.rotate_irreps(mats, f, 6), 6, True)
    torch.testing.assert_close(back, f, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,change", [
    ("mace", {"d_feat": 16}), ("mace", {}), ("equiformer-v2", {"d_feat": 16}),
    ("equiformer-v2", {})])
def test_equivariant_forward_and_gradients(arch, change):
    exp, got, jl, tl, jg, tg = forward_and_grads(
        arch, change, toy_batch(graphs=2), n_graphs=2)
    for key in ("node_out", "graph_out"):
        close(got[key].detach(), exp[key], TOL, key)
    close(tl, jl, TOL, "loss")
    trees_close(tg, jax.tree.map(np.asarray, jg), GRAD_TOL, "gradient")


def random_rotation(seed=5):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


@pytest.mark.parametrize("arch", ["schnet", "mace", "equiformer-v2"])
def test_port_rotation_invariance(arch):
    *_, model = carried(arch, {"d_feat": 16})
    b = {k: torch.from_numpy(v) for k, v in toy_batch(graphs=2).items()}
    b["n_graphs"] = 2
    with torch.no_grad():
        out1 = model(b)["graph_out"]
        b["positions"] = b["positions"] @ torch.from_numpy(random_rotation().T)
        out2 = model(b)["graph_out"]
    torch.testing.assert_close(out2, out1, rtol=2e-3, atol=2e-3)


def test_port_translation_invariance():
    *_, model = carried("mace", {"d_feat": 16})
    b = {k: torch.from_numpy(v) for k, v in toy_batch().items()}
    with torch.no_grad():
        out1 = model(b)["node_out"]
        b["positions"] = b["positions"] + torch.tensor([10.0, -3.0, 7.0])
        out2 = model(b)["node_out"]
    torch.testing.assert_close(out2, out1, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", sorted(SMALL))
@pytest.mark.parametrize("arch", ["mace", "equiformer-v2"])
def test_train_step_matches_jax_cell(arch, shape):
    cell = tsteps.gnn_cell(arch, shape, smoke=True, dims=SMALL[shape])
    jout, tout = run_steps(arch, shape, [tsteps.cell_batch(cell, 1)],
                           SMALL[shape])
    if arch == "equiformer-v2" and shape == "minibatch_lg":
        (jl, jn, *_), (tl, tn, *_) = jout[0], tout[0]
        close(tl, jl, TOL, "loss")
        assert np.isnan(jn) and np.isnan(tn)
        return
    check_steps(jout, tout, f"{arch} {shape}")
