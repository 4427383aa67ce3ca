"""Elastic checkpoints of a mesh's train state (``checkpoint.py``'s
``save``/``restore`` with ``shardings=``, ``launch/steps.py``'s
``train_state``/``state_shardings``, ``TrainGuard(shardings=)``) against
JAX's own checkpoint module and the port's one-rank save.

One world of four gloo CPU ranks (``test_torch_ranks.ckpt_mesh_rank``)
holds three meshes over ``("data", "model")``: ``(2, 2)``, ``(1, 4)``
and ``(4, 1)``. The float32 smoke configs of ``minicpm-2b`` (global
batch 4) and ``olmoe-1b-7b`` (16: its ``n_micro`` of 4 over data 2 or
4) train from JAX's state after one AdamW update with seeded gradients,
at ``test_torch_lm_mesh_train.py``'s cross-entropy chunk; DCN-v2 trains
``train_batch`` (batch 64) from JAX's smoke weights.

- save: the mesh's checkpoint after step 1 equals, manifest and every
  array bit for bit, the port's one-rank save of the gathered state,
  and JAX's ``CheckpointManager.restore`` reads it back bitwise, with
  global shapes and the keys of JAX's own save of the same state;
- a checkpoint JAX's manager wrote restores onto each mesh and one rank:
  every block bitwise ``block_of`` JAX's array under its spec;
- resize: the step-1 checkpoint restored on ``(4, 1)`` and on one rank
  (bitwise the saved state), then step 2 there, against ``(2, 2)``'s
  uninterrupted step 2 at ``test_torch_lm_mesh_train.py``'s tolerances;
- crash-resume: ``TrainGuard`` on ``(2, 2)`` with a save every step and
  a failure after the update of step 2 on every rank ends bitwise equal
  to the uninterrupted run;
- DCN-v2's state (its table's rows over ``model``) saved on ``(2, 2)``
  restores bitwise on ``(4, 1)``;
- a spec that does not divide, a block of the wrong shape or dtype, a
  sharded group dim, an unknown axis and a missing leaf raise;
- ``nn.module.reshard_block`` and ``gather_block_to_root`` (the save's
  gather) move an (8, 12) tensor between three layouts on the three
  meshes, bitwise.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.dcn_v2 import smoke_config as j_dcn_config
from repro.models import dcn_v2 as jdcn
from repro.models import transformer as jtfm
from repro.nn.module import split_boxed
from repro.optim import adamw as jadam
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models import transformer as ttfm
from repro_torch.models.gnn.common import named_tree
from repro_torch.nn.module import block_slices, set_activation_rules
from repro_torch.optim.adamw import AdamWState

import test_torch_ranks as TR
from test_torch_lm_mesh_train import LR, check_run, jax_config

LM = [arch for arch, _, _ in TR.CKPT_LM]
CASES = LM + ["dcn-v2"]
DIMS = {arch: (b, seq) for arch, b, seq in TR.CKPT_LM}
#: the rank group took 28 s alone on one thread a rank: about 3.5x that
RANKS_TIMEOUT_S = 100


@pytest.fixture(autouse=True)
def no_rules():
    yield
    set_activation_rules(None)


def jax_lm_state(arch):
    """JAX's float32 smoke train state after one AdamW update with
    seeded gradients (eager)."""
    params, _ = split_boxed(jtfm.init(jax.random.PRNGKey(0),
                                      jax_config(arch, "float32")))
    ocfg = jadam.AdamWConfig(lr=LR)
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), p.dtype), params)
    params, opt, _ = jadam.adamw_update(
        grads, jadam.adamw_init(params, ocfg), params, ocfg)
    return {"params": params, "opt": opt}


def jax_dcn_state():
    """JAX's DCN-v2 smoke weights and fresh AdamW state."""
    params, _ = split_boxed(jdcn.init(jax.random.PRNGKey(0),
                                      j_dcn_config())[0])
    return {"params": params,
            "opt": jadam.adamw_init(params, jadam.AdamWConfig(lr=1e-3))}


def as_numpy(state):
    """A JAX train state as numpy, ``opt`` a plain (step, mu, nu) tuple
    (a rank unpickles no JAX class)."""
    o = state["opt"]
    return {"params": jax.tree.map(np.asarray, state["params"]),
            "opt": (np.asarray(o.step), jax.tree.map(np.asarray, o.mu),
                    jax.tree.map(np.asarray, o.nu))}


@pytest.fixture(scope="module")
def jax_states():
    out = {arch: jax_lm_state(arch) for arch in LM}
    out["dcn-v2"] = jax_dcn_state()
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory, jax_states):
    """JAX's saves of its states under ``jax/<case>`` (step 5) and the
    error cases' small checkpoint under ``small``."""
    d = tmp_path_factory.mktemp("elastic")
    for case, state in jax_states.items():
        jckpt.CheckpointManager(str(d / "jax" / case)).save(
            5, state, blocking=True)
    small = TR.ckpt_small_arrays()
    tckpt.CheckpointManager(str(d / "small")).save(0, {
        "x": torch.from_numpy(small["x"]),
        "s": tckpt.Stacked(torch.from_numpy(r) for r in small["s"])},
        blocking=True)
    return d


@pytest.fixture(scope="module")
def ranks(jax_states, root):
    trees = {arch: as_numpy(jax_states[arch]) for arch in LM}
    trees["dcn-v2"] = jax.tree.map(np.asarray, jax_states["dcn-v2"]["params"])
    return run_ranks(TR.ckpt_mesh_rank, 4, (trees, str(root)),
                     timeout_s=RANKS_TIMEOUT_S)


def port_cfg(arch):
    return TR.lm_train_cell(make_mesh((1, 1), ("data", "model"), "cpu"),
                            arch, *DIMS[arch], "float32").config


def files(step_dir: Path):
    """(manifest leaves, {key: stored array}) of a checkpoint."""
    leaves = json.loads((step_dir / "manifest.json").read_text())["leaves"]
    with np.load(step_dir / "shards.npz") as z:
        return leaves, {k: z[v["file"]] for k, v in leaves.items()}


def bitwise(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


def saved_state(ranks, case):
    """(gathered state after step 1 by part and port name, step count)
    as rank 0 saw it."""
    rec = ranks[0][case]
    if case == "dcn-v2":
        return rec["saved"], rec["saved_opt_step"]
    return rec["run"]["states"][0], rec["run"]["saved_opt_step"]


def one_rank_tree(case, state: dict, opt_step: int) -> dict:
    """The port's train-state tree of a gathered state, for a plain
    save."""
    def tree(named):
        named = {k: torch.from_numpy(v) for k, v in named.items()}
        if case == "dcn-v2":
            return named_tree(named)
        return ttfm.named_tree(port_cfg(case), named)

    return {"params": tree(state["params"]),
            "opt": AdamWState(torch.tensor(opt_step, dtype=torch.int32),
                              tree(state["mu"]), tree(state["nu"]))}


def jax_by_name(case, state) -> dict:
    """A JAX train state as ``{"params", "mu", "nu"}`` by the port's
    names."""
    tree = as_numpy(state)
    if case != "dcn-v2":
        return TR.lm_by_name(port_cfg(case), tree)

    def flat(t, prefix=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(flat(v, f"{prefix}{k}."))
            return out
        return {prefix[:-1]: np.asarray(t)}

    _, mu, nu = tree["opt"]
    return {"params": flat(tree["params"]), "mu": flat(mu), "nu": flat(nu)}


@pytest.mark.parametrize("case", CASES)
def test_mesh_save_equals_the_one_rank_save(ranks, root, case):
    state, opt_step = saved_state(ranks, case)
    mesh_dir = root / "mesh" / case / "step_1"
    tckpt.CheckpointManager(str(root / "one" / case)).save(
        1, one_rank_tree(case, state, opt_step), blocking=True)
    got_leaves, got = files(mesh_dir)
    want_leaves, want = files(root / "one" / case / "step_1")
    assert got_leaves == want_leaves
    for key, arr in want.items():
        assert bitwise(got[key], arr), key
    # rank 0 alone wrote: one published step, no leftover
    assert sorted(p.name for p in (root / "mesh" / case).iterdir()) == [
        "step_1"]


@pytest.mark.parametrize("case", CASES)
def test_jax_reads_the_mesh_save(ranks, root, jax_states, case):
    state, opt_step = saved_state(ranks, case)
    back, step = jckpt.CheckpointManager(str(root / "mesh" / case)).restore(
        jax_states[case])
    assert step == 1 and int(back["opt"].step) == opt_step
    got = jax_by_name(case, back)
    for part, leaves in state.items():
        for name, arr in leaves.items():
            assert bitwise(got[part][name], arr), (part, name)
    # global shapes under JAX's keys: its own save's manifest
    mesh_leaves, _ = files(root / "mesh" / case / "step_1")
    jax_leaves, _ = files(root / "jax" / case / "step_5")
    assert {k: (v["shape"], v["dtype"]) for k, v in mesh_leaves.items()} == {
        k: (v["shape"], v["dtype"]) for k, v in jax_leaves.items()}


def one_rank_restore(root, kind, arch):
    """A seed-1 one-rank cell's state restored from ``root/kind/arch``
    with (1, 1) shardings: (cell, model, opt, step)."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    cell = TR.lm_train_cell(mesh, arch, *DIMS[arch], "float32")
    model, opt = TR._lm_state(cell, mesh)
    _, step = tckpt.CheckpointManager(str(root / kind / arch)).restore(
        steps.train_state(model, opt),
        shardings=steps.state_shardings(model, mesh))
    return cell, mesh, model, opt, step


@pytest.mark.parametrize("arch", LM)
@pytest.mark.parametrize("shape", TR.CKPT_MESHES + ((1, 1),))
def test_jax_checkpoint_restores_on_each_mesh(ranks, root, jax_states, arch,
                                              shape):
    want_step = int(jax_states[arch]["opt"].step)
    if shape == (1, 1):
        _, mesh, model, opt, step = one_rank_restore(root, "jax", arch)
        recs = [{"step": step, "opt_step": int(opt.step),
                 "mismatches": TR._mismatches(
                     model, opt, jax_by_name(arch, jax_states[arch]), mesh)}]
    else:
        recs = [r[arch]["jax", shape] for r in ranks]
    for r, rec in enumerate(recs):
        assert rec["step"] == 5 and rec["opt_step"] == want_step, (r, rec)
        assert rec["mismatches"] == [], (shape, r, rec["mismatches"][:5])


@pytest.mark.parametrize("arch", LM)
@pytest.mark.parametrize("shape", [(4, 1), (1, 1)])
def test_resized_restart_matches_the_uninterrupted_step(ranks, root, arch,
                                                        shape):
    run = ranks[0][arch]["run"]
    want = [(l, g, s) for (l, g), s in zip(run["steps"][:2],
                                           run["states"][:2])]
    if shape == (1, 1):
        cell, _, model, opt, step = one_rank_restore(root, "mesh", arch)
        restored = TR._state_copy(model, opt, make_mesh(
            (1, 1), ("data", "model"), "cpu"))
        batch = {k: torch.from_numpy(v) for k, v in TR.lm_train_batch(
            cell.config.vocab, *DIMS[arch]).items()}
        _, opt, loss, gnorm = cell.fn(model, opt, batch)
        recs = [{"step": step, "restored": restored,
                 "next": (float(loss), float(gnorm)),
                 "state": TR._state_copy(model, opt, make_mesh(
                     (1, 1), ("data", "model"), "cpu"))}]
    else:
        recs = [r[arch]["resize"] for r in ranks]
    for r, rec in enumerate(recs):
        assert rec["step"] == 1
        for part, leaves in run["states"][0].items():
            for name, arr in leaves.items():
                assert bitwise(rec["restored"][part][name], arr), (
                    shape, r, part, name)
        check_run({"steps": [run["steps"][0], rec["next"]],
                   "states": [rec["restored"], rec["state"]]}, want,
                  f"{shape} {arch} rank {r}")


@pytest.mark.parametrize("arch", LM)
def test_crash_resume_on_a_mesh_is_bitwise(ranks, arch):
    for r, rep in enumerate(ranks):
        run, guard = rep[arch]["run"], rep[arch]["guard"]
        assert guard["failed"] == [TR.CKPT_FAIL_AT]
        assert guard["end"] == TR.CKPT_STEPS
        assert guard["saved"] == list(range(1, TR.CKPT_STEPS + 1))
        assert guard["opt_step"] == run["opt_step"]
        for part, leaves in run["states"][-1].items():
            for name, arr in leaves.items():
                assert bitwise(guard["state"][part][name], arr), (
                    r, part, name)


def test_dcn_state_restores_on_another_mesh(ranks):
    saved, opt_step = saved_state(ranks, "dcn-v2")
    for r, rep in enumerate(ranks):
        rec = rep["dcn-v2"]
        assert rec["step"] == 1 and rec["opt_step"] == opt_step == 1
        assert rec["mismatches"] == [], (r, rec["mismatches"])
        for part, leaves in rec["saved"].items():  # every rank gathered
            for name, arr in leaves.items():
                assert bitwise(arr, saved[part][name])
    # the table's rows were split over model on (2, 2), whole on (4, 1)
    table = saved["params"]["embed.table"]
    assert table.shape[0] % 2 == 0 and np.isfinite(table).all()


def test_elastic_restore_refuses_what_does_not_fit(ranks):
    small = TR.ckpt_small_arrays()
    shape22 = {"data": 2, "model": 2}
    for r, rep in enumerate(ranks):
        e = rep["errors"]
        coords = e["coords"]
        x = small["x"][block_slices(small["x"].shape, ("data", "model"),
                                    shape22, coords)]
        assert bitwise(e["x"], x), r
        cols = block_slices(small["s"].shape[1:], ("model",), shape22,
                            coords)
        for g, got in enumerate(e["s"]):
            assert bitwise(got, small["s"][g][cols]), (r, g)
        assert "does not split" in e["non_dividing"]
        assert ("checkpoint holds torch.float32 (4, 3), the tree "
                "torch.float32 (4, 2)") in e["wrong_shape"]
        assert "the tree torch.float64" in e["wrong_dtype"]
        assert "group dim" in e["group_dim"]
        assert "lacks" in e["unknown_axis"]
        assert "differ at" in e["missing_leaf"]


def test_blocks_move_between_meshes_point_to_point(ranks):
    """``reshard_block`` between every two layouts of ``RESHARD_SPECS``
    on the three meshes (the same mesh included), and
    ``gather_block_to_root`` from each: every rank's result bitwise."""
    n = len(TR.CKPT_MESHES) * len(TR.RESHARD_SPECS)
    for r, rep in enumerate(ranks):
        assert len(rep["reshard"]) == n * (n + 1)
        bad = [case for case, ok in rep["reshard"].items() if not ok]
        assert bad == [], (r, bad[:5])


def test_one_rank_save_with_shardings_is_the_plain_save(tmp_path):
    """On a (1, 1) mesh (no process group) ``save(shardings=)`` writes the
    plain save's files and ``restore(shardings=)`` reads them back."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    cell = TR.lm_train_cell(mesh, "minicpm-2b", 4, 16, "float32")
    model, opt = TR._lm_state(cell, mesh)
    sh = steps.state_shardings(model, mesh)
    tckpt.CheckpointManager(str(tmp_path / "a")).save(
        3, steps.train_state(model, opt), blocking=True, shardings=sh)
    tckpt.CheckpointManager(str(tmp_path / "b")).save(
        3, steps.train_state(model, opt), blocking=True)
    (la, a), (lb, b) = (files(tmp_path / d / "step_3") for d in "ab")
    assert la == lb and all(bitwise(a[k], b[k]) for k in b)
    # the shardings tree is the state's: Stacked block leaves get the
    # group dim first, the step is replicated
    params = sh["params"]
    assert sh["opt"].step.spec == () and sh["opt"].mu is params
    assert params["blocks"]["layer_0"]["attn"]["wq"]["kernel"].spec[0] is None
    before = TR._state_copy(model, opt, mesh)
    with torch.no_grad():
        for t in [*model.parameters(), *opt.mu.values(), *opt.nu.values()]:
            t.zero_()
    tckpt.CheckpointManager(str(tmp_path / "a")).restore(
        steps.train_state(model, opt), shardings=sh)
    after = TR._state_copy(model, opt, mesh)
    for part, leaves in before.items():
        for name, arr in leaves.items():
            assert bitwise(after[part][name], arr), (part, name)


@pytest.mark.parametrize("fault", ["flipped_bit", "compressed"])
def test_restore_checks_each_stored_member(tmp_path, fault):
    """``restore`` maps each npz member and checks its CRC-32 (as
    ``np.load`` through ``zipfile`` does): a flipped bit raises, and so
    does a member ``np.savez`` would not have written (compressed)."""
    x = torch.arange(4096, dtype=torch.float32)
    tckpt.CheckpointManager(str(tmp_path)).save(1, {"x": x}, blocking=True)
    path = tmp_path / "step_1" / "shards.npz"
    if fault == "flipped_bit":
        data = bytearray(path.read_bytes())
        at = data.index(x.numpy()[1000:1002].tobytes())
        data[at] ^= 1
        path.write_bytes(bytes(data))
        match = "CRC-32"
    else:
        np.savez_compressed(path, a0=x.numpy())
        match = "compressed"
    with pytest.raises(ValueError, match=match):
        tckpt.CheckpointManager(str(tmp_path)).restore(
            {"x": torch.zeros(4096)})
