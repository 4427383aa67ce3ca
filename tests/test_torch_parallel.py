"""The port's pipeline stages and compressed gradient sums against the JAX
package, on the CPU.

- ``optim/compression``: ``compress_grads`` over 50 steps, each step's
  int8 payloads, scales and residuals bitwise those of
  ``jax.jit(compress_grads)`` (XLA's compiled function: a division by
  the constant 127 is a product with its float32 reciprocal, and the
  residual ``v - q * scale`` one fused multiply-add; JAX run op by op
  differs in both, a float32 step of the scale and a last bit of the
  residual, and is held to the error-feedback property instead);
  ``compressed_psum`` on 2 and 4 gloo ranks for three steps, each rank's
  mean gradient and residuals bitwise JAX's ``shard_map`` on 2 and 4
  fake devices (a subprocess with
  ``--xla_force_host_platform_device_count=4``); on a one-rank mesh it
  is the dequantized payload; the wire refuses a float SUM.
- ``parallel/pipeline``: ``pipeline_apply`` on a ``pipe`` axis of 4 gloo
  ranks (``tests/test_substrate.py::PIPE_SCRIPT``'s inputs, and 3
  microbatches of ``[5, 8]``, fewer than the stages) against JAX's run
  and the serial oracle within 1e-6, every rank holding the same
  result; on a one-rank mesh it is the serial application.

The rank programs are in ``test_torch_ranks.py`` (no JAX there).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import compression as jcomp

from repro_torch.core.collectives import Wire
from repro_torch.launch.mesh import Mesh, make_mesh, run_ranks
from repro_torch.optim import compression as tcomp
from repro_torch.parallel.pipeline import pipeline_apply

import test_torch_ranks as TR

ROOT = Path(__file__).resolve().parents[1]
PIPE_TOL = 1e-6

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
import test_torch_ranks as TR
from repro.compat import shard_map
from repro.launch.mesh import make_mesh
from repro.optim.compression import CompressionState, compressed_psum
from repro.parallel.pipeline import pipeline_apply

out = {}
mesh = make_mesh((TR.PIPE_STAGES,), ("pipe",))
for case in TR.PIPE_CASES:
    ws, xs = TR.pipe_inputs(case)
    got = pipeline_apply(mesh, {"W": jnp.asarray(ws)}, jnp.asarray(xs),
                         lambda p, x: jnp.tanh(x @ p["W"]))
    out[case] = np.asarray(got)
for n in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

    def body(g, r):
        one = lambda t: {k: v[0] for k, v in t.items()}
        mean, st = compressed_psum(one(g), CompressionState(one(r)), "data")
        return ({k: v[None] for k, v in mean.items()},
                {k: v[None] for k, v in st.residual.items()})

    fn = jax.jit(shard_map(body, mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data"))))
    res = {k: jnp.zeros((n, *s), jnp.float32)
           for k, s in TR.COMPRESS_SHAPES.items()}
    for step in range(TR.COMPRESS_STEPS):
        ins = [TR.compress_grads_input(r, step) for r in range(n)]
        g = {k: jnp.asarray(np.stack([i[k] for i in ins]))
             for k in TR.COMPRESS_SHAPES}
        mean, res = fn(g, res)
        for k in TR.COMPRESS_SHAPES:
            out[f"psum{n}/{step}/out/{k}"] = np.asarray(mean[k])
            out[f"psum{n}/{step}/residual/{k}"] = np.asarray(res[k])
np.savez(sys.argv[1], **out)
print("JAX_PARALLEL_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(path), str(ROOT / "tests")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {"pipe": run_ranks(TR.pipe_rank, TR.PIPE_STAGES,
                                  timeout_s=120),
                "psum2": run_ranks(TR.compress_rank, 2, timeout_s=120),
                "psum4": run_ranks(TR.compress_rank, 4, timeout_s=120)}
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as z:
        port["jax"] = dict(z)
    return port


def serial(case):
    ws, xs = TR.pipe_inputs(case)
    x = torch.from_numpy(xs)
    for w in torch.from_numpy(ws):
        x = torch.tanh(x @ w)
    return x.numpy()


@pytest.mark.parametrize("case", list(TR.PIPE_CASES))
def test_pipeline_apply_on_four_ranks_matches_jax_and_serial(runs, case):
    ranks = runs["pipe"]
    got = ranks[0][case]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case], got)
    want = runs["jax"][case]
    assert got.shape == want.shape == TR.pipe_inputs(case)[1].shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PIPE_TOL)
    np.testing.assert_allclose(got, serial(case), rtol=0, atol=PIPE_TOL)
    # S + M - 1 shifts a case, then the masked psum's gather
    m = TR.PIPE_CASES[case][1]
    assert ranks[0]["shifts"] >= TR.PIPE_STAGES + m - 1


def test_pipeline_apply_on_one_rank_is_serial():
    mesh = make_mesh((1,), ("pipe",), "cpu")
    ws, xs = TR.pipe_inputs("pipe")
    w = torch.from_numpy(ws[:1])
    got = pipeline_apply(mesh, {"W": w}, torch.from_numpy(xs),
                         lambda p, x: torch.tanh(x @ p["W"]))
    want = [torch.tanh(torch.from_numpy(x) @ w[0]) for x in xs]
    np.testing.assert_array_equal(got.numpy(), torch.stack(want).numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_on_ranks_matches_jax_shard_map(runs, world):
    ranks = runs[f"psum{world}"]
    j = runs["jax"]
    for step in range(TR.COMPRESS_STEPS):
        for k in TR.COMPRESS_SHAPES:
            for r, rank in enumerate(ranks):
                for leaf in ("out", "residual"):
                    key = f"{step}/{leaf}/{k}"
                    np.testing.assert_array_equal(
                        rank[key], j[f"psum{world}/{key}"][r],
                        err_msg=f"rank {r} {key}")
    # the all-zero leaf stays zero; a step moves int32 payloads, as many
    # bytes as float32 gradients
    assert not ranks[0]["0/out/z"].any()
    n = sum(int(np.prod(s)) for s in TR.COMPRESS_SHAPES.values())
    assert ranks[0]["wire_bytes"] >= TR.COMPRESS_STEPS * 4 * n


def test_compress_grads_fifty_steps_bitwise_jax():
    rng = np.random.default_rng(0)
    shapes = {"w": (1000,), "m": (7, 9)}
    jstate = jcomp.compression_init({k: jnp.zeros(s)
                                     for k, s in shapes.items()})
    tstate = tcomp.compression_init({k: torch.zeros(s)
                                     for k, s in shapes.items()})
    step_fn = jax.jit(jcomp.compress_grads)
    for step in range(50):
        g = {k: (rng.standard_normal(s) * (1 + step % 3)).astype(np.float32)
             for k, s in shapes.items()}
        jq, js, jstate = step_fn({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate)
        tq, ts, tstate = tcomp.compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in shapes:
            assert tq[k].dtype == torch.int8 and ts[k].dtype == torch.float32
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(tstate.residual[k].numpy(),
                                          np.asarray(jstate.residual[k]))
            np.testing.assert_array_equal(
                tcomp.decompress_grads(tq, ts)[k].numpy(),
                np.asarray(jcomp.decompress_grads(jq, js)[k]))


def test_compress_grads_error_feedback_and_eager_jax():
    """The error-feedback property of ``tests/test_substrate.py`` on the
    port; against JAX run op by op each step's scale within one float32
    step and the residuals within a last bit of the gradient."""
    rng = np.random.default_rng(0)
    g0 = rng.standard_normal(1000).astype(np.float32)
    tstate = tcomp.compression_init({"w": torch.from_numpy(g0)})
    acc_true = np.zeros(1000)
    acc_deq = np.zeros(1000)
    for _ in range(50):
        g = rng.standard_normal(1000).astype(np.float32)
        jstate = jcomp.CompressionState(
            residual={"w": jnp.asarray(tstate.residual["w"].numpy())})
        jq, js, jstate = jcomp.compress_grads({"w": jnp.asarray(g)}, jstate)
        tq, ts, tstate = tcomp.compress_grads({"w": torch.from_numpy(g)},
                                              tstate)
        assert abs(float(ts["w"]) - float(js["w"])) <= float(
            np.spacing(np.float32(js["w"])))
        if float(ts["w"]) == float(js["w"]):
            np.testing.assert_array_equal(tq["w"].numpy(),
                                          np.asarray(jq["w"]))
            v = np.abs(g) + 1.0
            assert (np.abs(tstate.residual["w"].numpy()
                           - np.asarray(jstate.residual["w"]))
                    <= np.spacing(v.astype(np.float32))).all()
        acc_true += g
        acc_deq += tcomp.decompress_grads(tq, ts)["w"].numpy()
    drift = np.abs(acc_true - acc_deq).max()
    res = np.abs(tstate.residual["w"].numpy()).max()
    np.testing.assert_allclose(drift, res, rtol=1e-3, atol=1e-4)
    assert drift < 0.2


def test_compressed_psum_on_one_rank_is_the_dequantized_payload():
    mesh = make_mesh((1,), ("data",), "cpu")
    g = {k: torch.from_numpy(v)
         for k, v in TR.compress_grads_input(0, 0).items()}
    state = tcomp.compression_init(g)
    mean, new = tcomp.compressed_psum(g, state, mesh.axes("data"))
    q, s, ref = tcomp.compress_grads(g, state)
    deq = tcomp.decompress_grads(q, s)
    for k in g:
        np.testing.assert_array_equal(mean[k].numpy(), deq[k].numpy())
        np.testing.assert_array_equal(new.residual[k].numpy(),
                                      ref.residual[k].numpy())


def test_wire_refuses_a_float_sum():
    wire = Wire(Mesh((1,), ("data",), "cpu", backend="gloo"))
    with pytest.raises(ValueError, match="psum"):
        wire.all_reduce(torch.ones(3), "data", dist.ReduceOp.SUM)
