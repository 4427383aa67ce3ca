"""The port's collectives (``repro_torch.core.collectives``) on a mesh of
ranks.

- ``_pack_bits`` / ``_unpack_bits`` give JAX's uint32 words bit for bit
  (in process).
- Four spawned gloo ranks on a ``(2, 2)`` mesh run every collective of
  the module; each rank's result is held against a numpy fold of the
  inputs every rank fed (``test_torch_ranks.collective_inputs``): the OR
  unions in all three flavors, the uint32 ring over one axis, ring and
  allgather reduce-scatters with ``|``, ``min`` and ``+``, the sharded
  merges, the gang merges, ``gang_handoff`` and ``gang_scatter_back``.
  Integer, OR and MIN results are exact; float sums are bitwise equal to
  the fold in the order the flavor promises (coordinate order for the
  gather flavors and the replicated sum, ring order for the ring).

The rank group joins under a timeout: a hang fails in about two minutes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import collectives as JC
from repro_torch.core import collectives as C
from repro_torch.launch.mesh import run_ranks

import test_torch_ranks as TR

WORLD = 4
COORDS = [(r // 2, r % 2) for r in range(WORLD)]  # (data, model)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1000])
def test_pack_bits_match_jax(n):
    rng = np.random.default_rng(n)
    x = rng.random((3, n)) < 0.4
    got = C._pack_bits(torch.from_numpy(x)).numpy().view(np.uint32)
    want = np.asarray(JC._pack_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    back = C._unpack_bits(torch.from_numpy(got.view(np.int32)), n).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(JC._unpack_bits(jnp.asarray(want), n)))


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(TR.collectives_rank, WORLD, timeout_s=120)


INPUTS = [TR.collective_inputs(r) for r in range(WORLD)]


def line(rank, axis):
    """Ranks of ``rank``'s line along ``axis``, by coordinate."""
    d, m = COORDS[rank]
    return ([a * 2 + m for a in range(2)] if axis == "data"
            else [d * 2 + b for b in range(2)])


def fold(vals, op):
    acc = vals[0]
    for v in vals[1:]:
        acc = op(acc, v)
    return acc


def ring_fold(vals, c, op):
    """Chunk ``c`` of a ring reduce-scatter: coordinate c first, then
    c+1, c+2, ... (each step adds the next rank's chunk)."""
    k = len(vals)
    acc = vals[c]
    for j in range(1, k):
        acc = op(acc, vals[(c + j) % k])
    return acc


OPS = {"or": np.bitwise_or, "min": np.minimum, "sum": np.add}


def expected(name, rank):
    x = INPUTS
    d, m = COORDS[rank]
    flat = 2 * d + m  # flat index over (data, model)
    if name.startswith("or_allreduce_both"):
        return fold([x[r]["bits"] for r in range(WORLD)], np.logical_or)
    if name.startswith("or_allreduce_model"):
        return fold([x[r]["bits"] for r in line(rank, "model")],
                    np.logical_or)
    if name == "ring_or_u32_model":
        return fold([x[r]["words"] for r in line(rank, "model")],
                    np.bitwise_or)
    if name.startswith("rs_"):
        _, flavor, op = name.split("_")
        key = "rs_f32" if op == "sum" else "rs_int"
        chunks = [x[r][key].reshape(2, -1) for r in line(rank, "model")]
        if flavor == "ring":
            return ring_fold([c[m] for c in chunks], m, OPS[op])
        return fold([c[m] for c in chunks], OPS[op])
    rows = TR.N_ROWS * 2 // WORLD
    block = slice(flat * rows, (flat + 1) * rows)
    if name.startswith(("or_rs", "merge_scatter")) and name.endswith(
            ("ring", "allgather", "_or")):
        return fold([x[r]["rows_bits"] for r in range(WORLD)],
                    np.logical_or)[block]
    if name.startswith(("min_rs", "merge_scatter")):
        return fold([x[r]["rows_min"] for r in range(WORLD)],
                    np.minimum)[block]
    if name.startswith("sum_rs"):
        flavor = name.split("_")[-1]
        return _two_axis_sum([x[r]["rows_f32"] for r in range(WORLD)],
                             flavor)[block]
    if name == "gang_merge_or":
        return fold([x[r]["gang_bits"] for r in range(WORLD)],
                    np.logical_or)[:, block]
    if name == "gang_merge_min":
        return fold([x[r]["gang_min"] for r in range(WORLD)],
                    np.minimum)[:, block]
    if name == "gang_merge_sum":
        full = _two_axis_sum(
            [x[r]["gang_f32"].T.reshape(-1) for r in range(WORLD)], "ring")
        return full.reshape(-1, TR.GANG).T[:, block]
    if name.startswith("handoff_"):
        leaf = TR.handoff_state()[0 if name.endswith("frontier") else 1]
        sub = np.zeros((TR.GANG,) + leaf.shape[1:], leaf.dtype)
        sub[: len(TR.HANDOFF_IDX)] = leaf[TR.HANDOFF_IDX]
        return sub[:, block]
    if name == "scatter_back_levels":
        return TR.handoff_state()[1]
    if name == "merge_sum":
        # per axis, major first, a strict fold in coordinate order
        s = [fold([x[2 * a + b]["sum_f32"] for a in range(2)], np.add)
             for b in range(2)]
        return fold(s, np.add)
    if name == "merge_min":
        return fold([x[r]["min_f32"] for r in range(WORLD)], np.minimum)
    if name == "any_over":
        return np.asarray(True)
    if name == "any_over_model":
        return np.asarray(any(x[r]["flag"] for r in line(rank, "model")))
    if name == "gather_rows":
        return np.repeat(np.arange(WORLD, dtype=np.int32), 2)[:, None] \
            .repeat(3, axis=1)
    raise KeyError(name)


def _two_axis_sum(vals, flavor):
    """A sum reduce-scatter over ('data', 'model'), data first: the fold
    order of each flavor, chunk by chunk, as full arrays (each rank then
    owns its block)."""
    n = vals[0].shape[0]
    out = np.empty(n, np.float32)
    for r in range(WORLD):
        d, m = COORDS[r]
        # step 1 over 'data': this rank's half of the model-line partial
        half = slice(d * n // 2, (d + 1) * n // 2)
        parts = [vals[2 * a + m][half] for a in range(2)]
        p = ring_fold(parts, d, np.add) if flavor == "ring" else fold(
            parts, np.add)
        # step 2 over 'model': partials of the other model coordinate
        other = []
        for b in range(2):
            pp = [vals[2 * a + b][half] for a in range(2)]
            other.append(ring_fold(pp, d, np.add) if flavor == "ring"
                         else fold(pp, np.add))
        q = n // 4
        chunks = [o[m * q : (m + 1) * q] for o in other]
        blk = slice(half.start + m * q, half.start + (m + 1) * q)
        out[blk] = (ring_fold(chunks, m, np.add) if flavor == "ring"
                    else fold(chunks, np.add))
        del p
    return out


NAMES = (
    [f"or_allreduce_{ax}_{impl}" for ax in ("both", "model")
     for impl in ("pmax", "allgather", "ring")]
    + ["ring_or_u32_model"]
    + [f"rs_{fl}_{op}" for fl in ("ring", "allgather")
       for op in ("or", "min", "sum")]
    + [f"{k}_rs_{impl}" for k in ("or", "min", "sum")
       for impl in ("ring", "allgather")]
    + [f"merge_scatter_{impl}_{k}" for impl in ("ring", "allgather")
       for k in ("or", "min")]
    + ["gang_merge_or", "gang_merge_min", "gang_merge_sum",
       "handoff_frontier", "handoff_levels", "scatter_back_levels",
       "merge_sum", "merge_min", "any_over", "any_over_model",
       "gather_rows"]
)


@pytest.mark.parametrize("name", NAMES)
def test_collective_matches_numpy_fold(ranks, name):
    for rank in range(WORLD):
        got = np.asarray(ranks[rank][name])
        want = np.asarray(expected(name, rank))
        assert got.shape == want.shape, (name, rank, got.shape, want.shape)
        if got.dtype == np.float32:
            # bitwise: the fold order is part of the contract
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.astype(np.float32)
                                          .view(np.int32), err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_trivial_axes_are_identity_and_bare_names_raise():
    x = torch.tensor([1, 0, 1], dtype=torch.uint8)
    assert C.or_allreduce(x, ()) is x
    assert C.merge_contribution("min", x, ()) is x
    with pytest.raises(ValueError, match="carry no mesh"):
        C.or_allreduce(x, ("model",))
