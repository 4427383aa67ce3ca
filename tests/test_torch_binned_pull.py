"""Host side of the port's ``binned_pull`` kernel, on the CPU.

- ``make_plan`` (a running sum) gives the JAX package's ``TilePlan``
  fields on every fixture's pack and on random slab shapes;
- the kernel's work list (``plan_tasks``) covers every live padded
  position exactly once: a narrow or warp row in one row task, a hub row
  in every chunk of its row, the chunks tiling its slots; walked as the
  kernel walks it, with the plain ops, it gives the plain version's bits
  for every op and several row-class boundaries;
- the launch record is built once per pack and a ``to_device`` copy
  builds its own; the per-call checks raise on a wrong ``gsrc`` dtype or
  shape and a wrong ``vloc`` on CPU tensors, before any kernel could run.

The kernel itself is held against the plain version on the card by
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import build_operands as j_build_operands
from repro.kernels.binned_pull.binned_pull import make_plan as j_make_plan
from repro.kernels.binned_pull.binned_pull import tile_rows as j_tile_rows
from repro.kernels.binned_pull.ops import pack_plan as j_pack_plan

from repro_torch.core import build_operands as t_build_operands
from repro_torch.kernels.binned_pull import binned_pull as bp
from repro_torch.kernels.binned_pull.binned_pull import (
    BLOCK_THREADS,
    LANE_OPS,
    NO_PARENT,
    OPS,
    make_plan,
    op_config,
    plan_tasks,
    task_table,
)
from repro_torch.kernels.binned_pull.ops import (
    binned_pull,
    launch_record,
    pack_plan,
)
from repro_torch.kernels.common import to_device

from test_torch_graph import KINDS, fixture_csr, np_of, to_port, with_weights
from test_torch_kernels import pull_inputs

PLAN_FIELDS = ("widths", "rows_pad", "astarts", "zero_rows", "rbp")


def port_pack(kind, n=300, seed=3):
    csr = with_weights(fixture_csr(kind, n=n, seed=seed), seed=4)
    ops, n_pad = t_build_operands(to_port(csr), "pull_binned_fused")
    return csr, ops.rev_binned_pack, n_pad


@pytest.mark.parametrize("kind", KINDS)
def test_make_plan_matches_jax_on_fixture_packs(kind):
    csr = fixture_csr(kind, seed=3)
    jops, _ = j_build_operands(csr, "pull_binned_fused")
    tops, _ = t_build_operands(to_port(csr), "pull_binned_fused")
    jp, tp = j_pack_plan(jops.rev_binned_pack), pack_plan(tops.rev_binned_pack)
    for f in PLAN_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_plan_matches_jax_on_random_shapes(seed):
    rng = np.random.default_rng(seed)
    widths = np.sort(rng.choice(np.arange(1, 30000), size=60, replace=False))
    widths = [int(w) for w in widths]
    rows_pad = [j_tile_rows(w) * int(rng.integers(1, 9)) for w in widths]
    zero_rows = int(rng.integers(0, 500))
    jp = j_make_plan(widths, rows_pad, zero_rows)
    tp = make_plan(widths, rows_pad, zero_rows)
    for f in PLAN_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    with pytest.raises(ValueError, match="bad slab shape"):
        make_plan([4], [j_tile_rows(4) + 8], 0)


def walk_tasks(op, rec, tasks, gsrc, vloc):
    """The kernel's work list walked on the host: each row task reduces
    its rows, each hub chunk its slots into a partial, and a hub row's
    partials are combined; the plain ops, numpy."""
    pp = np_of(rec.perm_pad).astype(np.int64)
    rows_local = rec.rows_local
    g = np_of(gsrc)
    lanes_op = op in LANE_OPS
    g2 = g if lanes_op else g[:, None]
    n_out, lanes = g2.shape
    acc_dtype, neutral, src_pad, suppress = op_config(op)
    np_dtype = {torch.uint8: np.uint8, torch.int32: np.int32,
                torch.float32: np.float32}[acc_dtype]
    out = np.full((rows_local, lanes), 77, np_dtype)  # poison: all written
    written = np.zeros(rows_local, np.int64)
    red = np.minimum if neutral != 0 else np.maximum
    slabs = [np_of(s).reshape(-1) for s in rec.slabs]
    wslabs = (None if rec.wslabs is None or op != "min_dist"
              else [np_of(w).reshape(-1) for w in rec.wslabs])

    def reduce(b, off, n):
        acc = np.full(lanes, neutral, np_dtype)
        if b < 0 or n == 0:
            return acc
        ids = slabs[b][off:off + n].astype(np.int64)
        ok = (ids >= 0) & (ids < n_out)
        got = np.where(ok[:, None], g2[np.clip(ids, 0, n_out - 1)],
                       np.asarray(src_pad, g2.dtype))
        if op in ("reach", "reach_lanes"):
            cand = got
        elif op == "min_dist":
            w = np.ones(n, np.float32) if wslabs is None else (
                wslabs[b][off:off + n])
            cand = got + w[:, None]
        else:
            cand = np.where(got != 0, ids[:, None], NO_PARENT)
        return red(acc, red.reduce(cand.astype(np_dtype), axis=0))

    def emit(r, acc):
        v = None if vloc is None else np_of(vloc).reshape(rows_local, -1)[r]
        out[r] = acc if v is None else np.where(v != 0, suppress, acc)
        written[r] += 1

    hub_parts = {}
    for b, off, pos, w, nrows, tpr, c, n_ch, part in tasks:
        if nrows:
            assert BLOCK_THREADS % tpr == 0 and nrows * tpr <= BLOCK_THREADS
            for k in range(nrows):
                r = pp[pos + k]
                if 0 <= r < rows_local:
                    emit(r, reduce(b, off + k * w, w))
            continue
        hub_parts.setdefault((pos, part, n_ch), {})[c] = reduce(b, off, w)
    for (pos, part, n_ch), parts in hub_parts.items():
        assert sorted(parts) == list(range(n_ch))
        emit(pp[pos], red.reduce(np.stack(list(parts.values())), axis=0))
    assert (written == 1).all(), "every local row written exactly once"
    return out if lanes_op else out[:, 0]


@pytest.mark.parametrize("hub_width,chunk,row_slots", [
    (1024, 2048, 8), (32, 8, 1), (64, 100, 4), (96, 32, 16)])
@pytest.mark.parametrize("kind", ["pl", "hub", "star", "edgeless"])
def test_task_walk_matches_plain_version(kind, hub_width, chunk, row_slots):
    csr, pack, n_pad = port_pack(kind)
    rec = launch_record(pack)
    pp = np_of(rec.perm_pad)
    live = (pp >= 0) & (pp < rec.rows_local)
    for op in OPS:
        lanes = 3 if op in LANE_OPS else 1
        tasks = plan_tasks(rec.plan, live, lanes=op in LANE_OPS,
                           hub_width=hub_width, chunk=chunk,
                           row_slots=row_slots)
        hub = tasks[:, 4] == 0
        # hub chunks first, each chunk's slots within its row's width
        assert not hub[np.argmin(hub):].any()
        widths = np.asarray((0,) + rec.plan.widths)[tasks[:, 0] + 1]
        assert (tasks[hub, 3] <= chunk).all()
        assert ((widths >= hub_width) == hub).all()
        tpr = tasks[~hub, 5]
        if op in LANE_OPS:
            assert (tpr == 32).all()
        else:
            need = -(-widths[~hub] // row_slots)
            assert ((tpr >= np.minimum(need, 32)) & (tpr <= 32)).all()
            assert ((tpr == 1) | (tpr < 2 * need)).all()
        g, vs = pull_inputs(op, n_pad, rec.rows_local, seed=5, lanes=lanes)
        for v in vs:
            gt = torch.from_numpy(g)
            vt = None if v is None else torch.from_numpy(v)
            exp = np_of(binned_pull(pack, gt, vt, op=op))
            got = walk_tasks(op, rec, tasks, gt, vt)
            np.testing.assert_array_equal(got, exp, err_msg=f"{kind}/{op}")


def test_task_table_points_at_each_tasks_first_slot():
    _, pack, _ = port_pack("pl")
    rec = launch_record(pack)
    pp = np_of(rec.perm_pad)
    tasks = plan_tasks(rec.plan, (pp >= 0) & (pp < rec.rows_local),
                       hub_width=64, chunk=40)
    for wsl in (None, rec.wslabs):
        table = np_of(task_table(tasks, rec.slabs, wsl, "cpu"))
        assert table.shape == (len(tasks), bp.TASK_WORDS)
        ptrs = table.view(np.int64)
        for row, t in zip(ptrs, tasks):
            b, off = int(t[0]), int(t[1])
            if b < 0:
                assert row[0] == 0 and row[1] == 0
                continue
            assert row[0] == rec.slabs[b].data_ptr() + 4 * off
            assert row[1] == (0 if wsl is None
                              else wsl[b].data_ptr() + 4 * off)
        np.testing.assert_array_equal(table[:, 4:11], tasks[:, 2:])


def test_launch_record_built_once_per_pack(monkeypatch):
    _, pack, n_pad = port_pack("er")
    builds = []
    real = bp.make_record
    monkeypatch.setattr(
        "repro_torch.kernels.binned_pull.ops.make_record",
        lambda *a, **k: builds.append(1) or real(*a, **k))
    g = torch.zeros(n_pad, dtype=torch.uint8)
    g[:20] = 1
    vis = torch.zeros(pack.rows_local, dtype=torch.bool)
    first = binned_pull(pack, g, op="reach")
    for _ in range(3):
        assert torch.equal(binned_pull(pack, g.bool(), vis, op="reach"),
                           first)
    rec = launch_record(pack)
    assert len(builds) == 1 and launch_record(pack) is rec
    assert rec.slabs[0].data_ptr() == pack.slabs[0].data_ptr()
    # a CPU record has no device tables
    assert rec.tasks == {} and rec.counters is None
    moved = to_device(pack, "cpu")
    assert moved is not pack and "_derived_record" not in moved.__dict__
    assert torch.equal(binned_pull(moved, g, op="reach"), first)
    assert len(builds) == 2 and launch_record(moved) is not rec


def test_call_checks_raise_on_cpu_tensors():
    _, pack, n_pad = port_pack("er")
    rows = pack.rows_local
    g = torch.zeros(n_pad, dtype=torch.uint8)
    with pytest.raises(ValueError, match="gsrc must be contiguous"):
        binned_pull(pack, g.to(torch.int32), op="reach")
    with pytest.raises(ValueError, match="gsrc must be contiguous"):
        binned_pull(pack, g.float(), op="min_parent")
    with pytest.raises(ValueError, match="gsrc must be contiguous"):
        binned_pull(pack, g.to(torch.uint8), op="min_dist")
    with pytest.raises(ValueError, match="gsrc has shape"):
        binned_pull(pack, g[:, None], op="reach")
    with pytest.raises(ValueError, match="gsrc has shape"):
        binned_pull(pack, g, op="reach_lanes")
    with pytest.raises(ValueError, match="gsrc must be contiguous"):
        binned_pull(pack, torch.zeros((n_pad, 4), dtype=torch.uint8)[:, ::2],
                    op="reach_lanes")
    with pytest.raises(ValueError, match="vloc must be"):
        binned_pull(pack, g, torch.zeros(rows + 1, dtype=torch.uint8),
                    op="reach")
    with pytest.raises(ValueError, match="vloc must be"):
        binned_pull(pack, g, torch.zeros(rows, dtype=torch.int32),
                    op="reach")
    with pytest.raises(ValueError, match="no visited suppression"):
        binned_pull(pack, g.float(), torch.zeros(rows, dtype=torch.uint8),
                    op="min_dist")
    with pytest.raises(ValueError, match="unknown binned-pull op"):
        binned_pull(pack, g, op="sum")
    # the same checks guard the launcher, before it needs a card
    with pytest.raises(ValueError, match="CUDA"):
        bp.fused_binned_pull(launch_record(pack), "reach", g)
