"""CUDA launcher for the fused degree-binned pull (``csrc/binned_pull.cu``).

Port of ``repro.kernels.binned_pull.binned_pull``: the static slab layout
(``TilePlan``/``make_plan``), the per-op constants (``op_config``) and the
kernel launch. The kernel computes one bottom-up frontier extension over
the row-padded binned reverse slabs and writes each live row's result
straight to its local row (``perm_pad``), with visited suppression in the
same pass; see the source's header for the design.

Everything about a pack that does not change between calls lives in a
``LaunchRecord`` (``make_record``): the plan, the shard-0 views, the
checks of the pack's own tensors and the kernel's task tables. A call
checks only its own arguments (``check_call``), allocates its output and
makes one C call, which launches one kernel; nothing in it synchronises
the host, so the call can be captured in a CUDA graph.
``fused_binned_pull.launches`` counts kernel launches (one per call).
"""
from __future__ import annotations

import ctypes
import dataclasses
from itertools import accumulate
from typing import Optional

import numpy as np
import torch

from .. import build

SOURCE = "src/repro_torch/kernels/csrc/binned_pull.cu"
NO_PARENT = 2**31 - 1

OPS = ("reach", "reach_lanes", "min_parent", "min_parent_lanes", "min_dist")
LANE_OPS = ("reach_lanes", "min_parent_lanes")
_OP_INDEX = {op: i for i, op in enumerate(OPS)}

TILE_SLOTS = 4096  # target int32 adjacency slots per row tile
MIN_TILE_ROWS = 8
MAX_TILE_ROWS = 256

# Row classes of the kernel's one grid, chosen by
# scripts/binned_pull_sweep.py on the card (PERF.md): a dense-op row
# narrower than HUB_WIDTH runs on the power-of-two group of threads
# (at most a warp) that gives each thread about ROW_SLOTS of its slots;
# a lane-op row on one warp, whose threads take the lanes; a hub row is
# cut into chunks of CHUNK slots, one thread block each.
WARP = 32
ROW_SLOTS = 16
HUB_WIDTH = 1024
CHUNK = 4096
BLOCK_THREADS = 256  # threads of every block (THREADS in the source)
TASK_WORDS = 12  # int32 words of one task (struct Task in the source)
PART_LANES = 64  # lanes whose hub partials the record holds


def tile_rows(width: int) -> int:
    """Row-padding unit of a width-``width`` slab (multiple of 8)."""
    tr = TILE_SLOTS // max(int(width), 1)
    tr = (tr // MIN_TILE_ROWS) * MIN_TILE_ROWS
    return max(MIN_TILE_ROWS, min(MAX_TILE_ROWS, tr))


def op_config(op: str):
    """Per-op (accumulator dtype, reduction neutral, source pad value,
    visited-suppression value), shared by the kernel and its plain
    version."""
    if op in ("reach", "reach_lanes"):
        return torch.uint8, 0, 0, 0
    if op in ("min_parent", "min_parent_lanes"):
        return torch.int32, NO_PARENT, 0, NO_PARENT
    if op != "min_dist":
        raise ValueError(f"unknown binned-pull op: {op}")
    return torch.float32, float("inf"), float("inf"), None


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Static slab layout, derived from the padded slab shapes: padded
    binned positions in bucket order, the zero-width bucket's rows first,
    then each nonzero-width slab's row-padded segment."""

    widths: tuple  # nonzero-width slab widths, bucket order
    rows_pad: tuple  # padded rows per slab (multiple of its tile_rows)
    astarts: tuple  # first padded position of each slab
    zero_rows: int  # zero-width-bucket rows (position prefix)
    rbp: int  # padded binned positions


def make_plan(widths, rows_pad, zero_rows) -> TilePlan:
    widths = tuple(int(w) for w in widths)
    rows_pad = tuple(int(r) for r in rows_pad)
    for w, r in zip(widths, rows_pad):
        if not (w > 0 and r > 0 and r % tile_rows(w) == 0):
            raise ValueError(f"bad slab shape: width {w}, rows {r}")
    ends = tuple(accumulate(rows_pad, initial=int(zero_rows)))
    return TilePlan(widths=widths, rows_pad=rows_pad, astarts=ends[:-1],
                    zero_rows=int(zero_rows), rbp=ends[-1])


def row_threads(width: int, row_slots: int = ROW_SLOTS) -> int:
    """Threads of a dense-op row of ``width`` slots below the hub width:
    the power of two, at most a warp, that leaves each about
    ``row_slots``."""
    need = -(-int(width) // row_slots)
    return min(WARP, 1 << max(need - 1, 0).bit_length())


def plan_tasks(plan: TilePlan, live: np.ndarray, *, lanes: bool = False,
               hub_width: int = HUB_WIDTH, chunk: int = CHUNK,
               row_slots: int = ROW_SLOTS) -> np.ndarray:
    """The kernel's work list, one task per thread block, as ``[T, 9]``
    int64 columns: slab (-1 = the zero-width bucket), first slot (offset
    in the slab), first padded position, slots per row (a hub chunk: its
    own slots), rows (0 = a hub chunk), threads per row, chunk, chunks of
    the row, the row's first partial slot.

    ``live`` marks the padded positions that hold a local row. Every live
    position is in exactly one row task, or in every chunk of its row;
    trailing pad rows of a slab get no task and pad rows of a hub slab no
    chunk. Hub chunks come first (widest row first), then the other rows,
    widest first, so the longest blocks start first. ``lanes`` gives every
    row below the hub width a warp (the lane ops' table)."""
    if chunk <= 0 or hub_width < WARP or row_slots <= 0:
        raise ValueError(f"bad row classes: hub width {hub_width}, "
                         f"chunk {chunk}, row slots {row_slots}")
    hub, rows = [], []
    segs = [(-1, 0, 0, plan.zero_rows)] + list(zip(
        range(len(plan.widths)), plan.widths, plan.astarts, plan.rows_pad))
    for b, w, a, r in segs:
        idx = np.flatnonzero(live[a:a + r])
        if not idx.size:
            continue
        if w >= hub_width:
            n_ch = -(-w // chunk)
            hub += [(w, b, int(k) * w + c * chunk, a + int(k),
                     min(chunk, w - c * chunk), c, n_ch)
                    for k in idx for c in range(n_ch)]
            continue
        tpr = WARP if lanes else row_threads(w, row_slots)
        per = BLOCK_THREADS // tpr
        n = int(idx[-1]) + 1
        rows += [(w, b, k * w, a + k, w, min(per, n - k), tpr)
                 for k in range(0, n, per)]
    hub.sort(key=lambda t: (-t[0], t[3], t[5]))
    rows.sort(key=lambda t: -t[0])  # stable within a slab
    out = np.zeros((len(hub) + len(rows), 9), np.int64)
    part = first = 0
    for i, (_, b, off, pos, slots, c, n_ch) in enumerate(hub):
        if c == 0:
            first, part = part, part + n_ch
        out[i] = (b, off, pos, slots, 0, 0, c, n_ch, first)
    for i, (_, b, off, pos, w, nrows, tpr) in enumerate(rows, len(hub)):
        out[i] = (b, off, pos, w, nrows, tpr, 0, 0, 0)
    return out


def task_table(tasks: np.ndarray, slabs, wslabs, device) -> torch.Tensor:
    """``plan_tasks`` rows as the kernel's ``[T, 12]`` int32 table: the
    task's first slot in the slab and in the weight slab as two int64
    pointers (0 for the zero-width bucket and for unit weights), then
    seven int32 fields and a pad word. The table holds raw pointers: keep
    ``slabs``/``wslabs`` alive while it is in use."""
    slab, off = tasks[:, 0], tasks[:, 1]
    table = np.zeros((len(tasks), TASK_WORDS), np.int32)
    ptrs = table.view(np.int64)  # [T, 6]
    for s in np.unique(slab[slab >= 0]):
        sel = slab == s
        ptrs[sel, 0] = slabs[s].data_ptr() + 4 * off[sel]
        if wslabs is not None:
            ptrs[sel, 1] = wslabs[s].data_ptr() + 4 * off[sel]
    table[:, 4:11] = tasks[:, 2:]
    return torch.from_numpy(table).to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class LaunchRecord:
    """What every call on one pack shares, built once by ``make_record``:
    the plan, the shard-0 views of the pack's tensors (checked once), and
    on a CUDA pack the kernel's task tables, the hub rows' arrival
    counters and their partials' scratch. It points into the pack's
    tensors, so it belongs to them: a pack whose tensors are replaced is a
    new pack with its own record, and a fold that writes into the tensors
    in place must drop the record."""

    plan: TilePlan
    slabs: tuple  # [rows_pad_b, width_b] int32 views
    wslabs: Optional[tuple]  # matching float32 views, or None
    perm_pad: torch.Tensor  # [rbp] int32
    inv_pad: torch.Tensor  # [rows_local] int32
    rows_local: int
    device: torch.device
    # (weighted, lane op) -> (the [T, 12] int32 task table, T); {} on a CPU
    tasks: dict
    n_parts: int  # hub chunks: partial slots per lane
    counters: Optional[torch.Tensor]  # [n_parts] int32, 0 between launches
    partials: Optional[torch.Tensor]  # [n_parts * PART_LANES] int32 words


def make_record(plan: TilePlan, slabs, wslabs, perm_pad: torch.Tensor,
                inv_pad: torch.Tensor, *, hub_width: int = HUB_WIDTH,
                chunk: int = CHUNK, row_slots: int = ROW_SLOTS
                ) -> LaunchRecord:
    """Check the pack's shard-0 tensors against ``plan`` and, on a CUDA
    device, build the task tables (one host copy of ``perm_pad`` to find
    the live positions: build it outside a CUDA-graph capture)."""
    slabs = tuple(slabs)
    dev = inv_pad.device
    if len(slabs) != len(plan.widths) or (
            wslabs is not None and len(wslabs) != len(slabs)):
        raise ValueError("slab count does not match the plan")
    for b, s in enumerate(slabs):
        shape = (plan.rows_pad[b], plan.widths[b])
        if (s.device != dev or s.dtype != torch.int32
                or tuple(s.shape) != shape or not s.is_contiguous()):
            raise ValueError(f"slab {b} must be contiguous int32 {shape}")
        if wslabs is not None and (
            wslabs[b].device != dev or wslabs[b].dtype != torch.float32
            or tuple(wslabs[b].shape) != shape
            or not wslabs[b].is_contiguous()
        ):
            raise ValueError(f"weight slab {b} must be contiguous f32 {shape}")
    if (perm_pad.device != dev or perm_pad.dtype != torch.int32
            or tuple(perm_pad.shape) != (plan.rbp,)
            or not perm_pad.is_contiguous()):
        raise ValueError(f"perm_pad must be contiguous int32 [{plan.rbp}]")
    if inv_pad.dtype != torch.int32 or inv_pad.ndim != 1:
        raise ValueError("inv_pad must be int32 [rows_local]")
    rows_local = int(inv_pad.shape[0])
    tables, n_parts, counters, partials = {}, 0, None, None
    if dev.type == "cuda":
        pp = perm_pad.cpu().numpy()
        live = (pp >= 0) & (pp < rows_local)
        for lanes in (False, True):
            tasks = plan_tasks(plan, live, lanes=lanes, hub_width=hub_width,
                               chunk=chunk, row_slots=row_slots)
            n_parts = int((tasks[:, 4] == 0).sum())  # a slot a hub chunk
            for weighted in (False, True)[:1 + (wslabs is not None)]:
                tables[weighted, lanes] = (task_table(
                    tasks, slabs, wslabs if weighted else None, dev),
                    len(tasks))
        counters = torch.zeros(max(n_parts, 1), dtype=torch.int32,
                               device=dev)
        partials = torch.empty(max(n_parts, 1) * PART_LANES,
                               dtype=torch.int32, device=dev)
    return LaunchRecord(
        plan=plan, slabs=slabs,
        wslabs=None if wslabs is None else tuple(wslabs),
        perm_pad=perm_pad, inv_pad=inv_pad, rows_local=rows_local,
        device=dev, tasks=tables, n_parts=n_parts, counters=counters,
        partials=partials,
    )


def check_call(rec: LaunchRecord, op: str, gsrc: torch.Tensor,
               vloc) -> int:
    """Check one call's arguments against its record (on any device);
    returns the lane count (1 for the dense ops)."""
    lanes_op = op in LANE_OPS
    if op not in _OP_INDEX:
        raise ValueError(f"unknown binned-pull op: {op}")
    if gsrc.ndim != (2 if lanes_op else 1):
        raise ValueError(f"{op}: gsrc has shape {tuple(gsrc.shape)}")
    want = torch.float32 if op == "min_dist" else torch.uint8
    if gsrc.dtype != want or not gsrc.is_contiguous():
        raise ValueError(f"{op}: gsrc must be contiguous {want}")
    if gsrc.device != rec.device:
        raise ValueError(f"gsrc is on {gsrc.device}, the pack on "
                         f"{rec.device}")
    lanes = int(gsrc.shape[1]) if lanes_op else 1
    if vloc is not None:
        if op == "min_dist":
            raise ValueError("min_dist has no visited suppression")
        shape = (rec.rows_local, lanes) if lanes_op else (rec.rows_local,)
        if (vloc.device != rec.device or vloc.dtype != torch.uint8
                or tuple(vloc.shape) != shape or not vloc.is_contiguous()):
            raise ValueError(f"vloc must be contiguous uint8 {shape}")
    return lanes


_ARGTYPES = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]
_entry = []  # the loaded C entry point, once


def _launch_fn():
    if not _entry:
        fn = build.load("binned_pull").binned_pull_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry.append(fn)
    return _entry[0]


def fused_binned_pull(rec: LaunchRecord, op: str, gsrc: torch.Tensor,
                      vloc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the fused pull on ``gsrc``'s CUDA device and current stream:
    ``gsrc`` is ``[n_out](, L)``, a uint8 mask or float32 distances;
    ``vloc`` is None or ``[rows_local](, L)`` uint8 (nonzero = visited).
    Returns ``[rows_local]`` (``[rows_local, L]`` for the lane ops):
    uint8 reach, int32 min-parent or float32 distance. Calls that share
    ``rec`` must be ordered on one stream (the hub rows' counters and
    partials)."""
    dev = gsrc.device
    if dev.type != "cuda":
        raise ValueError("fused_binned_pull launches on CUDA tensors only")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return fused_binned_pull(rec, op, gsrc, vloc)
    lanes = check_call(rec, op, gsrc, vloc)
    lanes_op = op in LANE_OPS
    out = torch.empty((rec.rows_local, lanes) if lanes_op
                      else (rec.rows_local,), dtype=_OUT_DTYPE[op],
                      device=dev)
    if rec.rows_local == 0 or lanes == 0:
        return out
    table, n_tasks = rec.tasks[op == "min_dist" and rec.wslabs is not None,
                               lanes_op]
    partials = rec.partials
    if lanes > PART_LANES and rec.n_parts:
        partials = torch.empty(rec.n_parts * lanes, dtype=torch.int32,
                               device=dev)
    code = _launch_fn()(
        _OP_INDEX[op], table.data_ptr(), n_tasks, gsrc.data_ptr(),
        gsrc.shape[0], lanes, rec.perm_pad.data_ptr(), rec.rows_local,
        None if vloc is None else vloc.data_ptr(), out.data_ptr(),
        partials.data_ptr(), rec.counters.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if code:
        build.check(build.load("binned_pull"), "binned_pull", code)
    fused_binned_pull.launches += 1
    return out


fused_binned_pull.launches = 0
_OUT_DTYPE = {op: op_config(op)[0] for op in OPS}
