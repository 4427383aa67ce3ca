"""CUDA launcher for the fused degree-binned pull (``csrc/binned_pull.cu``).

Port of ``repro.kernels.binned_pull.binned_pull``: the static slab layout
(``TilePlan``/``make_plan``), the per-op constants (``op_config``) and the
kernel launch. The kernel computes one bottom-up frontier extension over
the row-padded binned reverse slabs and writes each live row's result
straight to its local row (``perm_pad``), with visited suppression in the
same pass; see the source's header for the design.

``fused_binned_pull.launches`` counts kernel launches (one per call).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import build

SOURCE = "src/repro_torch/kernels/csrc/binned_pull.cu"
NO_PARENT = 2**31 - 1

OPS = ("reach", "reach_lanes", "min_parent", "min_parent_lanes", "min_dist")
LANE_OPS = ("reach_lanes", "min_parent_lanes")

TILE_SLOTS = 4096  # target int32 adjacency slots per row tile
MIN_TILE_ROWS = 8
MAX_TILE_ROWS = 256
WIDE = 32  # slabs this wide or wider run one thread block per row


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
    for w, r in zip(widths, rows_pad):
        if not (w > 0 and r > 0 and r % tile_rows(w) == 0):
            raise ValueError(f"bad slab shape: width {w}, rows {r}")
    astarts = tuple(
        int(zero_rows) + int(sum(rows_pad[:b])) for b in range(len(rows_pad))
    )
    return TilePlan(
        widths=tuple(int(w) for w in widths),
        rows_pad=tuple(int(r) for r in rows_pad),
        astarts=astarts,
        zero_rows=int(zero_rows),
        rbp=int(zero_rows) + int(sum(rows_pad)),
    )


def split_point(plan: TilePlan) -> tuple[int, int]:
    """(first wide slab, its first padded position): slabs are in
    ascending width, so narrow ones cover ``[zero_rows, a_split)`` and
    wide ones ``[a_split, rbp)``."""
    if list(plan.widths) != sorted(plan.widths):
        raise ValueError("binned slabs must be in ascending width order")
    first = next(
        (b for b, w in enumerate(plan.widths) if w >= WIDE), len(plan.widths)
    )
    a_split = plan.astarts[first] if first < len(plan.widths) else plan.rbp
    return first, a_split


def slab_descriptors(plan: TilePlan, slabs, wslabs) -> torch.Tensor:
    """The kernel's ``[S, 5]`` int64 slab table (data pointers, width,
    padded rows, first position) on the slabs' device. The table holds raw
    pointers: keep ``slabs``/``wslabs`` alive while it is in use."""
    rows = []
    for b, s in enumerate(slabs):
        w = 0 if wslabs is None else wslabs[b].data_ptr()
        rows.append([s.data_ptr(), w, plan.widths[b], plan.rows_pad[b],
                     plan.astarts[b]])
    dev = slabs[0].device if slabs else torch.device("cpu")
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 5).to(dev)


_ARGTYPES = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _library():
    lib = build.load("binned_pull")
    fn = lib.binned_pull_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def fused_binned_pull(
    op: str,
    plan: TilePlan,
    slabs,  # list of [rows_pad_b, width_b] int32 CUDA tensors
    wslabs,  # None, or matching [rows_pad_b, width_b] float32 (min_dist)
    gsrc: torch.Tensor,  # [n_out](, L): uint8 mask or float32 distance
    perm_pad: torch.Tensor,  # [rbp] int32: padded position -> local row
    rows_local: int,
    vloc,  # None, or [rows_local](, L) uint8 (nonzero = visited)
    desc: torch.Tensor | None = None,  # slab_descriptors(...) if cached
) -> torch.Tensor:
    """Launch the fused pull on ``gsrc``'s CUDA device and stream. Returns
    ``[rows_local]`` (``[rows_local, L]`` for the lane ops): uint8 reach,
    int32 min-parent, or float32 distance."""
    if op not in OPS:
        raise ValueError(f"unknown binned-pull op: {op}")
    lanes_op = op in LANE_OPS
    dev = gsrc.device
    if dev.type != "cuda":
        raise ValueError("fused_binned_pull launches on CUDA tensors only")
    if gsrc.ndim != (2 if lanes_op else 1):
        raise ValueError(f"{op}: gsrc has shape {tuple(gsrc.shape)}")
    want = torch.float32 if op == "min_dist" else torch.uint8
    if gsrc.dtype != want or not gsrc.is_contiguous():
        raise ValueError(f"{op}: gsrc must be contiguous {want}")
    if op == "min_dist" and vloc is not None:
        raise ValueError("min_dist has no visited suppression")
    if len(slabs) != len(plan.widths):
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
    lanes = int(gsrc.shape[1]) if lanes_op else 1
    tail = (lanes,) if lanes_op else ()
    if vloc is not None and (
        vloc.device != dev or vloc.dtype != torch.uint8
        or tuple(vloc.shape) != (rows_local,) + tail
        or not vloc.is_contiguous()
    ):
        raise ValueError("vloc must be contiguous uint8 [rows_local](, L)")
    acc_dtype = op_config(op)[0]
    out = torch.empty((rows_local,) + tail, dtype=acc_dtype, device=dev)
    if rows_local == 0 or lanes == 0:
        return out
    first_wide, a_split = split_point(plan)
    if desc is None:
        desc = slab_descriptors(plan, slabs, wslabs)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.binned_pull_launch(
            OPS.index(op), desc.data_ptr() if len(slabs) else None,
            len(slabs), first_wide, plan.zero_rows, a_split, plan.rbp,
            gsrc.data_ptr(), int(gsrc.shape[0]), lanes, perm_pad.data_ptr(),
            rows_local, None if vloc is None else vloc.data_ptr(),
            out.data_ptr(), stream,
        )
    build.check(lib, "binned_pull", code)
    fused_binned_pull.launches += 1
    return out


fused_binned_pull.launches = 0
