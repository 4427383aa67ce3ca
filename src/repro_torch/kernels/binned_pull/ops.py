"""Wrapper and host-side operand pack of the fused binned-pull kernel
(port of ``repro.kernels.binned_pull.ops``).

``binned_pull`` runs the plain PyTorch version for a CPU tensor and
launches the CUDA kernel for a CUDA tensor; there is no fall back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .binned_pull import (
    LaunchRecord,
    TilePlan,
    check_call,
    fused_binned_pull,
    make_plan,
    make_record,
    tile_rows,
)
from ..common import derived
from .ref import fused_binned_pull_ref


@dataclasses.dataclass(frozen=True)
class BinnedPullPack:
    """Kernel-ready repack of ``graph.csr.BinnedRevEll``: the same edge set
    and perm/inverse contract, every nonzero-width slab row-padded to a
    multiple of its ``tile_rows`` (pad rows all-sentinel), and the
    permutation pair re-indexed into the padded position space. ``K`` is
    the number of graph shards stacked (1 on a rank of a mesh, which
    builds only its own shard: ``rows_local`` is then ``n_out`` over the
    shard count and the wrapper's ``gsrc`` stays global)."""

    slabs: tuple  # of [K, rows_pad_b, width_b] int32 (nonzero-width)
    inv_pad: torch.Tensor  # [K, rows_local] int32 (local row -> padded pos)
    perm_pad: torch.Tensor  # [K, rbp] int32 (padded pos -> local row;
    #                         sentinel rows_local at pad positions)
    slab_weights: Optional[tuple] = None  # matching [K, rows_pad_b, w] f32

    @property
    def rows_local(self) -> int:
        return int(self.inv_pad.shape[-1])

    @property
    def n_shards(self) -> int:
        return int(self.inv_pad.shape[0])

    @property
    def widths(self) -> tuple:
        return tuple(int(s.shape[-1]) for s in self.slabs)

    @property
    def capacity_slots(self) -> int:
        """One shard's full-scan slots including the row padding."""
        return int(sum(s.shape[-2] * s.shape[-1] for s in self.slabs))


def pack_plan(pack: BinnedPullPack) -> TilePlan:
    """The static layout, rebuilt from the pack's shapes alone."""
    rows_pad = tuple(int(s.shape[-2]) for s in pack.slabs)
    return make_plan(
        widths=tuple(int(s.shape[-1]) for s in pack.slabs),
        rows_pad=rows_pad,
        zero_rows=int(pack.perm_pad.shape[-1]) - sum(rows_pad),
    )


def pack_tile_map(pack: BinnedPullPack):
    """Host-side scanned-slot accounting of shard 0 in JAX's tile layout
    (``tile_rows`` rows of one slab to a tile): ``(tile_of_row,
    tile_slots)``, the tile id of every local row (-1 for rows of
    in-degree 0, which no tile scans) and the int32 adjacency slots each
    tile pays."""
    plan = pack_plan(pack)
    inv = pack.inv_pad[0].cpu().numpy().astype(np.int64)
    tile_of_pos = np.full(plan.rbp, -1, np.int64)
    slots, t = [], 0
    for w, a0, rows in zip(plan.widths, plan.astarts, plan.rows_pad):
        tr = tile_rows(w)
        tile_of_pos[a0 : a0 + rows] = t + np.arange(rows) // tr
        slots.extend([tr * w] * (rows // tr))
        t += rows // tr
    return tile_of_pos[inv], np.asarray(slots, np.int64)


def build_pack(bn, n_pad: int) -> BinnedPullPack:
    """Host-side (numpy, deterministic) repack of a ``BinnedRevEll``;
    ``n_pad`` is the padded node count (the slab sentinel). Returns CPU
    tensors."""
    k = int(bn.inv.shape[0])
    rows_local = bn.rows_local
    widths = bn.widths
    if widths[0] != 0 or not all(w > 0 for w in widths[1:]):
        raise ValueError(f"unexpected binned slab widths: {widths}")
    rows_raw = [int(s.shape[-2]) for s in bn.slabs]
    rows_pad = [
        -(-r // tile_rows(w)) * tile_rows(w)
        for w, r in zip(widths[1:], rows_raw[1:])
    ]
    starts = np.concatenate([[0], np.cumsum(rows_raw)])[:-1]
    seg = np.asarray([rows_raw[0]] + rows_pad, np.int64)
    pstarts = np.concatenate([[0], np.cumsum(seg)])[:-1]
    rbp = int(seg.sum())
    bop = np.repeat(np.arange(len(widths)), rows_raw)
    pp = pstarts[bop] + np.arange(int(np.sum(rows_raw))) - starts[bop]
    inv_pad = pp[bn.inv.cpu().numpy()].astype(np.int32)
    perm_pad = np.full((k, rbp), rows_local, np.int32)
    perm_pad[:, pp] = bn.perm.cpu().numpy()
    slabs, wslabs = [], []
    for b in range(1, len(widths)):
        s = bn.slabs[b].cpu().numpy()
        pad = rows_pad[b - 1] - s.shape[1]
        fill = np.full((k, pad, widths[b]), n_pad, np.int32)
        slabs.append(torch.from_numpy(np.concatenate([s, fill], axis=1)))
        if bn.slab_weights is not None:
            wv = bn.slab_weights[b].cpu().numpy()
            wfill = np.zeros((k, pad, widths[b]), np.float32)
            wslabs.append(
                torch.from_numpy(np.concatenate([wv, wfill], axis=1))
            )
    return BinnedPullPack(
        slabs=tuple(slabs),
        inv_pad=torch.from_numpy(np.ascontiguousarray(inv_pad)),
        perm_pad=torch.from_numpy(perm_pad),
        slab_weights=(
            tuple(wslabs) if bn.slab_weights is not None else None
        ),
    )


def launch_record(pack: BinnedPullPack) -> LaunchRecord:
    """The pack's ``LaunchRecord``, built on first use and kept on the
    pack (``kernels.common.derived``). An in-place fold of graph deltas
    into the pack's tensors drops it (``drop_derived``): the record's work
    list was built from the old ``perm_pad``."""
    return derived(pack, "record", lambda: make_record(
        pack_plan(pack), [s[0] for s in pack.slabs],
        None if pack.slab_weights is None
        else [w[0] for w in pack.slab_weights],
        pack.perm_pad[0], pack.inv_pad[0],
    ))


def binned_pull(
    pack: BinnedPullPack,
    gsrc: torch.Tensor,  # [n_out](, L): uint8/bool mask or f32 distance
    vloc: torch.Tensor | None = None,  # [rows_local](, L) uint8/bool
    *,
    op: str,
    use_ref: bool = False,
) -> torch.Tensor:
    """Fused pull extension of shard 0 of ``pack`` (a rank's own shard)
    over the global source tensor ``gsrc [n_out]``. Returns
    ``[rows_local]`` (``[rows_local, L]`` for the lane ops): uint8 reach
    mask, int32 min-parent or float32 distance. A CPU ``gsrc`` (or
    ``use_ref``) runs the plain version; a CUDA ``gsrc`` launches the
    kernel (one C call, one launch). A bool mask is passed as a uint8
    view of the same memory."""
    rec = launch_record(pack)
    if gsrc.dtype == torch.bool:
        gsrc = gsrc.view(torch.uint8)
    if vloc is not None and vloc.dtype == torch.bool:
        vloc = vloc.view(torch.uint8)
    if use_ref or gsrc.device.type == "cpu":
        check_call(rec, op, gsrc, vloc)
        return fused_binned_pull_ref(
            op, rec.plan, rec.slabs,
            rec.wslabs if op == "min_dist" else None, gsrc, rec.inv_pad,
            vloc,
        )
    return fused_binned_pull(rec, op, gsrc, vloc)
