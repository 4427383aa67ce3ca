"""Plain PyTorch version of the fused binned-pull kernel (port of
``repro.kernels.binned_pull.ref``): the padded position layout, sentinel
gathers reading the op's pad value, suppression after the un-permute,
one gather per slab and no skipping. The CPU path of the wrapper, and
what the CUDA kernel is held against."""
from __future__ import annotations

import torch

from .binned_pull import LANE_OPS, NO_PARENT, OPS, TilePlan, op_config


def fused_binned_pull_ref(
    op: str,
    plan: TilePlan,
    slabs,
    wslabs,
    gsrc: torch.Tensor,
    inv_pad: torch.Tensor,
    vloc,
) -> torch.Tensor:
    if op not in OPS:
        raise ValueError(f"unknown binned-pull op: {op}")
    lanes = op in LANE_OPS
    acc_dtype, neutral, src_pad, suppress = op_config(op)
    dev = gsrc.device
    tail = tuple(gsrc.shape[1:])
    n_out = int(gsrc.shape[0])
    acc = torch.full((plan.rbp,) + tail, neutral, dtype=acc_dtype, device=dev)
    # one pad row at index n_out: every out-of-range id reads it
    ext = torch.cat(
        [gsrc, torch.full((1,) + tail, src_pad, dtype=gsrc.dtype, device=dev)]
    )
    for b, s in enumerate(slabs):
        idx = s.clamp(0, n_out).long()
        got = ext[idx]
        if op in ("reach", "reach_lanes"):
            part = got.amax(dim=1)
        elif op == "min_parent":
            part = torch.where(got != 0, s, NO_PARENT).amin(dim=1)
        elif lanes:  # min_parent_lanes
            part = torch.where(got != 0, s[:, :, None], NO_PARENT).amin(dim=1)
        else:  # min_dist
            w = wslabs[b] if wslabs is not None else 1.0
            part = (got + w).amin(dim=1)
        a0 = plan.astarts[b]
        acc[a0 : a0 + plan.rows_pad[b]] = part.to(acc_dtype)
    res = acc[inv_pad.long()]
    if vloc is not None:
        if suppress is None:
            raise ValueError(f"{op} has no visited suppression")
        res = torch.where(
            vloc != 0, torch.tensor(suppress, dtype=acc_dtype, device=dev), res
        )
    return res
