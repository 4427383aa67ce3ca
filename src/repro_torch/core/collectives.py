"""Frontier-union collectives on one device (port of the single-device
forms of ``repro.core.collectives``).

The engines call a merge after every extension. With one device every
graph axis has size 1, so each merge is the identity; the functions keep
the JAX package's signatures and raise for a real axis group, which is
the multi-device slice's work (``torch.distributed``).
"""
from __future__ import annotations

import torch

#: the hybrid's phase-2 frontier-union flavor (policy metadata only here)
REDISPATCH_OR_IMPL = "ring"


def _single(axis_names) -> None:
    if axis_names:
        raise NotImplementedError(
            "multi-device collectives are not ported yet (ROADMAP queue 1: "
            f"multi-device collectives); got axes {axis_names!r}"
        )


def or_allreduce(x: torch.Tensor, axis_names=(), impl: str = "ring"):
    """OR-union across graph axes (identity on one device)."""
    _single(axis_names)
    return x


def min_allreduce(x: torch.Tensor, axis_names=()):
    """Min across graph axes (identity on one device)."""
    _single(axis_names)
    return x


def sum_allreduce(x: torch.Tensor, axis_names=()):
    """Sum across graph axes (identity on one device)."""
    _single(axis_names)
    return x


def merge_contribution(merge: str, contribution, axis_names=(),
                       or_impl: str = "allgather"):
    """Apply an edge compute's MERGE across graph axes."""
    if merge == "or":
        return or_allreduce(contribution, axis_names, or_impl)
    if merge == "min":
        return min_allreduce(contribution, axis_names)
    if merge == "sum":
        return sum_allreduce(contribution, axis_names)
    if merge == "or_min":
        reached, cand = contribution
        return (or_allreduce(reached, axis_names, or_impl),
                min_allreduce(cand, axis_names))
    raise ValueError(f"unknown merge: {merge}")


def gang_scatter_back(full, sub, idx):
    """Write the ``len(idx)`` resumed survivors (leading rows of ``sub``)
    back into the stacked phase-1 state ``full``; gang pad slots are
    dropped. Returns new tensors."""
    idx_t = None
    out = []
    for f, s in zip(full, sub):
        if idx_t is None:
            idx_t = torch.as_tensor(idx, dtype=torch.long, device=f.device)
        g = f.clone()
        g[idx_t] = s[: idx_t.numel()]
        out.append(g)
    return type(full)(*out)
