"""EmbeddingBag for recsys (port of ``repro.nn.embedding_bag``).

One fused table holds every field's rows (FBGEMM-TBE style: all fields
concatenated, with a row offset per field). A lookup gathers rows with
``index_select``; a bag sums them with ``index_add`` in nnz order, which
on the CPU adds in the order of XLA's ``segment_sum`` scatter, bit for
bit. ``F.embedding_bag`` sums in an order of its own and is not used.
On the card ``index_add`` adds with atomics (bitwise the CPU's only under
``torch.use_deterministic_algorithms``).

The table's logical axes are JAX's ``("vocab", None)``: on a mesh of
ranks its rows lie over ``model`` (``nn.module.shard_params`` cuts a
rank's block). A lookup then takes the rows the rank owns, puts zeros
for the others and ``psum``s over those axes (under autograd), which
gives every rank JAX's ``("batch", None, None)`` result; the table's
gradient on a rank is its own rows'.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .module import activation_rules, param, set_axes, shard_activation


class FusedTable(nn.Module):
    """JAX's ``{"table": [sum(vocabs), dim]}``, ``0.01 * N(0, 1)``."""

    def __init__(self, field_vocabs, dim, generator, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        total = int(np.sum(field_vocabs))
        self.rows = total
        self.table = param((total, dim), generator, dtype, device, scale=0.01)
        set_axes(self, table=("vocab", None))


def table_offsets(field_vocabs) -> np.ndarray:
    """Each field's first row in the fused table, int64."""
    return np.concatenate([[0], np.cumsum(field_vocabs)[:-1]]).astype(
        np.int64)


def fused_table_init(field_vocabs, dim, generator, dtype=torch.float32,
                     device="cpu"):
    """One fused ``[sum(vocabs), dim]`` table and the per-field row
    offsets (int64, on the table's device)."""
    table = FusedTable(field_vocabs, dim, generator, dtype, device)
    return table, torch.as_tensor(table_offsets(field_vocabs),
                                  device=torch.device(device))


def _rows(params: FusedTable, flat: torch.Tensor) -> torch.Tensor:
    return params.table.index_select(0, flat.reshape(-1)).reshape(
        *flat.shape, params.table.shape[1])


def _owned_rows(params: FusedTable, flat: torch.Tensor) -> torch.Tensor:
    """A rank's part of a lookup in a row-sharded table: its rows where
    it owns the id, zeros elsewhere, ``psum``-ed over the table's axes."""
    from ..core.collectives import psum_grad

    rules, mesh = activation_rules()
    axes = mesh.axes(tuple(a for a in rules["vocab"]
                           if mesh.shape.get(a, 1) > 1))
    n = params.table.shape[0]
    if axes.size * n != params.rows:
        raise ValueError(f"a block of {n} rows of {params.rows} does not "
                         f"split the table over {tuple(axes)}")
    local = flat - axes.index() * n
    own = (local >= 0) & (local < n)
    rows = _rows(params, torch.where(own, local, 0))
    return psum_grad(torch.where(own[..., None], rows, 0.0), axes)


def lookup_single(params: FusedTable, offsets, ids):
    """Single-hot per field: ids [B, n_fields] -> [B, n_fields, dim]."""
    off = torch.as_tensor(offsets, device=ids.device)
    flat = ids.long() + off[None, :]
    if params.table.shape[0] == params.rows:
        out = _rows(params, flat)
    else:
        out = _owned_rows(params, flat)
    return shard_activation(out, ("batch", None, None),
                            have=("batch", None, None))


def embedding_bag(params: FusedTable, offsets, ids, field_ids, bag_ids,
                  n_bags: int, mode: str = "sum"):
    """Multi-hot bags: ids [nnz], field_ids [nnz], bag_ids [nnz] ->
    [n_bags, dim]. mode in {sum, mean}."""
    off = torch.as_tensor(offsets, device=ids.device)
    vecs = _rows(params, ids.long() + off.index_select(0, field_ids.long()))
    bags = bag_ids.long()
    out = vecs.new_zeros((n_bags, vecs.shape[1])).index_add(0, bags, vecs)
    if mode == "mean":
        cnt = torch.zeros(n_bags, device=vecs.device).index_add(
            0, bags, torch.ones(bags.shape[0], device=vecs.device))
        out = out / torch.clamp_min(cnt[:, None], 1.0)
    elif mode != "sum":
        raise ValueError(f"unknown mode: {mode}")
    return out
