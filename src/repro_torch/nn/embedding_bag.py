"""EmbeddingBag for recsys (port of ``repro.nn.embedding_bag``).

One fused table holds every field's rows (FBGEMM-TBE style: all fields
concatenated, with a row offset per field). A lookup gathers rows with
``index_select``; a bag sums them with ``index_add`` in nnz order, which
on the CPU adds in the order of XLA's ``segment_sum`` scatter, bit for
bit. ``F.embedding_bag`` sums in an order of its own and is not used.
On the card ``index_add`` adds with atomics (bitwise the CPU's only under
``torch.use_deterministic_algorithms``).

JAX shards the table's rows over the model axis; here the table lives
whole on one device (``shard_activation`` is the identity).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .module import param, shard_activation


class FusedTable(nn.Module):
    """JAX's ``{"table": [sum(vocabs), dim]}``, ``0.01 * N(0, 1)``."""

    def __init__(self, field_vocabs, dim, generator, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        total = int(np.sum(field_vocabs))
        self.table = param((total, dim), generator, dtype, device, scale=0.01)


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


def lookup_single(params: FusedTable, offsets, ids):
    """Single-hot per field: ids [B, n_fields] -> [B, n_fields, dim]."""
    off = torch.as_tensor(offsets, device=ids.device)
    out = _rows(params, ids.long() + off[None, :])
    return shard_activation(out, ("batch", None, None))


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
