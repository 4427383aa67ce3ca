"""DCN-v2 [arXiv:2008.13535] — deep & cross network v2 for CTR (port of
``repro.models.dcn_v2``).

Assigned config: n_dense=13, n_sparse=26, embed_dim=16, n_cross_layers=3,
MLP 1024-1024-512, interaction=cross (full-rank W per cross layer:
x_{l+1} = x0 ⊙ (W x_l + b) + x_l).

The embedding lookup is the hot path: one fused table
(``nn.embedding_bag``), 35,900,000 rows at the full config. Its gradient
is dense, as JAX's is, so AdamW reads and writes every row.
``retrieval_scores`` scores a query batch against 10⁶ candidates as one
batched product and ``torch.topk`` (no loop).

Parameters are ``nn.Parameter``s under JAX's key names (``embed.table``,
``cross.w_0.kernel``, ``cross.w_0.bias``, ``mlp.w_0.kernel``,
``head.kernel``, ``retrieval_proj.kernel``) with JAX's logical axes: the
table ``("vocab", None)``, the cross and MLP kernels ``("embed",
"mlp")``, the head and ``retrieval_proj`` ``(None, None)``; the
per-field row offsets travel beside the model, as in JAX.

On a mesh of ranks (the rules and a ``Mesh`` installed, the model cut by
``nn.module.shard_params``) the same functions run a rank's share: the
batch rows over the data axes, the table's rows over ``model``
(``nn.embedding_bag``), each kernel gathered over ``data`` where its
``"embed"`` dim is sharded (FSDP, ``fsdp_param``), the MLP
column-parallel over ``model`` with ``("batch", "act_model")``
activations gathered back before the next product, and the head on the
gathered hidden state. ``retrieval_scores`` with ``cand_axes`` takes a
rank's block of the candidates, its local top ``k`` and merges the
ranks' ``(value, index)`` pairs into ``lax.top_k``'s top ``k``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..nn.embedding_bag import FusedTable, lookup_single, table_offsets
from ..nn.layers import Dense
from ..core.collectives import gather_rows
from ..nn.module import (
    activation_rules,
    fsdp_param,
    param,
    part_axes,
    set_axes,
    shard_activation,
    zeros,
)
from .gnn.common import build, model_from_jax

# Criteo-like heterogeneous vocabulary mix: 35,900,000 rows in all
CRITEO_VOCABS = tuple(
    [10_000_000] * 3 + [1_000_000] * 5 + [100_000] * 8 + [10_000] * 10
)


@dataclasses.dataclass(frozen=True)
class DCNv2Config:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: tuple = (1024, 1024, 512)
    field_vocabs: tuple = CRITEO_VOCABS
    retrieval_dim: int = 64

    @property
    def x0_dim(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


class Cross(nn.Module):
    """``{"kernel": [d0, d0], "bias": [d0]}``, the bias zeros at init."""

    def __init__(self, d0, generator, device):
        super().__init__()
        self.kernel = param((d0, d0), generator, device=device)
        self.bias = zeros((d0,), device=device)
        set_axes(self, kernel=("embed", "mlp"), bias=(None,))


class DCNv2(nn.Module):
    def __init__(self, cfg: DCNv2Config, generator, device):
        super().__init__()
        self.embed = FusedTable(cfg.field_vocabs, cfg.embed_dim, generator,
                                device=device)
        d0 = cfg.x0_dim
        self.cross = nn.ModuleDict({
            f"w_{i}": Cross(d0, generator, device)
            for i in range(cfg.n_cross_layers)})
        mlp = {}
        d_in = d0
        for i, d_out in enumerate(cfg.mlp):
            mlp[f"w_{i}"] = Dense((d_in, d_out), generator, device=device)
            d_in = d_out
        self.mlp = nn.ModuleDict(mlp)
        self.head = Dense((d_in, 1), generator, device=device,
                          axes=(None, None))
        self.retrieval_proj = Dense((d_in, cfg.retrieval_dim), generator,
                                    device=device, axes=(None, None))


def field_offsets(cfg: DCNv2Config, device) -> torch.Tensor:
    """Each field's first row in the fused table, int64 on ``device``."""
    return torch.as_tensor(table_offsets(np.asarray(cfg.field_vocabs)),
                           device=device)


def init(cfg: DCNv2Config, generator, device=None):
    """(model, offsets): seeded weights drawn from ``generator`` (on its
    own device) on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``; ``"meta"`` builds the shapes alone, with no generator);
    offsets int64 on the same device."""
    model = build(DCNv2, cfg, generator, device)
    return model, field_offsets(cfg, model.embed.table.device)


def params_from_jax(tree: dict, cfg: DCNv2Config, device=None):
    """(model, offsets) holding the values of JAX's unboxed parameter tree
    (nested dicts of numpy arrays). Checks every shape and that the tree
    holds no other leaf; every value is copied into the model's own
    storage."""
    model = model_from_jax(DCNv2, cfg, tree, device)
    return model, field_offsets(cfg, model.embed.table.device)


def features(params: DCNv2, cfg: DCNv2Config, batch, offsets):
    """batch: dense [B, 13] f32, sparse [B, 26] int -> x0 [B, x0_dim].
    The dense features are taken in the table's type (float32, as JAX
    casts them, unless the model was cast to float64 for a check)."""
    emb = lookup_single(params.embed, offsets, batch["sparse"])  # [B,26,16]
    dense = torch.log1p(torch.clamp_min(
        batch["dense"].to(params.embed.table.dtype), 0.0))
    x0 = torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=-1)
    return shard_activation(x0, ("batch", None), have=("batch", None))


FULL = ("batch", None)
COLS = ("batch", "act_model")


def _cols(params: DCNv2, name: str) -> tuple:
    """The layout of ``x @ kernel``: ``COLS`` where the kernel's columns
    are sharded over ``model`` on a mesh, else ``FULL``."""
    rules, mesh = activation_rules()
    specs = getattr(params, "shard_specs", None)
    if rules is None or mesh is None or specs is None:
        return FULL
    model = [a for a in part_axes(specs[name][1])
             if a in rules["act_model"] and mesh.shape.get(a, 1) > 1]
    return COLS if model else FULL


def interaction(params: DCNv2, cfg: DCNv2Config, x0):
    """Cross layers then MLP -> final hidden [B, mlp[-1]], in the
    layout ``("batch", "act_model")``."""
    x = x0
    for i in range(cfg.n_cross_layers):
        p = params.cross[f"w_{i}"]
        name = f"cross.w_{i}.kernel"
        y = shard_activation(x @ fsdp_param(params, name), FULL,
                             have=_cols(params, name))
        x = x0 * (y + p.bias) + x
    x = shard_activation(x, FULL, have=FULL)
    have = FULL
    for i in range(len(cfg.mlp)):
        name = f"mlp.w_{i}.kernel"
        x = shard_activation(x, FULL, have=have)
        x = torch.relu(x @ fsdp_param(params, name))
        x = shard_activation(x, COLS, have=_cols(params, name))
        have = COLS
    return x


def _hidden(params: DCNv2, cfg: DCNv2Config, batch, offsets):
    """The final hidden state, gathered to ``FULL``."""
    x0 = features(params, cfg, batch, offsets)
    return shard_activation(interaction(params, cfg, x0), FULL, have=COLS)


def forward(params: DCNv2, cfg: DCNv2Config, batch, offsets):
    """CTR logit [B]."""
    h = _hidden(params, cfg, batch, offsets)
    return (h @ params.head.kernel)[:, 0]


def loss_fn(params: DCNv2, cfg: DCNv2Config, batch, offsets):
    """JAX's numerically stable BCE with logits, written out:
    ``mean(max(z, 0) - z y + log1p(exp(-|z|)))``. ``torch.maximum``
    splits a tie's gradient in half, as ``jnp.maximum`` does."""
    return torch.mean(bce(forward(params, cfg, batch, offsets),
                          batch["labels"]))


def bce(logits, labels):
    """Each example's ``max(z, 0) - z y + log1p(exp(-|z|))``."""
    y = labels.float()
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * y
            + torch.log1p(torch.exp(-logits.abs())))


def query_embedding(params: DCNv2, cfg: DCNv2Config, batch, offsets):
    """Query tower for retrieval: [B, retrieval_dim], L2-normalized."""
    h = _hidden(params, cfg, batch, offsets)
    q = h @ params.retrieval_proj.kernel
    return q / torch.clamp_min(
        torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-9)


def retrieval_scores(params: DCNv2, cfg: DCNv2Config, batch, offsets,
                     cand_embeds, top_k: int = 100, cand_axes=None):
    """Score one query batch against [n_cand, retrieval_dim] candidates:
    one batched product and ``torch.topk`` -> (values, indices).

    ``cand_axes`` (mesh axes of size > 1): ``cand_embeds`` is this rank's
    block of the candidates over them (blocks in flat-coordinate order).
    Each rank then keeps its best ``top_k`` and the ranks' ``(value,
    global index)`` pairs are all-gathered and merged; ties go to the
    lower index, as ``lax.top_k`` breaks them."""
    q = query_embedding(params, cfg, batch, offsets)  # [B, d]
    scores = q @ cand_embeds.T  # [B, n_cand]
    if not cand_axes:
        scores = shard_activation(scores, COLS, have=COLS)
        return torch.topk(scores, top_k, dim=-1)
    vals, idx = _top_k(scores, top_k)
    idx = idx + cand_axes.index() * cand_embeds.shape[0]
    vals, idx = (gather_rows(t.contiguous(), cand_axes, 1)
                 for t in (vals, idx))
    best, pos = _top_k(vals, top_k)
    return best, torch.gather(idx, 1, pos)


def _top_k(x, k):
    """``lax.top_k``: the ``k`` largest of each row, ties to the lower
    index (a stable sort)."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]
