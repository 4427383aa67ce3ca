"""Per-cell steps of the GNN and recsys families (the GNN and recsys parts
of ``repro.launch.steps``).

GNN: ``gnn_cell(arch_id, shape_name)`` makes JAX's per-shape config change
(``_gnn_cell``): a ``full_graph`` cell reads raw node features (PNA: 40
classes, 47 on ``ogb_products``; the geometric archs project them into
their scalar channels and predict 8 outputs), a ``minibatch`` cell is a
sampled fanout tree whose seeds carry the loss (PNA: ``d_feat`` 100, 47
classes), a ``batched`` cell a disjoint union of small molecules read out
per graph (``graph_out``). ``make_train_step`` is the cell's train step:
the MSE of ``graph_out[:, 0]``, ``node_out[:seeds]`` or ``node_out``
against the targets, its gradient, and AdamW (``lr=1e-3``,
``weight_decay=0``, JAX's other defaults) in place. ``gnn_flops`` is
JAX's analytic count of a forward's dense contractions.

Recsys (``_recsys_cell``): ``recsys_cell(arch_id, shape_name)`` is
DCN-v2's full config at a ``RECSYS_SHAPES`` batch; its step is a train
step (the BCE loss, its gradient, AdamW as above, the fused table's
gradient dense over all its rows, as JAX's is), a serve step (the
logits) or a retrieval step (one query against seeded candidates, top
100). ``dcn_flops`` is JAX's ``_dcn_flops``; batches come from
``data.pipeline.RecsysStream``.

``build(arch_id, shape_name, generator, device)`` gives either family's
cell, model, AdamW state and step on ``device``.

Paper engine (``_paper_cell``): ``build_cell(arch_id, shape_name, mesh,
multi_pod)`` is JAX's entry point (for the LM family too, below). For
the ``paper`` family it makes
JAX's decisions one for one (row padding, policy, state layout, engine,
source morsels, model FLOPs, iteration scale, notes) on a ``Mesh`` of
ranks, whose cell holds the engine, or on a ``MeshLayout`` of JAX's
production meshes, whose cell holds the decisions only. Its arguments
are ``meta`` tensors (``sds``). Nothing is lowered: ``bind_cell`` binds
a cell to the shape's seeded graph and sources on a ``Mesh`` instead.

LM family (``_lm_cell``, ``lm_components``): JAX's decisions for every
cell under the logical-axis rules (``nn.module``): the remat choice and
``n_micro`` of a train cell, its moment type, every parameter's
sanitized spec (``_sanitize``, on ``meta`` tensors), the batch, cache
and optimizer specs, the decode cache's ``seq_axes``, FLOPs, notes and
donation. On a ``Mesh`` every arch's prefill, decode and train cells
run (``models.transformer_mesh``, MoE layers expert-parallel over
``model``; ``shard_lm`` cuts the model and the moments). The train step is JAX's ``train_step``: the global batch in
``n_micro`` contiguous blocks of rows, each block's rows over the data
axes, a rank's loss share and backward a block (the gradients summed in
float32 over the blocks and divided by ``n_micro`` when there are
several), the mean loss, and AdamW over the rank's blocks
(``_mesh_update``). An MoE layer's capacity and aux loss are a
microbatch's, as in JAX's scan. ``train_state`` and
``state_shardings`` give a cut model's train state in JAX's layout and
its tree of ``NamedSharding``: what the elastic checkpoint saves from
one mesh and restores onto another.

GNN and recsys cells on a mesh (``_gnn_cell``, ``_gnn_batch_specs``,
``_recsys_cell``): JAX's decisions for every cell (the config change,
``k_slabs``, ``n_pad``, ``e_pad``, every parameter's sanitized spec, the
batch and AdamW specs, the padded candidates, FLOPs, notes, donation);
on a ``MeshLayout`` the cells hold decisions only. On a ``Mesh`` ``fn``
runs a rank's share: the GNN train step over the destination-aligned
edge slabs (``models.gnn.common``), DCN-v2's train, serve, bulk and
retrieval steps. A rank's loss is its squared errors (or BCE terms)
over the global count and over the ranks that hold the same rows, so
the ranks' losses add up to JAX's; ``_mesh_update`` sums the gradients
over the axes a parameter's spec does not shard, takes the global norm
across the ranks' blocks and runs AdamW on the blocks. ``shard_gnn`` /
``shard_recsys`` cut a model; ``gnn_rank_batch`` (the real slab layout,
``slab_layout``) and ``recsys_rank_batch`` give a rank its batch.
``gnn_collective_schedule`` and ``recsys_collective_schedule`` count
what ``Wire`` records a step on a rank.

``cell_batch`` and ``recsys_batch`` make seeded batches of a cell's
shapes, for tests and the smoke run (JAX's cells carry abstract shapes
only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs import base as cfgbase
from ..core.dispatcher import build_engine, pad_sources
from ..core.policies import POLICIES
from ..data.pipeline import RecsysStream
from ..graph.csr import CSRGraph, EllGraph, ell_shard, truncate_csr
from ..graph.generators import erdos_renyi, pick_sources, powerlaw, rmat
from ..checkpoint.checkpoint import Stacked
from ..core.collectives import gather_rows, psum
from ..graph.partition import padded_n, slab_edges
from ..graph.sampler import tree_edges
from ..kernels.common import resolve_device
from .mesh import Mesh, all_axes, batch_axes
from ..models import dcn_v2 as dcn
from ..models import transformer as tfm
from ..models import transformer_mesh as tmesh
from ..models.transformer_mesh import decode_seq_axes
from ..nn.attention import KVCache
from ..nn.module import (
    NamedSharding,
    block_of,
    logical_to_spec,
    param_axes,
    part_axes,
    sanitize_spec,
    set_activation_rules,
    shard_params,
    sharding_rules,
    specs_from_axes,
    using_rules,
)
from ..models.gnn import common as gnn_common
from ..optim.adamw import AdamWState
from ..models.gnn import equiformer_v2 as eqv2_m
from ..models.gnn import mace as mace_m
from ..models.gnn import pna as pna_m
from ..models.gnn import schnet as schnet_m
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update

GNN_MODULES = {
    "mace": mace_m,
    "equiformer-v2": eqv2_m,
    "pna": pna_m,
    "schnet": schnet_m,
}
GNN_ADAMW = AdamWConfig(lr=1e-3, weight_decay=0.0)


def gnn_flops(arch_id, cfg, n, e):
    """Analytic useful FLOPs for one forward pass (JAX's ``_gnn_flops``:
    documented approximations, 2 FLOPs per MAC). GNN message passing is
    gather/scatter-bound, so these count only the dense contractions."""
    d = cfg.d_hidden
    if arch_id == "pna":
        # per layer: 12 aggregated features of width d -> d (tower MLP) on
        # nodes + per-edge message transform d->d
        per = 2.0 * e * d * d + 2.0 * n * (12 * d) * d
        return cfg.n_layers * per + 2.0 * n * cfg.d_feat * d
    if arch_id == "schnet":
        # interaction: edge filter (n_rbf->d->d) + node d->d mixes
        per = 2.0 * e * (cfg.n_rbf * d + d * d) + 3 * 2.0 * n * d * d
        return cfg.n_interactions * per
    if arch_id == "mace":
        lm = (cfg.l_max + 1) ** 2
        # A-basis: edges contract rbf.Y.h (d.lm each); product basis:
        # correlation-order Gaunt contractions on nodes (lm^2.d per order)
        per = 2.0 * e * d * lm * (cfg.n_rbf + lm) + (
            2.0 * n * d * lm * lm * cfg.correlation_order
        ) + 2.0 * n * d * d * lm
        return cfg.n_layers * per
    if arch_id == "equiformer-v2":
        lm = (cfg.l_max + 1) ** 2
        m_width = 2 * cfg.m_max + 1
        # eSCN SO(2) conv per edge: O(lm * m_width * d^2) after alignment,
        # + attention scores/values per edge
        per = 2.0 * e * (lm * m_width * d * d / max(cfg.l_max, 1) + 2 * d * d)
        per += 2.0 * n * d * d * 4  # node FFN
        return cfg.n_layers * per
    raise ValueError(arch_id)


@dataclasses.dataclass(frozen=True)
class GnnCell:
    arch_id: str
    shape_name: str
    kind: str  # full_graph | minibatch | batched
    cfg: object
    n_nodes: int
    n_edges: int
    seeds: Optional[int] = None  # minibatch: the loss reads these nodes
    n_graphs: Optional[int] = None  # batched: graph_out rows
    graph_size: Optional[tuple] = None  # batched: (nodes, edges) a graph
    fanout: Optional[tuple] = None  # minibatch

    @property
    def geometric(self) -> bool:
        return self.arch_id != "pna"

    @property
    def flops(self) -> float:
        """A train step's model FLOPs: 3 x the forward's (JAX's cell)."""
        return 3.0 * gnn_flops(self.arch_id, self.cfg, self.n_nodes,
                               self.n_edges)


def gnn_cell(arch_id: str, shape_name: str, smoke: bool = False,
             dims: Optional[dict] = None) -> GnnCell:
    """JAX's ``_gnn_cell`` config change for one (arch, shape) on one
    device (no padding to a mesh). ``smoke`` starts from the smoke
    config; ``dims`` overrides the shape's dimensions (a smaller cell of
    the same kind)."""
    spec = cfgbase.get(arch_id)
    if spec.family != "gnn":
        raise ValueError(f"{arch_id} is not a GNN arch")
    shape = next(s for s in spec.shapes if s.name == shape_name)
    d = {**shape.dims, **(dims or {})}
    cfg = spec.smoke_config() if smoke else spec.full_config()
    pna = arch_id == "pna"
    if shape.kind == "full_graph":
        if pna:
            n_out = 47 if shape_name == "ogb_products" else 40
            cfg = dataclasses.replace(cfg, d_feat=d["d_feat"], n_out=n_out)
        else:
            cfg = dataclasses.replace(cfg, d_feat=d["d_feat"], n_out=8)
        return GnnCell(arch_id, shape_name, shape.kind, cfg, d["n_nodes"],
                       d["n_edges"])
    if shape.kind == "minibatch":
        bn = d["batch_nodes"]
        f1, f2 = d["fanout"]
        cfg = (dataclasses.replace(cfg, d_feat=100, n_out=47) if pna
               else dataclasses.replace(cfg, n_out=8))
        return GnnCell(arch_id, shape_name, shape.kind, cfg,
                       bn * (1 + f1 + f1 * f2), bn * (f1 + f1 * f2),
                       seeds=bn, fanout=(f1, f2))
    assert shape.kind == "batched"
    bsz, npg, epg = d["batch"], d["n_nodes"], d["n_edges"]
    cfg = (dataclasses.replace(cfg, d_feat=16, n_out=1) if pna
           else dataclasses.replace(cfg, n_out=1))
    return GnnCell(arch_id, shape_name, shape.kind, cfg, bsz * npg,
                   bsz * epg, n_graphs=bsz, graph_size=(npg, epg))


def init_model(cell: GnnCell, generator, device=None):
    """The cell's model, seeded from ``generator``, with gradients on."""
    model = GNN_MODULES[cell.arch_id].init(cell.cfg, generator, device)
    return model.requires_grad_(True)


def params_dict(model) -> dict:
    """The parameters keyed by dotted name in JAX's tree order (keys
    sorted at every level), the order AdamW's global norm adds them."""
    named = dict(model.named_parameters())
    return {k: named[k] for k in sorted(named, key=lambda k: k.split("."))}


def loss_fn(cell: GnnCell, model, batch):
    """MSE of the cell's prediction against ``batch["targets"]``."""
    b = dict(batch)
    targets = b.pop("targets")
    if cell.n_graphs is not None:
        b["n_graphs"] = cell.n_graphs
    out = GNN_MODULES[cell.arch_id].apply(model, cell.cfg, b)
    if cell.n_graphs is not None:
        pred = out["graph_out"][:, 0]
    elif cell.seeds is not None:
        pred = out["node_out"][:cell.seeds]
    else:
        pred = out["node_out"]
    return torch.mean(torch.square(pred - targets))


def make_train_step(cell: GnnCell):
    """``train_step(model, opt, batch) -> (model, opt, loss, grad_norm)``:
    the loss and its gradient, AdamW on the parameters and moments in
    place, then the gradients set to None."""

    def train_step(model, opt, batch):
        loss = loss_fn(cell, model, batch)
        loss.backward()
        params = params_dict(model)
        _, opt, gnorm = adamw_update({k: p.grad for k, p in params.items()},
                                     opt, params, GNN_ADAMW)
        for p in params.values():
            p.grad = None
        return model, opt, loss.detach(), gnorm

    return train_step


def build(arch_id: str, shape_name: str, generator, device=None,
          smoke: bool = False, dims: Optional[dict] = None):
    """(cell, model, AdamW state, step) on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``; raises without a GPU). A GNN cell's step is
    its train step; a recsys cell's is its train, serve or retrieval
    step (``recsys_step``), with no AdamW state (None) unless it trains."""
    dev = resolve_device(device)
    if cfgbase.get(arch_id).family == "recsys":
        return _build_recsys(arch_id, shape_name, generator, dev, smoke,
                             dims)
    cell = gnn_cell(arch_id, shape_name, smoke, dims)
    model = init_model(cell, generator, dev)
    return cell, model, adamw_init(params_dict(model), GNN_ADAMW), \
        make_train_step(cell)


def _edges(rng, n: int, e: int):
    """``e`` edges over ``n`` nodes with no self-loop: a ring through a
    random order of the nodes first (every node has an in-edge), then
    uniform ones."""
    ring = min(n, e)
    order = rng.permutation(n)[:ring]
    src = [order, rng.integers(0, n, e - ring)]
    dst = [np.roll(order, -1), None]
    dst[1] = (src[1] + rng.integers(1, n, e - ring)) % n
    return (np.concatenate(src).astype(np.int32),
            np.concatenate(dst).astype(np.int32))


def cell_batch(cell: GnnCell, seed: int = 0) -> dict:
    """A seeded numpy batch of the cell's shapes. Edges have no self-loop
    and reach every node (``batched``: within each molecule), as in
    molecules and citation graphs; a ``minibatch`` cell's edges are its
    fanout tree's (child -> parent, as ``graph.sampler`` lays them out).
    Standard-normal node features and targets; for the geometric archs
    positions ``2 * N(0, 1)`` and species below ``n_species``."""
    rng = np.random.default_rng(seed)
    n, e, cfg = cell.n_nodes, cell.n_edges, cell.cfg
    if cell.kind == "batched":
        npg, epg = cell.graph_size
        parts = [_edges(rng, npg, epg) for _ in range(cell.n_graphs)]
        off = np.repeat(np.arange(cell.n_graphs, dtype=np.int32) * npg, epg)
        src = np.concatenate([p[0] for p in parts]) + off
        dst = np.concatenate([p[1] for p in parts]) + off
    elif cell.kind == "minibatch":
        src, dst = (t.numpy() for t in tree_edges(cell.seeds, cell.fanout))
    else:
        src, dst = _edges(rng, n, e)
    batch = {"edge_src": src, "edge_dst": dst}
    if cfg.d_feat:
        batch["node_feat"] = rng.standard_normal(
            (n, cfg.d_feat)).astype(np.float32)
    if cell.geometric:
        batch["positions"] = (2.0 * rng.standard_normal((n, 3))).astype(
            np.float32)
        batch["species"] = rng.integers(0, cfg.n_species, n).astype(
            np.int32)
    if cell.n_graphs is not None:
        batch["graph_ids"] = np.repeat(np.arange(cell.n_graphs),
                                       cell.graph_size[0]).astype(np.int32)
        batch["targets"] = rng.standard_normal(cell.n_graphs).astype(
            np.float32)
    else:
        rows = cell.seeds if cell.seeds is not None else n
        batch["targets"] = rng.standard_normal(
            (rows, cfg.n_out)).astype(np.float32)
    return batch


def batch_to(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    dev = torch.device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


# =========================================================================
# recsys (dcn-v2)
# =========================================================================

RECSYS_ADAMW = AdamWConfig(lr=1e-3, weight_decay=0.0)
RETRIEVAL_TOP_K = 100


def dcn_flops(cfg, B, fwd_only=False):
    """JAX's ``_dcn_flops``: the cross layers', MLP's and head's
    products (2 FLOPs a MAC) and the embedding bag's adds; a train step
    is 3 x the forward."""
    d0 = cfg.x0_dim
    f = 2.0 * B * d0 * d0 * cfg.n_cross_layers
    d_in = d0
    for d_out in cfg.mlp:
        f += 2.0 * B * d_in * d_out
        d_in = d_out
    f += 2.0 * B * d_in  # head
    # embedding gather ~ bytes not flops; count the segment adds
    f += B * cfg.n_sparse * cfg.embed_dim
    return f if fwd_only else 3.0 * f


@dataclasses.dataclass(frozen=True)
class RecsysCell:
    arch_id: str
    shape_name: str
    kind: str  # train | serve | bulk | retrieval
    cfg: object
    batch: int
    n_candidates: Optional[int] = None  # retrieval

    @property
    def flops(self) -> float:
        """JAX's cell FLOPs: 3 x the forward's for a train step, the
        forward's for a serve step, plus the candidates' scores for a
        retrieval step."""
        if self.kind == "train":
            return dcn_flops(self.cfg, self.batch)
        f = dcn_flops(self.cfg, self.batch, fwd_only=True)
        if self.kind == "retrieval":
            f += 2.0 * self.batch * self.n_candidates * self.cfg.retrieval_dim
        return f


def recsys_cell(arch_id: str, shape_name: str, smoke: bool = False,
                dims: Optional[dict] = None) -> RecsysCell:
    """JAX's ``_recsys_cell`` on one device (the candidates not padded to
    a mesh): the full config (``smoke``: the smoke config) at the shape's
    batch; ``dims`` overrides the shape's dimensions."""
    spec = cfgbase.get(arch_id)
    if spec.family != "recsys":
        raise ValueError(f"{arch_id} is not a recsys arch")
    shape = next(s for s in spec.shapes if s.name == shape_name)
    d = {**shape.dims, **(dims or {})}
    cfg = spec.smoke_config() if smoke else spec.full_config()
    return RecsysCell(arch_id, shape_name, shape.kind, cfg, d["batch"],
                      d.get("n_candidates"))


def recsys_step(cell: RecsysCell, offsets):
    """The cell's step over a ``dcn_v2`` model and its ``offsets``:

    - train: ``(model, opt, batch) -> (model, opt, loss, grad_norm)``,
      AdamW (``RECSYS_ADAMW``, clipping at 1.0) on every parameter in
      place, a parameter the loss does not reach (``retrieval_proj``)
      with a zero gradient as in JAX, then the gradients set to None;
    - serve, bulk: ``(model, batch) -> logits [B]``;
    - retrieval: ``(model, batch, candidates) -> (scores, indices)`` of
      the top ``RETRIEVAL_TOP_K``.
    """
    cfg = cell.cfg
    if cell.kind == "train":
        def train_step(model, opt, batch):
            loss = dcn.loss_fn(model, cfg, batch, offsets)
            loss.backward()
            params = params_dict(model)
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p))
                     for k, p in params.items()}
            _, opt, gnorm = adamw_update(grads, opt, params, RECSYS_ADAMW)
            for p in params.values():
                p.grad = None
            return model, opt, loss.detach(), gnorm

        return train_step
    if cell.kind in ("serve", "bulk"):
        @torch.no_grad()
        def serve_step(model, batch):
            return dcn.forward(model, cfg, batch, offsets)

        return serve_step
    assert cell.kind == "retrieval"

    @torch.no_grad()
    def retrieval_step(model, batch, cand):
        return dcn.retrieval_scores(model, cfg, batch, offsets, cand,
                                    RETRIEVAL_TOP_K)

    return retrieval_step


def _build_recsys(arch_id, shape_name, generator, dev, smoke, dims):
    cell = recsys_cell(arch_id, shape_name, smoke, dims)
    model, offsets = dcn.init(cell.cfg, generator, dev)
    opt = None
    if cell.kind == "train":
        model.requires_grad_(True)
        opt = adamw_init(params_dict(model), RECSYS_ADAMW)
    return cell, model, opt, recsys_step(cell, offsets)


def recsys_batch(cell: RecsysCell, step: int = 0, seed: int = 0) -> dict:
    """Step ``step`` of ``RecsysStream`` at the cell's batch (numpy: dense
    [B, 13] float32, sparse [B, 26] int32 and, for a train cell, labels
    [B] int32)."""
    b = RecsysStream(cell.cfg.field_vocabs, cell.batch,
                     n_dense=cell.cfg.n_dense, seed=seed).batch(step)
    if cell.kind != "train":
        del b["labels"]
    return b


def retrieval_candidates(cell: RecsysCell, generator) -> torch.Tensor:
    """``[n_candidates, retrieval_dim]`` standard-normal float32 candidate
    embeddings drawn from ``generator``, on its device."""
    return torch.randn((cell.n_candidates, cell.cfg.retrieval_dim),
                       generator=generator, device=generator.device)


# =========================================================================
# paper engine (the paper's own contribution at published graph scale)
# =========================================================================


@dataclasses.dataclass
class Cell:
    """One (arch, shape) cell on a mesh: JAX's fields (``in_shardings``,
    ``prejitted``, ``donate`` and ``out_shardings`` carry their defaults;
    nothing is jitted or lowered), plus what the port's binder and
    dry-run read: the engine config, the shape's dims and the cell's
    decisions."""

    arch_id: str
    shape_name: str
    kind: str
    fn: Optional[Callable]  # engine(graph, morsels) on a Mesh; None on a layout
    args: tuple  # meta-device tensors: (EllGraph, morsels)
    in_shardings: Any  # None: the engine places its own shards
    model_flops: float  # analytic useful FLOPs per step execution
    iters_scale: float = 1.0  # roofline multiplier for dynamic while bodies
    notes: str = ""
    prejitted: bool = False
    donate: tuple = ()
    out_shardings: Any = None
    config: Any = None
    dims: Optional[dict] = None
    decisions: Optional[dict] = None


def sds(shape, dtype) -> torch.Tensor:
    """An abstract argument: a ``meta``-device tensor (shape and dtype,
    no storage), the port's ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _axes_size(mesh, axes) -> int:
    return int(math.prod(mesh.shape[a] for a in axes)) if axes else 1


def _paper_cell(spec, shape, mesh, multi_pod: bool,
                state_layout: str | None = None,
                or_impl: str | None = None) -> Cell:
    """JAX's ``_paper_cell``, decision for decision. On a ``Mesh`` the
    cell's ``fn`` is the engine; on a ``MeshLayout`` (no ranks) it is
    None and ``notes`` says why."""
    cfg = spec.full_config()
    dims = shape.dims
    n, avg_deg = dims["n_nodes"], dims["avg_degree"]
    sa = batch_axes(multi_pod)
    ga = ("model",)
    or_impl = or_impl or cfg.or_impl
    policy = POLICIES[cfg.policy](
        source_axes=sa, graph_axes=ga, or_impl=or_impl
    )
    shards = _axes_size(mesh, ga)
    n_pad = padded_n(n, shards, block=32)
    max_deg = cfg.max_deg_cap
    # memory-driven default: replicated per-node state for a 64-lane morsel
    # is 3·64 B/node, its contribution 4·64 B/node (JAX's count); past 8 GB
    # the sharded-state engine takes over
    if state_layout is None:
        lanes = policy.lanes if policy.is_multi_source else 1
        repl_bytes = n_pad * (3 * lanes + 4 * lanes)  # state + contribution
        state_layout = "sharded" if repl_bytes > 8e9 else "replicated"
    src_shards = _axes_size(mesh, sa)
    morsels_shape = pad_sources(
        np.arange(cfg.n_sources, dtype=np.int32), src_shards,
        policy.lanes, n_pad,
    ).shape
    graph = EllGraph(
        indices=sds((n_pad, max_deg), torch.int32),
        degrees=sds((n_pad,), torch.int32),
        weights=None,
    )
    morsels = sds(morsels_shape, torch.int32)
    lanes = policy.lanes
    # useful work: one edge visit per lane per scanned edge per iteration;
    # expected iterations ~ BFS diameter (cfg.max_iters caps it)
    edges_scanned = n * min(avg_deg, max_deg)
    flops = 2.0 * edges_scanned * lanes
    notes = (
        f"policy={policy.name} or={or_impl} state={state_layout} "
        f"lanes={lanes} n_pad={n_pad} max_deg={max_deg}"
    )
    fn = None
    if isinstance(mesh, Mesh):
        fn = build_engine(
            mesh, policy, cfg.edge_compute, n_pad, cfg.max_iters,
            state_layout=state_layout, extend="ell_push",
        )
    else:
        notes += (f" (fn=None: a layout of {mesh.size} ranks, which one "
                  "process cannot hold; run the cell on a Mesh)")
    return Cell(
        spec.arch_id, f"{shape.name}", "query", fn,
        (graph, morsels), None, flops,
        iters_scale=float(cfg.max_iters),
        notes=notes,
        config=cfg,
        dims=dict(dims),
        decisions=dict(
            policy=policy.name, or_impl=or_impl, state_layout=state_layout,
            lanes=lanes, n_pad=n_pad, max_deg=max_deg,
            source_shards=src_shards, graph_shards=shards,
            n_morsels=int(morsels_shape[0]),
            edge_compute=cfg.edge_compute, max_iters=cfg.max_iters,
        ),
    )


# =========================================================================
# LM family
# =========================================================================

# microbatch counts tuned against measured single-shot activation temps
_N_MICRO = {
    "deepseek-coder-33b": 4,
    "olmoe-1b-7b": 4,
    "llama4-maverick-400b-a17b": 8,
}


def _ns(*parts) -> tuple:
    """A spec: JAX's ``PartitionSpec(*parts)``, which writes an entry of
    one axis name as the name."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


def _sanitize(params: dict, specs: dict, mesh) -> dict:
    """JAX's ``_sanitize``: drop the spec of any parameter dim that does
    not divide its mesh axes (``nn.module.sanitize_spec``)."""
    return {n: sanitize_spec(tuple(params[n].shape), specs[n], mesh.shape)
            for n in params}


def _lm_abstract_params(cfg, mesh, rules):
    """(``{name: meta tensor}``, ``{name: sanitized spec}``) of the
    model ``cfg`` (built on ``meta``: any size, nothing allocated)."""
    return _param_specs(tfm.init(cfg, None, "meta"), mesh, rules)


def _lm_attn_flops(cfg, B, S, causal=True, cache_w=None):
    """Attention matmul FLOPs (QK^T + PV), fwd only, all layers.

    cache_w: decode mode, per-token attention against a W-deep cache."""
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if cache_w is not None:
            w_eff = min(cfg.window, cache_w) if kind in ("local", "chunk") \
                else cache_w
            total += 4.0 * B * w_eff * cfg.n_heads * cfg.d_head
        else:
            s_eff = min(cfg.window, S) if kind in ("local", "chunk") else S
            # causal ~ half the S x s_eff rectangle
            total += 4.0 * B * S * s_eff * cfg.n_heads * cfg.d_head * (
                0.5 if causal else 1.0
            )
    return total


def _moment_dtype(cfg):
    # llama4-maverick's 400B total params need bf16 moments to fit
    return torch.bfloat16 if cfg.total_params() > 1e11 else torch.float32


def _cache_specs(cfg, cache_batch, seq_axes) -> list:
    """One ``KVCache`` of specs a layer (JAX's less the group dim)."""
    kv = _ns(cache_batch, seq_axes, None, None)
    return [KVCache(k=kv, v=kv, slot_pos=_ns(seq_axes))
            for _ in range(cfg.n_layers)]


def _run_rules(rules: dict, B: int, mesh, ba) -> dict:
    """The rules a runnable cell installs: JAX's, with the batch left
    replicated where it does not divide the data axes (GSPMD pads it; the
    port's tensors are whole blocks)."""
    if B % _axes_size(mesh, ba):
        return dict(rules, batch=())
    return rules


def _lm_cell(spec, shape, mesh, multi_pod) -> Cell:
    """JAX's ``_lm_cell``, decision for decision. On a ``MeshLayout`` the
    cell holds decisions only (``fn=None``). On a ``Mesh`` the cell
    runs the rank's part (``models.transformer_mesh``): ``fn(params,
    tokens, max_seq=None, route=None)``, ``fn(params,
    caches, tokens, pos)`` and ``fn(params, opt, batch) -> (params, opt,
    loss, grad_norm)`` take the rank's parameter and moment blocks
    (``shard_lm``), its cache blocks and the global tokens or batch
    (each rank takes its block), and return the rank's blocks
    (``decisions["out_specs"]``; a train step updates the blocks in
    place and returns JAX's global loss and norm)."""
    cfg = spec.full_config()
    dims = shape.dims
    B, S = dims["global_batch"], dims["seq_len"]
    n_micro = _N_MICRO.get(spec.arch_id, 1)
    if shape.kind == "train":
        # launcher policy (not part of the published arch configs):
        # "minimal" named remat saves the two d_model-wide sublayer
        # outputs per layer; for deep/wide models even those stacks exceed
        # HBM, so fall back to carry-only ("full") remat
        dp = 16  # data-axis width (both meshes)
        saved = (3 * cfg.n_layers * (B // dp // n_micro) * (S // 16)
                 * cfg.d_model * 2)
        cfg = dataclasses.replace(
            cfg, remat="full" if saved > 6e9 else "minimal")
    runnable = isinstance(mesh, Mesh)
    # train/prefill: sequence-parallel residual stream; decode: TP
    rules = sharding_rules(multi_pod,
                           seq_parallel=shape.kind in ("train", "prefill"))
    set_activation_rules(rules)  # as JAX's; a runnable fn adds its mesh
    params, pshard = _lm_abstract_params(cfg, mesh, rules)
    ba = batch_axes(multi_pod)
    N = cfg.active_params()
    run_rules = _run_rules(rules, B, mesh, ba)
    seq_axes, cache_batch = decode_seq_axes(B, mesh.shape, ba)
    decisions = dict(seq_parallel=shape.kind in ("train", "prefill"),
                     remat=cfg.remat, batch_axes=ba,
                     fn=None if runnable else _layout_note(mesh))

    if shape.kind == "train":
        ocfg = AdamWConfig(lr=3e-4, moment_dtype=_moment_dtype(cfg))
        opt = adamw_init(params, ocfg)
        opt_shard = AdamWState(step=_ns(), mu=pshard, nu=pshard)
        batch = {"tokens": sds((B, S), torch.int32),
                 "labels": sds((B, S), torch.int32)}
        bshard = {k: _ns(ba, None) for k in batch}
        decisions.update(n_micro=n_micro, moment_dtype=str(
            ocfg.moment_dtype).split(".")[-1])
        flops = 6.0 * N * (B * S) + 3.0 * _lm_attn_flops(cfg, B, S)
        fn = (_lm_mesh_step(cfg, mesh, rules, n_micro, ocfg) if runnable
              else None)
        return Cell(
            spec.arch_id, shape.name, "train", fn,
            (params, opt, batch), (pshard, opt_shard, bshard), flops,
            notes=f"6ND={6.0 * N * B * S:.3e} n_micro={n_micro}",
            donate=(0, 1), config=cfg, dims=dict(dims),
            decisions=decisions,
        )

    if shape.kind == "prefill":
        tokens = sds((B, S), torch.int32)
        fn = None
        if runnable:
            def fn(params, tokens, max_seq=None, route=None):
                with using_rules(run_rules, mesh):
                    return tmesh.prefill(
                        params, cfg, _rows(tokens, run_rules, mesh),
                        max_seq=max_seq or S, route=route,
                        seq_axes=seq_axes)
        decisions.update(seq_axes=seq_axes, cache_batch=cache_batch,
                         out_specs=(_ns(run_rules["batch"] or None,
                                        "model"),
                                    _cache_specs(cfg, cache_batch,
                                                 seq_axes)))
        flops = 2.0 * N * (B * S) + _lm_attn_flops(cfg, B, S)
        return Cell(
            spec.arch_id, shape.name, "prefill", fn,
            (params, tokens), (pshard, _ns(ba, None)), flops,
            config=cfg, dims=dict(dims), decisions=decisions,
        )

    # decode: one new token against a seq_len-deep KV cache, its sequence
    # dim sharded over "model" (decode_32k) or over ALL axes (long_500k,
    # batch 1): flash-decoding-style distributed attention
    if shape.kind != "decode":
        raise ValueError(shape.kind)
    caches = tfm.init_model_cache(cfg, B, S, torch.bfloat16, "meta")
    cache_shard = _cache_specs(cfg, cache_batch, seq_axes)
    tokens = sds((B, 1), torch.int32)
    pos = sds((), torch.int32)
    fn = None
    if runnable:
        def fn(params, caches, tokens, pos):
            with using_rules(run_rules, mesh):
                return tmesh.decode(params, cfg, caches,
                                    _rows(tokens, run_rules, mesh),
                                    int(pos), seq_axes=seq_axes)
    decisions.update(seq_axes=seq_axes, cache_batch=cache_batch,
                     out_specs=(_ns(run_rules["batch"] or None, None,
                                    "model"), cache_shard))
    flops = 2.0 * N * B + _lm_attn_flops(cfg, B, None, cache_w=S)
    return Cell(
        spec.arch_id, shape.name, "decode", fn,
        (params, caches, tokens, pos),
        (pshard, cache_shard, _ns(cache_batch, None), _ns()),
        flops,
        notes=f"KV cache W={S}, seq sharded over {seq_axes}",
        donate=(1,), config=cfg, dims=dict(dims), decisions=decisions,
    )


def _rows(tokens: torch.Tensor, rules: dict, mesh) -> torch.Tensor:
    """This rank's rows of the global ``tokens`` under ``rules``."""
    return block_of(tokens, logical_to_spec(("batch", None), rules), mesh)


def _lm_mesh_step(cfg, mesh, rules: dict, n_micro: int, ocfg):
    """JAX's ``train_step`` of ``_lm_cell`` as a rank's share: each of
    the ``n_micro`` contiguous row blocks of the global batch, the
    rank's rows of it (``_rows``), its loss share's backward; the
    gradients of several blocks summed in float32 and divided by
    ``n_micro``; the losses' global mean; AdamW on the blocks."""
    every = mesh.axes(_live_axes(mesh, mesh.axis_names))
    data = _axes_size(mesh, _live_axes(mesh, rules["batch"]))

    def train_step(model, opt, batch):
        B = batch["tokens"].shape[0]
        if B % (n_micro * data):
            raise ValueError(f"a global batch of {B} rows does not split "
                             f"into n_micro={n_micro} microbatches over "
                             f"the data axes' {data} ranks")
        rows = B // n_micro
        params = params_dict(model)
        acc, shares = None, []
        with using_rules(rules, mesh):
            for i in range(n_micro):
                share = tmesh.loss_fn(model, cfg, {
                    k: _rows(v[i * rows:(i + 1) * rows], rules, mesh)
                    for k, v in batch.items()})
                share.backward()
                shares.append(share.detach())
                if n_micro > 1:
                    g = _take_grads(params)
                    acc = ({k: v.float() for k, v in g.items()} if acc is None
                           else {k: acc[k].add_(v) for k, v in g.items()})
            grads = (None if acc is None
                     else {k: v / n_micro for k, v in acc.items()})
            loss = psum(torch.stack(shares), every).mean()
            opt, gnorm = _mesh_update(model, opt, ocfg, mesh, grads)
        return model, opt, loss, gnorm

    return train_step


def shard_lm(cell: Cell, model, mesh, opt: Optional[AdamWState] = None):
    """Cut ``model`` (the cell's full config, whole) to this rank's
    blocks under the cell's rules, in place, and ``opt``'s moments
    (whole, keyed like the parameters) alike; the specs must be the
    cell's."""
    rules = sharding_rules(len(cell.decisions["batch_axes"]) > 1,
                           cell.decisions["seq_parallel"])
    specs = shard_params(model, mesh, rules)
    if specs != cell.in_shardings[0]:
        raise ValueError("the model's specs are not the cell's")
    if opt is not None:
        for moments in (opt.mu, opt.nu):
            for k, v in moments.items():
                moments[k] = block_of(v, specs[k], mesh).clone()
    return model


def train_state(model, opt: AdamWState) -> dict:
    """JAX's train state ``{"params", "opt": AdamWState(step, mu, nu)}``
    holding the model's and the optimizer's own tensors (a rank's blocks
    on a mesh): what ``CheckpointManager`` saves and restores in place.
    An LM's is ``transformer.state_tree`` (block leaves ``Stacked`` by
    group); another model's nests its dotted parameter names."""
    if isinstance(model, tfm.Transformer):
        return tfm.state_tree(model, opt)
    nest = gnn_common.named_tree
    return {"params": nest(dict(model.named_parameters())),
            "opt": AdamWState(opt.step, nest(opt.mu), nest(opt.nu))}


def state_shardings(model, mesh) -> dict:
    """The tree of ``train_state(model, opt)`` with a ``NamedSharding``
    on ``mesh`` at every leaf, from ``model.shard_specs`` (``shard_lm``,
    ``shard_gnn`` or ``shard_recsys``): the parameters' and both
    moments' specs alike, a ``Stacked`` leaf's with its group dim
    first, the step replicated. What ``CheckpointManager.save`` and
    ``restore`` take as ``shardings`` on that mesh."""
    specs = model.shard_specs
    if isinstance(model, tfm.Transformer):
        tree = tfm.named_tree(model.cfg, specs)
    else:
        tree = gnn_common.named_tree(specs)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, Stacked):
            if len(set(x.tensors)) != 1:
                raise ValueError(f"a stacked leaf's groups have specs "
                                 f"{set(x.tensors)}")
            return NamedSharding(mesh, (None, *x.tensors[0]))
        return NamedSharding(mesh, x)

    params = leaf(tree)
    return {"params": params,
            "opt": AdamWState(NamedSharding(mesh, ()), params, params)}


def lm_components(arch_id: str, shape_name: str, mesh,
                  multi_pod: bool) -> list:
    """JAX's compositional roofline probes for LM cells: each component
    a cell with a static trip multiplier (``iters_scale``), its
    arguments (``meta``) and specs, one group's parameters with JAX's
    ``"stack"`` dim dropped (the port's ``blocks.{j}``, ``j <
    group_size``). Summing trips x terms (``dryrun.run_components``)
    gives the step's cost:

      train:   n_groups x layer_group(fwd+bwd) + (S/ce_chunk) x ce_chunk
               + 1 x optimizer update (+ embedding, folded into ce/opt)
      prefill: n_groups x layer_group(fwd)     + 1 x unembed(last position)
      decode:  n_groups x decode_group         + 1 x unembed(one token)

    The port lowers nothing: ``fn`` is None, and ``decisions`` names the
    component for the dry-run's analytic count."""
    spec = cfgbase.get(arch_id)
    shape = {s.name: s for s in spec.shapes}[shape_name]
    cfg = spec.full_config()
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat="minimal")
    rules = sharding_rules(multi_pod,
                           seq_parallel=shape.kind in ("train", "prefill"))
    set_activation_rules(rules)
    params, pshard = _lm_abstract_params(cfg, mesh, rules)
    ba = batch_axes(multi_pod)
    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    G = cfg.n_groups
    group = [n for n in params
             if n.startswith("blocks.")
             and int(n.split(".")[1]) < cfg.group_size]
    gparams = {n: params[n] for n in group}
    gshard = {n: pshard[n] for n in group}
    unemb_key = "embed" if cfg.tie_embeddings else "unembed"
    emb = params[f"{unemb_key}.table"]
    emb_sh = pshard[f"{unemb_key}.table"]
    res_sharding = _ns(
        ba, "model" if shape.kind in ("train", "prefill") else None, None)

    def comp(key, args, shardings, trips, notes, donate=(), out=None):
        return Cell(arch_id, shape_name, "comp", None, args, shardings,
                    0.0, iters_scale=float(trips), notes=notes,
                    donate=donate, out_shardings=out, config=cfg,
                    dims=dict(shape.dims),
                    decisions=dict(component=key, batch_axes=ba))

    comps = []
    if shape.kind in ("train", "prefill"):
        x = sds((B, S, cfg.d_model), cfg.dtype)
        pos = sds((B, S), torch.int32)
        if shape.kind == "train":
            comps.append(comp(
                "layer_group_fwd_bwd", (gparams, x, pos),
                (gshard, res_sharding, _ns(ba, None)), G,
                "layer_group fwd+bwd", out=(gshard, res_sharding)))
            C = min(cfg.ce_chunk, S)
            comps.append(comp(
                "ce_chunk", (emb, sds((B, C, cfg.d_model), cfg.dtype),
                             sds((B, C), torch.int32)),
                (emb_sh, res_sharding, _ns(ba, None)), S // C,
                "ce_chunk fwd+bwd", out=(emb_sh, res_sharding)))
            ocfg = AdamWConfig(lr=3e-4, moment_dtype=_moment_dtype(cfg))
            opt = adamw_init(params, ocfg)
            opt_shard = AdamWState(step=_ns(), mu=pshard, nu=pshard)
            comps.append(comp(
                "optimizer", (params, opt, params),
                (pshard, opt_shard, pshard), 1, "optimizer update",
                donate=(1, 2)))
        else:  # prefill: fwd only + per-group kv materialization
            comps.append(comp(
                "layer_group_prefill", (gparams, x, pos),
                (gshard, res_sharding, _ns(ba, None)), G,
                "layer_group prefill"))
            comps.append(comp(
                "unembed", (emb, sds((B, 1, cfg.d_model), cfg.dtype)),
                (emb_sh, _ns(ba, None, None)), 1, "unembed last"))
        return comps

    if shape.kind != "decode":
        raise ValueError(shape.kind)
    seq_axes, cache_batch = decode_seq_axes(B, mesh.shape, ba)
    gcache = tfm.init_model_cache(cfg, B, S, torch.bfloat16,
                                  "meta")[:cfg.group_size]
    gcache_sh = _cache_specs(cfg, cache_batch, seq_axes)[:cfg.group_size]
    x = sds((B, 1, cfg.d_model), cfg.dtype)
    comps.append(comp(
        "decode_group", (gparams, gcache, x, sds((), torch.int32)),
        (gshard, gcache_sh, _ns(cache_batch, None, None), _ns()), G,
        "decode group", donate=(1,)))
    comps.append(comp(
        "unembed", (emb, x), (emb_sh, _ns(cache_batch, None, None)), 1,
        "unembed token"))
    return comps


# =========================================================================
# GNN and recsys cells on a mesh (JAX's _gnn_batch_specs, _gnn_cell,
# _recsys_cell)
# =========================================================================

def _round_up(x, m):
    return -(-x // m) * m


def _layout_note(mesh) -> str:
    return (f"a layout of {mesh.size} ranks, which one process cannot "
            "hold: run the cell on a Mesh")


def _param_specs(model, mesh, rules):
    """(``{name: meta tensor}``, ``{name: sanitized spec}``) of a model
    built on ``meta``."""
    params = dict(model.named_parameters())
    specs = specs_from_axes(param_axes(model), rules)
    return params, _sanitize(params, specs, mesh)


def _gnn_batch_specs(arch_id, cfg, n, e, d_feat, mesh, multi_pod):
    """JAX's ``_gnn_batch_specs``: node arrays over the batch axes, edge
    arrays as destination-aligned slabs (``set_edge_slabs(k_slabs)``, one
    slab a node shard) over all axes. Returns (batch, specs, n_pad,
    e_pad, k_slabs)."""
    aa = all_axes(multi_pod)
    ba = batch_axes(multi_pod)
    n_dev = _axes_size(mesh, aa)
    k_slabs = _axes_size(mesh, ba)
    gnn_common.set_edge_slabs(k_slabs)
    e_pad = _round_up(e, n_dev * k_slabs // math.gcd(n_dev, k_slabs))
    n_pad = _round_up(n, k_slabs)
    batch = {"edge_src": sds((e_pad,), torch.int32),
             "edge_dst": sds((e_pad,), torch.int32)}
    shard = {"edge_src": _ns(aa), "edge_dst": _ns(aa)}
    if arch_id != "pna":
        batch["positions"] = sds((n_pad, 3), torch.float32)
        batch["species"] = sds((n_pad,), torch.int32)
        shard["positions"] = _ns(ba, None)
        shard["species"] = _ns(ba)
    if d_feat:
        batch["node_feat"] = sds((n_pad, d_feat), torch.float32)
        shard["node_feat"] = _ns(ba, None)
    return batch, shard, n_pad, e_pad, k_slabs


def _gnn_cell(spec, shape, mesh, multi_pod, smoke: bool = False,
              dims: Optional[dict] = None) -> Cell:
    """JAX's ``_gnn_cell``, decision for decision (``gnn_cell``'s config
    change, the batch and parameter specs, AdamW, FLOPs, notes). On a
    ``Mesh`` ``fn(model, opt, batch)`` is a rank's train step over its
    blocks (``shard_gnn``) returning (model, opt, loss, grad_norm), the
    loss and norm JAX's global ones; on a ``MeshLayout`` it is None."""
    gc = gnn_cell(spec.arch_id, shape.name, smoke, dims)
    cfg = gc.cfg
    rules = sharding_rules(multi_pod)
    set_activation_rules(rules)
    ba = batch_axes(multi_pod)
    batch, bshard, n_pad, e_pad, k = _gnn_batch_specs(
        spec.arch_id, cfg, gc.n_nodes, gc.n_edges, cfg.d_feat, mesh,
        multi_pod)
    if gc.kind == "full_graph":
        batch["targets"] = sds((n_pad, cfg.n_out), torch.float32)
        bshard["targets"] = _ns(ba, None)
    elif gc.kind == "minibatch":
        batch["targets"] = sds((gc.seeds, cfg.n_out), torch.float32)
        bshard["targets"] = _ns(ba, None)
    else:
        batch["graph_ids"] = sds((n_pad,), torch.int32)
        bshard["graph_ids"] = _ns(ba)
        batch["targets"] = sds((gc.n_graphs,), torch.float32)
        bshard["targets"] = _ns(ba)
    model = GNN_MODULES[spec.arch_id].init(cfg, None, "meta")
    params, pshard = _param_specs(model, mesh, rules)
    opt = adamw_init(params, GNN_ADAMW)
    opt_shard = AdamWState(step=_ns(), mu=pshard, nu=pshard)
    runnable = isinstance(mesh, Mesh)
    fn = _gnn_mesh_step(gc, mesh, rules, k) if runnable else None
    return Cell(
        spec.arch_id, shape.name, shape.kind, fn,
        (params, opt, batch), (pshard, opt_shard, bshard), gc.flops,
        notes=f"n={gc.n_nodes} e={gc.n_edges}", donate=(0, 1), config=cfg,
        dims={**shape.dims, **(dims or {})},
        decisions=dict(batch_axes=ba, k_slabs=k, n_pad=n_pad, e_pad=e_pad,
                       seeds=gc.seeds, n_graphs=gc.n_graphs, smoke=smoke,
                       fn=None if runnable else _layout_note(mesh)),
    )


def _live_axes(mesh, names) -> tuple:
    return tuple(a for a in names if mesh.shape.get(a, 1) > 1)


def _take_grads(params: dict) -> dict:
    """Each parameter's gradient, taken off it (``.grad`` set to None); a
    parameter with none gives zeros, as JAX's unused leaf's gradient
    is zero."""
    out = {}
    for name, p in params.items():
        out[name] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return out


def _reduce_grads(grads: dict, specs: dict, mesh) -> dict:
    """Every gradient (a rank's, by parameter name) summed over the mesh
    axes its parameter's spec does not shard (a replicated parameter
    over every axis; a ``model``-sharded one's block is whole over
    ``model``, and an FSDP dim's gather already reduce-scattered it over
    ``data``): one ``psum`` an axis for each group of leaves that sums
    over the same axes, in one flat buffer. Consumes ``grads``: a
    leaf is dropped from it once copied in."""
    names = list(grads)
    groups: dict = {}
    for name in names:
        have = {a for part in specs[name] for a in part_axes(part)}
        axes = tuple(a for a in _live_axes(mesh, mesh.axis_names)
                     if a not in have)
        groups.setdefault(axes, []).append(name)
    out = {}
    for axes, group in groups.items():
        if not axes:
            out.update((n, grads.pop(n)) for n in group)
            continue
        shapes = [grads[n].shape for n in group]
        flat = torch.cat([grads.pop(n).reshape(-1) for n in group])
        flat = psum(flat, mesh.axes(axes))
        for n, shape, part in zip(group, shapes, flat.split(
                [math.prod(x) for x in shapes])):
            out[n] = part.reshape(shape)
    return {name: out[name] for name in names}


def _sharded_norm(grads: dict, specs: dict, mesh) -> torch.Tensor:
    """JAX's global norm of gradients a rank holds as blocks: a
    replicated leaf's squares once, a sharded leaf's squares summed over
    the axes that shard it (one ``psum`` a group of such axes)."""
    total = None
    parts: dict = {}
    for name, g in grads.items():
        axes = tuple(a for a in _live_axes(mesh, mesh.axis_names)
                     if a in {x for part in specs[name]
                              for x in part_axes(part)})
        sq = g.float().square().sum()
        if axes:
            parts[axes] = parts[axes] + sq if axes in parts else sq
        else:
            total = sq if total is None else total + sq
    for axes, sq in parts.items():
        sq = psum(sq.reshape(1), mesh.axes(axes))[0]
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _mesh_update(model, opt, cfg_opt, mesh, grads: Optional[dict] = None):
    """Sum the rank's gradients (``grads``, by default the parameters'
    own, taken off them) over the axes their specs do not shard
    (``_reduce_grads``), take the global norm and run AdamW on the
    rank's blocks."""
    params = params_dict(model)
    specs = model.shard_specs
    grads = _reduce_grads(_take_grads(params) if grads is None else grads,
                          specs, mesh)
    norm = _sharded_norm(grads, specs, mesh)
    _, opt, gnorm = adamw_update(grads, opt, params, cfg_opt, norm=norm)
    return opt, gnorm


def _gnn_rank_loss(gc: GnnCell, model, batch, mesh, ba, k: int):
    """A rank's share of the cell's MSE: its squared errors over the
    global count and over the ``mesh.size / k`` ranks that hold its node
    block, so the shares add up to JAX's loss over the ranks."""
    b = dict(batch)
    targets = b.pop("targets")
    if gc.n_graphs is not None:
        b["n_graphs"] = gc.n_graphs
    out = GNN_MODULES[gc.arch_id].apply(model, gc.cfg, b)
    d = ba.index()
    reps = mesh.size // k
    if gc.n_graphs is not None:
        rows = gc.n_graphs // k
        pred = out["graph_out"][d * rows:(d + 1) * rows, 0]
        se, count = torch.square(pred - targets), gc.n_graphs
    elif gc.seeds is not None:
        full = gather_rows(targets, ba, 0)
        node_out = out["node_out"]
        lo = d * node_out.shape[0]
        cnt = max(0, min(gc.seeds - lo, node_out.shape[0]))
        se = torch.square(node_out[:cnt] - full[lo:lo + cnt])
        count = gc.seeds * gc.cfg.n_out
    else:
        se = torch.square(out["node_out"] - targets)
        count = targets.numel() * k
    return se.sum() / (count * reps)


def _gnn_mesh_step(gc: GnnCell, mesh, rules: dict, k: int):
    ba = mesh.axes(_live_axes(mesh, rules["batch"]))
    every = mesh.axes(_live_axes(mesh, mesh.axis_names))

    def train_step(model, opt, batch):
        before = gnn_common.edge_slabs()
        gnn_common.set_edge_slabs(k)
        try:
            with using_rules(rules, mesh):
                loss = _gnn_rank_loss(gc, model, batch, mesh, ba, k)
                loss.backward()
                loss = psum(loss.detach().reshape(1), every)[0]
                opt, gnorm = _mesh_update(model, opt, GNN_ADAMW, mesh)
        finally:
            gnn_common.set_edge_slabs(*before)
        return model, opt, loss, gnorm

    return train_step


def pad_gnn_batch(cell: Cell, batch: dict) -> dict:
    """A global numpy batch with its node arrays padded to the cell's
    ``n_pad`` rows (zeros; a pad node's ``graph_ids`` is ``n_graphs``,
    which ``segment_sum`` drops): the batch both a one-rank step and the
    mesh step read."""
    n_pad = cell.decisions["n_pad"]
    out = dict(batch)
    n = len(batch["species"] if "species" in batch else batch["node_feat"])
    for key in ("node_feat", "positions", "species", "graph_ids"):
        if key in batch and n < n_pad:
            fill = cell.decisions["n_graphs"] if key == "graph_ids" else 0
            pad = np.full((n_pad - n, *batch[key].shape[1:]), fill,
                          batch[key].dtype)
            out[key] = np.concatenate([batch[key], pad])
    if cell.kind == "full_graph" and len(batch["targets"]) < n_pad:
        t = batch["targets"]
        out["targets"] = np.concatenate(
            [t, np.zeros((n_pad - len(t), *t.shape[1:]), t.dtype)])
    return out


def slab_layout(cell: Cell, src, dst, model_size: int):
    """The cell's real edge layout: ``slab_edges`` into ``k_slabs``
    uniform slabs over ``n_pad`` nodes, each bucket padded (src 0, dst
    ``n_pad``) to a multiple of ``model_size`` so every slab splits over
    ``model``. Returns (src [K, w], dst [K, w])."""
    k, n_pad = cell.decisions["k_slabs"], cell.decisions["n_pad"]
    s, d, _ = slab_edges(np.asarray(src), np.asarray(dst), n_pad, k)
    s, d = s.reshape(k, -1), d.reshape(k, -1)
    extra = _round_up(s.shape[1], model_size) - s.shape[1]
    if extra:
        s = np.concatenate([s, np.zeros((k, extra), s.dtype)], axis=1)
        d = np.concatenate([d, np.full((k, extra), n_pad, d.dtype)], axis=1)
    return s, d


def _check_specs(cell: Cell, model, mesh, rules) -> None:
    specs = shard_params(model, mesh, rules)
    if specs != cell.in_shardings[0]:
        raise ValueError("the model's specs are not the cell's")


def shard_gnn(cell: Cell, model, mesh):
    """Cut ``model`` (the cell's config, whole) to this rank's blocks
    under the cell's rules, in place; the specs must be the cell's."""
    _check_specs(cell, model, mesh,
                 sharding_rules(len(cell.decisions["batch_axes"]) > 1))
    return model


def gnn_rank_batch(cell: Cell, mesh, batch: dict):
    """This rank's part of a global numpy ``batch`` (``pad_gnn_batch``'s)
    on ``mesh.device``: node arrays' blocks under the cell's specs, and
    its part of the real slab layout (``slab_layout``): slab ``d`` (its
    node block), the ``m``-th columns over ``model``. Returns (batch,
    layout), ``layout`` the real edge count beside JAX's analytic
    ``e_pad``."""
    bshard = cell.in_shardings[2]
    m = mesh.shape.get("model", 1)
    s, d = slab_layout(cell, batch["edge_src"], batch["edge_dst"], m)
    w = s.shape[1] // m
    slab = mesh.axes(_live_axes(mesh, cell.decisions["batch_axes"])).index()
    col = mesh.coord("model") if m > 1 else 0
    out = {"edge_src": s[slab, col * w:(col + 1) * w],
           "edge_dst": d[slab, col * w:(col + 1) * w]}
    for key, x in batch.items():
        if key not in out:
            out[key] = block_of(np.asarray(x), bshard[key], mesh)
    layout = {"edges": int(s.size), "e_pad": cell.decisions["e_pad"],
              "edges_a_rank": int(w), "slab_width": int(s.shape[1])}
    return batch_to(out, mesh.device), layout


def _recsys_cell(spec, shape, mesh, multi_pod, smoke: bool = False,
                 dims: Optional[dict] = None) -> Cell:
    """JAX's ``_recsys_cell``: train, serve, bulk and retrieval, with the
    batch replicated (``ba = None``) where it does not divide the batch
    axes and the candidates padded to the mesh and sharded over all
    axes. On a ``Mesh`` ``fn`` runs a rank's part over its blocks
    (``shard_recsys``): ``(model, opt, batch) -> (model, opt, loss,
    grad_norm)``, ``(model, batch) -> logits block`` or ``(model, batch,
    candidates block) -> (values, indices)`` of the global top
    ``RETRIEVAL_TOP_K``; on a ``MeshLayout`` it is None."""
    rc = recsys_cell(spec.arch_id, shape.name, smoke, dims)
    cfg = rc.cfg
    rules = sharding_rules(multi_pod)
    set_activation_rules(rules)
    ba = batch_axes(multi_pod)
    model = dcn.init(cfg, None, "meta")[0]
    params, pshard = _param_specs(model, mesh, rules)
    B = rc.batch
    run_rules = _run_rules(rules, B, mesh, ba)
    if B % _axes_size(mesh, ba) != 0:
        ba = None  # retrieval_cand: a single query replicates
    batch = {"dense": sds((B, cfg.n_dense), torch.float32),
             "sparse": sds((B, cfg.n_sparse), torch.int32)}
    bshard = {"dense": _ns(ba, None), "sparse": _ns(ba, None)}
    runnable = isinstance(mesh, Mesh)
    decisions = dict(batch_axes=batch_axes(multi_pod), batch_shards=ba,
                     smoke=smoke,
                     fn=None if runnable else _layout_note(mesh))
    common = dict(config=cfg, dims={**shape.dims, **(dims or {})},
                  decisions=decisions)
    fn = None
    if rc.kind == "train":
        batch["labels"] = sds((B,), torch.float32)
        bshard["labels"] = _ns(ba)
        opt = adamw_init(params, RECSYS_ADAMW)
        opt_shard = AdamWState(step=_ns(), mu=pshard, nu=pshard)
        if runnable:
            fn = _recsys_mesh_step(rc, mesh, run_rules)
        return Cell(spec.arch_id, shape.name, "train", fn,
                    (params, opt, batch), (pshard, opt_shard, bshard),
                    dcn_flops(cfg, B), donate=(0, 1), **common)
    if rc.kind in ("serve", "bulk"):
        if runnable:
            fn = _recsys_mesh_step(rc, mesh, run_rules)
        return Cell(spec.arch_id, shape.name, rc.kind, fn, (params, batch),
                    (pshard, bshard), dcn_flops(cfg, B, fwd_only=True),
                    **common)
    assert rc.kind == "retrieval"
    # pad the candidate set to the device count (serving systems pad the
    # last ANN shard anyway)
    nc = _round_up(rc.n_candidates, mesh.size)
    cand = sds((nc, cfg.retrieval_dim), torch.float32)
    decisions["n_candidates_padded"] = nc
    if runnable:
        fn = _recsys_mesh_step(rc, mesh, run_rules)
    flops = dcn_flops(cfg, B, fwd_only=True) + 2.0 * B * nc * \
        cfg.retrieval_dim
    return Cell(spec.arch_id, shape.name, "retrieval", fn,
                (params, batch, cand),
                (pshard, bshard, _ns(all_axes(multi_pod), None)), flops,
                notes=f"B={B} x {nc} candidates, batched dot + top_k",
                **common)


def _recsys_mesh_step(rc: RecsysCell, mesh, rules: dict):
    cfg = rc.cfg
    offsets = dcn.field_offsets(cfg, mesh.device)
    every = mesh.axes(_live_axes(mesh, mesh.axis_names))
    rows = _axes_size(mesh, _live_axes(mesh, rules["batch"]))
    reps = mesh.size // rows
    if rc.kind == "train":
        def train_step(model, opt, batch):
            with using_rules(rules, mesh):
                logits = dcn.forward(model, cfg, batch, offsets)
                loss = dcn.bce(logits, batch["labels"]).sum() / (
                    rc.batch * reps)
                loss.backward()
                loss = psum(loss.detach().reshape(1), every)[0]
                opt, gnorm = _mesh_update(model, opt, RECSYS_ADAMW, mesh)
            return model, opt, loss, gnorm

        return train_step
    if rc.kind in ("serve", "bulk"):
        @torch.no_grad()
        def serve_step(model, batch):
            with using_rules(rules, mesh):
                return dcn.forward(model, cfg, batch, offsets)

        return serve_step

    @torch.no_grad()
    def retrieval_step(model, batch, cand):
        with using_rules(rules, mesh):
            return dcn.retrieval_scores(model, cfg, batch, offsets, cand,
                                        RETRIEVAL_TOP_K, cand_axes=every)

    return retrieval_step


def shard_recsys(cell: Cell, model, mesh):
    """Cut ``model`` (the cell's config, whole) to this rank's blocks
    under the cell's rules, in place; the specs must be the cell's."""
    _check_specs(cell, model, mesh,
                 sharding_rules(len(cell.decisions["batch_axes"]) > 1))
    return model


def recsys_rank_batch(cell: Cell, mesh, batch: Optional[dict] = None,
                      cand: Optional[torch.Tensor] = None):
    """This rank's blocks of a global numpy ``batch`` and of the
    candidates under the cell's specs, on ``mesh.device``: (batch or
    None, candidates or None)."""
    bshard = cell.in_shardings[1 if cell.kind != "train" else 2]
    out = None
    if batch is not None:
        out = batch_to({k: block_of(np.asarray(v), bshard[k], mesh)
                        for k, v in batch.items() if k in bshard},
                       mesh.device)
    if cand is not None:
        cand = block_of(cand, cell.in_shardings[2], mesh).to(mesh.device)
    return out, cand


# -------------------------------------------------- the analytic schedules --

class _Sched:
    """``{axis: {kind: [calls, result bytes]}}``, as ``Wire`` records a
    rank's calls (``WireStats.by_axis``); axes of size 1 send nothing."""

    def __init__(self, mesh_shape: dict):
        self.shape = mesh_shape
        self.recs: dict = {}

    def add(self, axis, kind, nbytes, calls=1):
        if self.shape.get(axis, 1) > 1:
            r = self.recs.setdefault(axis, {}).setdefault(kind, [0, 0])
            r[0] += calls
            r[1] += calls * int(nbytes)

    def live(self, axes) -> tuple:
        return tuple(a for a in axes if self.shape.get(a, 1) > 1)

    def gather(self, nbytes, axes, grad=False):
        """``gather_rows`` of a ``nbytes`` block (minor axis first), and
        under ``grad`` its backward, ``psum_scatter`` (major first)."""
        for a in reversed(self.live(axes)):
            nbytes *= self.shape[a]
            self.add(a, "all-gather", nbytes)
        if grad:
            for a in self.live(axes):
                nbytes //= self.shape[a]
                self.add(a, "reduce-scatter", nbytes)

    def psum(self, nbytes, axes, grad=False):
        for _ in range(2 if grad else 1):
            for a in self.live(axes):
                self.add(a, "all-gather", self.shape[a] * nbytes)

    def extremum(self, elems, el, axes):
        """``_MeshExtremum``: the MAX/MIN all-reduce, and its backward's
        ``psum`` of the gradient and int32 tie counts."""
        for a in self.live(axes):
            self.add(a, "all-reduce", elems * el)
            self.add(a, "all-gather", self.shape[a] * elems * el)
            self.add(a, "all-reduce", elems * 4)

    def update(self, specs: dict, shapes: dict, el: int):
        """``_mesh_update``: one ``psum`` of each group of gradients that
        sums over the same axes, then the norm's float32 ``psum`` a group
        of sharding axes."""
        axes = self.live(self.shape)
        groups: dict = {}
        sharded: set = set()
        for name, spec in specs.items():
            have = {a for p in spec for a in part_axes(p)}
            key = tuple(a for a in axes if a not in have)
            n = math.prod(shapes[name]) // math.prod(
                self.shape.get(a, 1) for a in have)
            groups[key] = groups.get(key, 0) + n * el
            sharded.add(tuple(a for a in axes if a in have))
        for key, nbytes in groups.items():
            self.psum(nbytes, key)
        for key in sharded:
            self.psum(4, key)


def gnn_collective_schedule(cell: Cell, mesh_shape: dict,
                            el: int = 4) -> dict:
    """What one ``_gnn_cell`` train step sends on one rank, as ``Wire``
    records it (``{axis: {kind: [calls, result bytes]}}``), from the
    cell's decisions and config (``el``: the parameters' bytes an
    element). Forward: a source gather of a node array is an all-gather
    over the batch axes (its backward a reduce-scatter), a sum
    reduction a ``psum`` over ``model`` (its backward too), an extremum
    a MAX/MIN all-reduce (its backward a ``psum`` and an int32
    all-reduce); PNA's checkpointed layers run their forward again in
    the backward. Then the minibatch targets' gather, the loss's
    ``psum``, the gradients' and the norm's (``_mesh_update``)."""
    d, cfg = cell.decisions, cell.config
    arch = cell.arch_id
    s = _Sched(mesh_shape)
    ba = d["batch_axes"]
    ma = tuple(a for a in sharding_rules(len(ba) > 1)["edges"]
               if a not in ba)
    rows = d["n_pad"] // d["k_slabs"]
    specs = cell.in_shardings[0]
    shapes = {n: tuple(t.shape) for n, t in cell.args[0].items()}

    def node_gather(width, grad=True):
        s.gather(rows * width * el, ba, grad)

    def red_sum(width, grad=True):
        s.psum(rows * width * el, ma, grad)

    def fsdp():
        name = "feat_proj.kernel"
        if name in specs and any(part_axes(p) for p in specs[name]):
            n = math.prod(shapes[name]) // math.prod(
                mesh_shape.get(a, 1) for p in specs[name]
                for a in part_axes(p))
            s.gather(n * el, ba, grad=True)

    fsdp()
    if arch == "pna":
        w = cfg.d_hidden
        s.psum(rows * 4, ma)  # degree: float32 counts in any dtype
        for _ in range(cfg.n_layers):
            for rep in range(2):  # the forward, then its recompute
                node_gather(w, grad=rep == 1)
                for _ in range(2):  # mean and the squares' mean
                    red_sum(w, grad=rep == 1)
                    red_sum(1, grad=False)
                for _ in range(2):  # max, min
                    if rep == 1:
                        s.extremum(rows * w, el, ma)
                    else:
                        for a in s.live(ma):
                            s.add(a, "all-reduce", rows * w * el)
    else:
        s.gather(rows * 3 * 4, ba)  # positions (edge_vectors)
        nlm = (cfg.l_max + 1) ** 2 if arch != "schnet" else 1
        layers = cfg.n_interactions if arch == "schnet" else cfg.n_layers
        w = nlm * cfg.d_hidden
        for _ in range(layers):
            node_gather(w)
            if arch == "equiformer-v2":
                s.extremum(rows * cfg.n_heads, el, ma)  # softmax max
                red_sum(cfg.n_heads)  # its denominator
            red_sum(w)
    if d["n_graphs"] is not None:
        s.psum(d["n_graphs"] * cfg.n_out * el, ba, grad=True)
    if d["seeds"] is not None:
        s.gather(d["seeds"] // d["k_slabs"] * cfg.n_out * 4, ba)
    s.psum(el, s.live(mesh_shape))  # the loss
    s.update(specs, shapes, el)
    return s.recs


def recsys_collective_schedule(cell: Cell, mesh_shape: dict,
                               el: int = 4) -> dict:
    """What one ``_recsys_cell`` step sends on one rank, as ``Wire``
    records it: the table lookup's ``psum`` over ``model`` where its rows
    are sharded, each kernel's FSDP gather over ``data``, each
    column-parallel product's gather over ``model`` before the next
    product (and the head), their transposes in a train step's backward
    with the loss's, the gradients' and the norm's ``psum``; a retrieval
    step's merge of the ranks' top ``k`` (values and int64 indices
    gathered over every axis)."""
    cfg, d = cell.config, cell.decisions
    s = _Sched(mesh_shape)
    train = cell.kind == "train"
    specs = cell.in_shardings[0]
    shapes = {n: tuple(t.shape) for n, t in cell.args[0].items()}
    data = s.live(d["batch_axes"])
    model = s.live(("model",))
    B = cell.dims["batch"]
    rows = B // math.prod(mesh_shape.get(a, 1)
                          for a in s.live(d["batch_shards"] or ()))

    def blocks(name):
        spec = specs[name]
        dims = []
        for i, n in enumerate(shapes[name]):
            k = math.prod(mesh_shape.get(a, 1) for a in part_axes(spec[i]))
            dims.append(n // k)
        return dims

    def fsdp(name):
        spec = specs[name]
        if any(a in data for a in part_axes(spec[0])):
            s.gather(math.prod(blocks(name)) * el, data, grad=train)

    def cols(name):
        return any(a in model for a in part_axes(specs[name][1]))

    if any(a in model for a in part_axes(specs["embed.table"][0])):
        s.psum(rows * cfg.n_sparse * cfg.embed_dim * el, model, grad=train)
    for i in range(cfg.n_cross_layers):
        name = f"cross.w_{i}.kernel"
        fsdp(name)
        if cols(name):
            s.gather(rows * blocks(name)[1] * el, model, grad=train)
    have_cols = False
    for i in range(len(cfg.mlp)):
        name = f"mlp.w_{i}.kernel"
        d_in = shapes[name][0]
        if have_cols:
            s.gather(rows * d_in // math.prod(mesh_shape[a] for a in model)
                     * el, model, grad=train)
        fsdp(name)
        have_cols = True
    s.gather(rows * cfg.mlp[-1] // math.prod(
        mesh_shape[a] for a in model) * el, model, grad=train)
    if train:
        s.psum(el, s.live(mesh_shape))  # the loss
        s.update(specs, shapes, el)
    elif cell.kind == "retrieval":
        k = RETRIEVAL_TOP_K
        every = s.live(mesh_shape)
        s.gather(k * 4, every)
        s.gather(k * 8, every)
    return s.recs


def schedule_by_kind(recs: dict, mesh_shape: dict) -> dict:
    """``{axis: {kind: [calls, bytes]}}`` -> ``{kind: {group: [calls,
    bytes]}}`` (``WireStats.by_kind``'s form)."""
    out: dict = {}
    for axis, kinds in recs.items():
        for kind, (c, b) in kinds.items():
            r = out.setdefault(kind, {}).setdefault(
                int(mesh_shape[axis]), [0, 0])
            r[0] += c
            r[1] += b
    return out


def build_cell(arch_id: str, shape_name: str, mesh, multi_pod: bool,
               **overrides) -> Cell:
    """JAX's ``build_cell``: the (arch, shape) cell on ``mesh`` (a ``Mesh``
    or a ``MeshLayout``) for every family. Raises on a documented skip.
    The edge slabs are reset first, and a GNN cell sets its own, as in
    JAX. ``overrides``: a paper cell's ``state_layout``/``or_impl``; a
    GNN or recsys cell's ``smoke`` and ``dims`` (``gnn_cell``'s)."""
    gnn_common.set_edge_slabs(None)  # a GNN cell sets its own per mesh
    spec = cfgbase.get(arch_id)
    shape = {s.name: s for s in spec.shapes}[shape_name]
    if shape_name in spec.skips:
        raise ValueError(
            f"{arch_id} x {shape_name} is a documented skip: "
            f"{spec.skips[shape_name]}"
        )
    if spec.family == "lm":
        return _lm_cell(spec, shape, mesh, multi_pod)
    if spec.family == "gnn":
        return _gnn_cell(spec, shape, mesh, multi_pod, **overrides)
    if spec.family == "recsys":
        return _recsys_cell(spec, shape, mesh, multi_pod, **overrides)
    if spec.family == "paper":
        return _paper_cell(spec, shape, mesh, multi_pod, **overrides)
    raise ValueError(spec.family)


#: each Table 2 dataset's seeded generator family (``graph.generators``),
#: with its degree law and seed; the node count is the shape's
PAPER_GRAPHS = {
    "ldbc100": (powerlaw, dict(avg_degree=22.0, alpha=1.8, seed=0)),
    "livejournal": (powerlaw, dict(avg_degree=7.0, alpha=2.1, seed=1)),
    "spotify": (erdos_renyi, dict(avg_degree=267.0, seed=2)),
    "graph500_28": (rmat, dict(edge_factor=17, seed=3)),
}


def paper_graph(shape_name: str, n_nodes: int) -> CSRGraph:
    """The seeded graph of a paper shape at ``n_nodes`` nodes (the
    shape's own count, or a cut). RMAT makes ``2^scale`` nodes, so a
    ``graph500_28`` count must be a power of two."""
    gen, kw = PAPER_GRAPHS[shape_name]
    if gen is rmat:
        scale = int(n_nodes).bit_length() - 1
        if 1 << scale != n_nodes:
            raise ValueError(f"rmat makes 2^scale nodes; {n_nodes} is not "
                             "a power of two")
        return rmat(scale, **kw)
    return gen(int(n_nodes), **kw)


@dataclasses.dataclass
class BoundCell:
    """A cell bound to real inputs on one rank of a ``Mesh``: this rank's
    rows of the forward ELL (cut at ``max_deg_cap``) on its device and
    the padded source morsels. Calling it runs the engine."""

    cell: Cell
    graph: EllGraph
    morsels: np.ndarray
    csr: CSRGraph  # the cut edge set the engine scans (host)
    sources: np.ndarray
    n_edges_generated: int  # before the cut

    def __call__(self):
        return self.cell.fn(self.graph, self.morsels)

    @property
    def argument_bytes(self) -> int:
        g = self.graph
        return (g.indices.numel() * g.indices.element_size()
                + g.degrees.numel() * g.degrees.element_size()
                + self.morsels.nbytes)


def bind_cell(cell: Cell, mesh: Mesh, csr: Optional[CSRGraph] = None,
              seed: int = 0) -> BoundCell:
    """Bind a paper cell built on ``mesh`` to real inputs: ``csr`` (by
    default the shape's seeded graph at its ``n_nodes``), its forward ELL
    cut at ``max_deg_cap`` (this rank's row block over the graph axes,
    on ``mesh.device``), and ``pick_sources`` of ``n_sources`` on the cut
    edge set, padded by ``pad_sources``. Returns the callable."""
    if cell.fn is None:
        raise ValueError(f"cell {cell.shape_name} has no engine: "
                         f"{cell.notes}")
    cfg, d = cell.config, cell.decisions
    if csr is None:
        csr = paper_graph(cell.shape_name, cell.dims["n_nodes"])
    n_pad, cap = d["n_pad"], d["max_deg"]
    if csr.n_nodes > n_pad:
        raise ValueError(f"a graph of {csr.n_nodes} nodes does not fit the "
                         f"cell's {n_pad} rows")
    cut = truncate_csr(csr, cap)
    ga = mesh.axes(("model",))
    rows = n_pad // ga.size
    lo = ga.index() * rows
    indices, degrees, _ = ell_shard(cut, lo, lo + rows, cap, n_pad)
    graph = EllGraph(indices=torch.from_numpy(indices).to(mesh.device),
                     degrees=torch.from_numpy(degrees).to(mesh.device))
    sources = pick_sources(cut, cfg.n_sources, seed=seed)
    morsels = pad_sources(sources, d["source_shards"], d["lanes"], n_pad)
    return BoundCell(cell, graph, morsels, cut, sources, csr.n_edges)
