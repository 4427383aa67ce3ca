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
donation. On a ``Mesh`` a dense arch's prefill and decode cells run
(``models.transformer_mesh``; ``shard_lm`` cuts the model); train cells
and MoE archs there raise ``NotImplementedError`` naming their ROADMAP
item.

Left out: the mesh shardings of the GNN and recsys cells and the GNN
edge slabs (``build_cell`` raises for those families; ROADMAP section
1). ``cell_batch`` and ``recsys_batch`` make seeded batches of a cell's
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
from ..graph.partition import padded_n
from ..graph.sampler import tree_edges
from ..kernels.common import resolve_device
from .mesh import Mesh, batch_axes
from ..models import dcn_v2 as dcn
from ..models import transformer as tfm
from ..models import transformer_mesh as tmesh
from ..models.transformer_mesh import MOE_ITEM, decode_seq_axes
from ..nn.attention import KVCache
from ..nn.module import (
    block_of,
    logical_to_spec,
    param_axes,
    sanitize_spec,
    set_activation_rules,
    shard_params,
    sharding_rules,
    specs_from_axes,
    using_rules,
)
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
TRAIN_ITEM = ("LM training on a mesh waits for its slice (ROADMAP section 1, "
              "item 2: LM train on a mesh)")


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
    model = tfm.init(cfg, None, "meta")
    params = dict(model.named_parameters())
    specs = specs_from_axes(param_axes(model), rules)
    return params, _sanitize(params, specs, mesh)


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
    cell holds decisions only (``fn=None``). On a ``Mesh`` a ``prefill``
    or ``decode`` cell of a dense arch runs the rank's part
    (``models.transformer_mesh``): ``fn(params, tokens, max_seq=None,
    route=None)`` and ``fn(params, caches, tokens, pos)`` take the
    rank's parameter blocks (``shard_lm``), its cache blocks and the
    global tokens (each rank takes its block), and return the rank's
    blocks (``decisions["out_specs"]``). A train cell or an MoE arch on
    a ``Mesh`` raises ``NotImplementedError``."""
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
    if runnable and cfg.moe is not None:
        raise NotImplementedError(f"{spec.arch_id}: {MOE_ITEM}")
    if runnable and shape.kind == "train":
        raise NotImplementedError(f"{spec.arch_id} x {shape.name}: "
                                  f"{TRAIN_ITEM}")
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
                     fn=None if runnable else
                     f"a layout of {mesh.size} ranks, which one process "
                     "cannot hold: run the cell on a Mesh")

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
        return Cell(
            spec.arch_id, shape.name, "train", None,
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


def shard_lm(cell: Cell, model, mesh):
    """Cut ``model`` (the cell's full config, whole) to this rank's
    blocks under the cell's rules, in place; the specs must be the
    cell's."""
    rules = sharding_rules(len(cell.decisions["batch_axes"]) > 1,
                           cell.decisions["seq_parallel"])
    specs = shard_params(model, mesh, rules)
    if specs != cell.in_shardings[0]:
        raise ValueError("the model's specs are not the cell's")
    return model


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


def build_cell(arch_id: str, shape_name: str, mesh, multi_pod: bool,
               **overrides) -> Cell:
    """JAX's ``build_cell``: the (arch, shape) cell on ``mesh`` (a ``Mesh``
    or a ``MeshLayout``). Raises on a documented skip. The paper and LM
    families are ported; the GNN and recsys mesh cells raise
    ``NotImplementedError``."""
    spec = cfgbase.get(arch_id)
    shape = {s.name: s for s in spec.shapes}[shape_name]
    if shape_name in spec.skips:
        raise ValueError(
            f"{arch_id} x {shape_name} is a documented skip: "
            f"{spec.skips[shape_name]}"
        )
    if spec.family == "lm":
        return _lm_cell(spec, shape, mesh, multi_pod)
    if spec.family == "paper":
        return _paper_cell(spec, shape, mesh, multi_pod, **overrides)
    if spec.family in ("gnn", "recsys"):
        slabs = " (with JAX's edge slabs)" if spec.family == "gnn" else ""
        raise NotImplementedError(
            f"the {spec.family} family's mesh cells{slabs} wait for their "
            "slice (ROADMAP section 1, item 2); gnn_cell and recsys_cell "
            "run one card"
        )
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
