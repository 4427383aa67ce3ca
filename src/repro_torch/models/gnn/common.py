"""GNN message-passing substrate (port of ``repro.models.gnn.common``).

Message passing is edge-index arrays plus segment reductions, as in JAX
(``jax.ops.segment_sum/max/min``): sums are ``index_add`` and extrema are
``scatter_reduce(..., "amax"/"amin", include_self=False)`` onto a ``-inf``/
``+inf`` base, so an empty segment reads JAX's ``-inf`` before the
``where(isfinite, m, 0)`` that turns it into 0; their gradient splits
among ties as JAX's does, bit for bit (``_SegmentExtremum``). A
destination id equal to the segment count is dropped, as JAX's scatters
drop it (the pad edges of ``graph/partition.slab_edges`` point there):
every reduce writes one spare row and slices it off, and
``segment_softmax`` reads such an edge's segment at the last row, as
JAX's ``x[ids]`` clamps. On the CPU ``index_add`` adds the edges in their
order, which is bitwise JAX's; on the card it adds with atomics, in no
fixed order (bitwise only under ``torch.use_deterministic_algorithms``).

JAX's destination-aligned edge slabs (``set_edge_slabs(K)``, the
communication-avoiding aggregation): edges bucketed by destination node
range, slab ``k`` of ``E / K`` edges targets only the nodes of range
``k`` (``N / K`` a range, or the edge-balanced ``bounds`` of
``graph/partition.slab_edges``), pad edges at ``dst == N``. Every
``aggregate``/``segment_softmax`` then reduces each slab over its LOCAL
ids into ``nl`` rows plus a dropped one, so the output is born
node-sharded. ``K`` None or 1, ``E % K``, ``N % K`` (uniform ranges) and
bounds that do not match fall back to the flat path, as JAX's
``_slab_view`` does.

On a mesh of ranks (the rules and a ``Mesh`` of more than one rank
installed, ``nn.module.set_activation_rules``) rank ``(d, m)`` holds
node block ``d`` over the batch axes and the ``m``-th part of slab
``d``'s edges (JAX's ``"edges"`` rule: edges over all axes). A reduce
then takes the rank's edges into its own ``[N / K]`` block and combines
the parts over ``model``: ``psum`` for sums, a MAX/MIN all-reduce for
the extrema (so an empty segment still reads JAX's ``-inf``), both
under autograd. ``node_table`` all-gathers a node array over the batch
axes for the models' source and destination gathers; ``take`` reads it
by global id. The slabs must be ``K`` = the batch axes' size with
uniform ranges there (JAX's cells' layout); the edge-balanced bounds
are a one-process path, as in JAX.

A pad edge's gathers read the last node row (``take`` clamps, as JAX's
``x[ids]`` does). JAX's ``jnp.take`` fills NaN there instead, and 0 x
NaN then turns PNA's ``pre`` and most of EquiformerV2's gradients NaN
on a padded slab batch; the port's forward is JAX's and its gradients
are those of the batch without its pad edges.

The models' parameters are ``nn.Parameter``s under JAX's key names
(``interaction_0.filter1.kernel``) with JAX's logical axes
(``nn.module.set_axes``); ``model_from_jax`` and ``params_to_numpy``
carry a model across from and to JAX's unboxed tree.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...core.collectives import (
    gather_rows_grad,
    int_psum,
    max_allreduce,
    min_allreduce,
    psum,
    psum_grad,
)
from ...kernels.common import init_device, resolve_device, tensor_from_numpy
from ...nn.module import activation_rules, param, set_axes, shard_activation


def _node_sharded(x):
    """JAX's constraint of a scatter's output to the node (batch) layout;
    the port's reduces are born in it, so ``have`` is the same layout."""
    axes = ("batch",) + (None,) * (x.ndim - 1)
    return shard_activation(x, axes, have=axes)


class _SegmentExtremum(torch.autograd.Function):
    """Segment max/min into ``n + 1`` rows with JAX's gradient: an edge
    that attains its segment's extremum gets ``g * (1 / ties)``, as the
    transpose of ``lax.scatter_max``'s JVP scales it (``g / ties``, as
    ``scatter_reduce``'s backward divides, rounds otherwise from three
    ties on)."""

    @staticmethod
    def forward(ctx, values, ids, n, op):
        out = _scatter_extremum(values, ids, n, op)
        ctx.save_for_backward(values, ids, out)
        return out

    @staticmethod
    def backward(ctx, g):
        values, ids, out = ctx.saved_tensors
        hit = values == out[ids]
        ties = torch.zeros_like(out).index_add(0, ids, hit.to(out.dtype))
        coef = torch.reciprocal(ties)
        return torch.where(hit, g[ids] * coef[ids], 0.0), None, None, None


def _scatter_extremum(values, ids, n, op):
    """[n + 1, ...]: each segment's max/min, ``-inf``/``+inf`` where
    empty (JAX's initial values)."""
    base = values.new_full((n + 1, *values.shape[1:]),
                           -math.inf if op == "max" else math.inf)
    index = ids.long().reshape(-1, *(1,) * (values.ndim - 1))
    return base.scatter_reduce(0, index.expand(values.shape), values,
                               "amax" if op == "max" else "amin",
                               include_self=False)


def _segment(values, ids, n, op):
    """Reduce ``values`` [E, ...] by ``ids`` [E] (in ``[0, n]``; ``n`` is
    dropped) into [n, ...]; an empty segment holds 0 (sum) or -inf/+inf
    (max/min), JAX's initial values."""
    if op == "sum":
        out = values.new_zeros((n + 1, *values.shape[1:])).index_add(
            0, ids, values)
    else:
        out = _SegmentExtremum.apply(values, ids, n, op)
    return out[:n]


# ---------------------------------------------------------------------------
# Destination-aligned edge slabs (JAX's set_edge_slabs, _slab_view,
# _slab_reduce and the slab branch of segment_softmax).
# ---------------------------------------------------------------------------

_EDGE_SLABS: int | None = None
_SLAB_BOUNDS = None  # [K+1] np.int64 node boundaries (edge-balanced slabs)


def set_edge_slabs(k: int | None, bounds=None):
    """``k`` slabs (the node-row shard count) for every ``aggregate`` and
    ``segment_softmax``; None restores the flat scatters. ``bounds``
    (optional, host [K+1] array): non-uniform node ranges, slab ``j``
    owns nodes ``[bounds[j], bounds[j+1])``, from
    ``graph/partition.slab_edges(..., balance="edges")``; None keeps the
    uniform ``N/K`` ranges."""
    global _EDGE_SLABS, _SLAB_BOUNDS
    _EDGE_SLABS = k
    _SLAB_BOUNDS = None if bounds is None else np.asarray(bounds, np.int64)


def edge_slabs():
    """(slab count, bounds) as ``set_edge_slabs`` left them."""
    return _EDGE_SLABS, _SLAB_BOUNDS


def _slab_view(dst, n_nodes):
    """(combined ids [E], nl, K, bounds) or None when slab mode is off or
    shapes don't divide: edge ``e`` of slab ``k`` (``dst`` viewed as [K,
    E/K]) goes to segment ``k (nl + 1) + local``, its dropped row at
    ``local = nl``. With edge-balanced bounds ``nl`` is the largest node
    span; shorter slabs' trailing segments are never targeted and the
    reassembly gather skips them."""
    K = _EDGE_SLABS
    E = dst.shape[0]
    if K is None or K <= 1 or E % K:
        return None
    bounds = _SLAB_BOUNDS
    if bounds is None:
        if n_nodes % K:
            return None
        nl = n_nodes // K
        offs = np.arange(K, dtype=np.int64) * nl
        his = offs + nl
    else:
        if len(bounds) != K + 1 or int(bounds[-1]) != n_nodes:
            return None
        nl = int((bounds[1:] - bounds[:-1]).max())
        offs, his = bounds[:-1], bounds[1:]
    ds = dst.reshape(K, E // K)
    offs_t = torch.as_tensor(offs, dtype=ds.dtype, device=ds.device)[:, None]
    his_t = torch.as_tensor(his, dtype=ds.dtype, device=ds.device)[:, None]
    in_slab = (ds >= offs_t) & (ds < his_t)
    local = torch.where(in_slab, ds - offs_t, nl)  # nl = dropped
    base = torch.arange(K, dtype=ds.dtype, device=ds.device)[:, None] * (
        nl + 1)
    return (base + local).reshape(-1), nl, K, bounds


def _slab_reduce(values, cid, nl, K, bounds, op):
    """Each slab's segment reduce over its local ids (the dropped row
    sliced off), reassembled in node order."""
    out = _segment(values, cid, K * (nl + 1), op)
    rest = tuple(out.shape[1:])
    flat = out.reshape(K, nl + 1, *rest)[:, :nl].reshape(K * nl, *rest)
    if bounds is None:
        return _node_sharded(flat)
    # non-uniform spans: node n lives at (slab k(n), n - bounds[k(n)]);
    # the gather map is a host constant (bounds are static per layout)
    node = np.arange(int(bounds[-1]), dtype=np.int64)
    k_of = np.searchsorted(bounds, node, side="right") - 1
    gather = torch.as_tensor(k_of * nl + (node - bounds[k_of]),
                             device=flat.device)
    return _node_sharded(flat[gather])


# ---------------------------------------------------------------------------
# The mesh of ranks: node blocks over the batch axes, slab parts over model.
# ---------------------------------------------------------------------------

class _MeshView:
    """This rank's part: node block ``block`` of ``k`` over ``batch``
    (axes), its edges' partial results combined over ``model`` (axes)."""

    def __init__(self, mesh, batch, model):
        self.mesh, self.batch, self.model = mesh, batch, model
        self.k = batch.size
        self.block = batch.index()


def _mesh_view():
    """The installed mesh's view, or None off a mesh (no rules, or one
    rank). Raises where the slabs set are not the mesh's layout."""
    rules, mesh = activation_rules()
    if rules is None or mesh is None or mesh.size == 1:
        return None
    ba = tuple(a for a in rules["batch"] if mesh.shape.get(a, 1) > 1)
    ma = tuple(a for a in rules["edges"]
               if mesh.shape.get(a, 1) > 1 and a not in ba)
    view = _MeshView(mesh, mesh.axes(ba), mesh.axes(ma))
    k = _EDGE_SLABS if _EDGE_SLABS is not None else 1
    if k != view.k or _SLAB_BOUNDS is not None:
        raise ValueError(
            f"a mesh with {view.k} node blocks runs uniform edge slabs "
            f"set_edge_slabs({view.k}); got {_EDGE_SLABS} slabs"
            + (" with bounds" if _SLAB_BOUNDS is not None else ""))
    return view


def _local_ids(view, dst, n_local):
    """Global destinations -> this rank's block rows, ``n_local`` (the
    dropped row) for a pad edge or an id outside the block."""
    loc = dst - view.block * n_local
    return torch.where((loc >= 0) & (loc < n_local), loc, n_local)


class _MeshExtremum(torch.autograd.Function):
    """Segment max/min of this rank's edges into its ``n`` block rows,
    then a MAX/MIN all-reduce over ``model``. Backward as
    ``_SegmentExtremum``'s with the ties counted over every rank of the
    segment: the incoming gradient (a share a rank) is ``psum``-ed over
    ``model``, the hits' counts summed there too (int32)."""

    @staticmethod
    def forward(ctx, values, ids, n, op, axes):
        out = _scatter_extremum(values, ids, n, op)[:n]
        red = max_allreduce if op == "max" else min_allreduce
        out = red(out.contiguous(), axes)
        ctx.axes, ctx.n = axes, n
        ctx.save_for_backward(values, ids, out)
        return out

    @staticmethod
    def backward(ctx, g):
        values, ids, out = ctx.saved_tensors
        axes, n = ctx.axes, ctx.n
        pad = lambda t: torch.cat([t, t.new_zeros((1, *t.shape[1:]))])
        g = pad(psum(g.contiguous(), axes))
        valid = (ids < n).reshape(-1, *(1,) * (values.ndim - 1))
        hit = valid & (values == pad(out)[ids])
        ties = torch.zeros((n + 1, *out.shape[1:]), dtype=torch.int32,
                           device=out.device)
        ties = int_psum(ties.index_add(0, ids, hit.to(torch.int32))[:n]
                        .contiguous(), axes)
        coef = torch.reciprocal(pad(ties.to(out.dtype)))
        return (torch.where(hit, g[ids] * coef[ids], 0.0),
                None, None, None, None)


def _mesh_reduce(view, values, ids, n_local, op):
    """This rank's edges (``ids``: block rows, ``n_local`` dropped) into
    its ``n_local`` block rows, combined over ``model``."""
    if op == "sum":
        return psum_grad(_segment(values, ids, n_local, "sum"), view.model)
    if view.model.size == 1:
        return _segment(values, ids, n_local, op)
    return _MeshExtremum.apply(values, ids, n_local, op, view.model)


def node_table(x):
    """The rows a gather by global node id reads: on a mesh, the node
    blocks all-gathered over the batch axes (under autograd: the
    backward reduce-scatters); else ``x``."""
    view = _mesh_view()
    if view is None:
        return x
    return gather_rows_grad(x, view.batch, 0)


def take(table, ids):
    """``table``'s rows at ``ids``; an id past the end (a pad edge's
    ``dst == N``) reads the last row, as JAX's ``x[ids]`` clamps."""
    return table[torch.clamp_max(ids, table.shape[0] - 1)]


def _softmax(lg, ids, safe, n, reduce):
    mx = reduce(lg, ids, n, "max")
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.exp(lg - mx[safe])
    den = reduce(e, ids, n, "sum")
    return e / torch.clamp_min(den[safe], 1e-16)


def segment_softmax(logits, segment_ids, num_segments):
    """Softmax over edges grouped by destination node (``num_segments``:
    the rank's node rows on a mesh)."""
    view = _mesh_view()
    if view is not None:
        ids = _local_ids(view, segment_ids, num_segments)
        return _softmax(logits, ids, torch.clamp_max(ids, num_segments - 1),
                        num_segments,
                        lambda v, i, n, op: _mesh_reduce(view, v, i, n, op))
    slab = _slab_view(segment_ids, num_segments)
    if slab is not None:
        cid, nl, K, _ = slab
        local = cid % (nl + 1)
        safe = cid - local + torch.clamp_max(local, nl - 1)
        return _softmax(logits, cid, safe, K * (nl + 1), _segment)
    safe = torch.clamp_max(segment_ids, num_segments - 1)
    return _softmax(logits, segment_ids, safe, num_segments, _segment)


def _reduce(messages, dst, n_nodes, op):
    view = _mesh_view()
    if view is not None:
        ids = _local_ids(view, dst, n_nodes)
        return _node_sharded(_mesh_reduce(view, messages, ids, n_nodes, op))
    slab = _slab_view(dst, n_nodes)
    if slab is not None:
        return _slab_reduce(messages, *slab, op)
    return _node_sharded(_segment(messages, dst, n_nodes, op))


def aggregate(messages, dst, n_nodes, op: str = "sum"):
    """Scatter-reduce edge messages to destination nodes (``n_nodes``:
    the rank's node rows on a mesh)."""
    if op == "sum":
        return _reduce(messages, dst, n_nodes, "sum")
    if op == "mean":
        s = _reduce(messages, dst, n_nodes, "sum")
        c = _reduce(messages.new_ones(messages.shape[:1]), dst, n_nodes,
                    "sum")
        c = c.reshape(-1, *(1,) * (s.ndim - 1))
        return s / torch.clamp_min(c, 1.0)
    if op in ("max", "min"):
        m = _reduce(messages, dst, n_nodes, op)
        return torch.where(torch.isfinite(m), m, 0.0)
    raise ValueError(op)


def segment_sum(values, ids, n):
    """``jax.ops.segment_sum`` (flat; the models' ``graph_out``). On a
    mesh ``values`` are a node block: each rank's partial sums are
    ``psum``-ed over the batch axes."""
    out = _segment(values, ids, n, "sum")
    view = _mesh_view()
    return out if view is None else psum_grad(out, view.batch)


def degree(dst, n_nodes):
    return _reduce(torch.ones(dst.shape, dtype=torch.float32,
                              device=dst.device), dst, n_nodes, "sum")


# ---------------------------------------------------------------------------
# Radial bases and edge geometry.
# ---------------------------------------------------------------------------

def _ipow(x, y: int):
    """``x ** y`` for an integer ``y > 0`` by XLA's square-and-multiply
    (``lax.integer_pow``), so the products round as JAX's do."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def bessel_rbf(r, n_rbf: int, cutoff: float):
    """Radial Bessel basis (DimeNet/MACE): sin(n pi r/c)/r, smoothly
    enveloped."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rc = torch.clamp(r, 1e-4, cutoff)[..., None]
    scale = float(np.sqrt(np.float32(2.0 / cutoff)))  # JAX's float32 sqrt
    basis = scale * torch.sin(n * math.pi * rc / cutoff) / rc
    # polynomial envelope p=6 for smooth cutoff
    x = torch.clamp(r / cutoff, 0.0, 1.0)[..., None]
    env = 1 - 28 * _ipow(x, 6) + 48 * _ipow(x, 7) - 21 * _ipow(x, 8)
    return basis * env


def rbf_centers(n_rbf: int, cutoff: float) -> np.ndarray:
    """``jnp.linspace(0, cutoff, n_rbf)`` as XLA computes it on the CPU,
    ``i * float32(cutoff / (n - 1))`` in float32 and the last point
    ``cutoff`` (``torch.linspace`` rounds some points otherwise)."""
    if n_rbf == 1:
        return np.zeros(1, np.float32)
    step = np.float32(cutoff) / np.float32(n_rbf - 1)
    out = np.arange(n_rbf - 1, dtype=np.float32) * step
    return np.concatenate([out, [np.float32(cutoff)]]).astype(np.float32)


def gaussian_rbf(r, n_rbf: int, cutoff: float):
    """Gaussian RBF expansion (SchNet)."""
    centers = torch.from_numpy(rbf_centers(n_rbf, cutoff)).to(r.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * torch.square(r[..., None] - centers))


_LOG2 = float(np.log(np.float32(2.0)))


def shifted_softplus(x):
    """``softplus(x) - log 2`` with JAX's softplus, ``logaddexp(x, 0) =
    max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` returns ``x`` above a
    threshold instead)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs())) - _LOG2


def edge_vectors(positions, src, dst, eps: float = 1e-6):
    """Returns (unit_vec [E,3], dist [E], valid [E]) for edges src->dst.

    Zero-length edges (self-loops, coincident atoms) have no direction:
    their unit vector is z and ``valid`` is False; models mask their
    messages."""
    table = node_table(positions)
    d = take(table, dst) - take(table, src)
    r = torch.linalg.vector_norm(d, dim=-1)
    valid = r > eps
    z = torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype, device=d.device)
    unit = torch.where(valid[..., None],
                       d / torch.clamp_min(r, eps)[..., None], z)
    return unit, r, valid


# ---------------------------------------------------------------------------
# Parameters under JAX's key names.
# ---------------------------------------------------------------------------

class Kernel(nn.Module):
    """JAX's ``{"kernel": array}`` leaf: one parameter named ``kernel``
    (``boxed_param``: ``scale * N(0, 1)``, default scale
    ``1/sqrt(shape[0])``), with its logical axes (``(None, None)``
    unless given, as the GNNs box all but ``feat_proj``)."""

    def __init__(self, shape, generator, device, scale=None, axes=None):
        super().__init__()
        self.kernel = param(tuple(shape), generator, device=device,
                            scale=scale)
        set_axes(self, kernel=axes or (None,) * len(shape))


def build(cls, cfg, generator, device):
    """``cls(cfg, generator, device)`` with seeded weights drawn from
    ``generator`` (on its own device), on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``; ``"meta"`` builds shapes alone)."""
    dev = init_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError("init needs a torch.Generator for its weights")
    return cls(cfg, generator, dev)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def model_from_jax(cls, cfg, tree: dict, device=None):
    """``cls``'s model holding the values of JAX's unboxed parameter tree
    (nested dicts of numpy arrays; a parameter's dotted name is its path
    there). Checks every shape and that the tree holds no other leaf."""
    dev = resolve_device(device)
    model = cls(cfg, None, torch.device("meta")).to_empty(device=dev)
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            val = tensor_from_numpy(_leaf(tree, name.split(".")))
            if tuple(val.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX leaf has shape "
                                 f"{tuple(val.shape)}, the port "
                                 f"{tuple(p.shape)}")
            p.copy_(val)
            n += 1
    if n != _n_leaves(tree):
        raise ValueError(f"the JAX tree has {_n_leaves(tree)} leaves, the "
                         f"port's {cfg.name} model {n}")
    return model


def named_tree(named: dict) -> dict:
    """JAX's nested layout of ``{dotted name: value}``."""
    tree: dict = {}
    for name, v in named.items():
        *head, last = name.split(".")
        node = tree
        for key in head:
            node = node.setdefault(key, {})
        node[last] = v
    return tree


def params_to_numpy(model: nn.Module) -> dict:
    return named_tree({k: p.detach().cpu().numpy().copy()
                       for k, p in model.named_parameters()})


def grads_to_numpy(model: nn.Module) -> dict:
    """The gradients in JAX's layout; a parameter without one holds zeros,
    as JAX's gradient of an unused leaf does."""
    return named_tree({
        k: (p.grad if p.grad is not None else torch.zeros_like(p))
        .detach().cpu().numpy().copy()
        for k, p in model.named_parameters()})
