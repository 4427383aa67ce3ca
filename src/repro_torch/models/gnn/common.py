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

JAX's destination-aligned edge slabs (``set_edge_slabs``) are left out:
JAX turns them on only for a cell sharded across devices, and with
``nn.module.shard_activation`` the identity they would compute the flat
path's values.

The models' parameters are ``nn.Parameter``s under JAX's key names
(``interaction_0.filter1.kernel``); ``model_from_jax`` and
``params_to_numpy`` carry a model across from and to JAX's unboxed tree.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...kernels.common import init_device, resolve_device, tensor_from_numpy
from ...nn.module import param, shard_activation


def _node_sharded(x):
    axes = ("batch",) + (None,) * (x.ndim - 1)
    return shard_activation(x, axes)


class _SegmentExtremum(torch.autograd.Function):
    """Segment max/min into ``n + 1`` rows with JAX's gradient: an edge
    that attains its segment's extremum gets ``g * (1 / ties)``, as the
    transpose of ``lax.scatter_max``'s JVP scales it (``g / ties``, as
    ``scatter_reduce``'s backward divides, rounds otherwise from three
    ties on)."""

    @staticmethod
    def forward(ctx, values, ids, n, op):
        base = values.new_full((n + 1, *values.shape[1:]),
                               -math.inf if op == "max" else math.inf)
        index = ids.long().reshape(-1, *(1,) * (values.ndim - 1))
        out = base.scatter_reduce(0, index.expand(values.shape), values,
                                  "amax" if op == "max" else "amin",
                                  include_self=False)
        ctx.save_for_backward(values, ids, out)
        return out

    @staticmethod
    def backward(ctx, g):
        values, ids, out = ctx.saved_tensors
        hit = values == out[ids]
        ties = torch.zeros_like(out).index_add(0, ids, hit.to(out.dtype))
        coef = torch.reciprocal(ties)
        return torch.where(hit, g[ids] * coef[ids], 0.0), None, None, None


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


def _softmax(lg, ids, safe, n):
    mx = _segment(lg, ids, n, "max")
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.exp(lg - mx[safe])
    den = _segment(e, ids, n, "sum")
    return e / torch.clamp_min(den[safe], 1e-16)


def segment_softmax(logits, segment_ids, num_segments):
    """Softmax over edges grouped by destination node."""
    safe = torch.clamp_max(segment_ids, num_segments - 1)
    return _softmax(logits, segment_ids, safe, num_segments)


def _reduce(messages, dst, n_nodes, op):
    return _node_sharded(_segment(messages, dst, n_nodes, op))


def aggregate(messages, dst, n_nodes, op: str = "sum"):
    """Scatter-reduce edge messages to destination nodes."""
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
    """``jax.ops.segment_sum`` (flat; the models' ``graph_out``)."""
    return _segment(values, ids, n, "sum")


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
    d = positions[dst] - positions[src]
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
    ``1/sqrt(shape[0])``)."""

    def __init__(self, shape, generator, device, scale=None):
        super().__init__()
        self.kernel = param(tuple(shape), generator, device=device,
                            scale=scale)


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
