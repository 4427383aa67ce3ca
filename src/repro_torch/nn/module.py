"""Parameter inits and counts, and the logical-axis sharding rules (port of
``repro.nn.module``).

The JAX package's layers are (init, apply) pairs over nested dicts of
``Boxed`` leaves. The port's layers are ``nn.Module``s that hold
``nn.Parameter``s under the JAX dicts' key names, so that a parameter's
dotted name in the port is its path in JAX's tree (``attn.wq.kernel``).
Each module records its parameters' logical axes where it creates them
(``set_axes``); ``param_axes(model)`` reads them back as ``{dotted
name: axes}``, the port's ``split_boxed``.

Seeded inits draw from an explicit ``torch.Generator`` on the generator's
own device and place the result on the target device; on the ``meta``
device nothing is drawn (shapes only, any model size). Parameters are
created without a gradient (``requires_grad=False``), for serving; the
trainer switches them on for its model (``requires_grad_(True)``).

Sharding. ``sharding_rules`` maps logical axes to mesh axes as JAX's
does, and ``logical_to_spec`` gives a spec: a tuple with one entry a dim,
``None``, one axis name or a tuple of names (the port's
``PartitionSpec``). ``sanitize_spec`` drops the entry of a dim that does
not divide (JAX's ``_sanitize``), ``shard_params`` cuts every parameter
to this rank's block of its sanitized spec (JAX's ``devices_indices_map``
block of the device at the rank's coordinates). ``NamedSharding(mesh,
spec)`` is one leaf's layout, the record a checkpoint's ``shardings=``
tree holds; ``gather_block_to_root`` and ``reshard_block`` move a
leaf's blocks point to point, each part once. ``set_activation_rules``
installs the rules, process-global as in JAX, and a rank's ``Mesh``
beside them. ``shard_activation`` then moves a rank's block of a tensor
from the layout the caller says it has into the layout ``axes`` names: a
dim that stops being sharded is all-gathered through ``core.collectives``
(``Wire``), a dim that starts being sharded takes the rank's slice, both
under autograd. It is the identity where the two agree, and with no
rules or no mesh of more than one rank installed. A partial sum is not a
layout: a row-parallel product reduces its own partial sums.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
from torch import nn


def sharding_rules(multi_pod: bool = False,
                   seq_parallel: bool = False) -> dict:
    """JAX's rules. seq_parallel (Megatron-SP style): the residual stream
    between layers (logical axis ``res_seq``) is sharded over the model
    axis along the sequence."""
    fsdp = ("pod", "data") if multi_pod else ("data",)
    return {
        "embed": fsdp,
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "heads": (),
        "kv": (),
        "head_dim": (),
        "stack": (),
        "batch": fsdp,
        "act_seq": (),
        "act_model": ("model",),
        "act_vocab": ("model",),  # logits vocab dim: always TP
        "res_seq": ("model",) if seq_parallel else (),
        "seq_shard": fsdp + ("model",),  # long-context KV sharding
        "edges": fsdp + ("model",),  # GNN edge-parallel message tensors
        "edges_dp": fsdp,  # edge dim when channels claim "model"
        None: (),
    }


def logical_to_spec(axes: tuple, rules: dict) -> tuple:
    """One entry a dim: ``None``, an axis name, or a tuple of names."""
    parts = []
    for a in axes:
        mesh_axes = rules.get(a, ())
        if not mesh_axes:
            parts.append(None)
        elif len(mesh_axes) == 1:
            parts.append(mesh_axes[0])
        else:
            parts.append(tuple(mesh_axes))
    return tuple(parts)


def specs_from_axes(axes_tree: dict, rules: dict) -> dict:
    """``{name: axes}`` -> ``{name: spec}``."""
    return {k: logical_to_spec(a, rules) for k, a in axes_tree.items()}


def part_axes(part) -> tuple:
    """A spec entry as a tuple of mesh axis names."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _axes_size(mesh_shape: dict, axes: tuple) -> int:
    return int(math.prod(mesh_shape.get(a, 1) for a in axes))


def sanitize_spec(shape, spec: tuple, mesh_shape: dict) -> tuple:
    """JAX's ``_sanitize`` for one parameter: the spec padded to the
    rank with ``None``, each entry dropped where its axes' size is 1 or
    does not divide the dim."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, spec):
        size = _axes_size(mesh_shape, part_axes(part))
        out.append(part if size > 1 and dim % size == 0 else None)
    return tuple(out)


def block_slices(shape, spec: tuple, mesh_shape: dict, coords: dict):
    """The slices of this rank's block of a ``shape`` tensor under
    ``spec``: a dim sharded over axes ``(a, b)`` is cut into
    ``size(a) * size(b)`` blocks, and the rank at coordinates ``coords``
    takes block ``coord(a) * size(b) + coord(b)`` (major to minor, as a
    ``NamedSharding`` places them)."""
    out = []
    for i, dim in enumerate(shape):
        axes = part_axes(spec[i]) if i < len(spec) else ()
        k = _axes_size(mesh_shape, axes)
        if dim % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {axes} ({k})")
        idx = 0
        for a in axes:
            idx = idx * mesh_shape.get(a, 1) + coords.get(a, 0)
        n = dim // k
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def _coords(mesh) -> dict:
    return {a: mesh.coord(a) for a in mesh.axis_names}


def block_of(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` (a view)."""
    return x[block_slices(x.shape, spec, mesh.shape, _coords(mesh))]


def gather_block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The global tensor of this rank's block ``x`` under ``spec`` (every
    sharded dim all-gathered; the inverse of ``block_of``)."""
    from ..core.collectives import gather_rows

    for d in range(min(len(spec), x.dim())):
        axes = tuple(a for a in part_axes(spec[d])
                     if mesh.shape.get(a, 1) > 1)
        if axes:
            x = gather_rows(x, mesh.axes(axes), d)
    return x


def _coords_of(mesh, rank: int) -> dict:
    """The coordinates of ``rank`` on ``mesh`` (row-major, as
    ``Mesh`` lays ranks out)."""
    out = {}
    for a, n in reversed(list(zip(mesh.axis_names, mesh.axis_sizes))):
        rank, out[a] = divmod(rank, n)
    return out


def _owns(mesh, spec: tuple, coords: dict) -> bool:
    """Whether the rank at ``coords`` is its block's first holder:
    coordinate 0 on every axis ``spec`` does not shard. The first
    holders' blocks tile the global tensor once."""
    used = {a for part in spec for a in part_axes(part)}
    return all(coords[a] == 0 for a in mesh.axis_names if a not in used)


def _box_cut(a: tuple, b: tuple):
    """The intersection of two boxes of slices, None when empty."""
    out = tuple(slice(max(x.start, y.start), min(x.stop, y.stop))
                for x, y in zip(a, b))
    return None if any(s.start >= s.stop for s in out) else out


def _box_in(cut: tuple, box: tuple) -> tuple:
    """``cut``'s slices relative to ``box``'s start."""
    return tuple(slice(c.start - b.start, c.stop - b.start)
                 for c, b in zip(cut, box))


def _redistribute(x: torch.Tensor, src_box, dst_box, mesh):
    """Move parts of a global tensor between the ranks of ``mesh``:
    rank ``r`` holds ``x`` as the box ``src_box(r)`` of it (None: it
    sends nothing) and assembles the box ``dst_box(r)`` (None: nothing).
    Every part goes once, point to point, from the rank whose source
    box holds it (the source boxes must not overlap). Returns this
    rank's assembled box or None."""
    from ..core.collectives import exchange

    me = mesh.rank
    mine, want = src_box(me), dst_box(me)
    out = (None if want is None else
           x.new_empty(tuple(s.stop - s.start for s in want)))
    sends, recvs, parts = {}, {}, []
    for r in range(mesh.size):
        to = dst_box(r)
        cut = None if mine is None or to is None else _box_cut(mine, to)
        if cut is not None:
            piece = x[_box_in(cut, mine)]
            if r == me:
                parts.append((cut, piece))
            else:
                sends[r] = piece.contiguous()
        frm = None if want is None or r == me else src_box(r)
        cut = None if frm is None else _box_cut(frm, want)
        if cut is not None:
            recvs[r] = x.new_empty(tuple(s.stop - s.start for s in cut))
            parts.append((cut, recvs[r]))
    exchange(sends, recvs, mesh, "gather")
    for cut, piece in parts:
        out[_box_in(cut, want)] = piece
    return out


def global_shape(shape, spec: tuple, mesh) -> tuple:
    """The global shape of a block of ``shape`` under ``spec``."""
    return tuple(dim * _axes_size(mesh.shape, part_axes(spec[i]) if
                                  i < len(spec) else ())
                 for i, dim in enumerate(shape))


def gather_block_to_root(x: torch.Tensor, spec: tuple, mesh):
    """``gather_block``'s global tensor on rank 0 alone (None on the
    others): each block goes once, from its first holder straight to
    rank 0, on ``x``'s device."""
    shape = global_shape(x.shape, spec, mesh)
    whole = tuple(slice(0, n) for n in shape)

    def src(r):
        c = _coords_of(mesh, r)
        return (block_slices(shape, spec, mesh.shape, c)
                if _owns(mesh, spec, c) else None)

    return _redistribute(x, src, lambda r: whole if r == 0 else None, mesh)


def reshard_block(x: torch.Tensor, spec: tuple, mesh, to_spec: tuple,
                  to_mesh) -> torch.Tensor:
    """This rank's block under ``to_spec`` on ``to_mesh`` of the global
    tensor whose block under ``spec`` on ``mesh`` it holds as ``x``
    (two meshes over the same ranks): each rank receives what its new
    block needs, each part once, point to point."""
    if to_mesh.size != mesh.size or to_mesh.rank != mesh.rank:
        raise ValueError(f"{to_mesh} and {mesh} order other ranks")
    shape = global_shape(x.shape, spec, mesh)

    def src(r):
        c = _coords_of(mesh, r)
        return (block_slices(shape, spec, mesh.shape, c)
                if _owns(mesh, spec, c) else None)

    return _redistribute(
        x, src, lambda r: block_slices(shape, to_spec, to_mesh.shape,
                                       _coords_of(to_mesh, r)), mesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on a mesh of ranks, the port's
    ``jax.sharding.NamedSharding(mesh, PartitionSpec(*spec))``: ``spec``
    has one entry a dim (``None``, an axis name or a tuple of names;
    missing trailing entries are ``None``). A ``checkpoint.Stacked``
    leaf's spec starts with its group dim, which is never sharded."""

    mesh: Any  # launch.mesh.Mesh
    spec: tuple

    def __post_init__(self):
        names = {a for part in self.spec for a in part_axes(part)}
        unknown = names - set(self.mesh.axis_names)
        if unknown:
            raise ValueError(f"spec {self.spec} names axes {sorted(unknown)}"
                             f" that the mesh {self.mesh.shape} lacks")


_ACTIVATION_RULES: dict | None = None
_MESH = None


def set_activation_rules(rules: dict | None, mesh=None):
    """Install the logical->mesh rules ``shard_activation`` reads, and the
    rank's ``Mesh`` (``launch.mesh.Mesh``) beside them. ``None`` removes
    both (single-device runs)."""
    global _ACTIVATION_RULES, _MESH
    _ACTIVATION_RULES = rules
    _MESH = mesh if rules is not None else None


def activation_rules():
    """(installed rules, installed mesh); either may be None."""
    return _ACTIVATION_RULES, _MESH


@contextlib.contextmanager
def using_rules(rules: dict, mesh):
    """``set_activation_rules(rules, mesh)`` for a ``with`` block; the
    rules and mesh installed before come back after it."""
    before = activation_rules()
    set_activation_rules(rules, mesh)
    try:
        yield
    finally:
        set_activation_rules(*before)


def shard_activation(x: torch.Tensor, axes: tuple,
                     have: tuple | None = None) -> torch.Tensor:
    """This rank's block of ``x`` moved from the layout ``have`` (logical
    axes, the layout ``x`` has) into the layout ``axes`` names. The
    identity without installed rules or without a mesh of more than one
    rank; with them, ``have`` is required (nothing is guessed). A dim
    that stops being sharded is all-gathered, a dim that starts being
    sharded takes this rank's slice; a sharded dim must divide. Both
    carry a gradient: the gather's is a reduce-scatter of the sum
    (``core.collectives.gather_rows_grad``), the slice's is zero outside
    the rank's block, so the ranks' gradients add up to the whole
    one's."""
    rules, mesh = _ACTIVATION_RULES, _MESH
    if rules is None or mesh is None or mesh.size == 1:
        return x
    if have is None:
        raise ValueError(f"shard_activation to {axes} on a mesh needs the "
                         "layout the tensor has (have=...)")
    from ..core.collectives import gather_rows_grad

    want = logical_to_spec(axes, rules)
    cur = logical_to_spec(have, rules)
    for d in range(x.dim()):
        c = part_axes(cur[d]) if d < len(cur) else ()
        w = part_axes(want[d]) if d < len(want) else ()
        c = tuple(a for a in c if mesh.shape.get(a, 1) > 1)
        w = tuple(a for a in w if mesh.shape.get(a, 1) > 1)
        if c == w:
            continue
        if c:
            x = gather_rows_grad(x, mesh.axes(c), d)
        if w:
            sl = block_slices(x.shape, (None,) * d + (w,), mesh.shape,
                              _coords(mesh))
            x = x[sl]
    return x


def fsdp_param(model: nn.Module, name: str) -> torch.Tensor:
    """The parameter ``name`` of ``model`` as a product reads it: on a
    mesh, a block cut by ``shard_params`` has its dims sharded over the
    rules' ``embed`` (FSDP) axes all-gathered, under autograd (the
    gradient is reduce-scattered back); ``model``-axis sharding stays.
    The parameter itself off a mesh or for a model not cut."""
    p = model.get_parameter(name)
    rules, mesh = _ACTIVATION_RULES, _MESH
    specs = getattr(model, "shard_specs", None)
    if rules is None or mesh is None or mesh.size == 1 or specs is None:
        return p
    from ..core.collectives import gather_rows_grad

    data = set(a for a in rules["embed"] if mesh.shape.get(a, 1) > 1)
    for d, part in enumerate(specs[name]):
        axes = tuple(a for a in part_axes(part) if a in data)
        if axes:
            p = gather_rows_grad(p, mesh.axes(axes), d)
    return p


def set_axes(module: nn.Module, **axes) -> None:
    """Record the logical axes of ``module``'s own parameters, by name."""
    table = module.__dict__.setdefault("_param_axes", {})
    for name, a in axes.items():
        table[name] = tuple(a)


def param_axes(model: nn.Module) -> dict:
    """``{dotted name: logical axes}`` for every parameter of ``model``
    (the port's ``split_boxed`` axes tree). Raises for a parameter whose
    module recorded no axes."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, a in mod.__dict__.get("_param_axes", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = a
    names = [n for n, _ in model.named_parameters()]
    missing = [n for n in names if n not in out]
    if missing:
        raise KeyError(f"parameters without logical axes: {missing[:5]}")
    return {n: out[n] for n in names}


def param_specs(model: nn.Module, rules: dict, mesh_shape: dict) -> dict:
    """Every parameter's sanitized spec (the model whole, or on
    ``meta``)."""
    specs = specs_from_axes(param_axes(model), rules)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return {n: sanitize_spec(shapes[n], s, mesh_shape)
            for n, s in specs.items()}


def shard_params(model: nn.Module, mesh, rules: dict) -> dict:
    """Cut each parameter of ``model`` (in place) to this rank's block of
    its sanitized spec; returns ``{name: spec}``, also kept as
    ``model.shard_specs``."""
    specs = param_specs(model, rules, mesh.shape)
    mods = dict(model.named_modules())
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        block = block_of(p.detach(), specs[name], mesh)
        if block.shape != p.shape:
            block = block.clone()
        mods[owner]._parameters[leaf] = nn.Parameter(
            block, requires_grad=p.requires_grad)
    model.shard_specs = specs
    return specs


def normal_init(shape, dtype, scale: float, generator: torch.Generator,
                device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32, then cast to ``dtype``."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (scale * x).to(dtype).to(dev)


def param(shape, generator: torch.Generator, dtype=torch.float32,
          device="cpu", scale: float | None = None) -> nn.Parameter:
    """A seeded ``nn.Parameter``; the default scale is ``1/sqrt(shape[0])``
    (JAX's ``boxed_param``: ``shape[0]`` is the fan-in of a dense kernel,
    and the expert count of a stacked expert kernel)."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    return nn.Parameter(normal_init(shape, dtype, scale, generator, device),
                        requires_grad=False)


def ones(shape, dtype=torch.float32, device="cpu") -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=dtype, device=device),
                        requires_grad=False)


def zeros(shape, dtype=torch.float32, device="cpu") -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def cast_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float. JAX turns a Python
    scalar into the array's type before a binary op (``x_bf16 * 0.3``
    multiplies by ``bf16(0.3)``); PyTorch's kernels keep the scalar in
    float32, so a bfloat16 product would round differently."""
    return torch.tensor(v, dtype=dtype).item()
