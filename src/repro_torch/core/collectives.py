"""Frontier-union collectives over a mesh of ranks (port of
``repro.core.collectives`` on ``torch.distributed``).

Per IFE iteration the graph shards of one source group union their
partial next frontiers across the graph axes. Three flavors, as in the
JAX package:

- ``pmax``: unpacked uint8 lanes, an all-reduce ``MAX`` (OR is max);
- ``allgather``: bit-packed 32-bit words, ``all_gather`` and a local OR
  fold;
- ``ring``: bit-packed words through a reduce-scatter ring and an
  all-gather ring, each a ``batch_isend_irecv`` step inside the axis's
  group, unrolled over ``K - 1`` steps like JAX's ``ppermute`` rings.

Entry points take and return the unpacked layout. Loops over several
axes run major axis first, as JAX's do, which fixes every fold order.
Packed words travel as int32 (OR is sign-blind); their bits are JAX's
uint32 words.

Float sums never use a backend's ``SUM``, whose order is its own: the
replicated merge gathers every rank's partial and folds them strictly in
rank order per axis (``allgather_reduce_scatter``'s order without the
slice), and the sharded merge keeps the ring's or the gather's own
order. So a sum gives the same bits under gloo and NCCL, on the CPU and
on the card.

``Wire`` is the one place tensors meet a backend. NCCL takes device
tensors as they are. gloo's point-to-point and reductions take host
tensors, so under gloo a CUDA tensor is copied to host memory and back,
on purpose, and the staged bytes are counted (``Mesh.wire``). A
collective a backend cannot do raises; nothing gives way to another
path.

Axes are ``launch.mesh.Axes`` (names bound to their mesh); an empty tuple
or axes of size 1 make every function the identity, which is the
one-device path.

Three carry a gradient (``torch.autograd.Function``s over ``Wire``, so a
backward's calls are recorded by kind and axis as a forward's are):
``gather_rows_grad``, whose backward is a reduce-scatter of the sum,
``psum_scatter_grad``, whose backward gathers the blocks, and
``psum_grad``, whose backward is a ``psum``. A rank then runs its share
of an SPMD program whose losses add up over the ranks to the global
one.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

PACK = 32

#: frontier-union flavor of the hybrid's phase 2 (nT1S over every axis,
#: the largest K in the system, where the ring's wire bytes win)
REDISPATCH_OR_IMPL = "ring"


def _pack_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., n] bool/uint8 -> [..., ceil(n/32)] int32 words (the bits of
    JAX's uint32 words: bit j of word w is element 32 w + j)."""
    n = x.shape[-1]
    bits = (x != 0).to(torch.int64)
    pad = (-n) % PACK
    if pad:
        bits = torch.cat(
            [bits, bits.new_zeros((*bits.shape[:-1], pad))], dim=-1)
    w = bits.shape[-1] // PACK
    shifts = torch.arange(PACK, dtype=torch.int64, device=x.device)
    words = (bits.reshape(*bits.shape[:-1], w, PACK) << shifts).sum(dim=-1)
    # [0, 2**32) -> the int32 with the same bits
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _unpack_bits(p: torch.Tensor, n: int) -> torch.Tensor:
    """[..., w] int32 words -> [..., n] bool."""
    shifts = torch.arange(PACK, dtype=torch.int64, device=p.device)
    bits = ((p.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return bits.reshape(*p.shape[:-1], p.shape[-1] * PACK)[..., :n] != 0


def _names(axes) -> tuple:
    """The axes that move data: an axis of size 1 is the identity."""
    if not axes:
        return ()
    return tuple(a for a in axes if axes.mesh.shape.get(a, 1) > 1)


def _trivial(axes) -> bool:
    """No collective to run: no axes, or axes of total size 1. Bare axis
    names carry no mesh and cannot be reduced over."""
    if not axes:
        return True
    if not hasattr(axes, "mesh"):
        raise ValueError(
            f"axes {axes!r} carry no mesh: pass launch.mesh.Mesh.axes(...)"
        )
    return axes.size == 1


class Wire:
    """One rank's collectives on one backend, counted in ``mesh.wire``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.stage = mesh.backend == "gloo"
        if mesh.backend not in ("gloo", "nccl"):
            raise ValueError(f"no collectives on backend {mesh.backend!r}")

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if x.dtype == torch.bool:  # bytes on the wire, bools again after
            x = x.view(torch.uint8)
        if self.stage and x.device.type == "cuda":
            self.mesh.wire.staged_bytes += x.numel() * x.element_size()
            return x.cpu()
        if not self.stage and x.device.type != "cuda":
            raise ValueError(
                "NCCL moves CUDA tensors only; got a tensor on "
                f"{x.device}")
        return x

    def _from_wire(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if y.device != like.device:
            self.mesh.wire.staged_bytes += y.numel() * y.element_size()
            y = y.to(like.device)
        return y.view(torch.bool) if like.dtype == torch.bool else y

    def _start(self):
        """(host clock, staged bytes so far) at a call's start."""
        return time.perf_counter(), self.mesh.wire.staged_bytes

    def _count(self, x: torch.Tensor, t0, kind: str, axis: str,
               out_bytes: int | None = None) -> None:
        """One call (``t0`` from ``_start``): its payload (``x``) in the
        totals, and its kind, result bytes (``x``'s unless given), group
        size and bytes staged by kind."""
        w = self.mesh.wire
        t0, staged0 = t0
        nbytes = x.numel() * x.element_size()
        ms = (time.perf_counter() - t0) * 1e3
        w.calls += 1
        w.bytes += nbytes
        w.ms += ms
        w.ms_by_kind[kind] = w.ms_by_kind.get(kind, 0.0) + ms
        w.record(kind, nbytes if out_bytes is None else out_bytes,
                 self.mesh.shape[axis], axis)
        if w.staged_bytes > staged0:
            w.staged_by_kind[kind] = (w.staged_by_kind.get(kind, 0)
                                      + w.staged_bytes - staged0)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """[K, *x.shape]: every rank's ``x`` along ``axis``, by coordinate."""
        t0 = self._start()
        k = self.mesh.shape[axis]
        wx = self._to_wire(x)
        outs = [torch.empty_like(wx) for _ in range(k)]
        dist.all_gather(outs, wx, group=self.mesh.group(axis))
        out = self._from_wire(torch.stack(outs), x)
        self._count(x, t0, "all-gather", axis,
                    out_bytes=k * x.numel() * x.element_size())
        return out

    def all_reduce(self, x: torch.Tensor, axis: str, op) -> torch.Tensor:
        """Order-free reductions only: MAX, MIN, and SUM of integers
        (exact in any order, so the backend's own order gives the same
        bits); float sums go through ``psum``'s ordered fold."""
        if op == dist.ReduceOp.SUM and x.is_floating_point():
            raise ValueError("a float SUM depends on the backend's order: "
                             "use psum")
        t0 = self._start()
        wx = self._to_wire(x).clone()
        dist.all_reduce(wx, op=op, group=self.mesh.group(axis))
        out = self._from_wire(wx, x)
        self._count(x, t0, "all-reduce", axis)
        return out

    def shift(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """One ring step along ``axis``: send ``x`` to coordinate d+1,
        return what coordinate d-1 sent."""
        t0 = self._start()
        m = self.mesh
        k, d = m.shape[axis], m.coord(axis)
        g = m.group(axis)
        wx = self._to_wire(x)
        got = torch.empty_like(wx)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wx, m.rank_at(**{axis: (d + 1) % k}),
                       group=g),
            dist.P2POp(dist.irecv, got, m.rank_at(**{axis: (d - 1) % k}),
                       group=g),
        ])
        for r in reqs:
            r.wait()
        out = self._from_wire(got, x)
        self._count(x, t0, "collective-permute", axis)
        return out


    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis`` of every rank's ``x``, this rank's chunk
        of dim 0 (cut into K chunks): each rank sends chunk ``j`` to
        coordinate ``j`` and folds the K chunks of its own coordinate
        strictly in coordinate order, so a float sum has the same bits on
        any backend. One call, kind ``reduce-scatter``."""
        t0 = self._start()
        m = self.mesh
        k, d = m.shape[axis], m.coord(axis)
        if x.shape[0] % k:
            raise ValueError(f"dim 0 ({x.shape[0]}) is not divisible by {k}")
        g = m.group(axis)
        wx = self._to_wire(x).reshape(k, x.shape[0] // k, *x.shape[1:])
        got = [wx[j] if j == d else torch.empty_like(wx[j])
               for j in range(k)]
        ops = []
        for j in range(k):
            if j != d:
                peer = m.rank_at(**{axis: j})
                ops += [dist.P2POp(dist.isend, wx[j], peer, group=g),
                        dist.P2POp(dist.irecv, got[j], peer, group=g)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        parts = [self._from_wire(t, x) for t in got]
        out = _fold(torch.stack(parts), torch.add)
        self._count(x, t0, "reduce-scatter", axis,
                    out_bytes=out.numel() * out.element_size())
        return out


    def exchange(self, sends: dict, recvs: dict, kind: str) -> None:
        """Point to point over the default process group, which holds
        the mesh's ranks: each tensor of ``sends`` (``{rank: tensor}``)
        goes to its rank, each of ``recvs`` is filled from its rank, all
        posted at once. One call of ``kind``, by the bytes received, its
        group the whole mesh."""
        t0 = self._start()
        ops, back = [], []
        for r, t in sends.items():
            ops.append(dist.P2POp(dist.isend, self._to_wire(t), r))
        for r, t in recvs.items():
            w = t
            if self.stage and t.device.type == "cuda":
                w = torch.empty(t.shape, dtype=t.dtype)
            ops.append(dist.P2POp(dist.irecv, w, r))
            back.append((t, w))
        if ops:
            for q in dist.batch_isend_irecv(ops):
                q.wait()
        got = 0
        for t, w in back:
            got += t.numel() * t.element_size()
            if w is not t:
                self.mesh.wire.staged_bytes += w.numel() * w.element_size()
                t.copy_(w)
        w = self.mesh.wire
        sent = sum(t.numel() * t.element_size() for t in sends.values())
        ms = (time.perf_counter() - t0[0]) * 1e3
        w.calls += 1
        w.bytes += sent
        w.ms += ms
        w.ms_by_kind[kind] = w.ms_by_kind.get(kind, 0.0) + ms
        w.record(kind, got, self.mesh.size)
        if w.staged_bytes > t0[1]:
            w.staged_by_kind[kind] = (w.staged_by_kind.get(kind, 0)
                                      + w.staged_bytes - t0[1])


def exchange(sends: dict, recvs: dict, mesh, kind: str) -> None:
    """``Wire.exchange`` on ``mesh`` (a one-rank mesh has no peer)."""
    if mesh.size == 1:
        if sends or recvs:
            raise ValueError("a one-rank mesh has no peer to exchange with")
        return
    _wire(mesh.axes(())).exchange(sends, recvs, kind)


def _wire(axes) -> Wire:
    mesh = axes.mesh
    w = mesh.__dict__.get("_wire")
    if w is None:
        w = mesh.__dict__["_wire"] = Wire(mesh)
    return w


def _single(axes, axis: str):
    """``axes`` narrowed to one of its names (same mesh)."""
    return axes.mesh.axes((axis,))


def ring_or_u32(x: torch.Tensor, axes) -> torch.Tensor:
    """Bitwise-OR all-reduce of int32 words over ONE mesh axis by a ring
    reduce-scatter and a ring all-gather."""
    if _trivial(axes):
        return x
    (axis,) = _names(axes)
    wire = _wire(axes)
    k = axes.mesh.shape[axis]
    d = axes.mesh.coord(axis)
    shape = x.shape
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % k
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(k, -1).clone()
    for t in range(k - 1):
        recv = wire.shift(chunks[(d - t) % k], axis)
        chunks[(d - t - 1) % k] |= recv
    for t in range(k - 1):
        chunks[(d - t) % k] = wire.shift(chunks[(d + 1 - t) % k], axis)
    return chunks.reshape(-1)[:n].reshape(shape)


def or_allreduce(x: torch.Tensor, axes, impl: str = "ring") -> torch.Tensor:
    """OR-union of a bool/uint8 array across mesh axes. Shape-preserving."""
    if _trivial(axes):
        return x
    names = _names(axes)
    wire = _wire(axes)
    orig = x.dtype
    if impl == "pmax":
        out = x.to(torch.uint8)
        for a in names:
            out = wire.all_reduce(out, a, dist.ReduceOp.MAX)
        return out.to(orig) if orig != torch.uint8 else out
    shape = x.shape
    flat = (x != 0).reshape(1, -1)
    packed = _pack_bits(flat)[0]
    if impl == "allgather":
        for a in names:
            gathered = wire.all_gather(packed, a)
            packed = gathered[0]
            for k in range(1, gathered.shape[0]):
                packed = packed | gathered[k]
    elif impl == "ring":
        for a in names:
            packed = ring_or_u32(packed, _single(axes, a))
    else:
        raise ValueError(f"unknown or_allreduce impl: {impl}")
    out = _unpack_bits(packed[None], flat.shape[-1])[0].reshape(shape)
    return out.to(orig)


def ring_reduce_scatter(x: torch.Tensor, axes, op) -> torch.Tensor:
    """Ring reduce-scatter over ONE mesh axis: ``x`` (flat length
    divisible by K) -> this rank's fully reduced chunk ``[n / K]``;
    ``op(a, b)`` combines chunks in ring order."""
    flat = x.reshape(-1)
    if _trivial(axes):
        return flat
    (axis,) = _names(axes)
    wire = _wire(axes)
    k = axes.mesh.shape[axis]
    d = axes.mesh.coord(axis)
    n = flat.shape[0]
    if n % k:
        raise ValueError(f"length {n} is not divisible by {k}")
    chunks = flat.reshape(k, -1).clone()
    for t in range(k - 1):
        recv = wire.shift(chunks[(d - t) % k], axis)
        r = (d - t - 1) % k
        chunks[r] = op(chunks[r], recv)
    # rank d now owns chunk (d+1) % K; one rotation hands chunk d to d
    return wire.shift(chunks[(d + 1) % k], axis)


def _fold(gathered: torch.Tensor, op) -> torch.Tensor:
    """Strict left fold over the leading (rank) axis."""
    red = gathered[0]
    for k in range(1, gathered.shape[0]):
        red = op(red, gathered[k])
    return red


def allgather_reduce_scatter(x: torch.Tensor, axes, op) -> torch.Tensor:
    """Reduce-scatter over ONE mesh axis as all-gather, a strict left fold
    in coordinate order and this rank's slice: the group-safe flavor
    (``sync="shard"`` engines degrade their rings to it, as JAX's do)."""
    flat = x.reshape(-1)
    if _trivial(axes):
        return flat
    (axis,) = _names(axes)
    k = axes.mesh.shape[axis]
    d = axes.mesh.coord(axis)
    n = flat.shape[0]
    if n % k:
        raise ValueError(f"length {n} is not divisible by {k}")
    red = _fold(_wire(axes).all_gather(flat, axis), op)
    return red[d * (n // k) : (d + 1) * (n // k)]


def or_reduce_scatter(x: torch.Tensor, axes, impl: str = "ring"):
    """OR-reduce-scatter of a bool/uint8 array over mesh axes: this rank's
    row block (rows / prod(K)) of the union."""
    if _trivial(axes):
        return x
    names = _names(axes)
    orig = x.dtype
    tail = tuple(x.shape[1:])
    rows = x.shape[0] // axes.size
    if impl == "allgather":
        full = or_allreduce(x, axes, "allgather")
        i = axes.index()
        return full[i * rows : (i + 1) * rows]
    # every other flavor (ring, pmax) takes the packed ring, as in JAX
    packed = _pack_bits((x != 0).reshape(1, -1))[0]
    for a in names:
        packed = ring_reduce_scatter(packed, _single(axes, a),
                                     torch.bitwise_or)
    n_bits = rows * int(np.prod(tail)) if tail else rows
    out = _unpack_bits(packed[None], n_bits)[0]
    return out.reshape(rows, *tail).to(orig)


def _rs_impl(impl: str):
    if impl == "ring":
        return ring_reduce_scatter
    if impl == "allgather":
        return allgather_reduce_scatter
    raise ValueError(f"unknown reduce-scatter impl: {impl}")


def _reduce_scatter(x: torch.Tensor, axes, impl: str, op):
    if _trivial(axes):
        return x
    rs = _rs_impl(impl)
    flat = x.reshape(-1)
    for a in _names(axes):
        flat = rs(flat, _single(axes, a), op)
    return flat.reshape(x.shape[0] // axes.size, *x.shape[1:])


def min_reduce_scatter(x: torch.Tensor, axes, impl: str = "ring"):
    """Min-reduce-scatter (parents, Bellman-Ford, top-k contributions)."""
    return _reduce_scatter(x, axes, impl, torch.minimum)


def sum_reduce_scatter(x: torch.Tensor, axes, impl: str = "ring"):
    """Sum-reduce-scatter (PPR pushes, pattern counts): each shard's
    partial covers its own forward rows, so either flavor rebuilds the
    global sum in a fixed order (the ring's, or coordinate order)."""
    return _reduce_scatter(x, axes, impl, torch.add)


def psum_scatter(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes``, this rank's block of
    ``dim`` (blocks in flat-coordinate order, major axis first): one
    ``Wire.reduce_scatter`` an axis, each folding in coordinate order."""
    if _trivial(axes):
        return x
    wire = _wire(axes)
    x = torch.movedim(x, dim, 0)
    for a in _names(axes):
        x = wire.reduce_scatter(x, a)
    return torch.movedim(x, 0, dim)


def merge_scatter(merge: str, contribution, axes, or_impl: str,
                  impl: str = "ring"):
    """Sharded-state merge: global contributions in, this shard's merged
    row block out. ``impl="allgather"`` also turns an OR ring into the
    allgather flavor (``sync="shard"`` bodies run no ring)."""
    if not axes:
        return contribution
    if impl == "allgather" and or_impl == "ring":
        or_impl = "allgather"
    if merge == "or":
        return or_reduce_scatter(contribution, axes, or_impl)
    if merge == "min":
        return min_reduce_scatter(contribution, axes, impl)
    if merge == "sum":
        return sum_reduce_scatter(contribution, axes, impl)
    if merge == "or_min":
        reached, cand = contribution
        return (or_reduce_scatter(reached, axes, or_impl),
                min_reduce_scatter(cand, axes, impl))
    raise ValueError(f"unknown merge: {merge}")


def gang_merge_scatter(merge: str, contribution, axes, or_impl: str):
    """Sharded-state merge of gang-stacked contributions ``[S, n_out,
    ...]``: the gang axis rotates to the back so rows lead, the row
    reduce-scatter runs unchanged, and the result rotates back to
    ``[S, rows_local, ...]``."""
    if _trivial(axes):
        return contribution
    move = lambda x: torch.movedim(x, 0, -1).contiguous()
    unmove = lambda x: torch.movedim(x, -1, 0).contiguous()
    if merge == "or":
        return unmove(or_reduce_scatter(move(contribution), axes, or_impl))
    if merge == "min":
        return unmove(min_reduce_scatter(move(contribution), axes))
    if merge == "sum":
        return unmove(sum_reduce_scatter(move(contribution), axes))
    if merge == "or_min":
        reached, cand = contribution
        return (unmove(or_reduce_scatter(move(reached), axes, or_impl)),
                unmove(min_reduce_scatter(move(cand), axes)))
    raise ValueError(f"unknown merge: {merge}")


def min_allreduce(x: torch.Tensor, axes) -> torch.Tensor:
    if _trivial(axes):
        return x
    wire = _wire(axes)
    for a in _names(axes):
        x = wire.all_reduce(x, a, dist.ReduceOp.MIN)
    return x


def max_allreduce(x: torch.Tensor, axes) -> torch.Tensor:
    """Max across axes (loop conditions, per-member liveness)."""
    if _trivial(axes):
        return x
    wire = _wire(axes)
    for a in _names(axes):
        x = wire.all_reduce(x, a, dist.ReduceOp.MAX)
    return x


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum across axes in a fixed order: per axis (major first) every
    rank's value is gathered and folded strictly in coordinate order, so
    float sums give the same bits on any backend."""
    if _trivial(axes):
        return x
    wire = _wire(axes)
    for a in _names(axes):
        x = _fold(wire.all_gather(x, a), torch.add)
    return x


def int_psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum of an integer tensor across axes by the backend's SUM: integer
    adds are exact, so any order gives the same result (on overflow,
    the same wrap)."""
    if _trivial(axes):
        return x
    wire = _wire(axes)
    for a in _names(axes):
        x = wire.all_reduce(x, a, dist.ReduceOp.SUM)
    return x


def shift(x: torch.Tensor, axes) -> torch.Tensor:
    """One ring step along ONE mesh axis (JAX's ``ppermute`` to ``i + 1``):
    this rank's ``x`` goes to the next coordinate, the previous
    coordinate's comes back; the identity on an axis of size 1."""
    if _trivial(axes):
        return x
    (axis,) = _names(axes)
    return _wire(axes).shift(x, axis)


def any_over(flag: bool, axes) -> bool:
    """True when ``flag`` holds on any rank of ``axes`` (a loop
    condition: every rank of the group gets the same answer)."""
    if _trivial(axes):
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=axes.mesh.wire_device)
    return bool(max_allreduce(t, axes)[0])


def gather_rows(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in flat-coordinate
    order over ``axes`` (minor axis first, so blocks land major to minor):
    the global array of a row- or morsel-sharded leaf."""
    if _trivial(axes):
        return x
    wire = _wire(axes)
    for a in reversed(_names(axes)):
        g = wire.all_gather(x, a)  # [K, ...]
        x = torch.cat(list(g.unbind(0)), dim=dim)
    return x


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` whose backward is the transpose: the sum over
    ``axes`` of every rank's gradient, this rank's block of ``dim``
    (``psum_scatter``, one ``reduce-scatter`` an axis through ``Wire``)."""

    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return gather_rows(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return psum_scatter(g.contiguous(), ctx.axes, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    """``psum_scatter`` whose backward is the transpose: every rank's
    block of the gradient gathered along ``dim`` over ``axes``
    (``gather_rows``, one ``all-gather`` an axis through ``Wire``)."""

    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return psum_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g.contiguous(), ctx.axes, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    """``psum`` whose backward is ``psum``: a rank's loss reads the sum
    on every rank, so each rank's gradient of it is a share whose sum
    over ``axes`` is the gradient of the summands."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.axes), None


def gather_rows_grad(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """``gather_rows`` under autograd (its backward reduce-scatters)."""
    if _trivial(axes):
        return x
    return _GatherRows.apply(x, axes, dim)


def psum_scatter_grad(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """``psum_scatter`` under autograd (its backward all-gathers)."""
    if _trivial(axes):
        return x
    return _PsumScatter.apply(x, axes, dim)


def psum_grad(x: torch.Tensor, axes) -> torch.Tensor:
    """``psum`` under autograd (its backward is a ``psum``)."""
    if _trivial(axes):
        return x
    return _Psum.apply(x, axes)


def merge_contribution(merge: str, contribution, axes=(),
                       or_impl: str = "allgather"):
    """Apply an edge compute's MERGE across graph axes (replicated
    layout): OR unions, MIN all-reduces, and the ordered sum."""
    if merge == "or":
        return or_allreduce(contribution, axes, or_impl)
    if merge == "min":
        return min_allreduce(contribution, axes)
    if merge == "sum":
        return psum(contribution, axes)
    if merge == "or_min":
        reached, cand = contribution
        return (or_allreduce(reached, axes, or_impl),
                min_allreduce(cand, axes))
    raise ValueError(f"unknown merge: {merge}")


def gang_handoff(state, idx, gang: int, axes):
    """Phase-1 -> phase-2 handoff of the sharded layout: the survivors
    ``idx`` of the stacked global phase-1 state (leaves ``[m, n, ...]``),
    zero-padded to ``gang`` members (all-zero frontiers are inert), and
    this rank's row block over ``axes`` (every mesh axis), the layout the
    sharded gang engine consumes. The phase-1 engine's row gather is the
    all-gather half of JAX's handoff; the slice here is its placement."""
    idx_t = None
    out = []
    for x in state:
        if idx_t is None:
            idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                    device=x.device)
        k = int(idx_t.numel())
        sub = torch.zeros((gang,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        sub[:k] = x[idx_t]
        if axes and axes.size > 1:
            rows = sub.shape[1] // axes.size
            i = axes.index()
            sub = sub[:, i * rows : (i + 1) * rows].contiguous()
        out.append(sub)
    return type(state)(*out)


def gang_scatter_back(full, sub, idx):
    """Write the ``len(idx)`` resumed survivors (leading rows of ``sub``)
    back into the stacked phase-1 state ``full``; gang pad slots are
    dropped. Returns new tensors."""
    idx_t = None
    out = []
    for f, s in zip(full, sub):
        if idx_t is None:
            idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                    device=f.device)
        g = f.clone()
        g[idx_t] = s[: idx_t.numel()]
        out.append(g)
    return type(full)(*out)
