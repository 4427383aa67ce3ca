"""Pluggable frontier-extension backends (port of ``repro.core.extend``).

Backends share one contract and produce bit-identical final states:

- ``ell_push``: forward-ELL scatter from the active rows;
- ``ell_pull``: gather over the padded reverse ELL with visited
  suppression;
- ``pull_binned``: the same pull over degree-binned reverse slabs;
- ``pull_binned_fused``: ``pull_binned`` through the fused
  ``binned_pull`` CUDA kernel (plain PyTorch on CPU tensors);
- ``block_mxu``: the OR-reach over stored 0/1 tiles through the
  ``msbfs_extend`` CUDA kernel (plain PyTorch on CPU tensors); parents,
  the weighted relax and additive pushes stay on the push scatter.

Besides the reach family's primitives every backend serves ``min_dist``
(the Bellman-Ford relax; on ``pull_binned_fused`` the ``binned_pull``
kernel's ``min_dist`` op), ``push_sum`` (the additive push of PPR and
pattern counts, one physical form: the forward scatter) and
``min_topk`` (the k-best relax, one physical form: the reverse gather).

``direction="auto"`` is Beamer's alpha/beta switch between push and a
pull flavor, decided per iteration on the host from the frontier's and
the unexplored edge mass.

On a mesh of ranks every rank holds its graph shard's operands (built
alone by ``operand_stream(...).build_shard(k)``). ``ExtendCtx`` carries
the layout: the replicated layout passes global state tensors and a
``row_offset`` (this shard's first row), the sharded layout passes the
shard's own rows and a ``row_base``. Pull flavors first union the global
frontier across the graph axes (``_global_or`` / ``_global_min``), then
scan their shard and place the result rows into the global
contribution; the direction predicate and the stats tap are summed over
the graph axes, so every rank of a group takes the same branch. On one
device the axes are empty and all of this is the identity.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..graph.csr import (
    BinnedPlan,
    BinnedRevEll,
    CSRGraph,
    EllGraph,
    ShardedBlocks,
    binned_plan,
    binned_rev_csr,
    binned_rev_shard,
    ell_shard,
    sharded_blocks_from_csr,
    sharded_blocks_nb,
    sharded_blocks_shard,
    truncate_csr,
)
from ..graph.partition import padded_n, reverse_shard
from ..kernels.binned_pull.ops import (
    BinnedPullPack,
    binned_pull as _fused_pull,
    build_pack as build_binned_pack,
)
from ..kernels.common import tensor_from_numpy
from ..kernels.msbfs_extend.ops import extend_blocks
from .collectives import min_allreduce, or_allreduce, psum
from .edge_compute import (
    INF,
    NO_PARENT,
    _deg_chunk,
    chunk_fold,
    ell_min_dist,
    ell_min_parent,
    ell_min_parent_lanes,
    ell_min_topk,
    ell_push_sum,
    ell_reach_dense,
    ell_reach_lanes,
)

BACKENDS = (
    "ell_push", "ell_pull", "pull_binned", "pull_binned_fused", "block_mxu"
)


@dataclasses.dataclass(frozen=True)
class ExtendSpec:
    """Static configuration of the extension step (hashable: engine-cache
    key material)."""

    backend: str = "ell_push"  # one of BACKENDS
    direction: str = "fixed"  # fixed | auto (Beamer push/pull switch)
    alpha: float = 14.0  # pull when m_frontier > m_unexplored / alpha
    beta: float = 24.0  # ... and n_frontier > n / beta
    block: int = 128  # tile size of the block_mxu operand
    pull: str = "binned"  # auto's bottom-up flavor

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown extension backend: {self.backend}")
        if self.direction not in ("fixed", "auto"):
            raise ValueError(f"unknown direction mode: {self.direction}")
        if self.pull not in ("binned", "binned_fused", "ell"):
            raise ValueError(f"unknown pull flavor: {self.pull}")
        if self.direction == "auto" and self.backend != "ell_push":
            raise ValueError(
                "direction='auto' switches between push and pull (flavor "
                "chosen by the `pull` field); it cannot be combined with "
                f"backend={self.backend!r}"
            )

    @property
    def needs_rev(self) -> bool:
        """Scans the single padded reverse-ELL slab."""
        return self.backend == "ell_pull" or (
            self.direction == "auto" and self.pull == "ell"
        )

    @property
    def needs_binned(self) -> bool:
        """Scans (or accounts with) the degree-binned reverse slabs."""
        return self.backend in ("pull_binned", "pull_binned_fused") or (
            self.direction == "auto"
            and self.pull in ("binned", "binned_fused")
        )

    @property
    def needs_binned_pack(self) -> bool:
        """Scans the kernel-ready row-padded repack of the binned slabs."""
        return self.backend == "pull_binned_fused" or (
            self.direction == "auto" and self.pull == "binned_fused"
        )

    @property
    def needs_blocks(self) -> bool:
        return self.direction == "fixed" and self.backend == "block_mxu"

    @property
    def structures(self) -> tuple:
        """The ``GraphOperands`` slots this spec scans (``fwd`` always)."""
        return ("fwd",) + tuple(name for need, name in (
            (self.needs_rev, "rev"),
            (self.needs_binned, "rev_binned"),
            (self.needs_binned_pack, "rev_binned_pack"),
            (self.needs_blocks, "blocks"),
        ) if need)

    @property
    def pad_block(self) -> int:
        """Row-padding unit the operands need (tiles must divide the row
        count; 32 keeps bit-packed words aligned)."""
        return self.block if self.needs_blocks else 32


_ALIASES = {
    "dopt": ExtendSpec(direction="auto"),
    "auto": ExtendSpec(direction="auto"),
    "dopt_ell": ExtendSpec(direction="auto", pull="ell"),
    "dopt_binned": ExtendSpec(direction="auto", pull="binned"),
    "dopt_fused": ExtendSpec(direction="auto", pull="binned_fused"),
}


def as_spec(extend) -> ExtendSpec:
    """Normalize a backend name / alias / spec / None to an ExtendSpec."""
    if extend is None:
        return ExtendSpec()
    if isinstance(extend, ExtendSpec):
        return extend
    if isinstance(extend, str):
        if extend in _ALIASES:
            return _ALIASES[extend]
        return ExtendSpec(backend=extend)
    raise TypeError(f"cannot interpret extend={extend!r}")


@dataclasses.dataclass(frozen=True)
class GraphOperands:
    """The physical scan operands of one graph: ``fwd`` always, the others
    only when an engine's ExtendSpec scans them."""

    fwd: EllGraph
    rev: Optional[EllGraph] = None
    rev_binned: Optional[BinnedRevEll] = None
    rev_binned_pack: Optional[BinnedPullPack] = None
    blocks: Optional[ShardedBlocks] = None

    @property
    def n_nodes(self) -> int:
        return self.fwd.n_nodes

    @property
    def device(self) -> torch.device:
        return self.fwd.indices.device


def as_operands(graph) -> GraphOperands:
    if isinstance(graph, GraphOperands):
        return graph
    return GraphOperands(fwd=graph)


def effective_csr(csr: CSRGraph, max_deg: int | None) -> CSRGraph:
    """The edge set every backend scans under a ``max_deg`` cap (the cap
    rounded up to the ELL pad multiple of 8)."""
    cap = None if max_deg is None else -(-int(max_deg) // 8) * 8
    return truncate_csr(csr, cap)


def build_operands(
    csr: CSRGraph,
    extend="ell_push",
    max_deg: int | None = None,
    shards: int = 1,
    block: int | None = None,
    binned_shards: int | None = None,
) -> tuple[GraphOperands, int]:
    """Host-side operand construction (CPU tensors; ``prepare_graph``
    places them). Rows pad to a multiple of ``shards * pad_block``; the
    reverse / binned / block operands derive from the truncated forward
    graph so every backend scans the identical edge set. Returns
    (operands, n_pad)."""
    spec = as_spec(extend)
    pad_block = block or spec.pad_block
    eff = effective_csr(csr, max_deg)
    n_pad = padded_n(eff.n_nodes, shards, pad_block)
    fwd = _padded_ell(eff, n_pad)
    rev = None
    if spec.needs_rev:
        rev = _padded_ell(eff.reverse(), n_pad)
    rev_binned = None
    rev_binned_pack = None
    if spec.needs_binned:
        k = shards if binned_shards is None else int(binned_shards)
        rev_binned = binned_rev_csr(eff, n_pad, k)
        if spec.needs_binned_pack:
            rev_binned_pack = build_binned_pack(rev_binned, n_pad)
    blocks = None
    if spec.needs_blocks:
        blocks = sharded_blocks_from_csr(eff, n_pad, shards, spec.block)
    return (
        GraphOperands(
            fwd=fwd,
            rev=rev,
            rev_binned=rev_binned,
            rev_binned_pack=rev_binned_pack,
            blocks=blocks,
        ),
        n_pad,
    )


def _padded_ell(csr: CSRGraph, n_pad: int) -> EllGraph:
    """``pad_ell(ell_from_csr(csr), ...)`` at ``n_pad`` rows, built in one
    slab (``ell_shard`` over every row) rather than built and copied."""
    cap = _round8(int(csr.degrees.max()) if csr.n_nodes else 0)
    idx, degs, w = ell_shard(csr, 0, n_pad, cap, n_pad)
    return EllGraph(indices=torch.from_numpy(idx),
                    degrees=torch.from_numpy(degs),
                    weights=None if w is None else torch.from_numpy(w))


def operands_from_numpy(leaves: dict, device="cpu") -> GraphOperands:
    """The port's bundle from a flat dict of numpy leaves, named like the
    JAX package's ``OperandStream.build_shard`` keys: ``fwd.indices``,
    ``fwd.degrees``, ``fwd.weights``, the same under ``rev.``,
    ``bn.perm``, ``bn.inv``, ``bn.slab{b}``, ``bn.w{b}``,
    ``pack.inv_pad``, ``pack.perm_pad``, ``pack.slab{b}``, ``pack.w{b}``,
    ``blocks.blocks``, ``blocks.rows``, ``blocks.cols``. Lets both
    packages run on identical operands (the graph plays the part of
    weights)."""
    dev = torch.device(device)

    def t(k):
        return tensor_from_numpy(leaves[k], dev)

    def ell(p):
        if f"{p}.indices" not in leaves:
            return None
        return EllGraph(
            indices=t(f"{p}.indices"),
            degrees=t(f"{p}.degrees"),
            weights=t(f"{p}.weights") if f"{p}.weights" in leaves else None,
        )

    def seq(prefix):
        out, b = [], 0
        while f"{prefix}{b}" in leaves:
            out.append(t(f"{prefix}{b}"))
            b += 1
        return tuple(out)

    bn = None
    if "bn.inv" in leaves:
        bn = BinnedRevEll(
            slabs=seq("bn.slab"), perm=t("bn.perm"), inv=t("bn.inv"),
            slab_weights=seq("bn.w") if "bn.w0" in leaves else None,
        )
    pack = None
    if "pack.inv_pad" in leaves:
        pack = BinnedPullPack(
            slabs=seq("pack.slab"), inv_pad=t("pack.inv_pad"),
            perm_pad=t("pack.perm_pad"),
            slab_weights=seq("pack.w") if "pack.w0" in leaves else None,
        )
    blocks = None
    if "blocks.blocks" in leaves:
        blocks = ShardedBlocks(
            blocks=t("blocks.blocks"), block_rows=t("blocks.rows"),
            block_cols=t("blocks.cols"),
        )
    return GraphOperands(fwd=ell("fwd"), rev=ell("rev"), rev_binned=bn,
                         rev_binned_pack=pack, blocks=blocks)


def operands_shard_from_numpy(leaves: dict, k: int, shards: int,
                              device="cpu") -> GraphOperands:
    """Policy shard ``k`` of ``shards`` of a whole bundle's numpy leaves
    (``operands_from_numpy``'s names, every leaf's axis 0 the row or the
    stacked shard axis): the bundle a rank of a mesh holds. Carries a
    graph built or folded whole (the JAX package's host mirror, say)
    across to one rank, as ``operands_from_numpy`` carries it to one
    device."""
    n_pad = int(leaves["fwd.indices"].shape[0])
    rl = n_pad // shards

    def part(name, a):
        if name.startswith(("fwd.", "rev.")):
            return a[k * rl:(k + 1) * rl]
        return a[k:k + 1]

    return operands_from_numpy(
        {name: part(name, a) for name, a in leaves.items()}, device)


def _round8(cap: int) -> int:
    return -(-cap // 8) * 8 if cap > 0 else 0


@dataclasses.dataclass(frozen=True)
class OperandStream:
    """Shard-at-a-time operand build: ``operand_stream`` runs the global
    O(n) planning passes once (row padding, ELL widths, the binned plan,
    the common tile count) and ``build_shard(k)`` builds only policy
    shard ``k``'s leaves as host numpy arrays, named like the JAX
    package's (``operands_from_numpy`` reads them). Every leaf's axis 0 is
    the sharded axis (rows, or the stacked shard axis of length 1), and
    each piece equals the matching slice of ``build_operands`` bitwise.
    ``structures`` names the ``GraphOperands`` slots built."""

    csr: CSRGraph  # effective (truncated) forward graph
    structures: frozenset
    n_pad: int
    k_shards: int  # policy shard count: the build granularity
    fine_shards: int  # row-padding (lcm) shard count; blocks built fine
    tile: int = 128  # block_mxu tile size
    cap_fwd: Optional[int] = None
    cap_rev: Optional[int] = None
    plan: Optional[BinnedPlan] = None
    nb: Optional[int] = None

    @property
    def rows_local(self) -> int:
        return self.n_pad // self.k_shards

    def build_shard(self, k: int) -> dict:
        """Policy shard ``k``'s leaves: name -> host numpy array."""
        want = self.structures
        rl = self.rows_local
        lo, hi = k * rl, (k + 1) * rl
        leaves = {}
        if "fwd" in want:
            idx, degs, w = ell_shard(self.csr, lo, hi, self.cap_fwd,
                                     self.n_pad)
            leaves["fwd.indices"], leaves["fwd.degrees"] = idx, degs
            if w is not None:
                leaves["fwd.weights"] = w
        rev_local = None
        if want & {"rev", "rev_binned"}:
            rev_local = reverse_shard(self.csr, lo, hi)
        if "rev" in want:
            idx, degs, w = ell_shard(rev_local, 0, rl, self.cap_rev,
                                     self.n_pad)
            leaves["rev.indices"], leaves["rev.degrees"] = idx, degs
            if w is not None:
                leaves["rev.weights"] = w
        if "rev_binned" in want:
            bn = binned_rev_shard(self.plan, k, rev_local)
            leaves["bn.perm"] = bn.perm.numpy()
            leaves["bn.inv"] = bn.inv.numpy()
            for b, x in enumerate(bn.slabs):
                leaves[f"bn.slab{b}"] = x.numpy()
            if bn.slab_weights is not None:
                for b, x in enumerate(bn.slab_weights):
                    leaves[f"bn.w{b}"] = x.numpy()
            if "rev_binned_pack" in want:
                pk = build_binned_pack(bn, self.n_pad)
                leaves["pack.inv_pad"] = pk.inv_pad.numpy()
                leaves["pack.perm_pad"] = pk.perm_pad.numpy()
                for b, x in enumerate(pk.slabs):
                    leaves[f"pack.slab{b}"] = x.numpy()
                if pk.slab_weights is not None:
                    for b, x in enumerate(pk.slab_weights):
                        leaves[f"pack.w{b}"] = x.numpy()
        if "blocks" in want:
            group = self.fine_shards // self.k_shards
            bsz = self.tile
            sb = sharded_blocks_shard(
                self.csr, self.n_pad, self.fine_shards, self.nb,
                k * group, (k + 1) * group, bsz,
            )
            # the fine subshards fold into one policy shard; local
            # row-block ids are re-based like ``_regroup_block_rows``
            rb_fine = (self.n_pad // self.fine_shards) // bsz
            offs = (np.arange(group, dtype=np.int32) * rb_fine)[:, None]
            leaves["blocks.blocks"] = sb.blocks.numpy().reshape(
                1, -1, bsz, bsz)
            leaves["blocks.rows"] = (
                (sb.block_rows.numpy() + offs).reshape(1, -1)
                .astype(np.int32)
            )
            leaves["blocks.cols"] = sb.block_cols.numpy().reshape(1, -1)
        return leaves


def _plan_stream(eff: CSRGraph, structures, n_pad: int, k_shards: int,
                 fine_shards: int, tile: int) -> OperandStream:
    """The global passes ``structures`` need: the forward and reverse ELL
    widths, the binned plan (at ``k_shards``), the common tile count (at
    ``fine_shards``)."""
    want = frozenset(structures)
    n = eff.n_nodes
    cap_fwd = cap_rev = plan = nb = None
    if "fwd" in want:
        cap_fwd = _round8(int(eff.degrees.max()) if n else 0)
    if want & {"rev", "rev_binned"}:
        rev_degs = (np.bincount(eff.indices, minlength=n) if n
                    else np.zeros(0, np.int64))
        if "rev" in want:
            cap_rev = _round8(int(rev_degs.max()) if n else 0)
        if "rev_binned" in want:
            plan = binned_plan(rev_degs, n_pad, k_shards)
    if "blocks" in want:
        nb = sharded_blocks_nb(eff, n_pad, fine_shards, tile)
    return OperandStream(
        csr=eff, structures=want, n_pad=n_pad, k_shards=k_shards,
        fine_shards=fine_shards, tile=tile, cap_fwd=cap_fwd,
        cap_rev=cap_rev, plan=plan, nb=nb,
    )


def operand_stream(
    csr: CSRGraph,
    extend="ell_push",
    max_deg: int | None = None,
    shards: int = 1,
    block: int | None = None,
    binned_shards: int | None = None,
) -> OperandStream:
    """Plan a shard-at-a-time build with ``build_operands``' parameters:
    rows pad for ``shards`` (the lcm count), the binned slabs and the
    build granularity are ``binned_shards`` (the policy's own count)."""
    spec = as_spec(extend)
    pad_block = block or spec.pad_block
    eff = effective_csr(csr, max_deg)
    fine = max(int(shards), 1)
    k = fine if binned_shards is None else int(binned_shards)
    if fine % k:
        raise ValueError(f"{fine} row shards do not fold into {k}")
    n_pad = padded_n(eff.n_nodes, fine, pad_block)
    return _plan_stream(eff, spec.structures, n_pad, k, fine, spec.block)


def rebuild_shard(eff: CSRGraph, n_pad: int, shards: int, k: int,
                  structures, tile: int = 128) -> dict:
    """Policy shard ``k`` of ``shards`` of the named structures, rebuilt
    from the effective graph ``eff`` at ``n_pad`` rows with the new global
    widths, binned plan and tile count: the ``[k]`` slice of a whole
    rebuild, as a graph delta rebuilds a structure it cannot fold (the
    tiles at ``shards`` lists, like ``sharded_blocks_from_csr(eff, n_pad,
    shards)``, whatever finer padding the first build had). Returns
    ``{name: structure}`` of host tensors."""
    st = _plan_stream(eff, structures, n_pad, shards, shards, tile)
    ops = operands_from_numpy(st.build_shard(k))
    return {name: getattr(ops, name) for name in structures}


@dataclasses.dataclass(frozen=True)
class ExtendCtx:
    """Per-call extension context: ``n_out`` is the global output width
    (the padded node count). Replicated layout: global state tensors and
    ``row_offset``, this shard's first row. Sharded layout: the shard's
    own state rows and ``row_base``, the global id of its first row.
    ``axes`` are the graph axes collectives span (``launch.mesh.Axes``);
    on one device every field but ``n_out`` keeps its default."""

    n_out: int
    row_offset: Optional[int] = None
    row_base: Optional[int] = None
    axes: tuple = ()
    or_impl: str = "allgather"
    sharded: bool = False

    @property
    def start(self) -> Optional[int]:
        """Global row id of the first local row (None on one shard)."""
        if self.row_offset is not None:
            return self.row_offset
        return self.row_base


def _place_rows(local: torch.Tensor, ctx: ExtendCtx, fill) -> torch.Tensor:
    """A local-rows result placed into the global ``[n_out, ...]``
    contribution (identity on one shard)."""
    start = ctx.start
    if start is None:
        return local
    out = torch.full((ctx.n_out, *local.shape[1:]), fill, dtype=local.dtype,
                     device=local.device)
    out[start : start + local.shape[0]] = local
    return out


def _local_state(x, rows: int, ctx: ExtendCtx):
    """This shard's rows of a state tensor (sharded state is local)."""
    if x is None or ctx.sharded or ctx.row_offset is None:
        return x
    return x[ctx.row_offset : ctx.row_offset + rows]


def _global_or(x: torch.Tensor, ctx: ExtendCtx) -> torch.Tensor:
    """The global activation tensor of a state tensor: already global in
    the replicated layout; placed and OR-unioned across the graph axes in
    the sharded layout (pull's inverse communication: frontier bits
    travel instead of contributions)."""
    if not ctx.sharded:
        return x
    placed = _place_rows(x, ctx, 0)
    return or_allreduce(placed, ctx.axes, ctx.or_impl)


def _global_min(x: torch.Tensor, ctx: ExtendCtx, fill) -> torch.Tensor:
    if not ctx.sharded:
        return x
    return min_allreduce(_place_rows(x, ctx, fill), ctx.axes)


# ---------------------------------------------------------------------------
# ell_push: forward scatter.
# ---------------------------------------------------------------------------


def _min_topk_pull(ops, dists, src_mask, ctx):
    """The k-best relax every backend shares: a full-Jacobi gather over
    the reverse ELL (a scatter cannot merge k sorted slots). The slot
    table is made global first, the rows placed back for the min merge."""
    if ops.rev is None:
        raise ValueError(
            "top-k relax scans the reverse ELL; build operands with "
            "extend='ell_pull' (needs_rev)"
        )
    rows = ops.rev.n_nodes
    gd = _global_min(dists, ctx, INF)
    seed = torch.where(_local_state(src_mask, rows, ctx), 0.0,
                       INF).to(torch.float32)
    return _place_rows(ell_min_topk(ops.rev, gd, seed), ctx, INF)


class PushBackend:
    name = "ell_push"

    @staticmethod
    def reach_dense(ops, frontier, visited, ctx):
        return ell_reach_dense(ops.fwd, frontier, ctx.n_out,
                               row_offset=ctx.row_offset)

    @staticmethod
    def push_sum(ops, values, ctx, normalize=False):
        return ell_push_sum(ops.fwd, values, ctx.n_out, normalize,
                            row_offset=ctx.row_offset)

    min_topk = staticmethod(_min_topk_pull)

    @staticmethod
    def min_dist(ops, dist, frontier, ctx):
        return ell_min_dist(ops.fwd, dist, frontier, ctx.n_out,
                            row_offset=ctx.row_offset)

    @staticmethod
    def reach_lanes(ops, lanes, visited, ctx):
        return ell_reach_lanes(ops.fwd, lanes, ctx.n_out,
                               row_offset=ctx.row_offset)

    @staticmethod
    def min_parent(ops, frontier, visited, ctx):
        return ell_min_parent(ops.fwd, frontier, ctx.n_out,
                              row_offset=ctx.row_offset,
                              row_base=ctx.row_base)

    @staticmethod
    def min_parent_lanes(ops, lanes, visited, ctx):
        return ell_min_parent_lanes(ops.fwd, lanes, ctx.n_out,
                                    row_offset=ctx.row_offset,
                                    row_base=ctx.row_base)

    @staticmethod
    def reach_parent_dense(ops, frontier, visited, ctx):
        return (
            PushBackend.reach_dense(ops, frontier, visited, ctx),
            PushBackend.min_parent(ops, frontier, visited, ctx),
        )

    @staticmethod
    def reach_parent_lanes(ops, lanes, visited, ctx):
        return (
            PushBackend.reach_lanes(ops, lanes, visited, ctx),
            PushBackend.min_parent_lanes(ops, lanes, visited, ctx),
        )


# ---------------------------------------------------------------------------
# Pull gathers over one ELL-shaped slab ([rows, D] ids, sentinel >= n_out).
# ---------------------------------------------------------------------------


def _extended(src: torch.Tensor, pad) -> torch.Tensor:
    """``src`` plus one trailing pad row: index ``n_out`` reads ``pad``."""
    tail = torch.full((1,) + tuple(src.shape[1:]), pad, dtype=src.dtype,
                      device=src.device)
    return torch.cat([src, tail])


def _slab_fold(s: torch.Tensor, src_ext: torch.Tensor, reduce, acc0,
               lane_bytes: int):
    """Fold ``reduce(acc, ids_chunk, gathered_chunk)`` over degree chunks
    of slab ``s``; ids widen to int64 one chunk at a time, so a wide slab
    is never copied whole."""
    rows, D = s.shape
    n_out = src_ext.shape[0] - 1
    chunk = _deg_chunk(rows, 8 + lane_bytes, budget=1 << 28)

    def step(start, width, acc):
        ids = s[:, start : start + width]
        got = src_ext[ids.clamp(0, n_out).long()]
        return reduce(acc, ids, got)

    return chunk_fold(D, min(chunk, max(D, 1)), step, acc0)


def _gather_any(s, gf_ext):
    """[rows, D] x [n_out+1] bool -> [rows] bool."""
    acc0 = torch.zeros(s.shape[0], dtype=torch.bool, device=s.device)
    return _slab_fold(s, gf_ext, lambda a, i, g: a | g.any(dim=1), acc0, 1)


def _gather_lanes(s, gl_ext):
    """[rows, D] x [n_out+1, L] -> [rows, L] max."""
    n_lanes = gl_ext.shape[-1]
    acc0 = torch.zeros((s.shape[0], n_lanes), dtype=gl_ext.dtype,
                       device=s.device)
    return _slab_fold(
        s, gl_ext, lambda a, i, g: torch.maximum(a, g.amax(dim=1)), acc0,
        n_lanes,
    )


def _gather_min_parent(s, gf_ext):
    """[rows] min in-neighbor id whose frontier bit is set."""
    acc0 = torch.full((s.shape[0],), NO_PARENT, dtype=torch.int32,
                      device=s.device)

    def red(a, ids, got):
        cand = torch.where(got, ids, NO_PARENT).amin(dim=1)
        return torch.minimum(a, cand)

    return _slab_fold(s, gf_ext, red, acc0, 5)


def _gather_min_parent_lanes(s, gl_ext):
    """[rows, L] per-lane min in-neighbor id whose lane bit is set."""
    n_lanes = gl_ext.shape[-1]
    acc0 = torch.full((s.shape[0], n_lanes), NO_PARENT, dtype=torch.int32,
                      device=s.device)

    def red(a, ids, got):
        cand = torch.where(got != 0, ids[:, :, None], NO_PARENT).amin(dim=1)
        return torch.minimum(a, cand)

    return _slab_fold(s, gl_ext, red, acc0, 5 * n_lanes)


def _gather_min_dist(s, w, gdu_ext):
    """[rows, D] ids (+ [rows, D] f32 weights, None = unit) x [n_out+1]
    f32 -> [rows] min of gdu[u] + w over each row's slots."""
    rows, D = s.shape
    n_out = gdu_ext.shape[0] - 1
    acc0 = torch.full((rows,), INF, dtype=torch.float32, device=s.device)
    chunk = _deg_chunk(rows, 16, budget=1 << 28)

    def step(start, width, acc):
        ids = s[:, start : start + width]
        got = gdu_ext[ids.clamp(0, n_out).long()]
        got = got + (1.0 if w is None else w[:, start : start + width])
        return torch.minimum(acc, got.amin(dim=1))

    return chunk_fold(D, min(chunk, max(D, 1)), step, acc0)


def _suppress(x, visited, value):
    if visited is None:
        return x
    if x.dtype == torch.bool:
        return x & ~(visited != 0)
    return torch.where(visited != 0, torch.tensor(value, dtype=x.dtype,
                                                  device=x.device), x)


class PullBackend:
    """Gather over the padded reverse ELL with visited suppression. The
    ``_`` cores take the global activation tensor and return the
    shard's rows placed into the global contribution."""

    name = "ell_pull"

    @staticmethod
    def _reach_dense(ops, gf, visited, ctx):
        rows = ops.rev.n_nodes
        r = _gather_any(ops.rev.indices, _extended(gf, False))
        return _place_rows(
            _suppress(r, _local_state(visited, rows, ctx), False), ctx,
            False)

    @staticmethod
    def _reach_lanes(ops, gl, visited, ctx):
        rows = ops.rev.n_nodes
        r = _gather_lanes(ops.rev.indices, _extended(gl, 0))
        return _place_rows(
            _suppress(r, _local_state(visited, rows, ctx), 0), ctx, 0)

    @staticmethod
    def _min_parent(ops, gf, visited, ctx):
        rows = ops.rev.n_nodes
        cand = _gather_min_parent(ops.rev.indices, _extended(gf, False))
        return _place_rows(
            _suppress(cand, _local_state(visited, rows, ctx), NO_PARENT),
            ctx, NO_PARENT)

    @staticmethod
    def _min_parent_lanes(ops, gl, visited, ctx):
        rows = ops.rev.n_nodes
        cand = _gather_min_parent_lanes(ops.rev.indices, _extended(gl, 0))
        return _place_rows(
            _suppress(cand, _local_state(visited, rows, ctx), NO_PARENT),
            ctx, NO_PARENT)

    @staticmethod
    def _min_dist(ops, gdu, ctx):
        cand = _gather_min_dist(ops.rev.indices, ops.rev.weights,
                                _extended(gdu, INF))
        return _place_rows(cand, ctx, INF)


class BinnedPullBackend:
    """The ``ell_pull`` contract over ``BinnedRevEll`` slabs: each degree
    bucket padded only to its own width, results un-permuted through
    ``inv``."""

    name = "pull_binned"

    @staticmethod
    def _binned_map(bn: BinnedRevEll, per_slab, neutral):
        """``per_slab(b, slab)`` over every nonempty slab, ``neutral(rows)``
        for the others, un-permuted to local row order."""
        parts = []
        for b, slab in enumerate(bn.slabs):
            s = slab[0]
            if s.shape[0] == 0 or s.shape[1] == 0:
                parts.append(neutral(s.shape[0]))
            else:
                parts.append(per_slab(b, s))
        cat = torch.cat(parts) if len(parts) > 1 else parts[0]
        return cat[bn.inv[0].long()]

    @staticmethod
    def _reach_dense(ops, gf, visited, ctx):
        bn = ops.rev_binned
        ext = _extended(gf, False)
        dev = gf.device
        reached = BinnedPullBackend._binned_map(
            bn, lambda b, s: _gather_any(s, ext),
            lambda r: torch.zeros(r, dtype=torch.bool, device=dev),
        )
        vloc = _local_state(visited, bn.rows_local, ctx)
        return _place_rows(_suppress(reached, vloc, False), ctx, False)

    @staticmethod
    def _reach_lanes(ops, gl, visited, ctx):
        bn = ops.rev_binned
        ext = _extended(gl, 0)
        n_lanes = gl.shape[-1]
        reached = BinnedPullBackend._binned_map(
            bn, lambda b, s: _gather_lanes(s, ext),
            lambda r: torch.zeros((r, n_lanes), dtype=gl.dtype,
                                  device=gl.device),
        )
        vloc = _local_state(visited, bn.rows_local, ctx)
        return _place_rows(_suppress(reached, vloc, 0), ctx, 0)

    @staticmethod
    def _min_parent(ops, gf, visited, ctx):
        bn = ops.rev_binned
        ext = _extended(gf, False)
        cand = BinnedPullBackend._binned_map(
            bn, lambda b, s: _gather_min_parent(s, ext),
            lambda r: torch.full((r,), NO_PARENT, dtype=torch.int32,
                                 device=gf.device),
        )
        vloc = _local_state(visited, bn.rows_local, ctx)
        return _place_rows(_suppress(cand, vloc, NO_PARENT), ctx, NO_PARENT)

    @staticmethod
    def _min_parent_lanes(ops, gl, visited, ctx):
        bn = ops.rev_binned
        ext = _extended(gl, 0)
        n_lanes = gl.shape[-1]
        cand = BinnedPullBackend._binned_map(
            bn, lambda b, s: _gather_min_parent_lanes(s, ext),
            lambda r: torch.full((r, n_lanes), NO_PARENT, dtype=torch.int32,
                                 device=gl.device),
        )
        vloc = _local_state(visited, bn.rows_local, ctx)
        return _place_rows(_suppress(cand, vloc, NO_PARENT), ctx, NO_PARENT)

    @staticmethod
    def _min_dist(ops, gdu, ctx):
        bn = ops.rev_binned
        ext = _extended(gdu, INF)
        cand = BinnedPullBackend._binned_map(
            bn,
            lambda b, s: _gather_min_dist(
                s, None if bn.slab_weights is None else bn.slab_weights[b][0],
                ext,
            ),
            lambda r: torch.full((r,), INF, dtype=torch.float32,
                                 device=gdu.device),
        )
        return _place_rows(cand, ctx, INF)


class FusedBinnedPullBackend:
    """``pull_binned`` through the fused ``binned_pull`` kernel over the
    row-padded pack of this rank's shard (``rows_local`` may be below
    ``n_out``); bit-identical to ``pull_binned``."""

    name = "pull_binned_fused"

    @staticmethod
    def _vloc(ops, visited, ctx):
        return _local_state(visited, ops.rev_binned_pack.rows_local, ctx)

    @staticmethod
    def _reach_dense(ops, gf, visited, ctx):
        r = _fused_pull(ops.rev_binned_pack, gf,
                        FusedBinnedPullBackend._vloc(ops, visited, ctx),
                        op="reach") != 0
        return _place_rows(r, ctx, False)

    @staticmethod
    def _reach_lanes(ops, gl, visited, ctx):
        r = _fused_pull(ops.rev_binned_pack, gl,
                        FusedBinnedPullBackend._vloc(ops, visited, ctx),
                        op="reach_lanes")
        return _place_rows(r.to(gl.dtype), ctx, 0)

    @staticmethod
    def _min_parent(ops, gf, visited, ctx):
        cand = _fused_pull(ops.rev_binned_pack, gf,
                           FusedBinnedPullBackend._vloc(ops, visited, ctx),
                           op="min_parent")
        return _place_rows(cand, ctx, NO_PARENT)

    @staticmethod
    def _min_parent_lanes(ops, gl, visited, ctx):
        cand = _fused_pull(ops.rev_binned_pack, gl,
                           FusedBinnedPullBackend._vloc(ops, visited, ctx),
                           op="min_parent_lanes")
        return _place_rows(cand, ctx, NO_PARENT)

    @staticmethod
    def _min_dist(ops, gdu, ctx):
        cand = _fused_pull(ops.rev_binned_pack, gdu, None, op="min_dist")
        return _place_rows(cand, ctx, INF)


def _pull_contract(cls):
    """Public backend methods of a pull flavor from its cores: the
    frontier (or the masked distance) is made global first, once per
    call. The additive push and the k-best relax have one physical form
    each, the forward scatter and the reverse gather."""
    cls.min_dist = staticmethod(lambda ops, dist, frontier, ctx: cls._min_dist(
        ops, _global_min(torch.where(frontier != 0, dist, INF), ctx, INF),
        ctx))
    cls.push_sum = staticmethod(PushBackend.push_sum)
    cls.min_topk = staticmethod(_min_topk_pull)
    cls.reach_dense = staticmethod(lambda ops, f, v, ctx: cls._reach_dense(
        ops, _global_or(f, ctx), v, ctx))
    cls.reach_lanes = staticmethod(lambda ops, f, v, ctx: cls._reach_lanes(
        ops, _global_or(f, ctx), v, ctx))
    cls.min_parent = staticmethod(lambda ops, f, v, ctx: cls._min_parent(
        ops, _global_or(f, ctx), v, ctx))
    cls.min_parent_lanes = staticmethod(
        lambda ops, f, v, ctx: cls._min_parent_lanes(
            ops, _global_or(f, ctx), v, ctx))

    def reach_parent_dense(ops, f, v, ctx):
        gf = _global_or(f, ctx)  # one union serves both scans
        return cls._reach_dense(ops, gf, v, ctx), cls._min_parent(
            ops, gf, v, ctx)

    def reach_parent_lanes(ops, f, v, ctx):
        gl = _global_or(f, ctx)
        return cls._reach_lanes(ops, gl, v, ctx), cls._min_parent_lanes(
            ops, gl, v, ctx)

    cls.reach_parent_dense = staticmethod(reach_parent_dense)
    cls.reach_parent_lanes = staticmethod(reach_parent_lanes)
    return cls


for _cls in (PullBackend, BinnedPullBackend, FusedBinnedPullBackend):
    _pull_contract(_cls)


# ---------------------------------------------------------------------------
# block_mxu: OR-reach over stored tiles through the msbfs_extend kernel.
# ---------------------------------------------------------------------------


class BlockBackend:
    """OR-reach over the stored 0/1 tiles; candidate parents and the
    weighted relax have no 0/1 product form and stay on the push scatter
    (same merged values)."""

    name = "block_mxu"

    @staticmethod
    def reach_lanes(ops, lanes, visited, ctx):
        sb = ops.blocks
        bsz = sb.block_size
        rows = ops.fwd.n_nodes
        n_lanes = lanes.shape[-1]
        local = _local_state(lanes, rows, ctx)
        out = extend_blocks(
            sb.blocks[0], sb.block_rows[0], sb.block_cols[0],
            local.reshape(rows // bsz, bsz, n_lanes), g_out=ctx.n_out // bsz,
        )
        return out.reshape(ctx.n_out, n_lanes)

    @staticmethod
    def reach_dense(ops, frontier, visited, ctx):
        lanes = frontier[:, None].to(torch.uint8)
        return BlockBackend.reach_lanes(ops, lanes, visited, ctx)[:, 0] != 0

    @staticmethod
    def push_sum(ops, values, ctx, normalize=False):
        """Additive count/mass propagation ``out[v] = sum_u values[u] *
        A[u, v]``. JAX runs it as a block matmul over the tiles; CUDA has
        no int32 matmul, and integer sums are exact in any order, so
        integer values (pattern counts) take the exact scatter of
        ``ell_push`` over the same edge set, bitwise equal to JAX's
        product. Float values take ``ell_push``'s fixed-order sum, so a
        PPR pinned to this backend is deterministic (JAX's float product
        may differ from it in the last ulp)."""
        return PushBackend.push_sum(ops, values, ctx, normalize)

    min_parent = staticmethod(PushBackend.min_parent)
    min_parent_lanes = staticmethod(PushBackend.min_parent_lanes)
    min_dist = staticmethod(PushBackend.min_dist)
    min_topk = staticmethod(_min_topk_pull)

    @staticmethod
    def reach_parent_dense(ops, frontier, visited, ctx):
        return (
            BlockBackend.reach_dense(ops, frontier, visited, ctx),
            PushBackend.min_parent(ops, frontier, visited, ctx),
        )

    @staticmethod
    def reach_parent_lanes(ops, lanes, visited, ctx):
        return (
            BlockBackend.reach_lanes(ops, lanes, visited, ctx),
            PushBackend.min_parent_lanes(ops, lanes, visited, ctx),
        )


# ---------------------------------------------------------------------------
# direction="auto": Beamer's alpha/beta switch, and the stats tap.
# ---------------------------------------------------------------------------


def _predicate_locals(ops, frontier, visited, ctx: ExtendCtx):
    """This shard's ``(n_f, m_f, m_u, unvis)``: active-row count, frontier
    out-edge mass, unexplored out-edge mass (float32 device scalars,
    before the sum over the graph axes) and the unvisited-row mask (None
    when the compute keeps no visited set)."""
    rows = ops.fwd.n_nodes
    frontier = _local_state(frontier, rows, ctx)
    visited = _local_state(visited, rows, ctx)
    act = (frontier != 0) if frontier.ndim == 1 else (frontier != 0).any(-1)
    deg = ops.fwd.degrees.to(torch.float32)
    n_f = act.sum(dtype=torch.float32)
    m_f = (deg * act).sum()
    if visited is not None:
        vis = (visited != 0) if visited.ndim == 1 else (visited != 0).any(-1)
        unvis = ~vis
        m_u = (deg * unvis).sum()
    else:
        unvis = None
        m_u = deg.sum() - m_f
    return n_f, m_f, m_u, unvis


#: columns of one ``frontier_stats`` sample
STATS_WIDTH = 6
#: bytes one int32 adjacency slot streams through an extension scan
BYTES_PER_SLOT = 5.0


def frontier_stats(ops, state, ctx: ExtendCtx, bin_widths=None):
    """One per-iteration sample for the online direction-threshold
    learner: ``[n_f, m_f, m_u, pull_slots_binned, wall_ms, pull_bytes]``
    float32 of the state about to extend, summed over ``ctx.axes``.
    ``wall_ms`` is host-filled (-1 here); the slot columns are -1 when
    ``bin_widths`` (this shard's per-row binned slab widths) is None."""
    visited = getattr(state, "visited", None)
    n_f, m_f, m_u, unvis = _predicate_locals(ops, state.frontier, visited,
                                             ctx)
    if bin_widths is None:
        pull = torch.zeros((), dtype=torch.float32, device=n_f.device)
    elif unvis is None:
        pull = bin_widths.sum()
    else:
        pull = (bin_widths * unvis).sum()
    minus1 = torch.full((), -1.0, dtype=torch.float32, device=n_f.device)
    if ctx.axes:
        n_f, m_f, m_u, pull = psum(torch.stack([n_f, m_f, m_u, pull]),
                                   ctx.axes).unbind(0)
    if bin_widths is None:
        return torch.stack([n_f, m_f, m_u, minus1, minus1, minus1])
    return torch.stack([n_f, m_f, m_u, pull, minus1, pull * BYTES_PER_SLOT])


def stats_bin_widths(ops: GraphOperands):
    """Per-local-row binned slab widths (float32) for the stats tap, or
    None when the operands carry no binned slabs."""
    if ops.rev_binned is None:
        return None
    bn = ops.rev_binned
    wvec = torch.cat([
        torch.full((s.shape[-2],), float(s.shape[-1]), dtype=torch.float32,
                   device=bn.inv.device)
        for s in bn.slabs
    ])
    return wvec[bn.inv[0].long()]


class AutoBackend:
    """Per-iteration push/pull choice. The predicate's inputs are summed
    over the graph axes and read on the host (one sync per iteration),
    so every rank of a group takes the same branch, and exactly one
    branch runs; the pull branch makes its frontier global first."""

    name = "dopt"

    def __init__(self, spec: ExtendSpec):
        self.alpha = spec.alpha
        self.beta = spec.beta
        self.pull_be = {
            "binned": BinnedPullBackend,
            "binned_fused": FusedBinnedPullBackend,
            "ell": PullBackend,
        }[spec.pull]

    def use_pull(self, ops, frontier, visited, ctx) -> bool:
        n_f, m_f, m_u, _ = _predicate_locals(ops, frontier, visited, ctx)
        alpha = torch.tensor(self.alpha, dtype=torch.float32)
        beta = torch.tensor(self.beta, dtype=torch.float32)
        stats = torch.stack([n_f, m_f, m_u])
        if ctx.axes:
            stats = psum(stats, ctx.axes)
        n_f, m_f, m_u = stats.cpu().unbind(0)
        # float32 products, like the JAX predicate
        return bool((m_f * alpha > m_u) & (n_f * beta > ctx.n_out))

    def reach_dense(self, ops, frontier, visited, ctx):
        if self.use_pull(ops, frontier, visited, ctx):
            return self.pull_be._reach_dense(
                ops, _global_or(frontier, ctx), visited, ctx)
        return PushBackend.reach_dense(ops, frontier, visited, ctx)

    def reach_lanes(self, ops, lanes, visited, ctx):
        if self.use_pull(ops, lanes, visited, ctx):
            return self.pull_be._reach_lanes(
                ops, _global_or(lanes, ctx), visited, ctx)
        return PushBackend.reach_lanes(ops, lanes, visited, ctx)

    def min_parent(self, ops, frontier, visited, ctx):
        if self.use_pull(ops, frontier, visited, ctx):
            return self.pull_be._min_parent(
                ops, _global_or(frontier, ctx), visited, ctx)
        return PushBackend.min_parent(ops, frontier, visited, ctx)

    def min_parent_lanes(self, ops, lanes, visited, ctx):
        if self.use_pull(ops, lanes, visited, ctx):
            return self.pull_be._min_parent_lanes(
                ops, _global_or(lanes, ctx), visited, ctx)
        return PushBackend.min_parent_lanes(ops, lanes, visited, ctx)

    def min_dist(self, ops, dist, frontier, ctx):
        # the relax keeps no visited set: the predicate's unexplored mass
        # is the total minus the frontier's
        if self.use_pull(ops, frontier, None, ctx):
            gdu = _global_min(torch.where(frontier != 0, dist, INF), ctx,
                              INF)
            return self.pull_be._min_dist(ops, gdu, ctx)
        return PushBackend.min_dist(ops, dist, frontier, ctx)

    # the additive push and the k-best relax have one physical form each
    push_sum = staticmethod(PushBackend.push_sum)
    min_topk = staticmethod(_min_topk_pull)

    def reach_parent_dense(self, ops, frontier, visited, ctx):
        if self.use_pull(ops, frontier, visited, ctx):
            gf = _global_or(frontier, ctx)
            return (self.pull_be._reach_dense(ops, gf, visited, ctx),
                    self.pull_be._min_parent(ops, gf, visited, ctx))
        return PushBackend.reach_parent_dense(ops, frontier, visited, ctx)

    def reach_parent_lanes(self, ops, lanes, visited, ctx):
        if self.use_pull(ops, lanes, visited, ctx):
            gl = _global_or(lanes, ctx)
            return (self.pull_be._reach_lanes(ops, gl, visited, ctx),
                    self.pull_be._min_parent_lanes(ops, gl, visited, ctx))
        return PushBackend.reach_parent_lanes(ops, lanes, visited, ctx)


_FIXED = {
    "ell_push": PushBackend,
    "ell_pull": PullBackend,
    "pull_binned": BinnedPullBackend,
    "pull_binned_fused": FusedBinnedPullBackend,
    "block_mxu": BlockBackend,
}


def make_backend(spec: ExtendSpec):
    """ExtendSpec -> backend object implementing the primitive contract."""
    if spec.direction == "auto":
        return AutoBackend(spec)
    return _FIXED[spec.backend]


def check_operands(spec: ExtendSpec, ops: GraphOperands) -> None:
    """Raise when ``ops`` lacks a structure ``spec`` scans."""
    missing = [name for name in spec.structures
               if getattr(ops, name) is None]
    if missing:
        raise ValueError(
            f"extend={spec.backend}/{spec.direction}/{spec.pull} needs "
            f"operands {missing}; build them with build_operands or "
            "prepare_graph(..., extend=spec)"
        )


class BackendCostProbe:
    """Measured per-slot extension cost (the ``cost="measured"`` lane):
    times one ``reach_dense`` step per backend the bundle supports against
    a half-full frontier and divides by the backend's full-scan slots.

    Timing: CUDA events around ``reps`` launches on a CUDA device (median);
    ``time.perf_counter`` medians on the CPU."""

    def __init__(self, reps: int = 3):
        self.reps = int(reps)

    def measure_ms(self, fn, *args) -> float:
        dev = args[0].device
        fn(*args)  # warm: builds the kernels, fills caches
        walls = []
        for _ in range(self.reps):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                walls.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn(*args)
                walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        return walls[len(walls) // 2]

    def rates(self, ops, n_pad: int) -> dict:
        """``{backend: {"ms_per_slot", "bytes_per_slot", "probe_ms",
        "slots"}}`` for every backend ``ops`` can run."""
        ops = as_operands(ops)
        ctx = ExtendCtx(n_out=n_pad)
        dev = ops.device
        frontier = torch.arange(n_pad, device=dev) < max(n_pad // 2, 1)
        # this rank's rows (all rows on one device)
        visited = torch.zeros(ops.fwd.n_nodes, dtype=torch.bool, device=dev)
        probes = {"ell_push": (PushBackend, int(ops.fwd.indices.numel()))}
        if ops.rev_binned is not None:
            probes["pull_binned"] = (
                BinnedPullBackend, ops.rev_binned.capacity_slots
            )
        if ops.rev_binned_pack is not None:
            probes["pull_binned_fused"] = (
                FusedBinnedPullBackend, ops.rev_binned_pack.capacity_slots
            )
        out = {}
        for name, (be, slots) in probes.items():
            ms = self.measure_ms(
                lambda f, v, be=be: be.reach_dense(ops, f, v, ctx),
                frontier, visited,
            )
            out[name] = {
                "ms_per_slot": ms / max(slots, 1),
                "bytes_per_slot": BYTES_PER_SLOT,
                "probe_ms": ms,
                "slots": slots,
            }
        return out
