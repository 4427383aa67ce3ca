"""Edge deltas and incremental operand folding for mutable graphs (port of
``repro.graph.delta``).

A ``GraphDelta`` is one batch of edge edits (deletes applied first, then
inserts) against a host ``CSRGraph``. Two consumers:

- ``apply_delta_csr(csr, delta)``: the semantic update. It rebuilds the
  host CSR from the surviving + inserted edge list through the one shared
  ``csr_from_edges`` path (stable keep-first dedup), so the updated graph
  is edge-for-edge what a build from scratch gives. Every fold below must
  match it.
- ``diff_effective`` + ``fold_operands``: the incremental update. Given
  the old and new effective (degree-truncated) graphs, they compute which
  padded rows / edge keys changed and rewrite only those in a writable
  host mirror of the device operand bundle. A structure keeps its shapes
  whenever its slabs can absorb the change (re-binning moves rows between
  existing degree buckets through the perm/inverse contract, keeping the
  ``width/deg <= max_overhead`` invariant); a row that fits no existing
  slab rebuilds that one structure, reported per structure so the
  dispatcher bumps engine epochs only for shape changes.

Everything here is host-side: the mirror's leaves are CPU tensors and the
folds write into their ``.numpy()`` views. Placing the changed structures
on the device (and the engine-cache versioning) is the dispatcher's job.

On a mesh of ranks a sharded bundle's mirror holds one policy shard
(``RankShard``): its ELL rows ``[lo, hi)`` and its stacked structures at
stacked index 0. Every rank computes the same global diff (each holds the
whole host CSR), folds only the dirty rows and tiles of its own shard,
and reads in-neighbors through ``reverse_shard``, so no rank builds
another rank's rows. A structure one shard cannot fold is rebuilt on
every shard (``core.extend.rebuild_shard``): the fold asks ``agree`` (an
OR over the ranks sharing the bundle) at fixed points, in one order on
every rank. Free slots are chosen per shard, so a shard's fold gives the
slots the whole-mirror fold gives it. A whole mirror (one device, or a
bundle every rank holds whole) is the one shard of one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.extend import rebuild_shard
from ..kernels.common import drop_derived
from .csr import CSRGraph, EllGraph, csr_from_edges
from .partition import reverse_shard

# Structure slots of a ``core.extend.GraphOperands`` bundle, in field order.
STRUCTURES = ("fwd", "rev", "rev_binned", "rev_binned_pack", "blocks")


def _np(t: torch.Tensor) -> np.ndarray:
    """The writable numpy view of a host-mirror leaf (a CPU tensor)."""
    return t.numpy()


# ---------------------------------------------------------------------------
# The delta itself
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batch of edge edits against a host CSR graph.

    Semantics: deletions apply first against the current edge set, then
    insertions, so ``apply_delta_csr(g, d)`` is edge-for-edge what
    ``csr_from_edges`` produces over ``(edges(g) - deletes) + inserts``
    with ``dedup=True``. Duplicate edges inside either batch collapse,
    deleting an absent edge does nothing, and re-inserting a present edge
    keeps the existing edge and its weight (keep-first dedup, surviving
    old edges sorted ahead of same-key inserts). Self-loops are ordinary
    edges.
    """

    add_src: np.ndarray = None  # [n_adds] int64
    add_dst: np.ndarray = None  # [n_adds] int64
    del_src: np.ndarray = None  # [n_dels] int64
    del_dst: np.ndarray = None  # [n_dels] int64
    add_weights: Optional[np.ndarray] = None  # [n_adds] float32

    def __post_init__(self):
        conv = lambda a: np.asarray(
            [] if a is None else a, dtype=np.int64
        ).reshape(-1)
        object.__setattr__(self, "add_src", conv(self.add_src))
        object.__setattr__(self, "add_dst", conv(self.add_dst))
        object.__setattr__(self, "del_src", conv(self.del_src))
        object.__setattr__(self, "del_dst", conv(self.del_dst))
        if self.add_weights is not None:
            object.__setattr__(
                self,
                "add_weights",
                np.asarray(self.add_weights, np.float32).reshape(-1),
            )
        if len(self.add_src) != len(self.add_dst):
            raise ValueError("add_src/add_dst length mismatch")
        if len(self.del_src) != len(self.del_dst):
            raise ValueError("del_src/del_dst length mismatch")
        if self.add_weights is not None and len(self.add_weights) != len(
            self.add_src
        ):
            raise ValueError("add_weights length mismatch")

    @property
    def n_adds(self) -> int:
        return len(self.add_src)

    @property
    def n_dels(self) -> int:
        return len(self.del_src)

    def touched_rows(self) -> np.ndarray:
        """Unique forward rows (source nodes) the delta names."""
        return np.unique(np.concatenate([self.add_src, self.del_src]))

    def validate(self, n_nodes: int) -> None:
        for name in ("add_src", "add_dst", "del_src", "del_dst"):
            a = getattr(self, name)
            if len(a) and (int(a.min()) < 0 or int(a.max()) >= n_nodes):
                raise ValueError(
                    f"{name} contains node ids outside [0, {n_nodes})"
                )


def random_delta(
    csr: CSRGraph, n_adds: int, n_dels: int, seed: int = 0
) -> GraphDelta:
    """Seeded delta: deletes sampled with replacement from the live edges
    (duplicates exercise the dedup contract), inserts uniform over the id
    space (self-loops and collisions with live edges allowed)."""
    rng = np.random.default_rng(seed)
    n = csr.n_nodes
    if csr.n_edges and n_dels:
        src_all, dst_all = csr.edge_list()
        pick = rng.integers(0, csr.n_edges, size=n_dels)
        dsrc = src_all[pick].astype(np.int64)
        ddst = dst_all[pick].astype(np.int64)
    else:
        dsrc = ddst = np.zeros(0, np.int64)
    asrc = rng.integers(0, n, size=n_adds)
    adst = rng.integers(0, n, size=n_adds)
    aw = None
    if csr.weights is not None:
        aw = rng.uniform(0.1, 2.0, size=n_adds).astype(np.float32)
    return GraphDelta(asrc, adst, dsrc, ddst, add_weights=aw)


def apply_delta_csr(csr: CSRGraph, delta: GraphDelta) -> CSRGraph:
    """Apply ``delta`` to the host CSR through ``csr_from_edges(dedup=True)``,
    the same code path a build from scratch takes, so the two can never
    disagree on degrees."""
    n = csr.n_nodes
    delta.validate(n)
    if delta.add_weights is not None and csr.weights is None:
        raise ValueError("delta carries add_weights but graph is unweighted")
    src, dst = csr.edge_list()
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    w = csr.weights
    if delta.n_dels:
        dkey = np.unique(delta.del_src * n + delta.del_dst)
        keep = ~np.isin(src * n + dst, dkey)
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
    asrc, adst = delta.add_src, delta.add_dst
    w_all = None
    if w is not None:
        aw = delta.add_weights
        if aw is None:
            aw = np.ones(len(asrc), np.float32)
        w_all = np.concatenate([w, aw])
    return csr_from_edges(
        n,
        np.concatenate([src, asrc]),
        np.concatenate([dst, adst]),
        weights=w_all,
        dedup=True,
    )


# ---------------------------------------------------------------------------
# Effective-edge diff
# ---------------------------------------------------------------------------


def _row_edge_keys(eff: CSRGraph, rows: np.ndarray, n: int):
    """Flattened ``src * n + dst`` keys of the effective edges of ``rows``,
    plus the weights at the same flat positions (``None`` unweighted)."""
    ptr = eff.indptr
    counts = (ptr[rows + 1] - ptr[rows]).astype(np.int64)
    flat_rows = np.repeat(rows, counts)
    offs = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    pos = np.repeat(ptr[rows], counts) + offs
    keys = flat_rows * n + eff.indices[pos].astype(np.int64)
    w = eff.weights[pos] if eff.weights is not None else None
    return keys, w


@dataclasses.dataclass(frozen=True)
class DeltaDiff:
    """What changed between two effective graphs, keyed for the
    per-structure folds. ``added``/``removed`` are ``src * n + dst`` edge
    keys; dirty rows are the rows whose membership set or per-edge weights
    changed (a row with the same set and weights keeps its within-row edge
    order in both orientations, so it needs no rewrite). Weight-only
    changes never enter ``added``/``removed``: the 0/1 tiles see no
    weights."""

    n_nodes: int
    fwd_dirty: np.ndarray  # int64 forward rows to rewrite
    rev_dirty: np.ndarray  # int64 reverse rows (dst nodes) to rewrite
    added: np.ndarray  # int64 effective edge keys
    removed: np.ndarray  # int64 effective edge keys
    # edges in both effective sets whose weight changed (a delete and a
    # re-insert of one edge at a new weight inside one delta)
    reweighted: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )

    @property
    def n_changed_edges(self) -> int:
        return len(self.added) + len(self.removed)


def diff_effective(
    old_eff: CSRGraph, new_eff: CSRGraph, delta: GraphDelta
) -> DeltaDiff:
    """Diff the effective (degree-truncated) edge sets over the rows the
    delta touches. Exact under truncation: a delete can pull a truncated
    edge into the cap and an insert can push one out, and both show
    because full per-row effective sets are compared. On weighted graphs
    edges in both sets are also compared by weight."""
    n = old_eff.n_nodes
    rows = delta.touched_rows()
    old_keys, old_w = _row_edge_keys(old_eff, rows, n)
    new_keys, new_w = _row_edge_keys(new_eff, rows, n)
    removed = np.setdiff1d(old_keys, new_keys)
    added = np.setdiff1d(new_keys, old_keys)
    changed = np.concatenate([added, removed])
    reweighted = np.zeros(0, np.int64)
    if old_w is not None and new_w is not None:
        # keys are unique (dedup'd CSR rows): intersect aligns the edges
        # that survive in both sets
        common, io, inew = np.intersect1d(
            old_keys, new_keys, return_indices=True
        )
        reweighted = common[old_w[io] != new_w[inew]]
    dirty = np.concatenate([changed, reweighted])
    return DeltaDiff(
        n_nodes=n,
        fwd_dirty=np.unique(dirty // n),
        rev_dirty=np.unique(dirty % n),
        added=added,
        removed=removed,
        reweighted=reweighted,
    )


# ---------------------------------------------------------------------------
# Folding into the operand structures (host mirror, in place)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FoldReport:
    """Per-structure outcome of one ``fold_operands`` call.

    ``changed[s]``: content differs, its device tensors need re-placing.
    ``reshaped[s]``: the fold could not keep shapes; the structure was
    rebuilt and engines keyed on its old shapes must be invalidated (an
    epoch bump).
    """

    changed: dict
    reshaped: dict
    binned_moves: int = 0  # rows re-binned between existing buckets

    @property
    def same_shape(self) -> bool:
        return not any(self.reshaped.values())

    @property
    def n_changed(self) -> int:
        return sum(bool(v) for v in self.changed.values())

    @property
    def n_reshaped(self) -> int:
        return sum(bool(v) for v in self.reshaped.values())


@dataclasses.dataclass(frozen=True)
class RankShard:
    """The policy shard of a sharded bundle one rank's mirror holds: shard
    ``k`` of ``shards`` over ``n_pad`` padded rows. Its ELLs hold rows
    ``[lo, hi)``; its binned slabs, pack and tiles hold the shard at
    stacked index 0."""

    k: int
    shards: int
    n_pad: int

    @property
    def rows_local(self) -> int:
        return self.n_pad // self.shards

    @property
    def lo(self) -> int:
        return self.k * self.rows_local

    @property
    def hi(self) -> int:
        return self.lo + self.rows_local


def _ell_row_data(eff: CSRGraph, rows: np.ndarray, width: int, n_pad: int):
    """Padded ``[len(rows), width]`` neighbor rows of ``eff`` (sentinel
    ``n_pad``), plus clipped degrees: the content an ELL slab stores."""
    idx = np.full((len(rows), width), n_pad, np.int32)
    ptr = eff.indptr
    counts = np.minimum(ptr[rows + 1] - ptr[rows], width).astype(np.int64)
    flat = np.repeat(np.arange(len(rows), dtype=np.int64), counts)
    offs = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    pos = np.repeat(ptr[rows], counts) + offs
    idx[flat, offs] = eff.indices[pos]
    w = None
    if eff.weights is not None:
        w = np.zeros((len(rows), width), np.float32)
        w[flat, offs] = eff.weights[pos]
    return idx, w, counts.astype(np.int32)


def _ell_overflows(eff: CSRGraph, rows: np.ndarray, width: int) -> bool:
    """True when a row's degree in ``eff`` passes the slab width (the
    edgeless ``[n, 0]`` slab gaining its first edge included)."""
    degs = eff.indptr[rows + 1] - eff.indptr[rows]
    return bool(len(degs)) and int(degs.max()) > width


def _fold_ell(ell: EllGraph, eff: CSRGraph, rows: np.ndarray,
              at: np.ndarray, n_pad: int) -> None:
    """Rewrite slab rows ``at`` of a host-mirror ELL in place with rows
    ``rows`` of ``eff``, which fit its width (``_ell_overflows``)."""
    width = int(ell.indices.shape[1])
    idx, w, counts = _ell_row_data(eff, rows, width, n_pad)
    _np(ell.indices)[at] = idx
    _np(ell.degrees)[at] = counts
    if ell.weights is not None:
        _np(ell.weights)[at] = w
    drop_derived(ell)


def _fold_binned(bn, rev: CSRGraph, dirty: np.ndarray, n_pad: int,
                 base: int = 0, row0: int = 0, max_overhead: float = 1.1):
    """Re-bin ``dirty`` (reverse) rows inside the existing slab shapes.
    The mirror stacks shards ``base, base + 1, ...`` and ``rev`` holds the
    reverse rows from ``row0`` on (the whole mirror: 0 and 0; a rank's
    shard: its index and its first row).

    A dirty row stays in its bucket when the bucket still satisfies the
    builder's invariant for its new degree (``deg <= width <= max_overhead
    * deg``, or the zero-width bucket for degree 0); otherwise it moves to
    the narrowest existing bucket that does, claiming a free
    (sentinel-perm) slot. Vacated slots are claimable in the same pass, so
    swaps inside one bucket always fit. Untouched rows keep their places.

    Returns ``(changed_cells, perm_changed, n_moves)`` with
    ``changed_cells`` the ``[(bucket, shard, slot)]`` rewritten slab rows,
    or ``None`` when some row fits no existing bucket or a target bucket
    has no free slot: the caller rebuilds the structure."""
    perm, inv = _np(bn.perm), _np(bn.inv)
    slabs = [_np(s) for s in bn.slabs]
    wslabs = (None if bn.slab_weights is None
              else [_np(w) for w in bn.slab_weights])
    K = int(perm.shape[0])
    rows_local = int(inv.shape[1])
    widths = [int(s.shape[-1]) for s in slabs]
    rows_b = np.asarray([int(s.shape[-2]) for s in slabs], np.int64)
    ends = np.cumsum(rows_b)
    starts = ends - rows_b
    def fits(d: int, b: int) -> bool:
        w = widths[b]
        if d == 0:
            return b == 0
        return b > 0 and w >= d and w <= max_overhead * d + 1e-9

    recs = []  # (reverse row, shard, local, new_deg, binned_pos, bucket)
    for r in map(int, dirty):
        k, l = divmod(r, rows_local)
        k -= base
        r -= row0
        d = (int(rev.indptr[r + 1] - rev.indptr[r]) if r < rev.n_nodes
             else 0)
        p = int(inv[k, l])
        b = int(np.searchsorted(ends, p, side="right"))
        recs.append((r, k, l, d, p, b))

    movers = [t for t in recs if not fits(t[3], t[5])]
    changed_cells: list = []
    perm_changed = False
    if movers:
        targets = []
        for _, _, _, d, _, _ in movers:
            cands = [b for b in range(len(widths)) if fits(d, b)]
            if not cands:
                return None
            targets.append(min(cands, key=lambda b: widths[b]))
        # free slots per (shard, bucket): positions whose perm is sentinel
        free: dict = {}
        for k in range(K):
            holes = np.nonzero(perm[k] == rows_local)[0]
            hb = np.searchsorted(ends, holes, side="right")
            for b in range(len(widths)):
                free[(k, b)] = sorted(
                    holes[hb == b].tolist(), reverse=True
                )  # pop() takes the lowest position: deterministic
        # pass 1: vacate every mover (their old slots become claimable)
        for (r, k, l, d, p, b) in movers:
            perm[k, p] = rows_local
            if widths[b] > 0:
                slot = p - int(starts[b])
                slabs[b][k, slot, :] = n_pad
                if wslabs is not None:
                    wslabs[b][k, slot, :] = 0.0
                changed_cells.append((b, k, slot))
            free[(k, b)].append(p)
            free[(k, b)].sort(reverse=True)
            perm_changed = True
        # pass 2: claim a slot in each mover's target bucket
        for (r, k, l, d, p, b), tb in zip(movers, targets):
            slots = free[(k, tb)]
            if not slots:
                return None
            p2 = int(slots.pop())
            perm[k, p2] = l
            inv[k, l] = p2

    # content rewrite: every dirty row at its (possibly new) slot
    for (r, k, l, d, _, _) in recs:
        p = int(inv[k, l])
        b = int(np.searchsorted(ends, p, side="right"))
        if widths[b] == 0:
            continue
        slot = p - int(starts[b])
        lo = int(rev.indptr[r])
        row = slabs[b][k, slot]
        row[:] = n_pad
        row[:d] = rev.indices[lo : lo + d]
        if wslabs is not None:
            wrow = wslabs[b][k, slot]
            wrow[:] = 0.0
            wrow[:d] = rev.weights[lo : lo + d]
        changed_cells.append((b, k, slot))
    return changed_cells, perm_changed, len(movers)


def _fold_pack(pack, bn, changed_cells, perm_changed: bool) -> None:
    """Mirror binned-slab rewrites into the fused-kernel pack in place.

    Pack slab ``b-1`` rows ``[0:rows_b]`` alias binned slab ``b`` rows
    (``build_pack`` only row-pads below), so changed cells copy across
    directly; when rows moved buckets, the padded perm/inverse pair is
    recomputed with ``build_pack``'s padded-position rule (a function of
    the unchanged shapes). The pack's launch record was built from the old
    ``perm_pad`` and points into these tensors, so it is dropped: the next
    ``binned_pull`` call rebuilds it."""
    has_w = pack.slab_weights is not None
    for b, k, slot in changed_cells:
        _np(pack.slabs[b - 1])[k, slot] = _np(bn.slabs[b])[k, slot]
        if has_w:
            _np(pack.slab_weights[b - 1])[k, slot] = (
                _np(bn.slab_weights[b])[k, slot]
            )
    if perm_changed:
        rows_raw = [int(s.shape[-2]) for s in bn.slabs]
        rows_pad = [int(s.shape[-2]) for s in pack.slabs]
        rows_local = int(bn.inv.shape[1])
        starts = np.concatenate([[0], np.cumsum(rows_raw)])[:-1]
        seg = np.asarray([rows_raw[0]] + rows_pad, np.int64)
        pstarts = np.concatenate([[0], np.cumsum(seg)])[:-1]
        bop = np.repeat(np.arange(len(rows_raw)), rows_raw)
        pp = pstarts[bop] + np.arange(int(np.sum(rows_raw))) - starts[bop]
        perm_pad = _np(pack.perm_pad)
        _np(pack.inv_pad)[:] = pp[_np(bn.inv)].astype(np.int32)
        perm_pad[:] = rows_local
        perm_pad[:, pp] = _np(bn.perm)
    drop_derived(pack)


def _fold_blocks(sb, new_eff: CSRGraph, added: np.ndarray,
                 removed: np.ndarray, shard: RankShard):
    """Recompute only the ``[B, B]`` tiles of ``shard`` (the mirror's
    stacked index 0) touched by changed edges.

    A tile that gains its first edge claims a free (sentinel-col) slot in
    its shard's tile list; a tile that empties is zeroed and its slot
    freed. Returns whether anything changed, or ``None`` when a new tile
    needs a slot and the shard's list is full: the caller rebuilds (the
    per-shard tile capacity ``nb`` is a shape)."""
    blocks = _np(sb.blocks)
    brows, bcols = _np(sb.block_rows), _np(sb.block_cols)
    K, nb, B, _ = (int(d) for d in blocks.shape)
    base, rows_local, n_pad = shard.k, shard.rows_local, shard.n_pad
    G = n_pad // B  # sentinel col-block id of padding tiles
    n = new_eff.n_nodes
    keys = np.concatenate([added, removed])
    u = keys // n
    v = keys % n
    k_of = u // rows_local - base
    held = (k_of >= 0) & (k_of < K)
    tiles = sorted(
        set(
            zip(
                k_of[held].tolist(),
                ((u[held] % rows_local) // B).tolist(),
                (v[held] // B).tolist(),
            )
        )
    )
    slot_of: dict = {}
    free: dict = {}
    for k in range(K):
        live = np.nonzero(bcols[k] != G)[0]
        for s in live:
            slot_of[(k, int(brows[k, s]), int(bcols[k, s]))] = int(s)
        free[k] = sorted(np.nonzero(bcols[k] == G)[0].tolist(), reverse=True)
    changed = False
    ptr = new_eff.indptr
    for (k, rb, cb) in tiles:
        r0 = (base + k) * rows_local + rb * B
        r1 = min(r0 + B, n)
        tile = np.zeros((B, B), np.int8)
        if r1 > r0:
            rows = np.arange(r0, r1, dtype=np.int64)
            counts = (ptr[rows + 1] - ptr[rows]).astype(np.int64)
            flat = np.repeat(rows - r0, counts)
            offs = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            pos = np.repeat(ptr[rows], counts) + offs
            dsts = new_eff.indices[pos].astype(np.int64)
            sel = (dsts >= cb * B) & (dsts < (cb + 1) * B)
            tile[flat[sel], dsts[sel] - cb * B] = 1
        s = slot_of.get((k, rb, cb))
        if tile.any():
            if s is None:
                if not free[k]:
                    return None
                s = free[k].pop()
                brows[k, s] = rb
                bcols[k, s] = cb
                slot_of[(k, rb, cb)] = s
            blocks[k, s] = tile
            changed = True
        elif s is not None:
            blocks[k, s] = 0
            brows[k, s] = 0
            bcols[k, s] = G
            del slot_of[(k, rb, cb)]
            free[k].append(s)
            free[k].sort(reverse=True)
            changed = True
    return changed


def fold_operands(host, old_eff: CSRGraph, new_eff: CSRGraph,
                  diff: DeltaDiff, shard: Optional[RankShard] = None,
                  agree: Callable[[bool], bool] = bool):
    """Fold one delta's effective changes into a host-mirror operand
    bundle (CPU-tensor leaves, written in place where shapes allow).

    ``host`` is any object with the ``GraphOperands`` structure slots
    (``fwd`` required; the rest optional). Returns ``(structures_dict,
    FoldReport)``: the dict maps each slot name to its post-fold structure,
    the mirror folded in place or a fresh rebuild for the slots the report
    marks ``reshaped``.

    With ``shard`` the mirror holds that one policy shard (without it, the
    whole graph: the one shard of one): only its rows and tiles are
    folded, and ``agree(flag)`` must return the OR of ``flag`` over the
    ranks holding the bundle's other shards (it is called in one order on
    every rank). ``reshaped`` is then the same on every rank; ``changed``
    and ``binned_moves`` are the shard's own (the caller reduces them
    over the ranks).
    """
    del old_eff  # the diff already carries everything the folds need
    if shard is None:
        shard = RankShard(0, 1, int(host.fwd.indices.shape[0]))
    n_pad, lo, hi = shard.n_pad, shard.lo, shard.hi
    changed = {s: False for s in STRUCTURES}
    reshaped = {s: False for s in STRUCTURES}
    moves = 0

    def mine(rows: np.ndarray) -> np.ndarray:
        return rows[(rows >= lo) & (rows < hi)]

    fwd = host.fwd
    if len(diff.fwd_dirty):
        rows = mine(diff.fwd_dirty)
        width = int(fwd.indices.shape[1])
        reshaped["fwd"] = agree(_ell_overflows(new_eff, rows, width))
        if not reshaped["fwd"]:
            _fold_ell(fwd, new_eff, rows, rows - lo, n_pad)
        changed["fwd"] = reshaped["fwd"] or bool(len(rows))

    rev_rows = None  # the reverse rows [lo, hi) of the new graph

    def rev_csr() -> CSRGraph:
        nonlocal rev_rows
        if rev_rows is None:
            rev_rows = reverse_shard(new_eff, lo, hi)
        return rev_rows

    rev = getattr(host, "rev", None)
    if rev is not None and len(diff.rev_dirty):
        rows = mine(diff.rev_dirty)
        width = int(rev.indices.shape[1])
        reshaped["rev"] = agree(_ell_overflows(rev_csr(), rows - lo, width))
        if not reshaped["rev"]:
            _fold_ell(rev, rev_csr(), rows - lo, rows - lo, n_pad)
        changed["rev"] = reshaped["rev"] or bool(len(rows))

    bn = getattr(host, "rev_binned", None)
    pack = getattr(host, "rev_binned_pack", None)
    if bn is not None and len(diff.rev_dirty):
        rows = mine(diff.rev_dirty)
        out = _fold_binned(bn, rev_csr(), rows, n_pad, base=shard.k,
                           row0=lo)
        reshaped["rev_binned"] = agree(out is None)
        if reshaped["rev_binned"]:
            reshaped["rev_binned_pack"] = pack is not None
            changed["rev_binned_pack"] = pack is not None
        else:
            cells, perm_changed, moves = out
            if pack is not None and (cells or perm_changed):
                _fold_pack(pack, bn, cells, perm_changed)
                changed["rev_binned_pack"] = True
        changed["rev_binned"] = reshaped["rev_binned"] or bool(len(rows))

    sb = getattr(host, "blocks", None)
    if sb is not None and diff.n_changed_edges:
        out = _fold_blocks(sb, new_eff, diff.added, diff.removed, shard)
        reshaped["blocks"] = agree(out is None)
        changed["blocks"] = reshaped["blocks"] or bool(out)

    structs = {
        "fwd": fwd,
        "rev": rev,
        "rev_binned": bn,
        "rev_binned_pack": pack,
        "blocks": sb,
    }
    names = tuple(s for s in STRUCTURES if reshaped[s])
    if names:
        structs.update(rebuild_shard(
            new_eff, n_pad, shard.shards, shard.k, names,
            128 if sb is None else sb.block_size))
    return structs, FoldReport(
        changed=changed, reshaped=reshaped, binned_moves=moves
    )


# ---------------------------------------------------------------------------
# Dispatcher-facing report
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeltaReport:
    """What one ``QueryDispatcher.apply_delta`` did."""

    version: int  # the new operands_version
    n_adds: int
    n_dels: int
    changed_edges: int  # effective edge inserts + removes
    dirty_fwd_rows: int
    dirty_rev_rows: int
    bundles: int  # operand bundles folded
    structures_changed: int  # device structures re-placed
    structures_rebuilt: int  # shape-changing rebuilds (epoch bumps)
    binned_moves: int  # rows re-binned between existing buckets
    engines_invalidated: int  # engines dropped from the cache
    ms: float = 0.0  # wall of the call: diff, folds and placement
    ms_max: float = 0.0  # the slowest rank's ms (``ms`` on one rank)
    wire_bytes: int = 0  # payload bytes this rank's collectives moved
    # per bundle, in bundle order: (bundle key, FoldReport), the same on
    # every rank of a mesh
    folds: tuple = ()

    @property
    def same_shape(self) -> bool:
        """True when every structure kept its shapes: the engine cache
        stayed warm."""
        return self.structures_rebuilt == 0
