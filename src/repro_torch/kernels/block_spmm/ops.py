"""Wrapper and host-side block preparation of the block-sparse SpMM (port
of ``repro.kernels.block_spmm.ops``).

``spmm`` runs the plain PyTorch version for a CPU tensor (or with
``use_ref``) and launches the CUDA kernel for a CUDA tensor; there is no
fall back. The kernel reads a compacted view of the blocks
(``SpmmNonzeros``: their nonzeros listed by destination, and a work list
of chunks), which every ``SpmmBlocks`` builds once, on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...graph.csr import CSRGraph
from ..common import resolve_device
from .block_spmm import block_spmm
from .ref import block_spmm_ref

# Nonzeros of one work item at most: a destination with more is split into
# chunks whose float32 partial sums a second pass adds. Picked on the card
# (PERF.md, scripts/spmm_chunk_sweep.py).
CHUNK = 256


@dataclasses.dataclass(frozen=True)
class SpmmNonzeros:
    """The nonzeros of a block adjacency by destination node ``v = c*B +
    j`` (CSR of ``A^T``) and the kernel's work list.

    ``nz_src[nz_ptr[v]:nz_ptr[v+1]]`` are the global sources ``u =
    rows[i]*B + k`` of the stored entries ``blocks[i][k][j] != 0`` of
    column block ``c``, in (block ``i`` in ``col_ptr`` order, ``k``) order,
    and ``nz_val`` their weights in the blocks' dtype (a stored 0 or -0 is
    left out, a stored NaN kept). ``items[t] = (v, lo, hi, slot)`` covers
    ``nz[lo:hi]`` of destination ``v``, at most ``chunk`` nonzeros; every
    destination ``v < n_dst`` has at least one item (an empty one writes
    zeros). ``slot`` is -1 when ``v`` has one item, else the row of the
    float32 partial sum that ``splits[s] = (v, slot_lo, slot_hi)`` adds
    up, in chunk order (slots are numbered in destination then chunk
    order). The kernel takes the items in list order, which is longest
    first (stable: destination then chunk order among equal lengths), so
    that no long chunk starts last."""

    nz_ptr: torch.Tensor  # [n_dst + 1] int64
    nz_src: torch.Tensor  # [nnz] int32
    nz_val: torch.Tensor  # [nnz] the blocks' dtype
    items: torch.Tensor  # [n_items, 4] int32
    splits: torch.Tensor  # [n_split, 3] int32
    n_slots: int  # items with a partial-sum row
    chunk: int

    @property
    def n_dst(self) -> int:
        return int(self.nz_ptr.shape[0]) - 1


def compact_blocks(blocks: torch.Tensor, block_rows: torch.Tensor,
                   block_cols: torch.Tensor, g: int, chunk: int = CHUNK,
                   budget: int = 1 << 28) -> SpmmNonzeros:
    """``SpmmNonzeros`` of ``g`` column blocks, built on the blocks' device
    from the tiles themselves: ``nonzero`` over slices of at most
    ``budget`` bytes of blocks, then a stable sort by destination."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    nb, bsz = int(blocks.shape[0]), int(blocks.shape[1])
    dev = blocks.device
    n_dst = g * bsz
    rows = block_rows.long()
    cols = block_cols.long()
    flat = blocks.reshape(-1)
    step = max(1, budget // max(1, bsz * bsz * blocks.element_size()))
    src, dst, val = [], [], []
    for i0 in range(0, nb, step):
        i, k, j = torch.nonzero(blocks[i0: i0 + step]).unbind(1)
        i = i + i0
        src.append(rows[i] * bsz + k)
        dst.append(cols[i] * bsz + j)
        val.append(flat[(i * bsz + k) * bsz + j])
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    src = torch.cat(src) if src else empty
    dst = torch.cat(dst) if dst else empty
    val = torch.cat(val) if val else flat[:0]
    nnz = int(src.shape[0])
    if max(nnz, n_dst) >= 2 ** 31:  # source ids are below n_dst too
        raise ValueError(f"{nnz} nonzeros over {n_dst} destinations: the "
                         "kernel's int32 ids need both below 2^31")
    order = torch.argsort(dst, stable=True)
    counts = torch.bincount(dst, minlength=n_dst)
    nz_ptr = torch.zeros(n_dst + 1, dtype=torch.int64, device=dev)
    nz_ptr[1:] = torch.cumsum(counts, 0)
    # work list: ceil(count / chunk) items per destination, at least one
    n_ch = torch.clamp((counts + chunk - 1) // chunk, min=1)
    first = torch.cumsum(n_ch, 0) - n_ch
    n_items = int(n_ch.sum())
    item_dst = torch.repeat_interleave(
        torch.arange(n_dst, device=dev), n_ch, output_size=n_items)
    part = torch.arange(n_items, device=dev) - first[item_dst]
    lo = nz_ptr[item_dst] + part * chunk
    hi = torch.minimum(lo + chunk, nz_ptr[item_dst + 1])
    split = (n_ch > 1)[item_dst]
    slot = torch.where(split, torch.cumsum(split, 0) - 1, -1)
    heavy = torch.nonzero(n_ch > 1).squeeze(1)
    slot_lo = slot[first[heavy]]
    longest_first = torch.argsort(lo - hi, stable=True)
    items = torch.stack([item_dst, lo, hi, slot], 1)[longest_first]
    return SpmmNonzeros(
        nz_ptr=nz_ptr,
        nz_src=src[order].int(),
        nz_val=val[order],
        items=items.int(),
        splits=torch.stack([heavy, slot_lo, slot_lo + n_ch[heavy]], 1).int(),
        n_slots=int(split.sum()),
        chunk=chunk,
    )


@dataclasses.dataclass(frozen=True)
class SpmmBlocks:
    """Column-sorted weighted block adjacency. ``col_ptr[c]:col_ptr[c+1]``
    are the blocks of destination column ``c``; every row and col id lies
    in ``[0, g)`` with ``g = len(col_ptr) - 1``. The four JAX-layout leaves
    are the public operand; ``nz``, the kernel's compacted view of them
    (``compact_blocks``), is built once, by every construction,
    ``dataclasses.replace`` included."""

    blocks: torch.Tensor  # [nb, B, B] f32 (or bf16), A[u, v] per block
    block_rows: torch.Tensor  # [nb] int32
    block_cols: torch.Tensor  # [nb] int32, non-decreasing
    col_ptr: torch.Tensor  # [g + 1] int64 column offsets into the blocks
    nz: SpmmNonzeros = dataclasses.field(init=False, repr=False,
                                         compare=False)

    def __post_init__(self):
        object.__setattr__(self, "nz", compact_blocks(
            self.blocks, self.block_rows, self.block_cols, self.g))

    @property
    def g(self) -> int:
        return int(self.col_ptr.shape[0]) - 1


def _col_ptr(cols: np.ndarray, g: int) -> np.ndarray:
    return np.searchsorted(cols, np.arange(g + 1), side="left").astype(
        np.int64)


def spmm_blocks_from_numpy(blocks, block_rows, block_cols,
                           device=None) -> SpmmBlocks:
    """Carry a ``[nb, B, B]`` block list (JAX's ``SpmmBlocks`` leaves as
    numpy arrays, or any col-sorted list) onto ``device``, with its column
    offsets and its compacted view. Columns with no block are
    allowed; ``g`` is one past the largest row or col id."""
    dev = resolve_device(device)
    rows = np.asarray(block_rows).astype(np.int32)
    cols = np.asarray(block_cols).astype(np.int32)
    nb = len(cols)
    if np.shape(blocks)[:1] != (nb,) or rows.shape != (nb,):
        raise ValueError("blocks, block_rows and block_cols disagree on nb")
    if nb and (rows.min() < 0 or cols.min() < 0
               or np.any(np.diff(cols) < 0)):
        raise ValueError("block ids must be >= 0 and block_cols sorted")
    g = int(max(rows.max(), cols.max())) + 1 if nb else 0
    return SpmmBlocks(
        blocks=torch.from_numpy(np.array(blocks)).to(dev),
        block_rows=torch.from_numpy(rows).to(dev),
        block_cols=torch.from_numpy(cols).to(dev),
        col_ptr=torch.from_numpy(_col_ptr(cols, g)).to(dev),
    )


def spmm_blocks_from_csr(
    csr: CSRGraph,
    block: int = 128,
    normalize: str | None = None,
    device=None,
) -> SpmmBlocks:
    """Dense-block adjacency with optional GCN-style normalization
    (``normalize`` in ``{None, "mean", "sym"}``), on ``device``.

    The leaves are bitwise JAX's: weights taken in float64, normalized and
    cast to float32; one zero block (row 0) for every column with no edge;
    blocks ordered by (col, row), which is JAX's stable sort by column of
    its row-major block list. JAX builds the dense ``[nb, B, B]`` array on
    the host and copies it again to reorder it (16 GB of host memory for
    the LDBC proxy at scale 10); here the block keys are sorted first and
    only the nonzero weights cross to ``device``, where they are scattered
    into blocks allocated there. When the CSR repeats an edge (built with
    ``dedup=False``), the repeats of one entry are summed on the host in
    float32 in edge order, the order of JAX's ``np.add.at``. The compacted
    view for the kernel is built from these tiles, on ``device``."""
    dev = resolve_device(device)
    n = csr.n_nodes
    g = -(-n // block)
    src, dst = csr.edge_list()
    w = (
        csr.weights.astype(np.float64)
        if csr.weights is not None
        else np.ones(len(src), np.float64)
    )
    if normalize == "mean":
        deg_in = np.zeros(n)
        np.add.at(deg_in, dst, w)
        w = w / np.maximum(deg_in[dst], 1e-9)
    elif normalize == "sym":
        deg_out = np.zeros(n)
        deg_in = np.zeros(n)
        np.add.at(deg_out, src, w)
        np.add.at(deg_in, dst, w)
        w = w / np.sqrt(np.maximum(deg_out[src] * deg_in[dst], 1e-9))
    elif normalize is not None:
        raise ValueError(f"unknown normalize: {normalize!r}")
    br = (src // block).astype(np.int64)
    bc = (dst // block).astype(np.int64)
    key = bc * g + br  # (col, row) order
    missing = np.setdiff1d(np.arange(g, dtype=np.int64), bc)
    keys = np.unique(np.concatenate([key, missing * g]))
    rows = (keys % g).astype(np.int32)
    cols = (keys // g).astype(np.int32)
    nb = len(keys)
    # flat position of every edge's entry; 0 + w like np.add.at into zeros
    pos = (np.searchsorted(keys, key) * block + src % block) * block + (
        dst % block)
    vals = np.float32(0) + w.astype(np.float32)
    order = np.argsort(pos, kind="stable")
    pos, vals = pos[order], vals[order]
    upos, first, counts = np.unique(pos, return_index=True,
                                    return_counts=True)
    acc = vals[first]
    if len(upos) < len(pos):  # repeated entries: add in edge order
        group = np.repeat(np.arange(len(upos)), counts)
        rank = np.arange(len(pos)) - first[group]
        for r in range(1, int(counts.max())):
            sel = rank == r
            acc[group[sel]] += vals[sel]
    blocks = torch.zeros((nb, block, block), dtype=torch.float32, device=dev)
    blocks.view(-1)[torch.from_numpy(upos).to(dev)] = torch.from_numpy(
        acc).to(dev)
    return SpmmBlocks(
        blocks=blocks,
        block_rows=torch.from_numpy(rows).to(dev),
        block_cols=torch.from_numpy(cols).to(dev),
        col_ptr=torch.from_numpy(_col_ptr(cols, g)).to(dev),
    )


def spmm(sb: SpmmBlocks, x: torch.Tensor, use_ref: bool = False):
    """Aggregated features ``Y[v] = sum_u A[u, v] X[u]``: ``x [n, F]``
    (``n`` a multiple of the block size, ``n / B >= sb.g``) gives
    ``[n, F]`` float32. The plain version for a CPU tensor (or
    ``use_ref``), the CUDA kernel over ``sb.nz`` for a CUDA tensor (``x``
    of the blocks' dtype; zero entries skipped, see ``block_spmm``)."""
    n, feat = x.shape
    bsz = int(sb.blocks.shape[1])
    ft = min(feat, 128)
    if ft == 0 or feat % ft or n % bsz:
        raise ValueError(f"x {tuple(x.shape)}: need F % min(F, 128) == 0 "
                         f"and n % {bsz} == 0")
    g = n // bsz
    if g < sb.g:
        raise ValueError(f"x has {g} row blocks, the adjacency {sb.g}")
    if use_ref or x.device.type == "cpu":
        xb = x.reshape(g, bsz, feat)
        out = block_spmm_ref(sb.blocks, sb.block_rows, sb.block_cols, xb)
        return out.reshape(n, feat)
    return block_spmm(sb.nz, x)
