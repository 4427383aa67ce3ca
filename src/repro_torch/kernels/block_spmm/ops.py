"""Wrapper and host-side block preparation of the block-sparse SpMM (port
of ``repro.kernels.block_spmm.ops``).

``spmm`` runs the plain PyTorch version for a CPU tensor (or with
``use_ref``) and launches the CUDA kernel for a CUDA tensor; there is no
fall back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...graph.csr import CSRGraph
from ..common import resolve_device
from .block_spmm import block_spmm
from .ref import block_spmm_ref


@dataclasses.dataclass(frozen=True)
class SpmmBlocks:
    """Column-sorted weighted block adjacency. ``col_ptr[c]:col_ptr[c+1]``
    are the blocks of destination column ``c``; every row and col id lies
    in ``[0, g)`` with ``g = len(col_ptr) - 1``."""

    blocks: torch.Tensor  # [nb, B, B] f32 (or bf16), A[u, v] per block
    block_rows: torch.Tensor  # [nb] int32
    block_cols: torch.Tensor  # [nb] int32, non-decreasing
    col_ptr: torch.Tensor  # [g + 1] int64 column offsets into the blocks

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
    offsets. Columns with no block are allowed; ``g`` is one past the
    largest row or col id."""
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
    float32 in edge order, the order of JAX's ``np.add.at``."""
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
    ``use_ref``), the CUDA kernel for a CUDA tensor (block size a power
    of two from 8 to 256, ``x`` of the blocks' dtype; zero entries
    skipped, see ``block_spmm``)."""
    n, feat = x.shape
    bsz = int(sb.blocks.shape[1])
    ft = min(feat, 128)
    if ft == 0 or feat % ft or n % bsz:
        raise ValueError(f"x {tuple(x.shape)}: need F % min(F, 128) == 0 "
                         f"and n % {bsz} == 0")
    g = n // bsz
    if g < sb.g:
        raise ValueError(f"x has {g} row blocks, the adjacency {sb.g}")
    xb = x.reshape(g, bsz, feat)
    if use_ref or x.device.type == "cpu":
        out = block_spmm_ref(sb.blocks, sb.block_rows, sb.block_cols, xb)
    else:
        out = block_spmm(sb.blocks, sb.block_rows, sb.col_ptr, xb)
    return out.reshape(n, feat)
