"""Wrappers and host-side tile preparation of the MS-BFS block extension
(port of ``repro.kernels.msbfs_extend.ops``).

``extend_blocks`` runs the plain PyTorch version for a CPU tensor and
launches the CUDA kernel for a CUDA tensor; there is no fall back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...graph.csr import BlockAdjacency, CSRGraph, blocks_from_csr
from .msbfs_extend import msbfs_extend_blocks
from .ref import msbfs_extend_ref


@dataclasses.dataclass(frozen=True)
class KernelBlocks:
    """Column-sorted block-sparse adjacency. Every destination block id in
    ``[0, G)`` appears at least once (zero anchor tiles fill empty
    columns), the layout the TPU kernel's revisiting accumulator needs;
    the CUDA kernel takes any order."""

    blocks: torch.Tensor  # [nb, B, B] int8
    block_rows: torch.Tensor  # [nb] int32
    block_cols: torch.Tensor  # [nb] int32 non-decreasing, covers all cols


def prepare_kernel_blocks(adj: BlockAdjacency) -> KernelBlocks:
    blocks = adj.blocks.cpu().numpy()
    rows = adj.block_rows.cpu().numpy()
    cols = adj.block_cols.cpu().numpy()
    g = adj.n_row_blocks
    missing = np.setdiff1d(np.arange(g, dtype=np.int32), cols)
    if len(missing):
        bsz = adj.block_size
        blocks = np.concatenate(
            [blocks, np.zeros((len(missing), bsz, bsz), np.int8)], axis=0
        )
        rows = np.concatenate([rows, np.zeros(len(missing), np.int32)])
        cols = np.concatenate([cols, missing.astype(np.int32)])
    order = np.argsort(cols, kind="stable")
    return KernelBlocks(
        blocks=torch.from_numpy(np.ascontiguousarray(blocks[order])),
        block_rows=torch.from_numpy(rows[order].astype(np.int32)),
        block_cols=torch.from_numpy(cols[order].astype(np.int32)),
    )


def kernel_blocks_from_csr(csr: CSRGraph, block: int = 128) -> KernelBlocks:
    return prepare_kernel_blocks(blocks_from_csr(csr, block=block))


def extend_blocks(
    blocks: torch.Tensor,
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    lanes: torch.Tensor,  # [G_in, B, L]
    g_out: int | None = None,
    use_ref: bool = False,
) -> torch.Tensor:
    """Reach mask ``[g_out, B, L]`` uint8 of one extension over the
    tiles: the plain version for a CPU tensor (or ``use_ref``), the CUDA
    kernel for a CUDA tensor. On a rank of a mesh the tiles are its shard's
    (``operand_stream(...).build_shard``): ``lanes`` holds the shard's row
    blocks and ``g_out`` every destination block of the graph."""
    if use_ref or lanes.device.type == "cpu":
        return msbfs_extend_ref(blocks, block_rows, block_cols, lanes, g_out)
    return msbfs_extend_blocks(blocks, block_rows, block_cols, lanes, g_out)


def msbfs_extend(
    kb: KernelBlocks,
    lanes: torch.Tensor,  # [n, L] (n divisible by the tile size)
    use_ref: bool = False,
) -> torch.Tensor:
    """Frontier lane extension: [n, L] -> [n, L] uint8 reach mask."""
    n, n_lanes = lanes.shape
    bsz = int(kb.blocks.shape[1])
    g = n // bsz
    out = extend_blocks(
        kb.blocks, kb.block_rows, kb.block_cols,
        lanes.reshape(g, bsz, n_lanes), use_ref=use_ref,
    )
    return out.reshape(n, n_lanes)
