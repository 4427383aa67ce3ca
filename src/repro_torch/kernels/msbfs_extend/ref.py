"""Plain PyTorch version of the MS-BFS block extension (port of
``repro.kernels.msbfs_extend.ref``): gather every tile's source stripe,
take the batched product, threshold it and OR-scatter it into the
destination blocks.

The product runs in int32 on the CPU and in float32 on CUDA (PyTorch has
no integer batched matmul there); both are exact, since the 0/1 tiles and
lanes give integer sums of at most B = 128. Tiles are processed in chunks
so the gathered stripes stay under ``budget`` bytes.
"""
from __future__ import annotations

import torch


def msbfs_extend_ref(
    blocks: torch.Tensor,  # [nb, B, B] int8
    block_rows: torch.Tensor,  # [nb] int32
    block_cols: torch.Tensor,  # [nb] int32
    lanes: torch.Tensor,  # [G_in, B, L]
    g_out: int | None = None,
    budget: int = 1 << 30,
) -> torch.Tensor:
    """Reach mask ``[g_out, B, L]`` uint8 (1 where reached); tiles whose
    col id is outside ``[0, g_out)`` are dropped."""
    g_in, bsz, n_lanes = lanes.shape
    g_out = g_in if g_out is None else int(g_out)
    dev = lanes.device
    dtype = torch.float32 if dev.type == "cuda" else torch.int32
    src_all = (lanes != 0).to(dtype)
    hits = torch.zeros((g_out + 1, bsz, n_lanes), dtype=torch.int32,
                       device=dev)
    cols = block_cols.long()
    cols = torch.where((cols >= 0) & (cols < g_out), cols, g_out)
    per_tile = bsz * (bsz + n_lanes) * 4
    step = max(1, budget // max(per_tile, 1))
    for i in range(0, int(blocks.shape[0]), step):
        a = blocks[i : i + step].to(dtype)  # [c, B(u), B(v)]
        f = src_all[block_rows[i : i + step].long()]  # [c, B(u), L]
        partial = torch.bmm(a.transpose(1, 2), f)  # [c, B(v), L]
        hits.index_add_(0, cols[i : i + step], (partial > 0).to(torch.int32))
    return (hits[:g_out] > 0).to(torch.uint8)
