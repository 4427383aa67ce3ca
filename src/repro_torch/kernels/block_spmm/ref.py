"""Plain PyTorch version of the block-sparse SpMM (port of
``repro.kernels.block_spmm.ref``): gather every block's source stripe,
take the per-block product ``blocks[i]^T . x[rows[i]]`` in float32 and add
it into the block's destination column.

Blocks are processed in slices of at most ``budget`` bytes of gathered
stripes, products and float32 tiles, with the same per-block arithmetic as
a single pass: at the LDBC proxy's scale 10 the blocks alone are 8 GB, and
a one-shot gather and product would allocate two more tensors of that
size. On the CPU the column sums are added in block order whatever the slice size, so the two
forms give the same bits; on CUDA ``index_add_`` adds with atomics, in an
order that changes from run to run.
"""
from __future__ import annotations

import torch


def block_spmm_ref(
    blocks: torch.Tensor,  # [nb, B, B] f32/bf16, A[u, v] per block
    block_rows: torch.Tensor,  # [nb] int32 source row-block ids
    block_cols: torch.Tensor,  # [nb] int32 destination col-block ids
    x: torch.Tensor,  # [G, B, F] features by source block
    budget: int = 1 << 30,
) -> torch.Tensor:
    """``[G, B, F]`` float32: ``out[c] = sum over blocks i with cols[i] = c
    of blocks[i]^T . x[rows[i]]``; blocks whose col id is outside
    ``[0, G)`` are dropped (JAX's ``mode="drop"``)."""
    g, bsz, feat = x.shape
    nb = int(blocks.shape[0])
    # row g collects the dropped blocks
    out = torch.zeros((g + 1, bsz, feat), dtype=torch.float32,
                      device=x.device)
    cols = block_cols.long()
    cols = torch.where((cols >= 0) & (cols < g), cols, g)
    per_block = 4 * bsz * (2 * feat + bsz)
    step = max(1, budget // per_block)
    for i in range(0, nb, step):
        a = blocks[i : i + step].float()  # [c, B(u), B(v)]
        src = x[block_rows[i : i + step].long()].float()  # [c, B(u), F]
        part = torch.bmm(a.transpose(1, 2), src)  # [c, B(v), F]
        out.index_add_(0, cols[i : i + step], part)
    return out[:g]
