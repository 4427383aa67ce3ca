"""CUDA launcher for the block-sparse SpMM (``csrc/block_spmm.cu``).

Port of ``repro.kernels.block_spmm.block_spmm``. One CTA per (destination
column block, feature tile) walks that column's blocks in order, skips
zero entries and writes its float32 sum once; see the source's header for
the design and for what skipping zeros means for non-finite features. The
block size is a power of two from 8 to 256 (the plain version takes any).

``block_spmm.launches`` counts kernel launches (one per call).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "src/repro_torch/kernels/csrc/block_spmm.cu"
DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]


def _library():
    lib = build.load("block_spmm")
    fn = lib.block_spmm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def block_spmm(
    blocks: torch.Tensor,  # [nb, B, B] f32/bf16, sorted by col block
    block_rows: torch.Tensor,  # [nb] int32 source row-block ids (< G)
    col_ptr: torch.Tensor,  # [g + 1] int64 column offsets, g <= G
    x: torch.Tensor,  # [G, B, F] features by source block, blocks' dtype
) -> torch.Tensor:
    """Launch the SpMM on ``x``'s CUDA device and stream. Returns
    ``[G, B, F]`` float32; columns ``>= g`` are zero."""
    nb, bsz, bsz2 = blocks.shape
    g, b_x, feat = x.shape
    g_sb = int(col_ptr.shape[0]) - 1
    ft = min(feat, 128)
    if (bsz != bsz2 or b_x != bsz or not 8 <= bsz <= 256
            or bsz & (bsz - 1)):
        raise ValueError(f"block/feature mismatch: {tuple(blocks.shape)} "
                         f"vs {tuple(x.shape)} (B a power of two, 8..256)")
    if ft == 0 or feat % ft or g_sb > g or g_sb < 0:
        raise ValueError(f"x {tuple(x.shape)} with {g_sb} column blocks: "
                         "need F % min(F, 128) == 0 and G >= g")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("block_spmm launches on CUDA tensors only")
    for name, t in (("blocks", blocks), ("x", x)):
        if (t.device != dev or t.dtype not in DTYPES
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32/bf16 on "
                             "x's device")
    if blocks.dtype != x.dtype:
        raise ValueError(f"blocks {blocks.dtype} and x {x.dtype} must have "
                         "one dtype")
    if (block_rows.device != dev or block_rows.dtype != torch.int32
            or tuple(block_rows.shape) != (nb,)
            or not block_rows.is_contiguous()):
        raise ValueError(f"block_rows must be contiguous int32 [{nb}]")
    if (col_ptr.device != dev or col_ptr.dtype != torch.int64
            or not col_ptr.is_contiguous()):
        raise ValueError("col_ptr must be contiguous int64 [g + 1]")
    out = torch.empty((g, bsz, feat), dtype=torch.float32, device=dev)
    if g == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.block_spmm_launch(
            blocks.data_ptr(), block_rows.data_ptr(), col_ptr.data_ptr(),
            g_sb, x.data_ptr(), int(x.dtype == torch.bfloat16), g, bsz,
            feat, out.data_ptr(), stream,
        )
    build.check(lib, "block_spmm", code)
    block_spmm.launches += 1
    return out


block_spmm.launches = 0
