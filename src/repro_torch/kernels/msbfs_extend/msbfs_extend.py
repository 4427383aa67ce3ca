"""CUDA launcher for the MS-BFS block extension (``csrc/msbfs_extend.cu``).

Port of ``repro.kernels.msbfs_extend.msbfs_extend``. The kernel ORs each
stored 0/1 tile's Boolean product with the bit-packed lanes of its source
stripe into the destination rows, skipping tiles whose stripe is empty and
tiles whose destination is the out-of-range pad column; see the source's
header for the design.

``msbfs_extend_blocks.launches`` counts kernel launches (one per call).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "src/repro_torch/kernels/csrc/msbfs_extend.cu"
WORD = 64  # lanes per packed word


def pack_words(lanes: torch.Tensor) -> torch.Tensor:
    """[R, L] (nonzero = set) -> [R, ceil(L/64)] int64 words; lane l is
    bit l % 64 of word l // 64 (the uint64 layout the kernel reads)."""
    r, n_lanes = lanes.shape
    words = -(-n_lanes // WORD)
    bits = (lanes != 0).to(torch.int64)
    if words * WORD != n_lanes:
        bits = torch.nn.functional.pad(bits, (0, words * WORD - n_lanes))
    shifts = torch.arange(WORD, dtype=torch.int64, device=lanes.device)
    # distinct powers of two: the int64 sum is the bitwise OR
    return (bits.view(r, words, WORD) << shifts).sum(dim=-1)


def unpack_words(words: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """Inverse of ``pack_words``: [R, W] int64 -> [R, n_lanes] uint8."""
    r, w = words.shape
    shifts = torch.arange(WORD, dtype=torch.int64, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.view(r, w * WORD)[:, :n_lanes].to(torch.uint8)


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
]


def _library():
    lib = build.load("msbfs_extend")
    fn = lib.msbfs_extend_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def msbfs_extend_blocks(
    blocks: torch.Tensor,  # [nb, B, B] int8
    block_rows: torch.Tensor,  # [nb] int32 source row-block ids
    block_cols: torch.Tensor,  # [nb] int32 destination col-block ids
    lanes: torch.Tensor,  # [G_in, B, L] frontier lane blocks
    g_out: int | None = None,  # destination blocks (default G_in)
) -> torch.Tensor:
    """Launch the extension on ``lanes``' CUDA device and stream. Returns
    the reach mask ``[g_out, B, L]`` uint8 (1 where reached). Tiles whose
    col id is outside ``[0, g_out)`` are dropped."""
    dev = lanes.device
    if dev.type != "cuda":
        raise ValueError("msbfs_extend_blocks launches on CUDA tensors only")
    nb, bsz, bsz2 = blocks.shape
    g_in, b_l, n_lanes = lanes.shape
    g_out = g_in if g_out is None else int(g_out)
    if bsz != bsz2 or b_l != bsz or bsz > 1024:
        raise ValueError(f"tile/lane block mismatch: {blocks.shape} "
                         f"vs {lanes.shape}")
    if (blocks.device != dev or blocks.dtype != torch.int8
            or not blocks.is_contiguous()):
        raise ValueError("blocks must be contiguous int8 on the lanes' device")
    for name, t in (("block_rows", block_rows), ("block_cols", block_cols)):
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != (nb,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 [{nb}]")
    fwords = pack_words(lanes.reshape(g_in * bsz, n_lanes)).contiguous()
    n_words = int(fwords.shape[1])
    out = torch.zeros((g_out * bsz, n_words), dtype=torch.int64, device=dev)
    if nb and n_words and g_out:
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.msbfs_extend_launch(
                blocks.data_ptr(), block_rows.data_ptr(),
                block_cols.data_ptr(), nb, bsz, fwords.data_ptr(), g_in,
                n_words, out.data_ptr(), g_out, stream,
            )
        build.check(lib, "msbfs_extend", code)
        msbfs_extend_blocks.launches += 1
    return unpack_words(out, n_lanes).view(g_out, bsz, n_lanes)


msbfs_extend_blocks.launches = 0
