"""CUDA launcher for the block-sparse SpMM (``csrc/block_spmm.cu``).

Port of ``repro.kernels.block_spmm.block_spmm``. The kernel reads the
blocks' compacted view (``ops.SpmmNonzeros``: nonzeros by destination and
a list of chunks of at most ``chunk`` nonzeros): one warp per chunk gathers
the chunk's source feature rows and writes its float32 sum, and a second
pass adds the partial sums of destinations split into several chunks, in
chunk order. No atomics: the same bits every run. Zero entries are not in
the view, so they are skipped; see the source's header for what that means
for non-finite features.

``block_spmm.launches`` counts calls that launch the kernels (one per
call; the two passes are one C entry point).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "src/repro_torch/kernels/csrc/block_spmm.cu"
ROUTE = "csr_chunks"
DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
]


def _library():
    lib = build.load("block_spmm")
    fn = lib.block_spmm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def block_spmm(nz, x: torch.Tensor) -> torch.Tensor:
    """Launch the SpMM over the compacted view ``nz`` (an
    ``ops.SpmmNonzeros``) on ``x``'s CUDA device and stream. ``x`` is
    ``[n, F]`` in the view's dtype with ``n >= nz.n_dst`` and ``F % min(F,
    128) == 0``; returns ``[n, F]`` float32, rows ``>= nz.n_dst`` zero."""
    if x.ndim != 2:
        raise ValueError(f"x must be [n, F], got {tuple(x.shape)}")
    n, feat = x.shape
    ft = min(feat, 128)
    if ft == 0 or feat % ft or n < nz.n_dst:
        raise ValueError(f"x {tuple(x.shape)} for {nz.n_dst} destinations: "
                         "need F % min(F, 128) == 0 and n >= destinations")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("block_spmm launches on CUDA tensors only")
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError("x must be contiguous f32/bf16")
    if nz.nz_val.dtype != x.dtype:
        raise ValueError(f"blocks {nz.nz_val.dtype} and x {x.dtype} must "
                         "have one dtype")
    if nz.nz_src.device != dev:
        raise ValueError("the blocks must lie on x's device")
    out = torch.empty((n, feat), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    part = torch.empty((nz.n_slots, feat), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.block_spmm_launch(
            nz.nz_src.data_ptr(), nz.nz_val.data_ptr(), nz.items.data_ptr(),
            nz.items.shape[0], nz.splits.data_ptr(), nz.splits.shape[0],
            nz.n_dst, x.data_ptr(), int(x.dtype == torch.bfloat16), n, feat,
            out.data_ptr(), part.data_ptr(), stream,
        )
    build.check(lib, "block_spmm", code)
    block_spmm.launches += 1
    return out


block_spmm.launches = 0
