"""CUDA launcher for the attention forward (``csrc/flash_attention.cu``).

Port of ``repro.kernels.flash_attention.flash_attention``: the online-
softmax forward with the TPU kernel's numerics (q scaled in float32 after
the upcast, ``-1e30`` mask, denominator clamped at ``1e-30``, one rounding
to q's type). One CTA per (batch*head, 64-row q tile) loops over 64-key
K/V tiles staged in shared memory; see the source's header.

``flash_attention.launches`` counts kernel launches (one per call).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]


def _library():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, H, S, D]
    v: torch.Tensor,  # [B, H, S, D]
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Launch the forward on q's CUDA device and stream; returns
    ``[B, H, S, D]`` in q's type. ``block_q``/``block_k`` keep the TPU
    kernel's check ``S % block == 0``; the CUDA kernel's own tiles are 64
    rows and 64 keys. ``D`` is at most 256."""
    if q.ndim != 4:
        raise ValueError(f"q must be [B, H, S, D], got {tuple(q.shape)}")
    b, h, s_len, d = q.shape
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError("q, k and v must have one shape [B, H, S, D]")
    if s_len % block_q or s_len % block_k:
        raise ValueError(f"S={s_len} must be a multiple of block_q="
                         f"{block_q} and block_k={block_k}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention launches on CUDA tensors only")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t in (q, k, v):
        if t.device != dev or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("q, k and v must be contiguous, of one type, "
                             "on one device")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b * h, s_len, d,
            1.0 / (d ** 0.5), int(causal), stream,
        )
    build.check(lib, "flash_attention", code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
