"""CUDA launcher for the attention forward (``csrc/flash_attention.cu``).

Port of ``repro.kernels.flash_attention.flash_attention``: the online-
softmax forward with the TPU kernel's numerics (``-1e30`` mask,
denominator clamped at ``1e-30``, one rounding to q's type). The launcher
picks the kernel by dtype, and nothing falls back from one to the other:

- bfloat16 runs on the tensor cores (route ``wgmma``): one CTA per
  (batch*head, q tile of 64 rows per consumer warpgroup: 192 rows for the
  D tile 64, 128 otherwise), TMA-fed K/V tiles, ``wgmma`` for both
  products; P enters the second as two bf16 terms, ``P_hi = bf16(P)`` and
  ``P_lo = bf16(P - P_hi)``, so that its error is about 2^-18 of P;
- float32 runs the float32 FMA kernel (route ``f32_fma``), q scaled in
  float32 after the upcast, one CTA per (batch*head, 64-row q tile).

See the source's header. ``flash_attention.launches`` counts kernel
launches (one per call), ``flash_attention.route_launches`` the same per
route.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "f32_fma"}
MAX_HEAD_DIM = 256

_ARGTYPES = {
    "flash_attention_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ],
    "flash_attention_bf16_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ],
}


def _library():
    lib = build.load("flash_attention")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _tma_operand(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` as TMA reads it: rows of ``dp`` elements (a multiple of 8, so
    16-byte strides), zero past the head dim, at a 16-byte aligned
    address. A copy only where ``t`` is not that already."""
    if t.shape[-1] == dp and t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros((*t.shape[:-1], dp), dtype=t.dtype, device=t.device)
    out[..., : t.shape[-1]] = t
    return out


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
    kernel's check ``S % block == 0``; the CUDA kernels' own tiles are
    fixed (see the source). ``D`` is at most 256."""
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
    route = ROUTES.get(q.dtype)
    if route is None:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t in (q, k, v):
        if t.device != dev or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("q, k and v must be contiguous, of one type, "
                             "on one device")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    scale = 1.0 / (d ** 0.5)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            dp = -(-d // 8) * 8
            qp, kp, vp = (_tma_operand(t, dp) for t in (q, k, v))
            code = lib.flash_attention_bf16_launch(
                qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
                b * h, s_len, d, dp, scale, int(causal), stream,
            )
        else:
            code = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, s_len, d, scale, int(causal), stream,
            )
    build.check(lib, "flash_attention", code)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES.values(), 0)
