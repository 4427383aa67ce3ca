"""LR schedules (port of ``repro.optim.schedules``): cosine and WSD
(Warmup-Stable-Decay, MiniCPM arXiv:2404.06395).

Each returns ``lr_scale(step)`` in [0, 1], a 0-d float32 CPU tensor that
multiplies the optimizer's peak lr. ``step`` is one step (an int or a 0-d
tensor). Every operation is a float32 one, as in JAX: JAX evaluates the
schedule eagerly, one step at a time, and XLA's CPU backend computes
``cos`` and ``pow`` of a float32 scalar with the C library's ``cosf`` and
``powf``. PyTorch's CPU kernels use other approximations, so the port
calls ``cosf``/``powf`` itself (``f32_cos``, ``f32_pow``); with them the
schedules are bitwise JAX's.

WSD's warmup gives ``lr_scale(0) == 0``: the first step of a run updates
nothing.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch


@functools.cache
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "powf"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * (2 if name == "powf" else 1)
    return lib


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def f32_cos(x: torch.Tensor) -> torch.Tensor:
    """``cosf`` of a float32 scalar, as XLA computes ``jnp.cos``."""
    return _f32(_libm().cosf(float(x)))


def f32_pow(base, exponent) -> torch.Tensor:
    """``powf`` of two float32 scalars, as XLA computes ``b ** e``."""
    return _f32(_libm().powf(float(_f32(base)), float(_f32(exponent))))


def cosine_schedule(warmup: int, total: int, min_ratio: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = step / max(warmup, 1)
        t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        # the float32 products and sums of JAX's expression, in its order:
        # (1 - min_ratio) * 0.5 is a Python float, then rounded to float32
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + f32_cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return f


def wsd_schedule(warmup: int, total: int, decay_frac: float = 0.1,
                 min_ratio: float = 0.01):
    """Warmup -> stable plateau at 1.0 -> sharp decay over the last
    ``decay_frac`` of training (MiniCPM's schedule: enables continual
    pretraining from the stable phase)."""
    decay_start = int(total * (1 - decay_frac))

    def f(step):
        step = _f32(step)
        warm = step / max(warmup, 1)
        t = ((step - decay_start) / max(total - decay_start, 1)).clamp(
            0.0, 1.0)
        # exponential-style decay (MiniCPM uses ~exp decay to 10% then cut)
        decay = f32_pow(min_ratio, t)
        out = torch.where(step < warmup, warm, _f32(1.0))
        return torch.where(step >= decay_start, decay, out)

    return f


SCHEDULES = {"cosine": cosine_schedule, "wsd": wsd_schedule}
