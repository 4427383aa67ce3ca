"""Gradient compression for data parallelism across ranks (port of
``repro.optim.compression``).

int8 error-feedback compression (1-bit-Adam family): each gradient is
quantized to int8 with a per-tensor scale before the data-parallel
all-reduce, the quantization residual is kept locally and added back the
next step, so what quantization dropped is carried, not lost.

Gradients, payloads, scales and residuals are flat dicts of tensors keyed
alike, as ``optim.adamw`` takes them. The arithmetic is JAX's function as
XLA compiles it (``jit``, ``shard_map``), operation for operation, in
float32:

- a division by a constant (``max|x| / 127``, the mean's ``/ n``) is a
  product with the constant's float32 reciprocal, as XLA's simplifier
  rewrites it; ``x / scale`` is a true division by a 0-d tensor on the
  operand's device (the card's kernels multiply by a reciprocal when the
  divisor is a Python scalar);
- ``torch.round`` rounds half to even like ``jnp.round``;
- the residual ``v - q * scale`` is rounded once, as XLA contracts it
  into a fused multiply-add on the CPU (``core.edge_compute.fma_f32``).

JAX run op by op, outside ``jit``, divides and rounds the product
first: its scale can be one float32 step away, and its residuals a last
bit.

``compressed_psum`` sums the int8 payloads as int32, exactly, by the
backend's SUM (``core.collectives.int_psum``): on the wire that is as
many bytes as the float32 gradient, whatever the int8 type suggests. The
float scales go through ``psum``'s ordered fold.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import collectives
from ..core.edge_compute import fma_f32


class CompressionState(NamedTuple):
    residual: dict  # like grads (float32 residuals)


def compression_init(grads_like: dict) -> CompressionState:
    return CompressionState(residual={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in grads_like.items()})


def _by_constant(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as XLA compiles it: ``x`` times the
    float32 reciprocal of ``c``."""
    inv = torch.reciprocal(torch.tensor(c, dtype=torch.float32))
    return x * inv.to(x.device)


def quantize_int8(x: torch.Tensor):
    """(int8 payload, float32 0-d scale): ``scale = max(max|x| / 127,
    1e-12)``, ``q = clip(round(x / scale), -127, 127)``."""
    scale = torch.clamp_min(_by_constant(torch.amax(x.abs()), 127.0), 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: dict, state: CompressionState):
    """Returns (int8 payloads, scales, new_state). The caller all-reduces
    the int8 payloads (their sum across ranks fits int32 accumulators)
    and dequantizes with the mean scale."""
    qs, scales, residual = {}, {}, {}
    for k, g in grads.items():
        v = g.float() + state.residual[k]
        q, scale = quantize_int8(v)
        qs[k], scales[k] = q, scale
        residual[k] = fma_f32(v, -scale.double(), q.float())
    return qs, scales, CompressionState(residual=residual)


def decompress_grads(qs: dict, scales: dict) -> dict:
    return {k: dequantize_int8(q, scales[k]) for k, q in qs.items()}


def compressed_psum(grads: dict, state: CompressionState, axes):
    """The compressed data-parallel all-reduce over ``axes``
    (``launch.mesh.Axes``): quantize, sum the int8 payloads as int32,
    dequantize with the mean scale. Returns (mean gradient, new_state)."""
    qs, scales, state = compress_grads(grads, state)
    n = axes.size if axes else 1
    out = {}
    for k, q in qs.items():
        summed = collectives.int_psum(q.to(torch.int32), axes)
        mean_scale = _by_constant(collectives.psum(scales[k], axes), n)
        out[k] = _by_constant(summed.float() * mean_scale, n)
    return out, state
