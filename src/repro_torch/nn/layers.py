"""Basic layers (port of ``repro.nn.layers``): Dense, Embedding, RMSNorm,
LayerNorm.

A dense kernel keeps JAX's layout, ``[d_in, d_out]`` (``x @ W``), so that
carrying weights across is a copy and not a transpose. Norms compute in
float32 and cast back to the input's type.
"""
from __future__ import annotations

import torch
from torch import nn

from .module import ones, param, set_axes, zeros


class Dense(nn.Module):
    """``{"kernel": [d_in, d_out]}``; also the holder of a stacked expert
    kernel ``[E, d_in, d_out]``. ``axes``: the kernel's logical axes
    (JAX's ``dense_init`` default ``("embed", "mlp")``)."""

    def __init__(self, shape, generator, dtype=torch.float32, device="cpu",
                 scale=None, axes=("embed", "mlp")):
        super().__init__()
        self.kernel = param(tuple(shape), generator, dtype, device, scale)
        set_axes(self, kernel=axes)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    return x @ p.kernel


class RMSNorm(nn.Module):
    """``{"scale": [d]}``, ones at init; axes ``("embed",)`` (QK-norm's
    per-head scale: ``(None,)``)."""

    def __init__(self, d, dtype=torch.float32, device="cpu",
                 axes=("embed",)):
        super().__init__()
        self.scale = ones((d,), dtype, device)
        set_axes(self, scale=axes)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = p.scale.float()
    if zero_centered:  # gemma-style (1 + scale)
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.scale = ones((d,), dtype, device)
        self.bias = zeros((d,), dtype, device)
        set_axes(self, scale=("embed",), bias=("embed",))


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


class Embedding(nn.Module):
    """``{"table": [vocab, d]}``, N(0, 1) at init."""

    def __init__(self, vocab, d, generator, dtype=torch.float32,
                 device="cpu", scale=1.0):
        super().__init__()
        self.table = param((vocab, d), generator, dtype, device, scale)
        set_axes(self, table=("vocab", "embed"))


def embed(p: Embedding, ids: torch.Tensor) -> torch.Tensor:
    return p.table[ids]


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits over vocab."""
    return x @ p.table.T


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)
