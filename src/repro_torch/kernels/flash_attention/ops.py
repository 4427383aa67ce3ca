"""Wrapper of the attention forward (port of
``repro.kernels.flash_attention.ops``), in JAX's ``[B, H, S, D]`` layout.

``mha`` runs the plain PyTorch version for a CPU tensor (or with
``use_ref``) and launches the CUDA kernel for a CUDA tensor; there is no
fall back. JAX's ``mha`` picks by backend (``use_kernel``); the port picks
by the tensor's device, like its other kernel wrappers.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .ref import attention_ref


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True, use_ref: bool = False) -> torch.Tensor:
    """Multi-head attention over ``[B, H, S, D]`` (no GQA: k and v have
    q's shape), causal or full, in q's type."""
    if use_ref or q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    return flash_attention(q, k, v, causal=causal)
