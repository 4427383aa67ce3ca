"""Rotary position embeddings (port of ``repro.nn.rope``): float32 inside,
cast back; the split-half layout (first half rotates with the second)."""
from __future__ import annotations

import torch


def rope_frequencies(d_head: int, theta: float = 1e4,
                     device="cpu") -> torch.Tensor:
    half = d_head // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor,  # [..., S, H, D]
               positions: torch.Tensor,  # [..., S] int
               theta: float = 1e4) -> torch.Tensor:
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
