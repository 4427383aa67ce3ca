"""Plain PyTorch version of the attention forward (port of
``repro.kernels.flash_attention.ref``): upcast to float32, scale q by
``1/sqrt(D)``, mask with ``-1e30``, softmax, the product with V, and one
cast back to q's type. It materialises the ``[B, H, S, S]`` scores."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """``[B, H, S, D]`` attention, causal or full, in q's type."""
    s_len, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        mask = torch.ones((s_len, s_len), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
