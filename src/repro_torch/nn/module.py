"""Parameter inits and counts (the LM's part of ``repro.nn.module``).

The JAX package's layers are (init, apply) pairs over nested dicts of
``Boxed`` leaves. The port's layers are ``nn.Module``s that hold
``nn.Parameter``s under the JAX dicts' key names, so that a parameter's
dotted name in the port is its path in JAX's tree (``attn.wq.kernel``).

Seeded inits draw from an explicit ``torch.Generator`` on the generator's
own device and place the result on the target device; on the ``meta``
device nothing is drawn (shapes only, any model size). The logical-axis
sharding rules (``sharding_rules``, ``logical_to_spec``) are GSPMD and
belong to the LM's mesh slice; here ``shard_activation`` is the identity,
as it is in JAX without installed rules. Parameters are created without a
gradient (``requires_grad=False``), for serving; the trainer switches them
on for its model (``requires_grad_(True)``).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def shard_activation(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """The identity: the port has no activation sharding rules yet."""
    return x


def normal_init(shape, dtype, scale: float, generator: torch.Generator,
                device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32, then cast to ``dtype``."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (scale * x).to(dtype).to(dev)


def param(shape, generator: torch.Generator, dtype=torch.float32,
          device="cpu", scale: float | None = None) -> nn.Parameter:
    """A seeded ``nn.Parameter``; the default scale is ``1/sqrt(shape[0])``
    (JAX's ``boxed_param``: ``shape[0]`` is the fan-in of a dense kernel,
    and the expert count of a stacked expert kernel)."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    return nn.Parameter(normal_init(shape, dtype, scale, generator, device),
                        requires_grad=False)


def ones(shape, dtype=torch.float32, device="cpu") -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=dtype, device=device),
                        requires_grad=False)


def zeros(shape, dtype=torch.float32, device="cpu") -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def cast_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float. JAX turns a Python
    scalar into the array's type before a binary op (``x_bf16 * 0.3``
    multiplies by ``bf16(0.3)``); PyTorch's kernels keep the scalar in
    float32, so a bfloat16 product would round differently."""
    return torch.tensor(v, dtype=dtype).item()
