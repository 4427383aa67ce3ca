"""AdamW with dtype-controlled moments (port of ``repro.optim.adamw``).

Moments can be held in bfloat16 (with float32 math) to halve optimizer
memory. Parameters, gradients and moments are flat dicts of tensors keyed
alike (``dict(model.named_parameters())``); ``adamw_update`` writes the new
parameters and moments in place, tensor by tensor, so a step holds one
tensor's float32 temporaries at a time and never a second copy of the
state.

The arithmetic is JAX's, operation for operation, in float32:

- ``c1 = 1 - b1 ** step`` and ``c2`` are float32 powers of the float32
  step (``powf``, as XLA computes them; a float64 power differs in the
  last bit), ``lr = cfg.lr * lr_scale`` a float32 product; all three are
  0-d CPU tensors, so the same scalars reach a CPU or a CUDA update;
- the global norm is taken before clipping and returned; a clipped
  gradient is ``(g * scale)`` in float32 rounded back to ``g``'s type;
- decoupled weight decay enters the update as ``wd * p`` beside
  ``mhat / (sqrt(vhat) + eps)``. This is not ``torch.optim.AdamW``, which
  decays ``p *= 1 - lr * wd`` before the step, clips nothing and rounds
  otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from .schedules import f32_pow


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4  # peak; scaled by the schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: Any = torch.float32
    clip_norm: float | None = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the CPU
    mu: dict  # like params
    nu: dict


def adamw_init(params: dict, cfg: AdamWConfig) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        mu={k: zeros(p) for k, p in params.items()},
        nu={k: zeros(p) for k, p in params.items()},
    )


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf sums added in the dict's
    order (JAX adds them in its tree order)."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-9))`` in float32 (a true division:
    PyTorch's ``scalar / tensor`` multiplies by a reciprocal)."""
    top = torch.full((), max_norm, dtype=torch.float32, device=norm.device)
    return torch.div(top, norm.clamp_min(1e-9)).clamp_max(1.0)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # JAX promotes ``g * scale`` to float32 before the cast back; PyTorch
    # would round a 0-d float32 scale to a bfloat16 g's type first
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads: dict, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: _scaled(g, scale) for k, g in grads.items()}, norm


def _work(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor holding ``t``'s values that the update may write:
    ``t`` itself when it is float32, else a float32 copy."""
    return t if t.dtype == torch.float32 else t.float()


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict,
                 cfg: AdamWConfig, lr_scale=1.0, norm=None):
    """Returns (params, new_state, grad_norm); ``params`` and the moments
    are updated in place, the step count is a new tensor. ``norm``: the
    global norm when the caller took it (a rank of a mesh holds blocks
    of some leaves, whose squares it sums across the ranks); by default
    ``global_norm(grads)``."""
    if norm is None:
        norm = global_norm(grads)
    scale = (None if cfg.clip_norm is None
             else _clip_scale(norm, cfg.clip_norm))
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    step32 = step.float()
    c1 = 1.0 - f32_pow(b1, step32)
    c2 = 1.0 - f32_pow(b2, step32)
    lr = torch.as_tensor(cfg.lr * lr_scale, dtype=torch.float32)
    for k, p in params.items():
        g, mu, nu = grads[k], state.mu[k], state.nu[k]
        if scale is not None:
            g = _scaled(g, scale)
        g32 = g.float()
        mu32 = _work(mu).mul_(b1).add_(g32 * (1 - b1))
        nu32 = _work(nu).mul_(b2).add_(g32.square().mul_(1 - b2))
        del g, g32
        mhat = mu32 / c1
        den = (nu32 / c2).sqrt_().add_(cfg.eps)
        delta = mhat.div_(den).add_(cfg.weight_decay * p.float())
        del den
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p.float().sub_(delta.mul_(lr)))
        for m, m32 in ((mu, mu32), (nu, nu32)):
            if m32 is not m:
                m.copy_(m32)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), norm
