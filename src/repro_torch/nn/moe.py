"""SwiGLU FFN and Mixture-of-Experts with capacity dispatch (port of
``repro.nn.moe``).

Dispatch is scatter-based as in JAX: each of the ``T*K`` (token, k)
slots, in token-major order, takes its position in its expert's buffer
from a running count (a cumsum of one-hots); slots past the capacity C
are dropped, written as zero rows at position 0. Below
``dropless_threshold`` slots C is ``T*K`` and nothing drops. The router's
top-k is a stable descending sort, so ties go to the lower expert index
as ``jax.lax.top_k`` sends them. The aux loss is Switch's load-balancing
term.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense
from .module import shard_activation


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    n_shared: int = 0  # shared (always-on) experts, DeepSeek/Llama4-style
    every: int = 1  # MoE in every k-th layer (1 = all layers)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # below this many (token, k) slots use dropless capacity (C = T*K):
    # decode batches must never drop tokens, and the buffer is tiny there.
    dropless_threshold: int = 4096


class SwiGLU(nn.Module):
    """``wi`` ``[d, 2*d_ff]`` (gate then up) and ``wo`` ``[d_ff, d]``, or
    with ``expert_dim`` E stacked ``[E, d, 2*d_ff]`` / ``[E, d_ff, d]``."""

    def __init__(self, d, d_ff, generator, dtype=torch.float32, device="cpu",
                 expert_dim: int | None = None):
        super().__init__()
        lead = () if expert_dim is None else (expert_dim,)
        wi, wo = ((("embed", "mlp"), ("mlp", "embed")) if expert_dim is None
                  else (("experts", "embed", None),
                        ("experts", None, "embed")))
        self.wi = Dense((*lead, d, 2 * d_ff), generator, dtype, device,
                        axes=wi)
        self.wo = Dense((*lead, d_ff, d), generator, dtype, device, axes=wo)


def ffn(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    gu = x @ p.wi.kernel
    g, u = torch.chunk(gu, 2, dim=-1)
    h = F.silu(g.float()).to(x.dtype) * u
    axes = ("batch",) + ("act_seq",) * (h.ndim - 2) + ("act_model",)
    h = shard_activation(h, axes)
    return h @ p.wo.kernel


class MoE(nn.Module):
    """``router`` ``[d, E]``, ``experts`` (stacked SwiGLU) and, with shared
    experts, ``shared`` (one SwiGLU of width ``d_ff * n_shared``)."""

    def __init__(self, d, m: MoESettings, generator, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        self.router = Dense((d, m.n_experts), generator, dtype, device,
                            axes=("embed", None))
        self.experts = SwiGLU(d, m.d_ff, generator, dtype, device,
                              expert_dim=m.n_experts)
        if m.n_shared:
            self.shared = SwiGLU(d, m.d_ff * m.n_shared, generator, dtype,
                                 device)


def moe(p: MoE, m: MoESettings, x: torch.Tensor):
    """x [B, S, d] -> ([B, S, d], aux loss)."""
    b, seq, d = x.shape
    t = b * seq
    e, k = m.n_experts, m.top_k
    xt = x.reshape(t, d)
    logits = (xt @ p.router.kernel).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]  # [T, K]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # --- aux load-balancing loss (Switch) ---
    me = probs.mean(dim=0)  # [E]
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = (me * ce).sum() * e * m.router_aux_weight

    # --- capacity dispatch ---
    if t * k <= m.dropless_threshold:
        cap = t * k  # dropless (decode / tiny batches)
    else:
        cap = max(int(m.capacity_factor * t * k / e), 1)
    e_flat = idx.reshape(t * k)  # [TK]
    pos_in_e = torch.cumsum(F.one_hot(e_flat, e), dim=0) - 1
    pos = pos_in_e.gather(1, e_flat[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, pos, 0)
    x_rep = xt.repeat_interleave(k, dim=0)  # [TK, d] token per slot
    buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((e_flat, slot), x_rep * keep[:, None].to(xt.dtype),
                   accumulate=True)
    buf = shard_activation(buf, ("act_model", None, None))

    # --- expert computation (batched over experts) ---
    gu = torch.einsum("ecd,edf->ecf", buf, p.experts.wi.kernel)
    g, u = torch.chunk(gu, 2, dim=-1)
    h = F.silu(g) * u  # in the compute dtype, as in JAX
    out_buf = torch.einsum("ecf,efd->ecd", h, p.experts.wo.kernel)
    out_buf = shard_activation(out_buf, ("act_model", None, None))

    # --- combine ---
    gathered = out_buf[e_flat, slot]  # [TK, d]
    gathered = gathered * (keep[:, None] * gates.reshape(t * k)[:, None]).to(
        x.dtype)
    y = gathered.reshape(t, k, d).sum(dim=1)
    if m.n_shared:
        y = y + ffn(p.shared, xt)
    return y.reshape(b, seq, d), aux
