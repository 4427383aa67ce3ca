"""EquiformerV2 [arXiv:2306.12059] — equivariant graph attention via eSCN
SO(2) convolutions (port of ``repro.models.gnn.equiformer_v2``).

Assigned config: n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8.

The eSCN trick: rotate neighbor irreps into the edge-aligned frame (Wigner
blocks from ``irreps.align_matrices``), where the SO(3) tensor product
reduces to per-|m| SO(2) linear maps (O(L^3) instead of O(L^6));
components with |m| > m_max are truncated. Attention logits come from the
frame's scalar channel and the radial basis; values are the SO(2)-convolved
irreps, rotated back after aggregation. JAX's ``.at[...].set`` writes
become one out-of-place ``index_copy``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ...nn.module import fsdp_param
from . import common
from .common import Kernel
from .irreps import align_matrices, l_of_lm, lm_index, n_lm, rotate_irreps


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 32
    cutoff: float = 8.0
    n_species: int = 32
    d_feat: int = 0
    n_out: int = 1


def _m_indices(cfg):
    """For each m in 0..m_max: flat lm indices of (l, +-m) components."""
    out = []
    for m in range(cfg.m_max + 1):
        ls = [l for l in range(m, cfg.l_max + 1)]
        pos = [lm_index(l, m) for l in ls]
        neg = [lm_index(l, -m) for l in ls]
        out.append((np.array(pos), np.array(neg), len(ls)))
    return out


def _so2_params(cfg, generator, device) -> nn.ModuleDict:
    """Per-|m| SO(2) linear weights over the l-stack (+ channel mix)."""
    p = {}
    for m in range(cfg.m_max + 1):
        nl = cfg.l_max + 1 - m
        p[f"wr_{m}"] = Kernel((nl, nl), generator, device, 1.0 / np.sqrt(nl))
        if m > 0:
            p[f"wi_{m}"] = Kernel((nl, nl), generator, device,
                                  1.0 / np.sqrt(nl))
    C = cfg.d_hidden
    p["channel"] = Kernel((C, C), generator, device, 1.0 / np.sqrt(C))
    return nn.ModuleDict(p)


def _lk(x, w):
    return torch.einsum("elc,lk->ekc", x, w)


def _so2_apply(p, cfg, x_rot, midx):
    """SO(2) conv in the edge frame: x_rot [E, nlm, C] -> [E, nlm, C]
    (m > m_max truncated to 0)."""
    parts, rows = [], []
    for m, (pos, neg, nl) in enumerate(midx):
        wr = p[f"wr_{m}"].kernel  # [nl, nl]
        xc = x_rot[:, pos, :]  # [E, nl, C] cos components
        if m == 0:
            parts.append(_lk(xc, wr))
            rows.append(pos)
        else:
            wi = p[f"wi_{m}"].kernel
            xs = x_rot[:, neg, :]
            parts += [_lk(xc, wr) - _lk(xs, wi), _lk(xc, wi) + _lk(xs, wr)]
            rows += [pos, neg]
    idx = torch.from_numpy(np.concatenate(rows)).to(x_rot.device)
    out = torch.zeros_like(x_rot).index_copy(1, idx, torch.cat(parts, 1))
    return out @ p["channel"].kernel


def _eq_layernorm(x, eps=1e-6):
    """Equivariant norm: per-l RMS over (m, C)."""
    outs = []
    l_max = int(np.sqrt(x.shape[1])) - 1
    for l in range(l_max + 1):
        blk = x[:, l * l : (l + 1) ** 2, :]
        rms = torch.sqrt(torch.mean(torch.square(blk), dim=(1, 2),
                                    keepdim=True))
        outs.append(blk / torch.clamp_min(rms, eps))
    return torch.cat(outs, dim=1)


def _leaky_relu(x, slope: float = 0.01):
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope * x)`` (gradient 1
    at 0, where ``F.leaky_relu``'s is the slope)."""
    return torch.where(x >= 0, x, slope * x)


class EquiformerV2(nn.Module):
    """JAX's tree: ``species_embed``, ``readout``, ``feat_proj`` (when
    ``d_feat``) and ``layer_{i}`` with ``so2`` (``wr_{m}``, ``wi_{m}``,
    ``channel``), ``alpha``, ``ffn_scalar`` (``w1``, ``w2``), ``gate`` and
    ``proj``."""

    def __init__(self, cfg: EquiformerV2Config, generator, device):
        super().__init__()
        self.cfg = cfg
        C, H = cfg.d_hidden, cfg.n_heads

        def k(shape, scale=None):
            return Kernel(shape, generator, device, scale)

        self.species_embed = k((cfg.n_species, C), 1.0)
        self.readout = k((C, cfg.n_out))
        if cfg.d_feat:
            self.feat_proj = Kernel((cfg.d_feat, C), generator, device,
                                    axes=("embed", None))
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", nn.ModuleDict({
                "so2": _so2_params(cfg, generator, device),
                "alpha": k((2 * C + cfg.n_rbf, H)),
                "ffn_scalar": nn.ModuleDict({"w1": k((C, 2 * C)),
                                             "w2": k((2 * C, C))}),
                "gate": k((C, cfg.l_max * C)),
                "proj": k((C, C))}))

    def forward(self, batch):
        return apply(self, self.cfg, batch)


def init(cfg: EquiformerV2Config, generator, device=None) -> EquiformerV2:
    return common.build(EquiformerV2, cfg, generator, device)


def params_from_jax(cfg: EquiformerV2Config, tree: dict,
                    device=None) -> EquiformerV2:
    return common.model_from_jax(EquiformerV2, cfg, tree, device)


def apply(params: EquiformerV2, cfg: EquiformerV2Config, batch):
    pos = batch["positions"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    N = pos.shape[0]
    dev = pos.device
    nlm = n_lm(cfg.l_max)
    C, H = cfg.d_hidden, cfg.n_heads
    midx = _m_indices(cfg)

    species = torch.clamp(batch["species"].long(), 0, cfg.n_species - 1)
    x0 = params.species_embed.kernel[species]
    if cfg.d_feat and "node_feat" in batch:
        x0 = x0 + batch["node_feat"].float() @ fsdp_param(
            params, "feat_proj.kernel")
    x = torch.cat([x0[:, None, :], x0.new_zeros((N, nlm - 1, C))], dim=1)

    vec, r, valid = common.edge_vectors(pos, src, dst)
    mats = align_matrices(cfg.l_max, vec)  # per-l [E, 2l+1, 2l+1]
    rbf = common.gaussian_rbf(r, cfg.n_rbf, cfg.cutoff)
    gate_l = l_of_lm(cfg.l_max, first=1).to(dev)

    for i in range(cfg.n_layers):
        lp = getattr(params, f"layer_{i}")
        xn = _eq_layernorm(x)
        table = common.node_table(xn)
        xj = common.take(table, src)  # [E, nlm, C]
        xj_rot = rotate_irreps(mats, xj, cfg.l_max)  # into edge frame
        msg = _so2_apply(lp["so2"], cfg, xj_rot, midx)  # [E, nlm, C]
        msg = msg * valid[:, None, None]  # degenerate edges carry no message
        # attention logits: frame scalars of i and conv output + rbf
        xi_scal = common.take(table[:, 0, :], dst)  # [E, C]
        feats = torch.cat([xi_scal, msg[:, 0, :], rbf], dim=-1)
        logits = _leaky_relu(feats @ lp["alpha"].kernel)  # [E, H]
        alpha = common.segment_softmax(logits, dst, N)  # [E, H]
        vals = msg.reshape(-1, nlm, H, C // H) * alpha[:, None, :, None]
        vals = vals.reshape(-1, nlm, C)
        vals = rotate_irreps(mats, vals, cfg.l_max, inverse=True)
        agg = common.aggregate(vals, dst, N, "sum")  # [N, nlm, C]
        x = x + agg @ lp["proj"].kernel
        # FFN: scalar MLP + gated non-scalars
        xn2 = _eq_layernorm(x)
        s = xn2[:, 0, :]
        h = torch.nn.functional.silu(s @ lp["ffn_scalar"]["w1"].kernel)
        s_out = h @ lp["ffn_scalar"]["w2"].kernel
        gates = torch.sigmoid(s @ lp["gate"].kernel).reshape(
            -1, cfg.l_max, C)
        gl = gates[:, gate_l, :]  # [N, nlm-1, C]
        upd = torch.cat([s_out[:, None, :], xn2[:, 1:, :] * gl], dim=1)
        x = x + upd
    node_out = x[:, 0, :] @ params.readout.kernel
    out = {"node_out": node_out}
    if "graph_ids" in batch:
        out["graph_out"] = common.segment_sum(
            node_out, batch["graph_ids"].long(), batch["n_graphs"])
    return out
