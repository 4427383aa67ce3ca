"""MACE [arXiv:2206.07697] — higher-order equivariant message passing
(E(3)-ACE), port of ``repro.models.gnn.mace``.

Assigned config: n_layers=2, d_hidden=128, l_max=2, correlation_order=3,
n_rbf=8. Irreps features are flat [N, (l_max+1)^2, C]; products use the
real Gaunt tensor (``irreps.gaunt_full``). The ACE symmetric contraction
to correlation order nu is iterated Gaunt products (B2 = G.A.A, B3 =
G.B2.A) with per-order, per-l channelwise linear weights.

JAX writes the two three-operand contractions as einsums and lets
opt_einsum order them; the port fixes the pairwise order: the edge tensor
product contracts ``Y`` with ``G`` first (``[E, b, c]``, one GEMM) and
then takes a batched product with the neighbor's irreps, and the node
product takes the outer product of its two operands (``[N, a*b, C]``)
into one GEMM with ``G`` reshaped to ``[a*b, c]``. The sums add in
another order than JAX's; the parity tests state the tolerance.

Geometric inputs (positions, species) drive the edge basis; optional node
features project into the l=0 channels (full-graph node classification).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ...nn.module import fsdp_param
from . import common
from .common import Kernel
from .irreps import gaunt_full, l_of_lm, n_lm, sph_harm_real


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 32
    d_feat: int = 0  # >0: project node features into l=0
    n_out: int = 1  # 1 = energy; >1 = node classes


def _per_l_linear(cfg, generator, device) -> nn.ModuleDict:
    """Per-l channel linear weights ``l{l}.kernel`` [C, C]."""
    C = cfg.d_hidden
    return nn.ModuleDict({
        f"l{l}": Kernel((C, C), generator, device, 1.0 / np.sqrt(C))
        for l in range(cfg.l_max + 1)})


def _per_l_apply(p, cfg, x):
    """x [N, n_lm, C] -> same, block-diagonal per-l channel mixing."""
    return torch.cat([x[:, l * l : (l + 1) ** 2, :] @ p[f"l{l}"].kernel
                      for l in range(cfg.l_max + 1)], dim=1)


class MACE(nn.Module):
    """JAX's tree: ``species_embed``, ``readout``, ``feat_proj`` (when
    ``d_feat``) and ``layer_{i}`` with ``radial``, ``w_A``, ``w_B2``,
    ``w_B3``, ``w_self`` (``l{l}`` each) and ``readout``."""

    def __init__(self, cfg: MACEConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        C = cfg.d_hidden
        self.species_embed = Kernel((cfg.n_species, C), generator, device,
                                    1.0)
        self.readout = Kernel((C, cfg.n_out), generator, device)
        if cfg.d_feat:
            self.feat_proj = Kernel((cfg.d_feat, C), generator, device,
                                    axes=("embed", None))
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", nn.ModuleDict({
                "radial": Kernel((cfg.n_rbf, (cfg.l_max + 1) * C),
                                 generator, device),
                **{w: _per_l_linear(cfg, generator, device)
                   for w in ("w_A", "w_B2", "w_B3", "w_self")},
                "readout": Kernel((C, cfg.n_out), generator, device)}))

    def forward(self, batch):
        return apply(self, self.cfg, batch)


def init(cfg: MACEConfig, generator, device=None) -> MACE:
    return common.build(MACE, cfg, generator, device)


def params_from_jax(cfg: MACEConfig, tree: dict, device=None) -> MACE:
    return common.model_from_jax(MACE, cfg, tree, device)


def _edge_product(Y, G, hj):
    """einsum("ea,abc,ebk->eck", Y, G, hj): (Y . G) first, then a batched
    product over b."""
    E, a = Y.shape
    YG = (Y @ G.reshape(a, -1)).reshape(E, a, a)  # [E, b, c]
    return YG.transpose(1, 2) @ hj  # [E, c, k]


def _node_product(G, X, Z):
    """einsum("abc,nak,nbk->nck", G, X, Z): the outer product over (a, b)
    first, then one GEMM with G as [a*b, c]."""
    n, a, k = X.shape
    outer = (X[:, :, None, :] * Z[:, None, :, :]).reshape(n, a * a, k)
    return torch.einsum("nxk,xc->nck", outer, G.reshape(a * a, a))


def apply(params: MACE, cfg: MACEConfig, batch):
    """batch: positions [N,3], species [N], edge_src/dst [E], optional
    node_feat [N,d_feat], optional graph_ids [N] (+ n_graphs). Returns
    per-node outputs [N, n_out] (and graph outputs if graph_ids)."""
    pos = batch["positions"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    N = pos.shape[0]
    dev = pos.device
    nlm = n_lm(cfg.l_max)
    C = cfg.d_hidden
    G = torch.from_numpy(gaunt_full(cfg.l_max).astype(np.float32)).to(dev)

    species = torch.clamp(batch["species"].long(), 0, cfg.n_species - 1)
    h0 = params.species_embed.kernel[species]
    if cfg.d_feat and "node_feat" in batch:
        h0 = h0 + batch["node_feat"].float() @ fsdp_param(
            params, "feat_proj.kernel")
    # JAX's zeros.at[:, 0, :].set(h0), out of place
    h = torch.cat([h0[:, None, :], h0.new_zeros((N, nlm - 1, C))], dim=1)

    vec, r, valid = common.edge_vectors(pos, src, dst)
    Y = sph_harm_real(cfg.l_max, vec)  # [E, nlm]
    rbf = common.bessel_rbf(r, cfg.n_rbf, cfg.cutoff)  # [E, n_rbf]
    rbf = rbf * valid[:, None]  # degenerate edges carry no message
    lm_l = l_of_lm(cfg.l_max).to(dev)

    node_out = torch.zeros((N, cfg.n_out), dtype=torch.float32, device=dev)
    for i in range(cfg.n_layers):
        lp = getattr(params, f"layer_{i}")
        # radial weights per output-l, per channel
        R = (rbf @ lp["radial"].kernel).reshape(-1, cfg.l_max + 1, C)
        R_lm = R[:, lm_l, :]  # [E, nlm, C]
        hj = common.take(common.node_table(h), src)  # [E, nlm, C]
        # tensor product via Gaunt: m[c(out)] = G[a,b,c] Y[a] h[b]
        msg = _edge_product(Y, G, hj) * R_lm
        A = common.aggregate(msg, dst, N, "sum")  # [N, nlm, C]
        # ACE product basis (correlation order up to 3)
        B2 = _node_product(G, A, A)
        terms = (_per_l_apply(lp["w_A"], cfg, A)
                 + _per_l_apply(lp["w_B2"], cfg, B2))
        if cfg.correlation_order >= 3:
            B3 = _node_product(G, B2, A)
            terms = terms + _per_l_apply(lp["w_B3"], cfg, B3)
        h = _per_l_apply(lp["w_self"], cfg, h) + terms
        # per-layer scalar readout (MACE sums site energies per interaction)
        node_out = node_out + torch.nn.functional.silu(h[:, 0, :]) \
            @ lp["readout"].kernel

    node_out = node_out + h[:, 0, :] @ params.readout.kernel
    out = {"node_out": node_out}
    if "graph_ids" in batch:
        out["graph_out"] = common.segment_sum(
            node_out, batch["graph_ids"].long(), batch["n_graphs"])
    return out
