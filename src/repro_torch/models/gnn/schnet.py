"""SchNet [arXiv:1706.08566] — continuous-filter convolutions (port of
``repro.models.gnn.schnet``).

Assigned config: n_interactions=3, d_hidden=64, rbf=300, cutoff=10.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...nn.module import fsdp_param
from . import common
from .common import Kernel


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 32
    d_feat: int = 0
    n_out: int = 1


class SchNet(nn.Module):
    """JAX's tree: ``species_embed``, ``out1``, ``out2``, ``feat_proj``
    (when ``d_feat``) and ``interaction_{i}`` with ``filter1``,
    ``filter2``, ``in_proj``, ``out_proj``. Calling it runs ``apply``."""

    def __init__(self, cfg: SchNetConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_hidden

        def k(shape, scale=None):
            return Kernel(shape, generator, device, scale)

        self.species_embed = k((cfg.n_species, d), 1.0)
        self.out1 = k((d, d // 2))
        self.out2 = k((d // 2, cfg.n_out))
        if cfg.d_feat:
            self.feat_proj = Kernel((cfg.d_feat, d), generator, device,
                                    axes=("embed", None))
        for i in range(cfg.n_interactions):
            self.add_module(f"interaction_{i}", nn.ModuleDict({
                "filter1": k((cfg.n_rbf, d)), "filter2": k((d, d)),
                "in_proj": k((d, d)), "out_proj": k((d, d))}))

    def forward(self, batch):
        return apply(self, self.cfg, batch)


def init(cfg: SchNetConfig, generator, device=None) -> SchNet:
    return common.build(SchNet, cfg, generator, device)


def params_from_jax(cfg: SchNetConfig, tree: dict, device=None) -> SchNet:
    return common.model_from_jax(SchNet, cfg, tree, device)


def apply(params: SchNet, cfg: SchNetConfig, batch):
    pos = batch["positions"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    N = pos.shape[0]
    species = torch.clamp(batch["species"].long(), 0, cfg.n_species - 1)
    x = params.species_embed.kernel[species]
    if cfg.d_feat and "node_feat" in batch:
        x = x + batch["node_feat"].float() @ fsdp_param(
            params, "feat_proj.kernel")
    _, r, valid = common.edge_vectors(pos, src, dst)
    rbf = common.gaussian_rbf(r, cfg.n_rbf, cfg.cutoff)  # [E, n_rbf]
    rbf = rbf * valid[:, None]  # degenerate edges carry no message

    for i in range(cfg.n_interactions):
        lp = getattr(params, f"interaction_{i}")
        W = common.shifted_softplus(rbf @ lp["filter1"].kernel)
        W = W @ lp["filter2"].kernel  # [E, d] continuous filter
        hj = common.take(common.node_table(x @ lp["in_proj"].kernel), src)
        msg = hj * W
        agg = common.aggregate(msg, dst, N, "sum")
        v = common.shifted_softplus(agg @ lp["out_proj"].kernel)
        x = x + v
    h = common.shifted_softplus(x @ params.out1.kernel)
    node_out = h @ params.out2.kernel
    out = {"node_out": node_out}
    if "graph_ids" in batch:
        out["graph_out"] = common.segment_sum(
            node_out, batch["graph_ids"].long(), batch["n_graphs"])
    return out
