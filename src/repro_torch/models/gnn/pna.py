"""PNA [arXiv:2004.05718] — Principal Neighbourhood Aggregation (port of
``repro.models.gnn.pna``).

Assigned config: n_layers=4, d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation (log-degree). Each layer is
rematerialized in the backward pass (JAX's ``jax.checkpoint``; here a
non-reentrant ``torch.utils.checkpoint`` while a graph is built), so only
the ``[N, d]`` residual stream is saved, not the twelve aggregated
tensors.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...nn.module import fsdp_param, shard_activation
from . import common
from .common import Kernel


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_feat: int = 128
    n_out: int = 40
    avg_log_degree: float = 3.0  # delta: dataset-mean log(deg+1)


AGGS = ("mean", "max", "min", "std")
N_SCALERS = 3


class PNA(nn.Module):
    """JAX's tree: ``feat_proj``, ``readout`` and ``layer_{i}`` with
    ``pre`` and ``post``. Calling it runs ``apply``."""

    def __init__(self, cfg: PNAConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_hidden
        self.feat_proj = Kernel((cfg.d_feat, d), generator, device,
                                axes=("embed", None))
        self.readout = Kernel((d, cfg.n_out), generator, device)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", nn.ModuleDict({
                "pre": Kernel((2 * d, d), generator, device),
                "post": Kernel((len(AGGS) * N_SCALERS * d + d, d),
                               generator, device)}))

    def forward(self, batch):
        return apply(self, self.cfg, batch)


def init(cfg: PNAConfig, generator, device=None) -> PNA:
    return common.build(PNA, cfg, generator, device)


def params_from_jax(cfg: PNAConfig, tree: dict, device=None) -> PNA:
    return common.model_from_jax(PNA, cfg, tree, device)


def _layer(x, lp, src, dst, amp, att):
    N = x.shape[0]
    table = common.node_table(x)
    hi = common.take(table, dst)
    hj = common.take(table, src)
    msg = torch.relu(torch.cat([hi, hj], dim=-1) @ lp["pre"].kernel)
    msg = shard_activation(msg, ("edges", None), have=("edges", None))
    aggs = []
    mean = common.aggregate(msg, dst, N, "mean")
    for a in AGGS:
        if a == "std":
            sq = common.aggregate(torch.square(msg), dst, N, "mean")
            # +eps inside sqrt: d/dx sqrt at 0 is inf (NaN grads for
            # isolated nodes)
            agg = torch.sqrt(torch.clamp_min(sq - torch.square(mean), 0.0)
                             + 1e-6)
        elif a == "mean":
            agg = mean
        else:
            agg = common.aggregate(msg, dst, N, a)
        aggs += [agg, agg * amp, agg * att]  # identity, amp, atten
    h = torch.cat(aggs + [x], dim=-1) @ lp["post"].kernel
    return shard_activation(torch.relu(h) + x, ("batch", None),
                            have=("batch", None))


def apply(params: PNA, cfg: PNAConfig, batch):
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    # the parameters' type: float32 as JAX's, float64 for a reference
    feat = batch["node_feat"].to(params.feat_proj.kernel.dtype)
    N = feat.shape[0]
    x = feat @ fsdp_param(params, "feat_proj.kernel")
    deg = common.degree(dst, N).to(x.dtype)  # counts: exact in float32
    logd = torch.log1p(deg)[:, None]
    amp = logd / cfg.avg_log_degree
    # a true division: PyTorch's ``scalar / tensor`` multiplies by a
    # reciprocal
    att = torch.div(torch.full_like(logd, cfg.avg_log_degree),
                    torch.clamp_min(logd, 1e-6))
    for i in range(cfg.n_layers):
        lp = getattr(params, f"layer_{i}")
        if torch.is_grad_enabled():
            x = checkpoint(_layer, x, lp, src, dst, amp, att,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(x, lp, src, dst, amp, att)
    node_out = x @ params.readout.kernel
    out = {"node_out": node_out}
    if "graph_ids" in batch:
        out["graph_out"] = common.segment_sum(
            node_out, batch["graph_ids"].long(), batch["n_graphs"])
    return out
