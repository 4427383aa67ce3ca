"""Fanout neighbor sampler for minibatch GNN training (port of
``repro.graph.sampler``, GraphSAGE-style).

Multi-hop neighbor sampling is bounded frontier expansion: each hop
extends the frontier of sampled nodes through the same ELL adjacency the
IFE engine scans, with a fanout cap instead of a visited filter. The
sampled tree comes back as a flat subgraph (edge lists with local
indices), so every GNN's edge-list ``apply`` runs on minibatch cells.

A hop is two steps. ``draw_slots`` draws raw slots, int32 in ``[0,
2^30)``, from a ``torch.Generator``; ``gather_hop`` maps them onto the
frontier's neighbor lists (``slot % degree``). JAX draws its slots with
``jax.random.randint`` on threefry keys, which the port does not
reproduce: ``sample_subgraph(..., raw_slots=)`` takes JAX's raw slots
(one array a hop) and then returns JAX's subgraph bitwise. The gather
reads ``indices[frontier, slot]`` alone where JAX gathers the frontier's
whole rows first (``[n_frontier, max_deg]``, 1.47 GB for hop 2 of a
1,024-seed (15, 10) batch on a 23,920-wide ELL).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.common import resolve_device
from .csr import EllGraph

SLOT_RANGE = 1 << 30  # JAX's ``randint(rng, (n, f), 0, 1 << 30)``


class SampledSubgraph(NamedTuple):
    nodes: torch.Tensor  # [n_sampled] global node ids (with repetition)
    edge_src: torch.Tensor  # [n_edges] local index into nodes (child)
    edge_dst: torch.Tensor  # [n_edges] local index into nodes (parent)
    seed_count: int  # first seed_count entries of nodes are the seeds


def draw_slots(generator: torch.Generator, n: int, fanout: int
               ) -> torch.Tensor:
    """[n, fanout] int32 raw slots in ``[0, 2^30)``, on the generator's
    device."""
    return torch.randint(0, SLOT_RANGE, (n, fanout), generator=generator,
                         device=generator.device, dtype=torch.int32)


def gather_hop(g: EllGraph, frontier: torch.Tensor, raw_slots: torch.Tensor
               ) -> torch.Tensor:
    """[n_frontier, fanout] global ids: neighbor ``raw % degree`` of each
    frontier node (with replacement); a zero-degree node samples itself
    (standard GraphSAGE padding)."""
    f = frontier.long()
    degs = g.degrees[f]
    if g.max_deg == 0:
        return frontier[:, None].expand(raw_slots.shape).to(torch.int32)
    slots = raw_slots.to(torch.int32) % torch.clamp_min(degs, 1)[:, None]
    sampled = g.indices[f[:, None], slots.long()]
    return torch.where(degs[:, None] > 0, sampled,
                       frontier[:, None].to(sampled.dtype)).to(torch.int32)


def tree_edges(n_seeds: int, fanouts: tuple, device="cpu"):
    """(src, dst) int32 local edge lists of a fanout tree of ``n_seeds``
    roots laid out layer after layer: child -> parent, the children of
    parent ``i`` of a layer next to each other."""
    srcs, dsts = [], []
    n_parent, offset, total = n_seeds, 0, n_seeds
    for f in fanouts:
        parent = torch.arange(n_parent, dtype=torch.int32,
                              device=device) + offset
        srcs.append(torch.arange(n_parent * f, dtype=torch.int32,
                                 device=device) + total)
        dsts.append(torch.repeat_interleave(parent, f))
        offset, total, n_parent = total, total + n_parent * f, n_parent * f
    return torch.cat(srcs), torch.cat(dsts)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))  # a copy: JAX's arrays are read-only


def sample_subgraph(g: EllGraph, seeds, fanouts: tuple,
                    generator: Optional[torch.Generator] = None,
                    raw_slots=None, device=None) -> SampledSubgraph:
    """Layered fanout sampling: seeds [B] + fanouts (f1, f2, ...) -> flat
    subgraph with child->parent edges (messages flow toward the seeds).

    ``device`` (``cuda`` unless the caller passes ``"cpu"``) must be where
    ``g`` lies: the sampler never copies the graph. Slots come from
    ``generator`` unless ``raw_slots`` (one ``[n_frontier, f]`` array a
    hop, e.g. JAX's) are given."""
    dev = resolve_device(device)
    if g.indices.device.type != dev.type:
        raise ValueError(f"the ELL lies on {g.indices.device}, the sampler "
                         f"was asked for {dev}")
    dev = g.indices.device
    if raw_slots is None and generator is None:
        raise ValueError("sample_subgraph needs a torch.Generator or "
                         "raw_slots")
    if raw_slots is not None and len(raw_slots) != len(fanouts):
        raise ValueError(f"{len(raw_slots)} raw slot arrays for "
                         f"{len(fanouts)} hops")
    seeds = _tensor(seeds).to(dev, torch.int32)
    layers = [seeds]
    for h, f in enumerate(fanouts):
        cur = layers[-1]
        if raw_slots is None:
            raw = draw_slots(generator, cur.shape[0], f)
        else:
            raw = _tensor(raw_slots[h])
            if tuple(raw.shape) != (cur.shape[0], f):
                raise ValueError(f"hop {h}: raw slots {tuple(raw.shape)}, "
                                 f"expected {(cur.shape[0], f)}")
        layers.append(gather_hop(g, cur, raw.to(dev)).reshape(-1))
    src, dst = tree_edges(seeds.shape[0], fanouts, dev)
    return SampledSubgraph(nodes=torch.cat(layers), edge_src=src,
                           edge_dst=dst, seed_count=int(seeds.shape[0]))
