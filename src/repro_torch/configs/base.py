"""Arch/shape registry (port of ``repro.configs.base``, pure Python).

Each arch module registers an ``ArchSpec`` carrying its full published config,
a reduced smoke config, its shape set, and documented skips. The port's
registry holds the LM, GNN and recsys families and the paper engine's
Table 2 cells (``_ensure_loaded``), as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | full_graph | minibatch | batched
    #           | serve | bulk | retrieval
    dims: dict  # family-specific dimensions


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | paper
    source: str  # citation tag from the assignment
    full_config: Callable[[], Any]
    smoke_config: Callable[[], Any]
    shapes: tuple  # tuple[ShapeSpec, ...]
    skips: dict  # shape name -> reason (documented in DESIGN.md)
    schedule: str = "cosine"  # training LR schedule
    notes: str = ""


REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    return REGISTRY[arch_id]


def all_archs() -> dict[str, ArchSpec]:
    _ensure_loaded()
    return dict(REGISTRY)


def all_cells():
    """Every runnable (arch, shape) cell + the documented skips."""
    _ensure_loaded()
    cells, skips = [], []
    for spec in REGISTRY.values():
        for shape in spec.shapes:
            if shape.name in spec.skips:
                skips.append((spec.arch_id, shape.name, spec.skips[shape.name]))
            else:
                cells.append((spec.arch_id, shape.name))
    return cells, skips


# ---- shared shape sets ------------------------------------------------------

LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
)

GNN_SHAPES = (
    ShapeSpec(
        "full_graph_sm", "full_graph",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    ),
    ShapeSpec(
        "minibatch_lg", "minibatch",
        dict(
            n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
            fanout=(15, 10),
        ),
    ),
    ShapeSpec(
        "ogb_products", "full_graph",
        dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    ),
    ShapeSpec(
        "molecule", "batched",
        dict(n_nodes=30, n_edges=64, batch=128),
    ),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "bulk", dict(batch=262144)),
    ShapeSpec(
        "retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)
    ),
)

FULL_ATTENTION_SKIP = (
    "long_500k needs sub-quadratic attention; this arch is pure "
    "full-attention (see DESIGN.md §4)"
)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # registration order is the registry's (and the dry-run list's) order,
    # the JAX package's
    from . import (  # noqa: F401  isort: skip
        deepseek_coder_33b,
        gemma2_2b,
        minicpm_2b,
        olmoe_1b_7b,
        llama4_maverick,
        mace,
        equiformer_v2,
        pna,
        schnet,
        dcn_v2,
        paper_bfs,
    )
