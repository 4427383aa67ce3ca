"""GPipe-style pipeline parallelism over a mesh axis of ranks (port of
``repro.parallel.pipeline``).

Stages live on the ``pipe`` axis, one rank a stage. The schedule runs M
microbatches through S stages in S + M - 1 ticks: each tick every stage
applies its block to the microbatch it holds, then the activations shift
one stage forward (``core.collectives.shift``, JAX's ``ppermute``). The
last stage's outputs reach every rank by a masked ``psum``.

JAX's ``shard_map`` body computes every stage on every tick and masks the
inactive ones out; here a rank computes only on the ticks where it holds
a microbatch, which gives the same outputs. The stage function is the
caller's (any ``(params, x) -> x``). Correctness contract (tested):
output == applying all S stages serially to every microbatch.
"""
from __future__ import annotations

import torch

from ..core.collectives import psum, shift


def _take(tree, i: int):
    """Stage ``i``'s parameters: the leading index of every leaf."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def pipeline_apply(mesh, stage_params, xs: torch.Tensor, stage_fn,
                   axis: str = "pipe") -> torch.Tensor:
    """Runs all M microbatches ``xs`` [M, ...] (the same on every rank;
    stage 0 feeds them in) through the S stages of ``axis``.
    ``stage_params`` holds every stage's parameters, leaves with leading
    dim S; this rank takes its own. Returns [M, ...] on every rank."""
    S = mesh.shape[axis]
    M = xs.shape[0]
    axes = mesh.axes((axis,))
    stage = mesh.coord(axis) if S > 1 else 0
    params_me = _take(stage_params, stage)
    buf = torch.zeros_like(xs[0])  # the activation this stage holds
    outs = torch.zeros_like(xs)
    for t in range(S + M - 1):
        mb_here = t - stage  # the microbatch at this stage on tick t
        y = buf
        if 0 <= mb_here < M:
            y = stage_fn(params_me, xs[mb_here] if stage == 0 else buf)
            if stage == S - 1:
                outs[mb_here] = y
        buf = shift(y, axes)
    # only the last stage's outputs are valid; share them by a masked psum
    return psum(outs if stage == S - 1 else torch.zeros_like(outs), axes)
