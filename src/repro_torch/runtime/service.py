"""Result extraction of the serving core (the part of
``repro.runtime.service`` the closed-loop path needs).

The JAX package's ``ServingLoop`` (the open-loop, overlapped serving
loop with tenant telemetry) is not ported yet (ROADMAP queue 1); the
synchronous façade's ``flush`` and the closed-loop driver share
``unpack_levels`` with it.
"""
from __future__ import annotations

import numpy as np


def unpack_levels(
    levels: np.ndarray,
    spans: dict[str, tuple[int, int]],
    n_nodes: int,
    packed: bool,
) -> dict[str, np.ndarray]:
    """Per-query result rows out of one batch's levels.

    Packed (nTkMS) batches carry levels as [morsels, n_pad, lanes] uint8
    with 255 = unreached: lane-major flatten to one row per source, map the
    sentinel to -1, slice each query's span. Solo batches carry [rows,
    n_pad] with one row per source already. Both slice off the graph's
    padding columns."""
    n = n_nodes
    levels = np.asarray(levels)
    if packed:
        per_src = (
            levels[:, :n, :].transpose(0, 2, 1).reshape(-1, n)
        ).astype(np.int32)
        per_src[per_src == 255] = -1
        return {qid: per_src[a:b] for qid, (a, b) in spans.items()}
    return {
        qid: levels[a:b, :n].astype(np.int32)
        for qid, (a, b) in spans.items()
    }
