"""The IFE operator (port of ``repro.core.ife``): iterative frontier
extension to convergence, and the output helpers.

``lax.while_loop`` becomes a host loop on ``any(frontier) and it < cap``:
one device-to-host sync per iteration (the place for CUDA graphs later).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .edge_compute import EDGE_COMPUTES, NO_PARENT
from .frontier import dense_from_sources
from .extend import ExtendCtx, as_operands, as_spec, check_operands, make_backend


class IFEResult(NamedTuple):
    state: Any  # final edge-compute state (NamedTuple of tensors)
    iterations: torch.Tensor  # int32, frontier extensions performed


def run_ife(
    graph,
    sources: torch.Tensor,
    edge_compute: str = "sp_lengths",
    max_iters: int | None = None,
    extend="ell_push",
) -> IFEResult:
    """Run one IFE subroutine (one source morsel) to convergence on the
    device of ``graph``'s operands. For dense edge computes all
    ``sources`` seed one frontier; for msbfs_* computes sources[l] seeds
    lane l. Out-of-range ids are inert."""
    ec = EDGE_COMPUTES[edge_compute]
    spec = as_spec(extend)
    ops = as_operands(graph)
    check_operands(spec, ops)
    be = make_backend(spec)
    n = ops.n_nodes
    ctx = ExtendCtx(n_out=n)
    cap = n if max_iters is None else int(max_iters)
    src = torch.as_tensor(sources, dtype=torch.int32).reshape(-1)
    state = ec.init(n, src.to(ops.device))
    it = 0
    while it < cap and bool((state.frontier != 0).any()):
        state = ec.apply(state, ec.extend(be, ops, state, ctx), it)
        it += 1
    return IFEResult(state=state, iterations=torch.tensor(it,
                                                          dtype=torch.int32))


def run_ife_batch(
    graph,
    source_batch: torch.Tensor,
    edge_compute: str = "sp_lengths",
    max_iters: int | None = None,
    extend="ell_push",
) -> IFEResult:
    """Independent single-source IFE runs, one per entry of
    ``source_batch`` ([m]); leaves stack over the batch."""
    runs = [
        run_ife(graph, s.reshape(1), edge_compute, max_iters, extend)
        for s in torch.as_tensor(source_batch).reshape(-1)
    ]
    state = type(runs[0].state)(
        *(torch.stack(leaves) for leaves in zip(*(r.state for r in runs)))
    )
    return IFEResult(state=state,
                     iterations=torch.stack([r.iterations for r in runs]))


def run_ife_scan(
    graph,
    source_batch: torch.Tensor,
    edge_compute: str = "sp_lengths",
    max_iters: int | None = None,
    extend="ell_push",
) -> IFEResult:
    """One morsel at a time (JAX's ``lax.map`` form of ``run_ife_batch``,
    the true 1T1S semantics). The port's ``run_ife_batch`` already runs
    its morsels one after another, so the two give the same states."""
    return run_ife_batch(graph, source_batch, edge_compute, max_iters, extend)


# ---------------------------------------------------------------------------
# OUTPUT phase (paper §4.1): consume IFE results.
# ---------------------------------------------------------------------------


def histogram_lengths(levels: torch.Tensor, max_len: int = 64) -> torch.Tensor:
    """Histogram of path lengths (ignores -1 / 255 and >= max_len)."""
    lv = levels.to(torch.int64).reshape(-1)
    valid = (lv >= 0) & (lv < max_len)
    return torch.bincount(lv[valid], minlength=max_len)[:max_len].to(
        torch.int32
    )


def reconstruct_paths(
    parents: torch.Tensor, dests: torch.Tensor, max_len: int
) -> torch.Tensor:
    """Walk parent pointers from each destination: [d, max_len] int32
    node ids padded with -1, ordered dest -> source."""
    n = parents.shape[0]
    cur = torch.as_tensor(dests, dtype=torch.int32,
                          device=parents.device).reshape(-1)
    ext = torch.cat([parents.to(torch.int32),
                     torch.full((1,), NO_PARENT, dtype=torch.int32,
                                device=parents.device)])
    cols = []
    for _ in range(max_len):
        cols.append(cur)
        ok = (cur >= 0) & (cur < n)
        nxt = ext[torch.where(ok, cur, n).long()]
        cur = torch.where(nxt == NO_PARENT, -1, nxt).to(torch.int32)
    return torch.stack(cols, dim=1)


def validate_parents(
    levels: torch.Tensor, parents: torch.Tensor, sources: torch.Tensor
) -> torch.Tensor:
    """Every reached non-source v has a parent one level up. Returns a
    bool scalar tensor."""
    n = levels.shape[0]
    src = torch.as_tensor(sources, device=levels.device).reshape(-1)
    is_src = dense_from_sources(n, src)
    reached = (levels > 0) & ~is_src
    p = parents.clamp(0, n - 1).long()
    ok = torch.where(reached, levels[p] == levels - 1, True)
    has_parent = torch.where(reached, parents != NO_PARENT, True)
    return (ok & has_parent).all()
