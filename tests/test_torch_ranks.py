"""Rank programs of the port's multi-rank tests (no test here).

Each function here runs inside one spawned rank
(``repro_torch.launch.mesh.run_ranks``): it builds the rank's mesh, runs
the port on it and returns numpy results for the parent test to hold
against numpy folds or the JAX package. This module imports only the
port (a rank never loads JAX), and its input builders are plain numpy,
so the parent rebuilds exactly the inputs each rank saw.
"""
from __future__ import annotations

import numpy as np
import torch

MESH = ((2, 2), ("data", "model"))


# ---------------------------------------------------------------------------
# Collectives on a (2, 2) mesh.
# ---------------------------------------------------------------------------

N_ROWS = 64  # rows of the reduce-scatter inputs (32 x 2 shards of 'model')
GANG = 4


def collective_inputs(rank: int) -> dict:
    """The numpy inputs rank ``rank`` feeds every collective."""
    rng = np.random.default_rng(100 + rank)
    return {
        "bits": rng.random(1000) < 0.2,
        "words": rng.integers(-2**31, 2**31, size=37, dtype=np.int64)
        .astype(np.int32),
        "rs_int": rng.integers(0, 1000, size=(N_ROWS * 2,), dtype=np.int32),
        "rs_bits": rng.random((N_ROWS * 2, 3)) < 0.1,
        "rs_f32": rng.standard_normal(N_ROWS * 2).astype(np.float32),
        "rows_bits": rng.random((N_ROWS * 2, 5)) < 0.1,
        "rows_min": rng.integers(0, 10**6, size=(N_ROWS * 2, 5),
                                 dtype=np.int32),
        "rows_f32": rng.standard_normal((N_ROWS * 2,)).astype(np.float32),
        "gang_bits": rng.random((GANG, N_ROWS * 2)) < 0.1,
        "gang_min": rng.integers(0, 10**6, size=(GANG, N_ROWS * 2),
                                 dtype=np.int32),
        "gang_f32": rng.standard_normal((GANG, N_ROWS * 2)).astype(
            np.float32),
        "sum_f32": rng.standard_normal(300).astype(np.float32),
        "min_f32": rng.standard_normal(300).astype(np.float32),
        "flag": bool(rank == 2),
    }


def handoff_state():
    """A stacked global phase-1 state every rank holds (leaves [m, n])."""
    rng = np.random.default_rng(7)
    m, n = 6, N_ROWS * 2
    return (rng.random((m, n)) < 0.3,
            rng.integers(-1, 9, size=(m, n)).astype(np.int32))


HANDOFF_IDX = np.array([4, 1, 3])


def collectives_rank(rank: int, world: int) -> dict:
    from collections import namedtuple

    from repro_torch.core import collectives as C
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(*MESH, "cpu")
    both = mesh.axes(("data", "model"))
    model = mesh.axes("model")
    x = {k: (torch.from_numpy(np.asarray(v)) if k != "flag" else v)
         for k, v in collective_inputs(rank).items()}
    out = {}
    t = lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    for impl in ("pmax", "allgather", "ring"):
        out[f"or_allreduce_both_{impl}"] = t(C.or_allreduce(x["bits"], both,
                                                            impl))
        out[f"or_allreduce_model_{impl}"] = t(
            C.or_allreduce(x["bits"], model, impl))
    out["ring_or_u32_model"] = t(C.ring_or_u32(x["words"], model))
    ops = {"or": torch.bitwise_or, "min": torch.minimum, "sum": torch.add}
    for flavor, rs in (("ring", C.ring_reduce_scatter),
                       ("allgather", C.allgather_reduce_scatter)):
        for name, op in ops.items():
            src = x["rs_f32"] if name == "sum" else x["rs_int"]
            out[f"rs_{flavor}_{name}"] = t(rs(src, model, op))
    for impl in ("ring", "allgather"):
        out[f"or_rs_{impl}"] = t(C.or_reduce_scatter(x["rows_bits"], both,
                                                     impl))
        out[f"min_rs_{impl}"] = t(C.min_reduce_scatter(x["rows_min"], both,
                                                       impl))
        out[f"sum_rs_{impl}"] = t(C.sum_reduce_scatter(x["rows_f32"], both,
                                                       impl))
        r, p = C.merge_scatter("or_min", (x["rows_bits"], x["rows_min"]),
                               both, "ring", impl=impl)
        out[f"merge_scatter_{impl}_or"] = t(r)
        out[f"merge_scatter_{impl}_min"] = t(p)
    out["gang_merge_or"] = t(C.gang_merge_scatter("or", x["gang_bits"], both,
                                                  "ring"))
    out["gang_merge_min"] = t(C.gang_merge_scatter("min", x["gang_min"], both,
                                                   "allgather"))
    out["gang_merge_sum"] = t(C.gang_merge_scatter("sum", x["gang_f32"], both,
                                                   "ring"))
    St = namedtuple("St", "frontier levels")
    full = St(*(torch.from_numpy(a) for a in handoff_state()))
    sub = C.gang_handoff(full, HANDOFF_IDX, GANG, both)
    out["handoff_frontier"], out["handoff_levels"] = t(sub[0]), t(sub[1])
    # the inverse: every rank writes the gathered survivors back
    whole = St(*(C.gather_rows(s, both, 1) for s in sub))
    back = C.gang_scatter_back(full, St(*(w.clone() for w in whole)),
                               HANDOFF_IDX)
    out["scatter_back_levels"] = t(back[1])
    out["merge_sum"] = t(C.merge_contribution("sum", x["sum_f32"], both))
    out["merge_min"] = t(C.merge_contribution("min", x["min_f32"], both))
    out["any_over"] = np.asarray(C.any_over(x["flag"], both))
    out["any_over_model"] = np.asarray(C.any_over(x["flag"], model))
    out["gather_rows"] = t(C.gather_rows(
        torch.full((2, 3), rank, dtype=torch.int32), both, 0))
    out["wire_calls"] = np.asarray(mesh.wire.calls)
    return out


# ---------------------------------------------------------------------------
# Engines, dispatcher and serving on a mesh.
# ---------------------------------------------------------------------------


def skew_graph(csr_from_edges, powerlaw):
    """The gang case of the JAX package's multi-device test: a powerlaw
    component plus three long paths whose heads straggle."""
    pl = powerlaw(200, 5.0, seed=2)
    src_pl, dst_pl = pl.edge_list()
    srcs, dsts, base, heads = [src_pl], [dst_pl], 200, []
    for n in (40, 28, 22):
        p = np.arange(n - 1, dtype=np.int64) + base
        srcs += [p, p + 1]
        dsts += [p + 1, p]
        heads.append(base)
        base += n
    csr = csr_from_edges(base, np.concatenate(srcs), np.concatenate(dsts))
    return csr, np.array(heads + [3, 9, 17], dtype=np.int32)


def weighted_graph(csr_from_edges):
    """The divergent ``sync="shard"`` case's weighted graph."""
    rng = np.random.default_rng(3)
    n, m = 300, 1800
    w = rng.uniform(0.1, 2.0, m).astype(np.float32)
    return csr_from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m),
                          weights=w)


SOURCES = np.array([0, 3, 17, 44, 123, 200, 250, 280, 5, 9], np.int32)
SOURCES_70 = (np.arange(70, dtype=np.int32) * 4 % 300).astype(np.int32)
BACKENDS = ("ell_push", "ell_pull", "pull_binned", "pull_binned_fused",
            "dopt", "dopt_fused", "block_mxu")
#: the JAX backend each port backend is held against (JAX's fused Pallas
#: body does not trace on current jax; the fused kernel is bit-identical
#: to the binned pull by contract)
JAX_TWIN = {"pull_binned_fused": "pull_binned", "dopt_fused": "dopt"}
# (name, policy, or_impl, edge compute, layout, backend, sources)
QUERY_CASES = (
    [("1t1s", "1t1s", None, "sp_lengths", "replicated", "ell_push", "s10"),
     ("nt1s_ring", "nt1s", "ring", "sp_lengths", "replicated", "ell_push",
      "s10"),
     ("ntkms_ring", "ntkms", "ring", "msbfs_lengths", "replicated",
      "ell_push", "s70"),
     ("ntkms_sharded_block", "ntkms", "allgather", "msbfs_lengths",
      "sharded", "block_mxu", "s70"),
     ("ntkms_parents_binned", "ntkms", "ring", "msbfs_parents", "sharded",
      "pull_binned_fused", "s70"),
     ("ntks_parents_dopt", "ntks", "ring", "sp_parents", "sharded", "dopt",
      "s10"),
     ("bellman_replicated", "ntks", "allgather", "bellman_ford",
      "replicated", "ell_push", "w4"),
     ("bellman_sharded", "ntks", "allgather", "bellman_ford", "sharded",
      "dopt_fused", "w4")]
    + [(f"ntks_{impl}", "ntks", impl, "sp_lengths", "replicated", "ell_push",
        "s10") for impl in ("allgather", "ring", "pmax")]
    + [(f"be_{lay}_{be}", "ntks", "allgather", "sp_lengths", lay, be, "s10")
       for lay in ("replicated", "sharded") for be in BACKENDS]
)


def query_case_inputs(powerlaw, csr_from_edges):
    csr = powerlaw(300, 5.0, seed=1)
    wcsr = weighted_graph(csr_from_edges)
    return {"s10": (csr, SOURCES), "s70": (csr, SOURCES_70),
            "w4": (wcsr, np.array([0, 3, 17, 44], np.int32))}


def _leaves(state) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in state._fields}


def engines_rank(rank: int, world: int) -> dict:
    """Every policy/backend/layout case, the gang phase 2 and the
    divergent ``sync="shard"`` case on a (2, 2) mesh."""
    from repro_torch.core import POLICIES, run_recursive_query
    from repro_torch.graph.csr import csr_from_edges
    from repro_torch.graph.generators import powerlaw
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.dispatch import QueryDispatcher
    from repro_torch.runtime.scheduler import AdaptiveScheduler

    mesh = make_mesh(*MESH, "cpu")
    inputs = query_case_inputs(powerlaw, csr_from_edges)
    out = {}
    for name, pol, impl, ec, lay, be, src in QUERY_CASES:
        csr, sources = inputs[src]
        policy = POLICIES[pol]() if impl is None else POLICIES[pol](
            or_impl=impl)
        res = run_recursive_query(mesh, csr, sources, policy, ec,
                                  state_layout=lay, extend=be)
        for k, v in _leaves(res.state).items():
            out[f"{name}/{k}"] = v
        out[f"{name}/iterations"] = res.iterations.numpy()
    skew, gsrcs = skew_graph(csr_from_edges, powerlaw)
    for lay in ("replicated", "sharded"):
        sched = AdaptiveScheduler(mesh, skew, max_iters=64, phase1_iters=2)
        o = sched.query(gsrcs, state_layout=lay)
        out[f"gang_{lay}/levels"] = o.result.state.levels.cpu().numpy()
        out[f"gang_{lay}/iterations"] = o.result.iterations.numpy()
        out[f"gang_{lay}/counts"] = np.array(
            [o.hybrid, o.resumed_ganged, o.gang_width, o.resumed_serial])
    wcsr = weighted_graph(csr_from_edges)
    srcs = np.array([0, 3, 17, 44], dtype=np.int32)
    for kind, leaf, budget in (("topk_paths", "dists", 14),
                               ("ppr", "mass", 48)):
        dq = QueryDispatcher(mesh, wcsr, max_iters=512, phase1_iters=budget)
        for lay in ("replicated", "sharded"):
            o = dq.query(srcs, query_kind=kind, state_layout=lay)
            out[f"{kind}_{lay}/{leaf}"] = getattr(
                o.result.state, leaf).cpu().numpy()
            out[f"{kind}_{lay}/iterations"] = o.result.iterations.numpy()
            out[f"{kind}_{lay}/counts"] = np.array(
                [o.hybrid, o.redispatched])
    out["wire/staged_bytes"] = np.asarray(mesh.wire.staged_bytes)
    return out


SERVE_ARGV = ["--closed-loop", "--device", "cpu", "--dataset", "ldbc",
              "--scale", "0.1", "--batches", "3"]


def serve_rank(rank: int, world: int, argv: list) -> list:
    """``serve.main`` on this rank; rank 0 returns its served batches."""
    from repro_torch.launch import serve

    got = []
    rc = serve.main(argv, on_batch=lambda b: got.append({
        "sources": b.sources, "policy": b.policy,
        "levels": b.result.state.levels.cpu().numpy(),
        "iterations": b.result.iterations.numpy(),
    }))
    assert rc == 0
    return got


def plans_rank(rank: int, world: int) -> list:
    """A measured-cost dispatcher whose probe rates differ on every rank:
    the plans each rank logs must be the same (rank 0's rates rule)."""
    from repro_torch.graph.generators import powerlaw
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.scheduler import AdaptiveScheduler

    mesh = make_mesh(*MESH, "cpu")
    csr = powerlaw(400, 6.0, seed=4)
    sched = AdaptiveScheduler(mesh, csr, max_iters=32, cost="measured",
                              refit_every=1, family="powerlaw")

    def skewed_rates(ops, n_pad):
        # push far cheaper than pull on even ranks, far dearer on odd
        # ones: fitted on its own rates, each rank would pick other
        # thresholds
        cheap, dear = 1e-3, 1e3
        push, pull = (cheap, dear) if rank % 2 == 0 else (dear, cheap)
        ms = {"ell_push": push, "pull_binned": pull,
              "pull_binned_fused": pull}
        return {k: {"ms_per_slot": v * 1e-6, "bytes_per_slot": 5.0,
                    "probe_ms": v, "slots": 1} for k, v in ms.items()}

    sched.cost_probe.rates = skewed_rates
    log = []
    rng = np.random.default_rng(0)
    for b in range(6):
        sources = rng.choice(csr.n_nodes, size=int(rng.integers(2, 9)),
                             replace=False).astype(np.int32)
        infl = sched.begin_batch(sources)
        p = infl.payload
        plan = [infl.kind, infl.name]
        if isinstance(p, dict) and "budget" in p:
            plan += [p["budget"], repr(p["extend"])]
        out = sched.settle_batch(infl).finalize()
        plan += [int(out.redispatched)]
        thr = sched.direction_thresholds
        plan.append(None if thr is None else repr(thr))
        log.append(plan)
    return log


CARD_CASES = (("ntks", "sp_lengths", "dopt_fused", "sharded"),
              ("ntks", "sp_parents", "pull_binned_fused", "replicated"),
              ("ntkms", "msbfs_lengths", "block_mxu", "sharded"))


def card_rank(rank: int, world: int) -> dict:
    """Ranks sharing cuda:0 over gloo: the shard-local kernels on the
    main path, and what the wire staged through host memory."""
    from repro_torch.core import POLICIES, run_recursive_query
    from repro_torch.graph.generators import powerlaw
    from repro_torch.kernels.binned_pull.binned_pull import fused_binned_pull
    from repro_torch.kernels.msbfs_extend.msbfs_extend import (
        msbfs_extend_blocks,
    )
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, world), ("data", "model"), "cuda:0")
    csr = powerlaw(2000, 6.0, seed=5)
    out = {}
    for pol, ec, be, lay in CARD_CASES:
        srcs = SOURCES_70 if pol == "ntkms" else SOURCES
        res = run_recursive_query(mesh, csr, srcs, POLICIES[pol](), ec,
                                  state_layout=lay, extend=be)
        for k, v in _leaves(res.state).items():
            out[f"{be}/{k}"] = v
    out["launches"] = np.array([fused_binned_pull.launches,
                                msbfs_extend_blocks.launches])
    out["staged"] = np.asarray(mesh.wire.staged_bytes)
    return out


LINE_MESH = ((1, 4), ("data", "model"))


def line_rank(rank: int, world: int) -> dict:
    """``serve``'s mesh shape, ``(1, 4)``: a size-1 source axis
    inside every collective over both axes (nT1S, the phase-2 gang)."""
    from repro_torch.core import policy_nt1s, run_recursive_query
    from repro_torch.graph.csr import csr_from_edges
    from repro_torch.graph.generators import powerlaw
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.scheduler import AdaptiveScheduler

    mesh = make_mesh(*LINE_MESH, "cpu")
    out = {}
    csr = powerlaw(300, 5.0, seed=1)
    for lay in ("replicated", "sharded"):
        res = run_recursive_query(mesh, csr, SOURCES, policy_nt1s(
            or_impl="ring"), "sp_parents", state_layout=lay, extend="dopt")
        for k, v in _leaves(res.state).items():
            out[f"line_nt1s_{lay}/{k}"] = v
        out[f"line_nt1s_{lay}/iterations"] = res.iterations.numpy()
    skew, gsrcs = skew_graph(csr_from_edges, powerlaw)
    for lay in ("replicated", "sharded"):
        o = AdaptiveScheduler(mesh, skew, max_iters=64,
                              phase1_iters=2).query(gsrcs, state_layout=lay)
        out[f"line_gang_{lay}/levels"] = o.result.state.levels.numpy()
        out[f"line_gang_{lay}/iterations"] = o.result.iterations.numpy()
        out[f"line_gang_{lay}/counts"] = np.array(
            [o.hybrid, o.resumed_ganged, o.gang_width, o.resumed_serial])
    return out


# ---------------------------------------------------------------------------
# Graph deltas on a mesh.
# ---------------------------------------------------------------------------

MESHES = {"2x2": MESH, "1x4": LINE_MESH}
DELTA_N = 600
DELTA_TILE = 128
#: (backend, layout) of every reach case after each delta, under nTkS
#: (phase 1 on the 'model' split, the gang phase 2 over both axes)
DELTA_CASES = [(be, lay) for be in ("pull_binned", "dopt", "block_mxu",
                                    "ell_pull")
               for lay in ("replicated", "sharded")] + [
    ("pull_binned_fused", "replicated"), ("dopt_fused", "sharded")]
DELTA_SOURCES = np.array([0, 3, 17, 44, 90, 123, 200, 250, 333, 470, 512,
                          599], np.int32)
WEIGHTED_KINDS = (("topk_paths", "dists"), ("ppr", "mass"))


def local_graph(csr_from_edges, weighted: bool = False):
    """600 nodes, out-degrees 2 + geometric (capped at 40), each target
    within 100 rows of its source: the tiles sit near the diagonal, so
    tile lists have free slots and a far edge opens a new tile."""
    rng = np.random.default_rng(11)
    n = DELTA_N
    deg = np.minimum(1 + rng.geometric(0.3, n), 40)
    src = np.repeat(np.arange(n), deg)
    dst = np.clip(src + rng.integers(-100, 101, len(src)), 0, n - 1)
    w = rng.uniform(0.1, 2.0, len(src)).astype(np.float32) if weighted \
        else None
    return csr_from_edges(n, src, dst, weights=w)


def _edge_set(csr) -> set:
    s, t = csr.edge_list()
    return set(zip(s.tolist(), t.tolist()))


def _same_shape_delta(csr, GraphDelta, n_swaps: int, rng):
    """Double edge swaps (u->v, x->y) => (u->y, x->v) with v and y in one
    column block: every degree and every tile's presence stays, only
    content changes."""
    edges = _edge_set(csr)
    s, t = csr.edge_list()
    used, dels, adds = set(), [], []
    while len(dels) < 2 * n_swaps:
        i, j = rng.integers(0, len(s), 2)
        (u, v), (x, y) = (int(s[i]), int(t[i])), (int(s[j]), int(t[j]))
        new = [(u, y), (x, v)]
        if (v // DELTA_TILE != y // DELTA_TILE or u == x or v == y
                or any(e in edges or e in used for e in new)
                or (u, v) in used or (x, y) in used):
            continue
        used.update([(u, v), (x, y), *new])
        dels += [(u, v), (x, y)]
        adds += new
    (ds, dd), (as_, ad) = zip(*dels), zip(*adds)
    return GraphDelta(add_src=as_, add_dst=ad, del_src=ds, del_dst=dd)


def _rebin_delta(csr, GraphDelta):
    """Moves in-edges from a row of higher in-degree to one of lower
    in-degree, both in the first 96 rows (shard 0 of every split, one
    column block), from the same sources: the two rows trade degree
    buckets and every out-degree stays."""
    indeg = np.bincount(csr.indices, minlength=csr.n_nodes)[:96]
    rev = csr.reverse()
    ins = lambda v: set(rev.indices[rev.indptr[v]:rev.indptr[v + 1]]
                        .tolist())
    order = np.argsort(indeg, kind="stable")
    for t in order:
        for t2 in order[::-1]:
            a, b = int(indeg[t]), int(indeg[t2])
            if a < 1 or b - a < 2:
                continue
            movers = sorted(ins(t2) - ins(t))[: b - a]
            if len(movers) == b - a:
                return GraphDelta(add_src=movers, add_dst=[t] * len(movers),
                                  del_src=movers,
                                  del_dst=[t2] * len(movers))
    raise AssertionError("no pair of rows to rebin")


def _overflow_delta(csr, GraphDelta):
    """New out-edges for the node of highest out-degree, one past its
    forward ELL width."""
    u = int(np.argmax(csr.degrees))
    width = -(-int(csr.degrees[u]) // 8) * 8
    have = set(csr.neighbors(u).tolist())
    near = sorted(range(csr.n_nodes), key=lambda v: (abs(v - u), v))
    new = [v for v in near if v not in have][: width - int(csr.degrees[u])
                                             + 1]
    return GraphDelta(add_src=[u] * len(new), add_dst=new)


def _tiles_full_delta(csr, GraphDelta):
    """One far edge into every empty tile of every row block that holds
    edges, each from another low-degree source of the block: every
    shard's tile list has to grow."""
    n, B = csr.n_nodes, DELTA_TILE
    s, t = csr.edge_list()
    have = set(zip((s // B).tolist(), (t // B).tolist()))
    degs = csr.degrees
    adds = []
    for rb in range(-(-n // B)):
        rows = [r for r in range(rb * B, min((rb + 1) * B, n))
                if degs[r] < 8]
        empty = [cb for cb in range(-(-n // B)) if (rb, cb) not in have]
        for r, cb in zip(rows, empty):
            adds.append((r, min(cb * B + (r % B), n - 1)))
    a_s, a_d = zip(*adds)
    return GraphDelta(add_src=a_s, add_dst=a_d)


def delta_script(csr, GraphDelta, apply_delta_csr) -> list:
    """The seeded edit script, ``[(name, delta)]``, each delta built on
    the graph the ones before it left (either package's classes give the
    same arrays)."""
    rng = np.random.default_rng(21)
    out = []
    for name, make in (
            ("same_shape", lambda g: _same_shape_delta(g, GraphDelta, 8,
                                                       rng)),
            ("rebin", lambda g: _rebin_delta(g, GraphDelta)),
            ("ell_overflow", lambda g: _overflow_delta(g, GraphDelta)),
            ("tiles_full", lambda g: _tiles_full_delta(g, GraphDelta))):
        d = make(csr)
        out.append((name, d))
        csr = apply_delta_csr(csr, d)
    return out


def weighted_script(wcsr, GraphDelta, apply_delta_csr, random_delta) -> list:
    """A seeded weighted delta, then the same edges at new weights."""
    d = random_delta(wcsr, 16, 16, seed=3)
    g = apply_delta_csr(wcsr, d)
    s, t = g.edge_list()
    pick = np.unique(np.random.default_rng(4).integers(0, g.n_edges, 8))
    w = np.random.default_rng(5).uniform(0.1, 2.0, len(pick))
    return [("weighted", d),
            ("reweighted", GraphDelta(add_src=s[pick], add_dst=t[pick],
                                      del_src=s[pick], del_dst=t[pick],
                                      add_weights=w.astype(np.float32)))]


def bundle_name(key, shape: dict) -> str:
    """A bundle key's name, its split axes filtered to those of size
    above 1 (the port keys bundles so; the JAX package keeps every
    axis)."""
    split = [a for a in key[0] if shape.get(a, 1) > 1]
    flags = [f for f, on in zip(("rev", "binned", "pack", "blocks"),
                                key[1:5]) if on]
    return "+".join(split or ["whole"]) + ":" + "+".join(["fwd"] + flags) \
        + f":{key[5]}"


def operand_leaves(ops) -> dict:
    """Copies of the numpy leaves of a port ``GraphOperands`` under
    ``operands_from_numpy``'s names (a fold writes a mirror in place)."""
    out = {}
    for p, g in (("fwd", ops.fwd), ("rev", ops.rev)):
        if g is not None:
            out[f"{p}.indices"] = g.indices.cpu().numpy().copy()
            out[f"{p}.degrees"] = g.degrees.cpu().numpy().copy()
            if g.weights is not None:
                out[f"{p}.weights"] = g.weights.cpu().numpy().copy()
    for p, x, rows in (("bn", ops.rev_binned, ("perm", "inv")),
                       ("pack", ops.rev_binned_pack,
                        ("inv_pad", "perm_pad"))):
        if x is None:
            continue
        for f in rows:
            out[f"{p}.{f}"] = getattr(x, f).cpu().numpy().copy()
        for b, sl in enumerate(x.slabs):
            out[f"{p}.slab{b}"] = sl.cpu().numpy().copy()
        for b, w in enumerate(x.slab_weights or ()):
            out[f"{p}.w{b}"] = w.cpu().numpy().copy()
    if ops.blocks is not None:
        out["blocks.blocks"] = ops.blocks.blocks.cpu().numpy().copy()
        out["blocks.rows"] = ops.blocks.block_rows.cpu().numpy().copy()
        out["blocks.cols"] = ops.blocks.block_cols.cpu().numpy().copy()
    return out


STRUCTURES = ("fwd", "rev", "rev_binned", "rev_binned_pack", "blocks")


def fold_row(rep) -> np.ndarray:
    """A ``FoldReport`` (either package's) as ``[changed x 5, reshaped x
    5, moves]``."""
    return np.array([rep.changed[s] for s in STRUCTURES]
                    + [rep.reshaped[s] for s in STRUCTURES]
                    + [rep.binned_moves], np.int64)


def _record_step(out, dq, prefix, rep, shape):
    """One delta's per-bundle reports, host mirrors and epochs."""
    for key, frep in rep.folds:
        out[f"{prefix}/fold/{bundle_name(key, shape)}"] = fold_row(frep)
    for key, bundle in dq._graphs.items():
        name = bundle_name(key, shape)
        for leaf, a in operand_leaves(bundle.host).items():
            out[f"{prefix}/host/{name}/{leaf}"] = a
        # the placed tensors are the mirror's
        for leaf, a in operand_leaves(bundle.ops).items():
            assert np.array_equal(a, out[f"{prefix}/host/{name}/{leaf}"]), (
                prefix, name, leaf)
        out[f"{prefix}/epochs/{name}"] = np.array(
            [bundle.epochs.get(s, 0) for s in STRUCTURES])
    out[f"{prefix}/report"] = np.array(
        [rep.version, rep.changed_edges, rep.dirty_fwd_rows,
         rep.dirty_rev_rows, rep.structures_changed,
         rep.structures_rebuilt, rep.binned_moves,
         rep.engines_invalidated, len(dq.cache)])


def delta_rank(rank: int, world: int, mesh_name: str) -> dict:
    """The edit script on one mesh: after each delta every bundle's
    mirror, every bundle's report, and every reach case's levels and
    iterations; then the weighted script with the non-reach kinds."""
    from repro_torch.graph.csr import csr_from_edges
    from repro_torch.graph.delta import (
        GraphDelta,
        apply_delta_csr,
        random_delta,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.dispatch import QueryDispatcher

    mesh = make_mesh(*MESHES[mesh_name], "cpu")
    shape = mesh.shape
    csr = local_graph(csr_from_edges)
    dq = QueryDispatcher(mesh, csr, max_iters=64, phase1_iters=2)
    script = delta_script(csr, GraphDelta, apply_delta_csr)
    out = {}
    for step in range(len(script) + 1):
        if step:
            rep = dq.apply_delta(script[step - 1][1])
            _record_step(out, dq, f"{step}", rep, shape)
        for be, lay in DELTA_CASES:
            o = dq.query(DELTA_SOURCES, policy="ntks", backend=be,
                         state_layout=lay)
            out[f"{step}/{be}/{lay}/levels"] = o.result.state.levels.numpy()
            out[f"{step}/{be}/{lay}/iterations"] = o.result.iterations.numpy()
        o = dq.query(DELTA_SOURCES, policy="1t1s", backend="pull_binned")
        out[f"{step}/1t1s/levels"] = o.result.state.levels.numpy()
        out[f"{step}/1t1s/iterations"] = o.result.iterations.numpy()
    wcsr = local_graph(csr_from_edges, weighted=True)
    wq = QueryDispatcher(mesh, wcsr, max_iters=512, phase1_iters=14)
    wscript = weighted_script(wcsr, GraphDelta, apply_delta_csr,
                              random_delta)
    srcs = DELTA_SOURCES[:4]
    for step in range(len(wscript) + 1):
        if step:
            rep = wq.apply_delta(wscript[step - 1][1])
            _record_step(out, wq, f"w{step}", rep, shape)
        for kind, leaf in WEIGHTED_KINDS:
            for lay in ("replicated", "sharded"):
                o = wq.query(srcs, query_kind=kind, state_layout=lay)
                out[f"w{step}/{kind}/{lay}/{leaf}"] = getattr(
                    o.result.state, leaf).numpy()
                out[f"w{step}/{kind}/{lay}/iterations"] = (
                    o.result.iterations.numpy())
        o = wq.query(srcs, policy="ntks", backend="pull_binned_fused",
                     state_layout="sharded")
        out[f"w{step}/reach/levels"] = o.result.state.levels.numpy()
    out["wire/calls"] = np.asarray(mesh.wire.calls)
    return out


STREAM_ARGV = ["--device", "cpu", "--dataset", "ldbc", "--scale", "0.1",
               "--arrivals", "10", "--rate", "200", "--mutate-stream", "2"]


def stream_rank(rank: int, world: int, argv: list) -> dict:
    """Open-loop ``serve.main`` with deltas on this rank: every rank's
    finalized batches by control-channel number; rank 0 also each query's
    levels, the schedule and the delta reports."""
    from repro_torch.launch import serve

    batches, streams = {}, []

    def on_outcome(seq, outcome):
        batches[seq] = (outcome.result.state.levels.cpu().numpy(),
                        outcome.result.iterations.numpy())

    assert serve.main(argv, on_stream=streams.append,
                      on_outcome=on_outcome) == 0
    out = {"batches": batches}
    if streams:
        loop = streams[0].loop
        out["results"] = dict(loop.results)
        out["arrivals"] = streams[0].arrivals
        out["reports"] = [(r.version, r.structures_changed,
                           r.structures_rebuilt, r.binned_moves,
                           r.engines_invalidated, r.ms_max >= r.ms)
                          for r in loop.delta_reports]
        out["avg_degree"] = loop.admission.avg_degree
    return out


CARD_DELTA_CASES = (("dopt_fused", "sharded"),
                    ("pull_binned_fused", "replicated"),
                    ("block_mxu", "sharded"))


def card_delta_queries(dq, out: dict, prefix: str, lanes_srcs) -> None:
    """The card delta cases through ``dq``, levels into ``out``."""
    for be, lay in CARD_DELTA_CASES:
        pol, srcs = (("ntkms", lanes_srcs) if be == "block_mxu"
                     else ("ntks", DELTA_SOURCES))
        o = dq.query(srcs, policy=pol, backend=be, state_layout=lay)
        out[f"{prefix}/{be}/levels"] = o.result.state.levels.cpu().numpy()
        out[f"{prefix}/{be}/iterations"] = o.result.iterations.numpy()


def card_delta_rank(rank: int, world: int) -> dict:
    """Ranks sharing cuda:0 over gloo fold the edit script's deltas (the
    forward ELL overflow and the full tile lists rebuild) into their
    shards on the card; levels after each delta and the kernels' launches
    on the folded operands."""
    from repro_torch.graph.csr import csr_from_edges
    from repro_torch.graph.delta import GraphDelta, apply_delta_csr
    from repro_torch.kernels.binned_pull.binned_pull import fused_binned_pull
    from repro_torch.kernels.msbfs_extend.msbfs_extend import (
        msbfs_extend_blocks,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.dispatch import QueryDispatcher

    mesh = make_mesh(*MESH, "cuda:0")
    csr = local_graph(csr_from_edges)
    dq = QueryDispatcher(mesh, csr, max_iters=64, phase1_iters=2)
    out = {}
    card_delta_queries(dq, out, "0", SOURCES_70)
    for step, (_, d) in enumerate(
            delta_script(csr, GraphDelta, apply_delta_csr), 1):
        rep = dq.apply_delta(d)
        out[f"{step}/rebuilt"] = np.asarray(rep.structures_rebuilt)
        fused_binned_pull.launches = msbfs_extend_blocks.launches = 0
        card_delta_queries(dq, out, f"{step}", SOURCES_70)
        out[f"{step}/launches"] = np.array([fused_binned_pull.launches,
                                            msbfs_extend_blocks.launches])
    out["staged"] = np.asarray(mesh.wire.staged_bytes)
    return out


# ---------------------------------------------------------------------------
# Pipeline stages and compressed gradient sums (parallel/, optim/).
# ---------------------------------------------------------------------------

PIPE_STAGES = 4
# case -> (seed, microbatches, one microbatch's shape, width); "pipe" is
# tests/test_substrate.py::PIPE_SCRIPT's inputs, "pipe_short" has fewer
# microbatches than stages and 2-D microbatches
PIPE_CASES = {"pipe": (0, 6, (8,), 8), "pipe_short": (1, 3, (5, 8), 8)}


def pipe_inputs(case: str):
    """(stage weights [S, D, D], microbatches [M, ...]) float32."""
    seed, m, shape, d = PIPE_CASES[case]
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((PIPE_STAGES, d, d)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((m, *shape)).astype(np.float32)
    return ws, xs


def pipe_rank(rank: int, world: int) -> dict:
    """``pipeline_apply`` with ``tanh(x @ W)`` stages on a ``pipe`` axis of
    ``world`` ranks, every case."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh((world,), ("pipe",), "cpu")
    out = {}
    for case in PIPE_CASES:
        ws, xs = pipe_inputs(case)
        got = pipeline_apply(mesh, {"W": torch.from_numpy(ws)},
                             torch.from_numpy(xs),
                             lambda p, x: torch.tanh(x @ p["W"]))
        out[case] = got.numpy()
    out["shifts"] = mesh.wire.calls
    return out


COMPRESS_SHAPES = {"a": (37,), "b": (6, 5), "c": (1000,), "z": (4,)}
COMPRESS_STEPS = 3


def compress_grads_input(rank: int, step: int) -> dict:
    """Rank ``rank``'s float32 gradients at ``step``: standard normal
    leaves at three magnitudes, and an all-zero leaf (its scale clamps to
    1e-12)."""
    rng = np.random.default_rng(1000 * step + rank)
    out = {}
    for k, shape in COMPRESS_SHAPES.items():
        mag = {"a": 1.0, "b": 30.0, "c": 1e-3, "z": 0.0}[k]
        out[k] = (rng.standard_normal(shape) * mag).astype(np.float32)
    return out


def compress_rank(rank: int, world: int) -> dict:
    """``compressed_psum`` over a ``data`` axis of ``world`` ranks for
    ``COMPRESS_STEPS`` steps, each step's mean gradient and residuals."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import (
        compressed_psum,
        compression_init,
    )

    mesh = make_mesh((world,), ("data",), "cpu")
    axes = mesh.axes("data")
    state = compression_init({k: torch.zeros(s)
                              for k, s in COMPRESS_SHAPES.items()})
    out = {}
    for step in range(COMPRESS_STEPS):
        g = {k: torch.from_numpy(v)
             for k, v in compress_grads_input(rank, step).items()}
        mean, state = compressed_psum(g, state, axes)
        for k in COMPRESS_SHAPES:
            out[f"{step}/out/{k}"] = mean[k].numpy()
            out[f"{step}/residual/{k}"] = state.residual[k].numpy()
    out["wire_bytes"] = mesh.wire.bytes
    return out


def card_parallel_rank(rank: int, world: int) -> dict:
    """``pipe_rank`` and ``compress_rank`` with ranks sharing cuda:0 over
    gloo (every message staged through host memory)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import (
        compressed_psum,
        compression_init,
    )
    from repro_torch.parallel.pipeline import pipeline_apply

    dev = torch.device("cuda:0")
    pipe = make_mesh((world,), ("pipe",), dev)
    out = {}
    for case in PIPE_CASES:
        ws, xs = pipe_inputs(case)
        got = pipeline_apply(pipe, {"W": torch.from_numpy(ws).to(dev)},
                             torch.from_numpy(xs).to(dev),
                             lambda p, x: torch.tanh(x @ p["W"]))
        assert got.device.type == "cuda"
        out[case] = got.cpu().numpy()
    data = make_mesh((world,), ("data",), dev)
    state = compression_init({k: torch.zeros(s, device=dev)
                              for k, s in COMPRESS_SHAPES.items()})
    for step in range(COMPRESS_STEPS):
        g = {k: torch.from_numpy(v).to(dev)
             for k, v in compress_grads_input(rank, step).items()}
        mean, state = compressed_psum(g, state, data.axes("data"))
        for k in COMPRESS_SHAPES:
            out[f"{step}/out/{k}"] = mean[k].cpu().numpy()
            out[f"{step}/residual/{k}"] = state.residual[k].cpu().numpy()
    out["staged"] = pipe.wire.staged_bytes + data.wire.staged_bytes
    return out


# ---------------------------------------------------------------------------
# The paper engine's cell (launch.steps._paper_cell) on gloo ranks.
# ---------------------------------------------------------------------------

PAPER_N = 3000
#: (mesh shape, config, state layout) a world of ranks runs
PAPER_CASES = {
    2: (((1, 2), "full", "replicated"), ((1, 2), "full", "sharded"),
        ((1, 2), "smoke", "sharded")),
    4: (((2, 2), "full", "replicated"), ((2, 2), "full", "sharded"),
        ((2, 2), "smoke", "replicated"), ((1, 4), "full", "sharded")),
}


def paper_graph(powerlaw):
    """The seeded graph every paper-cell test shares."""
    return powerlaw(PAPER_N, 4.0, alpha=2.1, seed=5)


def paper_spec(base, config: str):
    """The paper arch with ``full_config`` as given (``_paper_cell``
    builds from ``full_config``, in JAX and in the port)."""
    import dataclasses

    spec = base.get("paper-bfs-engine")
    if config == "smoke":
        spec = dataclasses.replace(spec, full_config=spec.smoke_config)
    return spec


def paper_shape(ShapeSpec):
    return ShapeSpec("tiny", "query", dict(n_nodes=PAPER_N, n_edges=0,
                                           avg_degree=8))


def paper_cell_rank(rank: int, world: int) -> dict:
    """Each case of ``PAPER_CASES[world]``: the cell built on the rank's
    mesh, bound to ``paper_graph`` and run; its global levels, trips,
    notes and collective counts by kind."""
    from repro_torch.configs import base
    from repro_torch.graph.generators import powerlaw
    from repro_torch.launch import steps
    from repro_torch.launch.hlo_analysis import collective_stats
    from repro_torch.launch.mesh import make_mesh

    csr = paper_graph(powerlaw)
    out = {}
    for shape, config, layout in PAPER_CASES[world]:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        cell = steps._paper_cell(paper_spec(base, config),
                                 paper_shape(base.ShapeSpec), mesh, False,
                                 state_layout=layout)
        bound = steps.bind_cell(cell, mesh, csr)
        mesh.wire.reset()
        res = bound()
        name = f"{shape[0]}x{shape[1]}/{config}/{layout}"
        out[f"{name}/levels"] = res.state.levels.numpy()
        out[f"{name}/iterations"] = res.iterations.numpy()
        out[f"{name}/notes"] = cell.notes
        st = collective_stats(mesh.wire)
        out[f"{name}/counts"] = {k: v for k, v in st.counts.items() if v}
    return out


# ---------------------------------------------------------------------------
# The LM serving cells on a mesh (launch/steps.py's _lm_cell,
# models/transformer_mesh.py).
# ---------------------------------------------------------------------------

#: (arch, global batch, prompt length, decode steps) a mesh runs
LM_MESH_CASES = {
    (2, 2): (("minicpm-2b", 4, 32, 4), ("gemma2-2b", 4, 32, 4),
             ("gemma2-2b", 1, 32, 4)),
    (1, 4): (("minicpm-2b", 4, 32, 4), ("gemma2-2b", 4, 32, 4)),
}


def lm_smoke_spec(base, arch: str, dtype=None, moe: dict | None = None):
    """The arch with ``full_config`` replaced by its smoke config
    (``_lm_cell`` builds from ``full_config``), in ``dtype`` if given,
    its ``MoESettings`` fields changed by ``moe``."""
    import dataclasses

    spec = base.get(arch)
    if dtype is None and not moe:
        return dataclasses.replace(spec, full_config=spec.smoke_config)

    def config():
        cfg = spec.smoke_config()
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **moe))
        return cfg if dtype is None else dataclasses.replace(cfg,
                                                             dtype=dtype)

    return dataclasses.replace(spec, full_config=config)


def lm_tokens(vocab: int, b: int, n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, n)).astype(np.int32)


def lm_cells(mesh, arch: str, b: int, seq: int, steps_: int, dtype=None,
             moe: dict | None = None):
    """The smoke config's prefill cell (``b`` x ``seq``) and decode cell
    (a cache of ``seq + steps_`` slots) on ``mesh``."""
    from repro_torch.configs import base
    from repro_torch.launch import steps

    spec = lm_smoke_spec(base, arch, dtype, moe)
    p = base.ShapeSpec("prefill_32k", "prefill",
                       dict(seq_len=seq, global_batch=b))
    d = base.ShapeSpec("decode_32k", "decode",
                       dict(seq_len=seq + steps_, global_batch=b))
    return (steps._lm_cell(spec, p, mesh, False),
            steps._lm_cell(spec, d, mesh, False))


def lm_mesh_rank(rank: int, world: int, shape: tuple, trees: dict,
                 device: str = "cpu") -> dict:
    """Each case of ``LM_MESH_CASES[shape]`` on this rank: the model
    carried from JAX's numpy tree (``trees[arch]``), cut by
    ``steps.shard_lm``, a prefill and ``steps_`` decode steps fed
    ``lm_tokens``; the global logits of each, this rank's cache blocks
    after the prefill, and the collectives the path sent (by kind and by
    axis) beside ``collective_schedule``'s count (``lm_serve_case``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn.module import set_activation_rules

    if device != "cpu":  # gloo ranks sharing the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(torch.device(device))
    mesh = make_mesh(shape, ("data", "model"), device)
    out = {"coords": {a: mesh.coord(a) for a in mesh.axis_names}}
    for arch, b, seq, n in LM_MESH_CASES[shape]:
        out[f"{arch}/{b}"] = lm_serve_case(mesh, arch, b, seq, n,
                                           trees[arch], device)
        set_activation_rules(None)
    return out


def lm_serve_case(mesh, arch: str, b: int, seq: int, n: int, tree: dict,
                  device: str = "cpu", moe: dict | None = None) -> dict:
    """One serving case on this rank of ``mesh``: the smoke model (its
    ``MoESettings`` changed by ``moe``) carried from JAX's numpy
    ``tree``, cut by ``steps.shard_lm``, a prefill of ``b`` x ``seq``
    ``lm_tokens`` and ``n`` decode steps; the global logits of each,
    this rank's cache blocks after the prefill, the collectives the
    path sent (by kind and by axis) beside ``collective_schedule``'s
    count, and the MoE layers' routing on this rank
    (``transformer_mesh.moe_log``)."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.models import transformer_mesh as tmesh
    from repro_torch.nn.module import gather_block, sharding_rules

    pcell, dcell = lm_cells(mesh, arch, b, seq, n, moe=moe)
    cfg = pcell.config
    model = tfm.params_from_jax(cfg, tree, device=device)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    steps.shard_lm(pcell, model, mesh)
    toks = torch.from_numpy(lm_tokens(cfg.vocab, b, seq + n)).to(device)
    mesh.wire.reset()
    tmesh.moe_log = []
    try:
        logits, caches = pcell.fn(model, toks[:, :seq], max_seq=seq + n)
        blocks = [{f: getattr(c, f).cpu().numpy().copy() for f in c._fields}
                  for c in caches]
        outs = [logits]
        for t in range(n):
            o, caches = dcell.fn(model, caches, toks[:, seq + t:seq + t + 1],
                                 seq + t)
            outs.append(o[:, 0])
        routing = tmesh.moe_log
    finally:
        tmesh.moe_log = None
    by_kind = {k: {int(g): list(v) for g, v in d.items()}
               for k, d in mesh.wire.by_kind.items()}
    by_axis = {a: {k: list(v) for k, v in d.items()}
               for a, d in mesh.wire.by_axis.items()}
    spec = pcell.decisions["out_specs"][0]
    out = {
        "logits": [gather_block(x, spec, mesh).cpu().numpy() for x in outs],
        "staged": mesh.wire.staged_bytes,
        "caches": blocks,
        "by_kind": by_kind, "by_axis": by_axis,
        "seq_axes": dcell.decisions["seq_axes"],
        "routing": routing,
    }
    specs = model.shard_specs
    data = mesh.shape.get("data", 1)
    rows = b // data if b % data == 0 else b
    sch = [tmesh.collective_schedule(
        cfg, kind, rows, seq, mesh.shape,
        sharding_rules(False, kind == "prefill"), specs, shapes,
        dcell.decisions["seq_axes"]) for kind in ("prefill", "decode")]
    parts = [sch[0]["global"], *sch[0]["layers"], sch[0]["final"]]
    for _ in range(n):
        parts += [sch[1]["global"], *sch[1]["layers"], sch[1]["final"]]
    out["schedule"] = tmesh.merge_records(*parts)
    return out


def lm_replicated_kv_rank(rank: int, world: int) -> dict:
    """MiniCPM-smoke with one kv head of 6 on ``(1, 4)``: ``wk``/``wv``
    (``[64, 6]``) do not divide the model axis and stay replicated
    (``sanitize_spec``); each rank runs the unsharded model, then the
    mesh cells from the same weights. Returns both runs' logits and the
    kv specs."""
    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.nn.module import gather_block

    spec = base.get("minicpm-2b")
    cfg = dataclasses.replace(spec.smoke_config(), n_kv_heads=1, d_head=6)
    spec = dataclasses.replace(spec, full_config=lambda: cfg)
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    b, seq, n = 4, 32, 4  # 36 cache slots, 9 a rank
    pcell = steps._lm_cell(spec, base.ShapeSpec(
        "prefill_32k", "prefill", dict(seq_len=seq, global_batch=b)),
        mesh, False)
    dcell = steps._lm_cell(spec, base.ShapeSpec(
        "decode_32k", "decode", dict(seq_len=seq + n, global_batch=b)),
        mesh, False)
    model = tfm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(lm_tokens(cfg.vocab, b, seq + n))
    want, caches = tfm.prefill(model, cfg, toks[:, :seq], max_seq=seq + n)
    ref = [want.numpy()]
    for t in range(n):
        o, caches = tfm.decode(model, cfg, caches,
                               toks[:, seq + t:seq + t + 1], seq + t)
        ref.append(o[:, 0].numpy())
    steps.shard_lm(pcell, model, mesh)
    logits, caches = pcell.fn(model, toks[:, :seq], max_seq=seq + n)
    out_spec = pcell.decisions["out_specs"][0]
    got = [gather_block(logits, out_spec, mesh).numpy()]
    for t in range(n):
        o, caches = dcell.fn(model, caches, toks[:, seq + t:seq + t + 1],
                             seq + t)
        got.append(gather_block(o[:, 0], out_spec, mesh).numpy())
    return {"got": got, "ref": ref, "vocab": cfg.vocab,
            "wk": model.shard_specs["blocks.0.attn.wk.kernel"],
            "wq": model.shard_specs["blocks.0.attn.wq.kernel"]}


# ---------------------------------------------------------------------------
# The GNN and recsys cells on a mesh (launch/steps.py's _gnn_cell and
# _recsys_cell on a Mesh).
# ---------------------------------------------------------------------------

GNN_MESH_ARCHS = ("pna", "schnet", "mace", "equiformer-v2")
#: smaller cells of each shape kind, their node and graph counts
#: divisible by 4 (no pad node on any mesh of four)
GNN_MESH_DIMS = {"full_graph_sm": dict(n_nodes=40, n_edges=120, d_feat=24),
                 "minibatch_lg": dict(batch_nodes=4, fanout=(3, 2)),
                 "molecule": dict(batch=4, n_nodes=6, n_edges=10)}
MESH_STEPS = 2
RECSYS_MESH_DIMS = {"train_batch": dict(batch=64),
                    "serve_p99": dict(batch=16),
                    "serve_bulk": dict(batch=32),
                    "retrieval_cand": dict(batch=1, n_candidates=1002)}


def gnn_mesh_batches(arch: str, shape: str) -> list:
    """The seeded global batches of a case (``steps.cell_batch``)."""
    from repro_torch.launch import steps

    cell = steps.gnn_cell(arch, shape, smoke=True, dims=GNN_MESH_DIMS[shape])
    return [steps.cell_batch(cell, 10 + i) for i in range(MESH_STEPS)]


def recsys_mesh_batch(shape: str, step: int = 0) -> dict:
    from repro_torch.launch import steps

    cell = steps.recsys_cell("dcn-v2", shape, smoke=True,
                             dims=RECSYS_MESH_DIMS[shape])
    return steps.recsys_batch(cell, step, seed=3)


def recsys_candidates(n: int, dim: int) -> np.ndarray:
    return np.random.default_rng(4).standard_normal((n, dim)).astype(
        np.float32)


def _blocks_equal(model, tree: dict, mesh) -> bool:
    """Every parameter block equals its spec's slice of the whole."""
    from repro_torch.nn.module import block_of

    ok = True
    for name, p in model.named_parameters():
        whole = tree
        for k in name.split("."):
            whole = whole[k]
        want = block_of(np.asarray(whole), model.shard_specs[name], mesh)
        ok &= bool(np.array_equal(p.detach().cpu().numpy(), want))
    return ok


def _global_state(model, opt, mesh) -> dict:
    """The parameters and moments gathered whole (after the run's
    collectives were read)."""
    from repro_torch.nn.module import gather_block

    specs = model.shard_specs
    with torch.no_grad():
        return {
            "params": {k: gather_block(p.detach(), specs[k], mesh).cpu()
                       .numpy() for k, p in model.named_parameters()},
            "mu": {k: gather_block(v, specs[k], mesh).cpu().numpy()
                   for k, v in opt.mu.items()},
            "nu": {k: gather_block(v, specs[k], mesh).cpu().numpy()
                   for k, v in opt.nu.items()},
        }


def _wire_axes(mesh) -> dict:
    return {a: {k: list(v) for k, v in d.items()}
            for a, d in mesh.wire.by_axis.items()}


def gnn_mesh_rank(rank: int, world: int, shape: tuple, trees: dict,
                  device: str = "cpu") -> dict:
    """Each ``(arch, shape)`` of ``trees`` (JAX's numpy weights) on this
    rank: the cell on the ``shape`` mesh, the model cut by
    ``steps.shard_gnn``, ``MESH_STEPS`` train steps on the rank's part
    of ``gnn_mesh_batches``; returns the losses and norms, the global
    parameters and moments after, the collectives of the steps beside
    ``gnn_collective_schedule``'s count, the slab layout and whether
    the blocks matched their specs."""
    import copy

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import adamw_init

    if device != "cpu":  # gloo ranks sharing the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(torch.device(device))
    mesh = make_mesh(shape, ("data", "model"), device)
    out = {}
    for (arch, sname), tree in trees.items():
        cell = steps.build_cell(arch, sname, mesh, False, smoke=True,
                                dims=GNN_MESH_DIMS[sname])
        model = steps.GNN_MODULES[arch].params_from_jax(
            cell.config, tree, device).requires_grad_(True)
        steps.shard_gnn(cell, model, mesh)
        blocks_ok = _blocks_equal(model, tree, mesh)
        opt = adamw_init(steps.params_dict(model), steps.GNN_ADAMW)
        mesh.wire.reset()
        res, node_blocks_ok = [], True
        for b in gnn_mesh_batches(arch, sname):
            b = steps.pad_gnn_batch(cell, b)
            rb, layout = steps.gnn_rank_batch(cell, mesh, b)
            for key, spec in cell.in_shardings[2].items():
                if not key.startswith("edge_"):
                    want = steps.block_of(np.asarray(b[key]), spec, mesh)
                    node_blocks_ok &= bool(np.array_equal(
                        rb[key].cpu().numpy(), want))
            _, opt, loss, gnorm = cell.fn(model, opt, rb)
            res.append((float(loss), float(gnorm)))
        wire = _wire_axes(mesh)
        out[f"{arch}/{sname}"] = dict(
            steps=res, wire=copy.deepcopy(wire),
            staged=mesh.wire.staged_bytes,
            schedule=steps.gnn_collective_schedule(cell, mesh.shape),
            layout=layout, blocks_ok=blocks_ok,
            batch_blocks_ok=node_blocks_ok, **_global_state(model, opt,
                                                            mesh))
    return out


def recsys_mesh_rank(rank: int, world: int, shape: tuple, tree: dict,
                     device: str = "cpu") -> dict:
    """DCN-v2's four kinds on this rank of the ``shape`` mesh from JAX's
    numpy weights ``tree``: ``MESH_STEPS`` train steps (losses, norms,
    the global parameters and moments after), the serve and bulk logits
    gathered whole, the retrieval top 100; each kind's collectives
    beside ``recsys_collective_schedule``'s count."""
    import copy

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import dcn_v2 as dcn
    from repro_torch.nn.module import gather_block, set_activation_rules
    from repro_torch.optim.adamw import adamw_init

    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(torch.device(device))
    mesh = make_mesh(shape, ("data", "model"), device)
    out = {}
    for sname, dims in RECSYS_MESH_DIMS.items():
        cell = steps.build_cell("dcn-v2", sname, mesh, False, smoke=True,
                                dims=dims)
        model, _ = dcn.params_from_jax(tree, cell.config, device)
        if cell.kind == "train":
            model.requires_grad_(True)
        steps.shard_recsys(cell, model, mesh)
        rec = {"blocks_ok": _blocks_equal(model, tree, mesh),
               "schedule": steps.recsys_collective_schedule(cell,
                                                            mesh.shape)}
        mesh.wire.reset()
        if cell.kind == "train":
            opt = adamw_init(steps.params_dict(model), steps.RECSYS_ADAMW)
            res = []
            for i in range(MESH_STEPS):
                b, _ = steps.recsys_rank_batch(cell, mesh,
                                               recsys_mesh_batch(sname, i))
                _, opt, loss, gnorm = cell.fn(model, opt, b)
                res.append((float(loss), float(gnorm)))
            rec.update(steps=res, wire=copy.deepcopy(_wire_axes(mesh)),
                       **_global_state(model, opt, mesh))
        elif cell.kind == "retrieval":
            nc = cell.decisions["n_candidates_padded"]
            cand = torch.from_numpy(recsys_candidates(
                nc, cell.config.retrieval_dim))
            b, c = steps.recsys_rank_batch(cell, mesh,
                                           recsys_mesh_batch(sname), cand)
            vals, idx = cell.fn(model, b, c)
            rec.update(wire=copy.deepcopy(_wire_axes(mesh)),
                       values=vals.cpu().numpy(), indices=idx.cpu().numpy(),
                       cand_rows=int(c.shape[0]))
        else:
            b, _ = steps.recsys_rank_batch(cell, mesh,
                                           recsys_mesh_batch(sname))
            logits = cell.fn(model, b)
            rec["wire"] = copy.deepcopy(_wire_axes(mesh))
            set_activation_rules(None)
            spec = cell.in_shardings[1]["dense"][:1]
            rec["logits"] = gather_block(logits, spec, mesh).cpu().numpy()
        out[sname] = rec
    return out


# ---------------------------------------------------------------------------
# LM training on a mesh (launch/steps.py's _lm_cell train step on a Mesh).
# ---------------------------------------------------------------------------

#: (arch, dtype, global batch, length) a mesh trains: deepseek-coder's
#: n_micro of 4 at batch 8, so each microbatch's two rows split over data
LM_TRAIN_CASES = {
    (2, 2): (("minicpm-2b", "float32", 4, 16),
             ("gemma2-2b", "float32", 4, 16),
             ("deepseek-coder-33b", "float32", 8, 16),
             ("minicpm-2b", "bfloat16", 4, 16)),
    (1, 4): (("minicpm-2b", "float32", 4, 16),
             ("gemma2-2b", "float32", 4, 16),
             ("deepseek-coder-33b", "float32", 8, 16)),
}
LM_TRAIN_STEPS = 2
LM_TRAIN_CE = 8  # two cross-entropy chunks of the 16-token sequence


def lm_train_cell(mesh, arch: str, b: int, seq: int, dtype: str):
    """The smoke config's ``train_4k`` cell at ``b`` x ``seq``,
    ``ce_chunk`` ``LM_TRAIN_CE``, in ``dtype``."""
    import dataclasses

    from repro_torch.configs import base
    from repro_torch.launch import steps

    spec = base.get(arch)
    cfg = dataclasses.replace(spec.smoke_config(), ce_chunk=LM_TRAIN_CE,
                              dtype=getattr(torch, dtype))
    spec = dataclasses.replace(spec, full_config=lambda: cfg)
    shape = base.ShapeSpec("train_4k", "train",
                           dict(seq_len=seq, global_batch=b))
    return steps._lm_cell(spec, shape, mesh, False)


def lm_train_batch(vocab: int, b: int, seq: int) -> dict:
    toks = lm_tokens(vocab, b, seq + 1, seed=2)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_train_run(cell, mesh, tree: dict, device: str = "cpu") -> dict:
    """``LM_TRAIN_STEPS`` steps of a train ``cell`` on this rank of
    ``mesh`` from JAX's train state ``tree`` (numpy, blocks stacked by
    group), the model and the moments cut by ``steps.shard_lm``, on the
    seeded global batch: each step's loss and norm and the global state
    after it (``{"params", "mu", "nu"}``, by the port's parameter
    names), the collectives of the steps by kind and by axis beside
    ``collective_schedule``'s count, and an MoE model's aux loss (its
    layers' sum) of each microbatch of each step."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models import transformer_mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.nn.module import gather_block, sharding_rules

    cfg = cell.config
    model, opt = tfm.state_from_jax(cfg, tree, device)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    steps.shard_lm(cell, model, mesh, opt)
    specs = model.shard_specs
    b, seq = cell.dims["global_batch"], cell.dims["seq_len"]
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in lm_train_batch(cfg.vocab, b, seq).items()}
    mesh.wire.reset()
    res, blocks = [], []
    tmesh.moe_log = [] if cfg.moe is not None else None
    try:
        for _ in range(LM_TRAIN_STEPS):
            _, opt, loss, gnorm = cell.fn(model, opt, batch)
            res.append((float(loss), float(gnorm)))
            blocks.append({"params": {k: p.detach().clone() for k, p in
                                      model.named_parameters()},
                           "mu": {k: v.clone() for k, v in opt.mu.items()},
                           "nu": {k: v.clone() for k, v in opt.nu.items()}})
        aux = [r["aux"] for r in tmesh.moe_log or ()]
    finally:
        tmesh.moe_log = None
    wire = {"by_kind": {k: {int(g): list(v) for g, v in d.items()}
                        for k, d in mesh.wire.by_kind.items()},
            "by_axis": _wire_axes(mesh), "staged": mesh.wire.staged_bytes}
    n_micro = cell.decisions["n_micro"]
    rows = b // mesh.shape.get("data", 1) // n_micro
    sch = tmesh.collective_schedule(
        cfg, "train", rows, seq, mesh.shape, sharding_rules(False, True),
        specs, shapes, n_micro=n_micro)
    sch = tmesh.merge_records(sch["global"], *sch["layers"], sch["final"])
    states = [{part: {k: gather_block(v, specs[k], mesh).float().cpu()
                      .numpy() for k, v in st[part].items()}
               for part in st} for st in blocks]  # after the wire's read
    return {"steps": res, "states": states, "wire": wire,
            "schedule": tmesh.merge_records(*[sch] * LM_TRAIN_STEPS),
            "n_micro": n_micro, "aux": aux}


def lm_train_rank(rank: int, world: int, shape: tuple, trees: dict) -> dict:
    """Each case of ``LM_TRAIN_CASES[shape]`` on this rank
    (``lm_train_run``), from ``trees[(arch, dtype)]``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn.module import set_activation_rules

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    out = {}
    for arch, dtype, b, seq in LM_TRAIN_CASES[shape]:
        cell = lm_train_cell(mesh, arch, b, seq, dtype)
        out[arch, dtype] = lm_train_run(cell, mesh, trees[arch, dtype])
        set_activation_rules(None)
    return out


# ---------------------------------------------------------------------------
# MoE layers on a mesh (models/transformer_mesh.py's expert-parallel _moe).
# ---------------------------------------------------------------------------

MOE_ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
MOE_SERVE = (4, 32, 4)  # global batch, prompt length, decode steps
#: both packages' smoke ``MoESettings`` changed so that about half of
#: the slots of a 4 x 32 prefill drop, which ones by the global order
MOE_CAPACITY = {"dropless_threshold": 0, "capacity_factor": 0.5}
#: (arch, global batch, length) a (2, 2) mesh trains in float32: each
#: arch's n_micro (4 and 8), one row a data rank a microbatch
MOE_TRAIN = (("olmoe-1b-7b", 8, 16), ("llama4-maverick-400b-a17b", 16, 16))


def moe_mesh_rank(rank: int, world: int, shape: tuple, trees: dict) -> dict:
    """On this rank of ``shape``: each MoE arch served
    (``lm_serve_case``, ``MOE_SERVE``) from ``trees[arch]``, then a
    prefill at ``MOE_CAPACITY``; on ``(2, 2)`` also ``MOE_TRAIN``'s
    train cells (``lm_train_run``) from ``trees[arch, "float32"]``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn.module import set_activation_rules

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    out = {"coords": {a: mesh.coord(a) for a in mesh.axis_names}}
    b, seq, n = MOE_SERVE
    for arch in MOE_ARCHS:
        out["serve", arch] = lm_serve_case(mesh, arch, b, seq, n,
                                           trees[arch])
        set_activation_rules(None)
        out["capacity", arch] = lm_serve_case(mesh, arch, b, seq, 0,
                                              trees[arch],
                                              moe=MOE_CAPACITY)
        set_activation_rules(None)
    if shape == (2, 2):
        for arch, b, seq in MOE_TRAIN:
            cell = lm_train_cell(mesh, arch, b, seq, "float32")
            out["train", arch] = lm_train_run(cell, mesh,
                                              trees[arch, "float32"])
            set_activation_rules(None)
    return out


# ---------------------------------------------------------------------------
# The pipelined split-phase loop with a delta in flight (test_torch_overlap).
# ---------------------------------------------------------------------------

OVERLAP_MESH = ((1, 2), ("data", "model"))
OVERLAP_DELTA_AT = 2  # the delta lands between this batch's begin and settle


def overlap_batches() -> list:
    """``[(sources, state_layout)]`` of the pipelined loop, seeded, over
    ``powerlaw(160, 5.0, seed=0)``."""
    rng = np.random.default_rng(4)
    return [(rng.integers(0, 160, 4).astype(np.int32),
             ("replicated", "sharded")[i % 2]) for i in range(5)]


def pipelined_run(d, batches, delta, at: int, overlap: bool,
                  backend: str = "dopt") -> list:
    """``ServingLoop``'s order over a dispatcher's split-phase API,
    ``begin(i)``, ``finalize(i-1)``, ``settle(i)``, nTkS on ``backend``,
    with ``delta`` applied between the begin and the settle of batch
    ``at``; ``overlap=False`` finalizes each batch before the next begins.
    Either package's dispatcher; returns the outcomes in batch order."""
    tail, outs = None, []
    for i, (srcs, lay) in enumerate(batches):
        inflight = d.begin_batch(srcs, policy="ntks", state_layout=lay,
                                 backend=backend)
        if overlap and tail is not None:
            outs.append(tail.finalize())
        if i == at:
            d.apply_delta(delta)
        settled = d.settle_batch(inflight)
        if overlap:
            tail = settled
        else:
            outs.append(settled.finalize())
    if tail is not None:
        outs.append(tail.finalize())
    return outs


def overlap_rank(rank: int, world: int) -> dict:
    """``pipelined_run`` on ``OVERLAP_MESH`` with rank 0 leading and the
    follower replaying, overlapped and then serial: each rank's finalized
    batches (levels, iterations) by control-channel number, its ``Wire``
    (calls, bytes, by kind, by axis) and the threads that ran phase 1's
    morsel loops."""
    import threading

    import repro_torch.core.dispatcher as cd
    from repro_torch.graph.delta import random_delta
    from repro_torch.graph.generators import powerlaw
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.dispatch import QueryDispatcher

    threads = set()
    run_morsel = cd._run_morsel

    def recording(*args, **kwargs):
        threads.add(threading.current_thread().name)
        return run_morsel(*args, **kwargs)

    cd._run_morsel = recording
    mesh = make_mesh(*OVERLAP_MESH, "cpu")
    csr = powerlaw(160, 5.0, seed=0)
    delta = random_delta(csr, 15, 15, seed=9)
    out = {}
    for mode, overlap in (("overlap", True), ("serial", False)):
        mesh.wire.reset()
        d = QueryDispatcher(mesh, csr, max_iters=64, phase1_iters=1)
        d.leading = True
        got = {}
        d.on_finalized = lambda seq, o: got.__setitem__(seq, (
            o.result.state.levels.numpy(), o.result.iterations.numpy()))
        if rank == 0:
            pipelined_run(d, overlap_batches(), delta, OVERLAP_DELTA_AT,
                          overlap)
            d.release_followers()
        else:
            d.follow()
        w = mesh.wire
        out[mode] = got
        out[mode, "wire"] = (w.calls, w.bytes, w.staged_bytes, w.by_kind,
                             w.by_axis)
    out["threads"] = sorted(threads)
    return out


# ---------------------------------------------------------------------------
# Elastic checkpoints of a mesh's train state (CheckpointManager's
# shardings=, steps.state_shardings, TrainGuard on a mesh).
# ---------------------------------------------------------------------------

#: (arch, global batch, length) of each float32 smoke LM: the batch
#: splits into n_micro x data rows on (2, 2) and on (4, 1)
CKPT_LM = (("minicpm-2b", 4, 16), ("olmoe-1b-7b", 16, 16))
CKPT_MESHES = ((2, 2), (1, 4), (4, 1))  # where JAX's checkpoint restores
CKPT_STEPS = 3  # the uninterrupted (2, 2) run; its save after step 1
CKPT_FAIL_AT = 2  # TrainGuard's step that fails, after its update
#: the small checkpoint the error cases restore: "x" (8, 6) float32 and
#: "s" a Stacked leaf of two (4,) groups
CKPT_SMALL = {"x": (8, 6), "s": (2, 4)}


def ckpt_small_arrays() -> dict:
    x = np.arange(48, dtype=np.float32).reshape(CKPT_SMALL["x"])
    s = np.arange(8, dtype=np.float32).reshape(CKPT_SMALL["s"]) + 100
    return {"x": x, "s": s}


def _lm_state(cell, mesh, tree=None):
    """(model, opt) of a train ``cell`` on this rank of ``mesh``, cut by
    ``shard_lm``: JAX's train state ``tree`` (numpy, ``opt`` a (step,
    mu, nu) tuple) or, without one, a seed-1 model and zero moments."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    if tree is None:
        model = tfm.init(cell.config, torch.Generator().manual_seed(1),
                         "cpu")
        model.requires_grad_(True)
        opt = adamw_init(dict(model.named_parameters()), AdamWConfig())
    else:
        model, opt = tfm.state_from_jax(cell.config, tree, "cpu")
    steps.shard_lm(cell, model, mesh, opt)
    return model, opt


def lm_by_name(cfg, tree: dict) -> dict:
    """JAX's numpy train state ``{"params", "opt": (step, mu, nu)}`` as
    ``{"params", "mu", "nu"}`` by the port's parameter names."""
    from repro_torch.models import transformer as tfm

    names = [n for n, _ in tfm.init(cfg, None, "meta").named_parameters()]

    def flat(t):
        out = {}
        for name in names:
            path, g = tfm.jax_path(cfg, name)
            leaf = t
            for k in path:
                leaf = leaf[k]
            out[name] = np.asarray(leaf if g is None else leaf[g])
        return out

    _, mu, nu = tree["opt"]
    return {"params": flat(tree["params"]), "mu": flat(mu), "nu": flat(nu)}


def _mismatches(model, opt, whole: dict, mesh) -> list:
    """(part, name) of each block of this rank's state that is not,
    bit for bit, its spec's slice of ``whole`` (numpy by part and
    name)."""
    from repro_torch.nn.module import block_of

    mine = {"params": {k: p.detach() for k, p in model.named_parameters()},
            "mu": opt.mu, "nu": opt.nu}
    bad = []
    for part, leaves in mine.items():
        for name, t in leaves.items():
            want = np.ascontiguousarray(block_of(
                np.asarray(whole[part][name]), model.shard_specs[name],
                mesh))
            got = t.detach().cpu().numpy()
            if (got.dtype != want.dtype or got.shape != want.shape
                    or got.tobytes() != want.tobytes()):
                bad.append((part, name))
    return bad


def _state_copy(model, opt, mesh) -> dict:
    """``_global_state``, copied: a leaf that needs no gather is the
    live tensor's memory, which the next step writes in place."""
    return {part: {k: v.copy() for k, v in leaves.items()}
            for part, leaves in _global_state(model, opt, mesh).items()}


def _ckpt_lm(meshes: dict, arch: str, b: int, seq: int, tree: dict,
             root: str) -> dict:
    """One arch's cases on this rank (``ckpt_mesh_rank``)."""
    import os

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.launch import steps
    from repro_torch.nn.module import set_activation_rules
    from repro_torch.runtime.fault_tolerance import TrainGuard

    def fresh_cell(shape):
        set_activation_rules(None)
        return lm_train_cell(meshes[shape], arch, b, seq, "float32")

    def manager(kind):
        return CheckpointManager(os.path.join(root, kind, arch))

    rec = {}
    cell = fresh_cell((2, 2))
    jax_named = lm_by_name(cell.config, tree)
    batch = {k: torch.from_numpy(v) for k, v in
             lm_train_batch(cell.config.vocab, b, seq).items()}
    # JAX's checkpoint onto each mesh, into a seed-1 model
    for shape in CKPT_MESHES:
        mesh = meshes[shape]
        c = fresh_cell(shape)
        model, opt = _lm_state(c, mesh)
        _, step = manager("jax").restore(
            steps.train_state(model, opt),
            shardings=steps.state_shardings(model, mesh))
        rec["jax", shape] = {
            "step": step, "opt_step": int(opt.step),
            "mismatches": _mismatches(model, opt, jax_named, mesh)}
    # the uninterrupted (2, 2) run from JAX's state, saved after step 1
    m22 = meshes[2, 2]
    cell = fresh_cell((2, 2))
    model, opt = _lm_state(cell, m22, tree)
    mgr = manager("mesh")
    run = {"steps": [], "states": []}
    for i in range(CKPT_STEPS):
        _, opt, loss, gnorm = cell.fn(model, opt, batch)
        run["steps"].append((float(loss), float(gnorm)))
        run["states"].append(_state_copy(model, opt, m22))
        if i == 0:
            mgr.save(1, steps.train_state(model, opt),
                     shardings=steps.state_shardings(model, m22))
            run["saved_opt_step"] = int(opt.step)
    mgr.wait()
    run["opt_step"] = int(opt.step)
    rec["run"] = run
    # TrainGuard on (2, 2): step CKPT_FAIL_AT fails on every rank after
    # its update, once
    model, opt = _lm_state(cell, m22, tree)
    live = {"opt": opt}
    failed = []

    def step_fn(state, i):
        # the step count is a new tensor each step: take the state's,
        # which a restore wrote
        live["opt"] = live["opt"]._replace(step=state["opt"].step)
        _, live["opt"], _, _ = cell.fn(model, live["opt"], batch)
        if i == CKPT_FAIL_AT and not failed:
            failed.append(i)
            raise RuntimeError("injected failure after the update")
        return steps.train_state(model, live["opt"])

    gmgr = manager("guard")
    guard = TrainGuard(ckpt=gmgr, save_every=1,
                       shardings=steps.state_shardings(model, m22))
    _, end = guard.run(steps.train_state(model, opt), step_fn, CKPT_STEPS)
    rec["guard"] = {"failed": failed, "end": end,
                    "saved": gmgr.all_steps(),
                    "opt_step": int(live["opt"].step),
                    "state": _state_copy(model, live["opt"], m22)}
    # the step-1 checkpoint onto (4, 1), then step 2 there
    m41 = meshes[4, 1]
    c41 = fresh_cell((4, 1))
    model, opt = _lm_state(c41, m41)
    _, step = manager("mesh").restore(
        steps.train_state(model, opt),
        shardings=steps.state_shardings(model, m41))
    restored = _state_copy(model, opt, m41)
    _, opt, loss, gnorm = c41.fn(model, opt, batch)
    rec["resize"] = {"step": step, "restored": restored,
                     "next": (float(loss), float(gnorm)),
                     "state": _state_copy(model, opt, m41),
                     "opt_step": int(opt.step)}
    set_activation_rules(None)
    return rec


def _ckpt_dcn(meshes: dict, tree: dict, root: str) -> dict:
    """DCN-v2's ``train_batch`` on (2, 2) from JAX's weights: one step,
    saved; restored on (4, 1) into seed-1 weights."""
    import os

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.launch import steps
    from repro_torch.models import dcn_v2 as dcn
    from repro_torch.nn.module import set_activation_rules
    from repro_torch.optim.adamw import adamw_init

    dims = RECSYS_MESH_DIMS["train_batch"]
    where = os.path.join(root, "mesh", "dcn-v2")

    def state(mesh, weights):
        cell = steps.build_cell("dcn-v2", "train_batch", mesh, False,
                                smoke=True, dims=dims)
        if weights is None:
            model, _ = dcn.init(cell.config, torch.Generator().manual_seed(1),
                                "cpu")
        else:
            model, _ = dcn.params_from_jax(weights, cell.config, "cpu")
        model.requires_grad_(True)
        steps.shard_recsys(cell, model, mesh)
        return cell, model, adamw_init(steps.params_dict(model),
                                       steps.RECSYS_ADAMW)

    m22, m41 = meshes[2, 2], meshes[4, 1]
    cell, model, opt = state(m22, tree)
    b, _ = steps.recsys_rank_batch(cell, m22,
                                   recsys_mesh_batch("train_batch", 0))
    _, opt, _, _ = cell.fn(model, opt, b)
    mgr = CheckpointManager(where)
    mgr.save(1, steps.train_state(model, opt),
             shardings=steps.state_shardings(model, m22))
    mgr.wait()
    saved, saved_step = _state_copy(model, opt, m22), int(opt.step)
    set_activation_rules(None)
    _, model, opt = state(m41, None)
    _, step = CheckpointManager(where).restore(
        steps.train_state(model, opt),
        shardings=steps.state_shardings(model, m41))
    set_activation_rules(None)
    return {"saved": saved, "saved_opt_step": saved_step, "step": step,
            "opt_step": int(opt.step),
            "mismatches": _mismatches(model, opt, saved, m41)}


def _ckpt_errors(meshes: dict, root: str) -> dict:
    """Restores of the small checkpoint (``CKPT_SMALL``): one that fits
    on (2, 2) (the rank's blocks), and the messages of those that must
    raise (None where one did not)."""
    import os

    from repro_torch.checkpoint.checkpoint import CheckpointManager, Stacked
    from repro_torch.nn.module import NamedSharding

    mgr = CheckpointManager(os.path.join(root, "small"))
    m22, m14 = meshes[2, 2], meshes[1, 4]

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    def like(x=None, s=None):
        return {"x": zeros(4, 3) if x is None else x,
                "s": Stacked([zeros(2), zeros(2)]) if s is None else s}

    def sh(mesh=m22, x=("data", "model"), s=(None, "model")):
        return {"x": NamedSharding(mesh, x), "s": NamedSharding(mesh, s)}

    def raised(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    fits = like()
    mgr.restore(fits, shardings=sh())
    return {
        "x": fits["x"].numpy(), "s": [t.numpy() for t in fits["s"].tensors],
        "coords": {a: m22.coord(a) for a in m22.axis_names},
        "non_dividing": raised(lambda: mgr.restore(
            like(x=zeros(8, 1), s=Stacked([zeros(1), zeros(1)])),
            shardings=sh(m14, x=(None, "model")))),
        "wrong_shape": raised(lambda: mgr.restore(like(x=zeros(4, 2)),
                                                  shardings=sh())),
        "wrong_dtype": raised(lambda: mgr.restore(
            like(x=zeros(4, 3, dtype=torch.float64)), shardings=sh())),
        "group_dim": raised(lambda: mgr.restore(like(), shardings=sh(
            s=("model",)))),
        "unknown_axis": raised(lambda: NamedSharding(m22, ("pod",))),
        "missing_leaf": raised(lambda: mgr.restore(
            like(), shardings={"x": sh()["x"]})),
    }


#: the layouts ``reshard_block`` and ``gather_block_to_root`` move an
#: (8, 12) tensor between (each divides on every mesh of CKPT_MESHES)
RESHARD_SPECS = (("data", "model"), (None, ("data", "model")),
                 (None, None))


def reshard_cases(meshes: dict) -> dict:
    """On this rank: an (8, 12) tensor's block under each of
    ``RESHARD_SPECS`` on each mesh moved to each layout on each other
    mesh (``reshard_block``) and to rank 0 (``gather_block_to_root``):
    ``{case: the result is bitwise what it should be}``."""
    from repro_torch.nn.module import (block_of, gather_block_to_root,
                                       reshard_block)

    x = torch.arange(96, dtype=torch.float32).reshape(8, 12)
    out = {}
    for a, ma in meshes.items():
        for sa in RESHARD_SPECS:
            block = block_of(x, sa, ma).clone()
            root = gather_block_to_root(block, sa, ma)
            out["root", a, sa] = (torch.equal(root, x) if ma.rank == 0
                                  else root is None)
            for b, mb in meshes.items():
                for sb in RESHARD_SPECS:
                    got = reshard_block(block, sa, ma, sb, mb)
                    out[a, sa, b, sb] = torch.equal(got, block_of(x, sb, mb))
    return out


def ckpt_mesh_rank(rank: int, world: int, trees: dict, root: str) -> dict:
    """On this rank of a four-rank world, over the meshes ``(2, 2)``,
    ``(1, 4)`` and ``(4, 1)`` of the same ranks: for each ``CKPT_LM``
    arch, JAX's checkpoint under ``root/jax/<arch>`` restored onto
    each mesh, the uninterrupted (2, 2) run from JAX's state
    ``trees[arch]`` (saved after step 1 under ``root/mesh/<arch>``), a
    ``TrainGuard`` run with a failure, and the step-1 checkpoint
    restored onto (4, 1) with its next step; DCN-v2's state saved on
    (2, 2) and restored on (4, 1); the error cases; ``reshard_cases``."""
    from repro_torch.launch.mesh import make_mesh

    meshes = {shape: make_mesh(shape, ("data", "model"), "cpu")
              for shape in CKPT_MESHES}
    out = {"coords": {shape: {a: m.coord(a) for a in m.axis_names}
                      for shape, m in meshes.items()}}
    for arch, b, seq in CKPT_LM:
        out[arch] = _ckpt_lm(meshes, arch, b, seq, trees[arch], root)
    out["dcn-v2"] = _ckpt_dcn(meshes, trees["dcn-v2"], root)
    out["errors"] = _ckpt_errors(meshes, root)
    out["reshard"] = reshard_cases(meshes)
    return out
