"""Dry-run of every (arch x input-shape x mesh) cell (port of
``repro.launch.dryrun``).

JAX lowers and compiles each cell for its production meshes (16 x 16
and 2 x 16 x 16 TPU chips) and records XLA's memory and cost analysis,
the collectives parsed from the optimized HLO and the roofline terms.
The port has no compiler to ask, so the record comes from two sources:

- ``--mesh single`` / ``multi`` (JAX's layouts, ``both`` is the two):
  nothing runs. The record holds the cell's decisions, the per-device
  argument and output bytes under the cell's placement (graph rows over
  ``model``, morsels over the source axes), an analytic cost a trip
  (``paper_cost``) and the roofline from it and the port's collective
  schedule (``paper_collectives``). ``temp_size_in_bytes`` and the
  ``collective_*`` fields are null, beside ``"measured": false``: only a
  compiler could give them.
- ``--mesh card``: the cell runs on one card (a ``Mesh`` of one rank)
  over the shape's seeded graph at its published node count
  (``steps.bind_cell``), after one cold run: peak device memory (from
  the binding on, above what the process held before),
  argument bytes, the collectives ``Wire`` recorded, the median wall ms
  of ``REPS`` runs, each morsel's iterations and the edges scanned a
  second.

Records land in ``results/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``.
LM cells: on ``single``/``multi`` the record is analytic as above:
per-device argument and output bytes under the cell's specs
(parameters, AdamW moments, caches, tokens), ``lm_cost`` and the port's
collective schedule (``lm_collectives``: ``transformer_mesh.
collective_schedule``, the calls ``Wire`` records on a real mesh; a
train step's with its recompute, backward and gradient sums). On
``card`` a cell runs on a one-rank ``Mesh`` (``lm_card_cut``, in
``reduced``): wall ms, tokens a second, peak memory, ``mha``
launches; a cell whose state exceeds the card (``lm_state_bytes``:
llama4 at full width, olmoe's AdamW state) records an error naming the
bytes. ``--components`` (JAX's
per-component LM roofline, ``run_components``) sums trips x terms of
``steps.lm_components``; each term is the port's analytic count
(``component_terms``), as XLA's cost analysis has no counterpart here.

GNN and recsys cells: on ``single``/``multi`` the record is analytic in
the same format: per-device argument and output bytes under the cell's
specs (parameters, AdamW moments, the batch with its slab-aligned
edges, the padded candidates), ``gnn_cost``/``dcn_cost`` and the
family's collective schedule (``steps.gnn_collective_schedule``,
``steps.recsys_collective_schedule``, the calls ``Wire`` records on a
real mesh). A GNN record's floor of device memory adds one per-edge
message tensor of the device's edges (``edge_tensor_bytes``):
``ogb_products`` and EquiformerV2's per-edge irrep tensors exceed the
card by design and are recorded so. On ``card`` the cell's step runs on
a one-rank ``Mesh`` at its shape, ``ogb_products`` cut
(``GNN_CARD_CUTS``, in ``reduced``): wall ms, peak memory.

A cell that fails records its error and the run carries on, as JAX's
does; the exit code counts the failures.

Usage:
    python -m repro_torch.launch.dryrun --list
    python -m repro_torch.launch.dryrun --arch paper-bfs-engine --shape ldbc100 --mesh card
    python -m repro_torch.launch.dryrun --all --mesh both [--subprocess]
    python -m repro_torch.launch.dryrun --arch minicpm-2b --shape prefill_32k --mesh single --components
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time
import traceback

import torch

#: timed runs of a card cell after its cold run (the median is recorded)
REPS = 5
#: device memory of one H100 (NVIDIA H100 Tensor Core GPU datasheet: 80 GB)
HBM_BYTES = 80e9
MESHES = ("single", "multi", "card")


def _bytes_per_node(ec, lanes: int) -> tuple[int, int]:
    """(state bytes, contribution bytes) a node of one morsel: the edge
    compute's state leaves, and its frontier's (the contribution has the
    frontier's layout)."""
    st = ec.init(1, torch.full((lanes,), 1, dtype=torch.int32))
    per = lambda x: x.numel() * x.element_size()
    return sum(per(x) for x in st), per(st.frontier)


def placement(cell) -> dict:
    """Per-device rows, morsels and bytes of a paper cell under its
    placement: graph rows over ``model`` (state rows too in the sharded
    layout), morsels over the source axes."""
    from ..core.edge_compute import EDGE_COMPUTES

    d = cell.decisions
    rows = d["n_pad"] // d["graph_shards"]
    sharded = d["state_layout"] == "sharded"
    state_rows = rows if sharded else d["n_pad"]
    morsels = d["n_morsels"] // d["source_shards"]
    state_b, contrib_b = _bytes_per_node(EDGE_COMPUTES[d["edge_compute"]],
                                         d["lanes"])
    ell = rows * (d["max_deg"] + 1) * 4  # indices and degrees, int32
    return dict(
        rows=rows, state_rows=state_rows, morsels=morsels,
        ell_bytes=ell, state_bytes=state_rows * state_b,
        contribution_bytes=d["n_pad"] * contrib_b,
        argument_bytes=ell + morsels * d["lanes"] * 4,
        output_bytes=morsels * (state_rows * state_b + 4),
    )


def paper_cost(cell) -> dict:
    """Analytic work of one trip of the frontier loop on one device, in
    XLA's cost keys: ``ell_push`` visits every ELL slot of the device's
    rows once a lane (2 FLOPs, as the cell's model FLOPs count them),
    reads the slab, reads and writes the morsel's state and writes and
    reads the ``[n_pad]`` contribution, for each of the device's
    morsels."""
    p = placement(cell)
    d = cell.decisions
    flops = 2.0 * p["rows"] * d["max_deg"] * d["lanes"] * p["morsels"]
    hbm = p["morsels"] * (p["ell_bytes"] + 2 * p["state_bytes"]
                          + 2 * p["contribution_bytes"])
    return {"flops": flops, "bytes accessed": float(hbm)}


def paper_collectives(cell, mesh_shape: dict):
    """The port's collectives in one trip on one device
    (``core.collectives``): the loop condition's int32 MAX all-reduce
    over each sync axis, and the merge of the contribution across the
    graph shards (``ring``: a packed reduce-scatter ring and, replicated,
    an all-gather ring, one ``collective-permute`` a step; ``allgather``:
    the packed words gathered; ``pmax``: a MAX all-reduce), for each of
    the device's morsels. The final gather of the results is left out."""
    from .hlo_analysis import collective_stats

    d = cell.decisions
    p = placement(cell)
    k = d["graph_shards"]
    recs: dict = {}

    def add(kind, group, out_bytes, calls=1):
        r = recs.setdefault(kind, {}).setdefault(group, [0, 0])
        r[0] += calls * p["morsels"]
        r[1] += calls * out_bytes * p["morsels"]

    for a in ("pod", "data", "model"):
        if mesh_shape.get(a, 1) > 1:
            add("all-reduce", mesh_shape[a], 4)
    if k > 1:
        packed = -(-d["n_pad"] * d["lanes"] // 32) * 4
        chunk = -(-packed // 4 // k) * 4
        sharded = d["state_layout"] == "sharded"
        if d["or_impl"] == "ring":
            # reduce-scatter: K - 1 steps (+1 rotation when sharded);
            # replicated: then K - 1 all-gather steps
            steps = k if sharded else 2 * (k - 1)
            add("collective-permute", k, chunk, calls=steps)
        elif d["or_impl"] == "allgather":
            add("all-gather", k, k * packed)
        else:
            add("all-reduce", k, p["contribution_bytes"])
    return collective_stats(recs)


def levels_edges_scanned(levels: torch.Tensor, iterations, degrees) -> int:
    """Edges the engine scanned: in each morsel, a row's out-edges once
    for every trip at which it was on some lane's frontier (its distinct
    levels below the morsel's trip count)."""
    total = 0
    deg = degrees.to(torch.int64)
    for m in range(levels.shape[0]):
        lv = levels[m].to(torch.int16)
        if lv.dim() == 1:
            lv = lv[:, None]
        it = int(iterations[m])
        key = torch.where((lv >= 0) & (lv < it), lv,
                          torch.full_like(lv, -1))
        s = key.sort(dim=1).values
        distinct = (s[:, 0] >= 0).to(torch.int64) + (
            (s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum(dim=1)
        total += int((distinct * deg[: lv.shape[0]]).sum())
    return total


def _cut_cell(arch, shape, mesh, overrides, cut):
    """``build_cell``, with the shape's dims changed by ``cut`` (a
    smaller node count where the host's generator or the card force
    one)."""
    from ..configs import base as cfgbase
    from . import steps

    if not cut:
        return steps.build_cell(arch, shape, mesh, False, **overrides)
    spec = cfgbase.get(arch)
    s = next(x for x in spec.shapes if x.name == shape)
    s = dataclasses.replace(s, dims={**s.dims, **cut})
    return steps._paper_cell(spec, s, mesh, False, **overrides)


def _card_fields(arch, shape, device, overrides, cut, keep,
                 csr=None) -> dict:
    from .hlo_analysis import HBM_BW, collective_stats
    from .mesh import make_mesh
    from . import steps

    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    cell = _cut_cell(arch, shape, mesh, overrides or {}, cut)
    t_build = time.perf_counter() - t0
    if cuda:  # the cell's own bytes: its inputs on, whatever else the
        # process holds off
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if csr is not None and csr.n_nodes != cell.dims["n_nodes"]:
        raise ValueError(f"a graph of {csr.n_nodes} nodes for a cell of "
                         f"{cell.dims['n_nodes']}")
    bound = steps.bind_cell(cell, mesh, csr=csr)
    t_bind = time.perf_counter() - t0 - t_build

    def run():
        t = time.perf_counter()
        res = bound()
        if cuda:
            torch.cuda.synchronize(dev)
        return res, (time.perf_counter() - t) * 1e3

    res, cold_ms = run()
    mesh.wire.reset()
    walls = []
    for _ in range(REPS):
        res, ms = run()
        walls.append(ms)
    peak = int(torch.cuda.max_memory_allocated(dev)) - held if cuda \
        else None
    p = placement(cell)
    arg = bound.argument_bytes
    out = sum(x.numel() * x.element_size() for x in res.state) + \
        res.iterations.numel() * 4
    coll = collective_stats(mesh.wire)
    cost = paper_cost(cell)
    iters = [int(x) for x in res.iterations]
    wall = statistics.median(walls)
    scanned = levels_edges_scanned(res.state.levels, iters,
                                   bound.graph.degrees)
    if keep is not None:
        keep.update(cell=cell, bound=bound, result=res)
    mem = {
        "argument_size_in_bytes": arg,
        "output_size_in_bytes": out,
        "temp_size_in_bytes": None if peak is None
        else max(peak - arg - out, 0),
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": 0,
        "total_bytes_per_device": peak,
    }
    return dict(
        cell=cell, n_devices=mesh.size, memory=mem, cost=cost, coll=coll,
        measured=True, device=str(dev),
        device_name=torch.cuda.get_device_name(dev) if cuda else "cpu",
        build_s=t_build, bind_s=t_bind, cold_ms=cold_ms,
        wall_ms=wall, wall_ms_runs=walls, iterations=iters,
        n_nodes=bound.csr.n_nodes, n_edges_generated=bound.n_edges_generated,
        n_edges_cut=bound.csr.n_edges, edges_scanned=scanned,
        gteps=scanned / (wall / 1e3) / 1e9,
        # the analytic trip's bytes at this run's trip count
        bound_ms=cost["bytes accessed"] * max(iters) / HBM_BW * 1e3,
        state_plus_contribution_bytes=p["state_bytes"]
        + p["contribution_bytes"],
    )


# ----------------------------------------------------------- LM cells ----

#: ``--mesh card`` cuts of the LM cells, ``chip_smoke.py``'s one-card
#: shapes: phase 6b's ``prefill_32k`` 32 x 32,768 to 4 x 4,096 and
#: decode cache 4 x 4,128, phase 8b's ``train_4k`` 256 x 4,096 to 2 x
#: 4,096 (one card; the host wall a reps loop may take)
LM_CARD_CUTS = {"prefill": {"global_batch": 4, "seq_len": 4096},
                "decode": {"global_batch": 4, "seq_len": 4128},
                "train": {"global_batch": 2, "seq_len": 4096}}
LM_CUT_WHY = ("one card: the published batch and length are cut to the "
              "one-card shapes (prefill 4 x 4,096, decode 4 x 4,128, "
              "train 2 x 4,096, its batch rounded up to the arch's "
              "n_micro)")
#: analytic FLOPs a parameter of an AdamW update (moments, bias
#: corrections, the update and the decay)
ADAMW_FLOPS = 12


def _prod(xs) -> int:
    return int(math.prod(int(x) for x in xs))


def _dev_bytes(t, spec, mesh_shape) -> int:
    """Bytes of one device's block of ``t`` (meta) under ``spec``."""
    from ..models.transformer_mesh import block_numel

    return block_numel(tuple(t.shape), tuple(spec), mesh_shape) * \
        t.element_size()


def _tree_bytes(tree, specs, mesh_shape) -> int:
    """A (meta tensor, spec) tree's per-device bytes: dicts by key,
    lists and NamedTuples by position, a tensor and its spec."""
    if isinstance(tree, torch.Tensor):
        return _dev_bytes(tree, specs, mesh_shape)
    if isinstance(tree, dict):
        return sum(_tree_bytes(tree[k], specs[k], mesh_shape) for k in tree)
    return sum(_tree_bytes(a, b, mesh_shape) for a, b in zip(tree, specs))


def _lm_rows(cell, mesh_shape) -> int:
    """A device's batch rows (the batch over the data axes when it
    divides them)."""
    b = cell.dims["global_batch"]
    data = int(_prod(mesh_shape.get(a, 1)
                       for a in cell.decisions["batch_axes"]))
    return b // data if b % data == 0 else b


def _lm_schedule(cell, mesh_shape) -> dict:
    """``transformer_mesh.collective_schedule`` of an LM cell (a train
    cell's rows a microbatch)."""
    from ..models import transformer_mesh as tmesh
    from ..nn.module import sharding_rules

    cfg = cell.config
    specs = cell.in_shardings[0]
    shapes = {n: tuple(t.shape) for n, t in cell.args[0].items()}
    n_micro = cell.decisions.get("n_micro", 1)
    rules = sharding_rules(len(cell.decisions["batch_axes"]) > 1,
                           cell.kind != "decode")
    return tmesh.collective_schedule(
        cfg, cell.kind, _lm_rows(cell, mesh_shape) // n_micro,
        cell.dims["seq_len"], mesh_shape, rules, specs, shapes,
        cell.decisions.get("seq_axes", ("model",)), n_micro)


def lm_cost(cell, mesh_shape) -> dict:
    """Analytic per-device work of an LM cell, in XLA's cost keys: the
    model FLOPs over the devices (a train step's forward counted again
    for the remat recompute, plus AdamW's ``ADAMW_FLOPS`` a parameter),
    and bytes: each layer's weights read once as gathered (sharded over
    ``model`` only), the device's cache written (prefill) or read
    (decode), its logits written; a train step reads the weights three
    times (forward, recompute, backward) and AdamW reads and writes the
    parameters and both moments and reads the gradients."""
    cfg, dims = cell.config, cell.dims
    n_dev = _prod(mesh_shape.values())
    params, pshard = cell.args[0], cell.in_shardings[0]
    m = mesh_shape.get("model", 1)
    el = params["embed.table"].element_size()
    w_bytes = sum(_dev_bytes(t, pshard[n], {"model": m})
                  for n, t in params.items())
    p_dev = _tree_bytes(params, pshard, mesh_shape)
    rows = _lm_rows(cell, mesh_shape)
    flops = cell.model_flops / n_dev
    if cell.kind == "train":
        fwd = cell.model_flops / 3.0
        n_p = sum(t.numel() for t in params.values())
        flops = (cell.model_flops + fwd) / n_dev + ADAMW_FLOPS * n_p / n_dev
        mom = cell.args[1].mu["embed.table"].element_size()
        opt = p_dev / el * (3 * el + 4 * mom + 4)  # p rw, mu nu rw, g f32
        return {"flops": flops, "bytes accessed": float(3 * w_bytes + opt)}
    logits = rows * cfg.vocab_padded // m * 4
    cache = 0
    if cell.kind == "decode":
        cache = _tree_bytes(cell.args[1], cell.in_shardings[1], mesh_shape)
    else:
        s = dims["seq_len"]
        for i in range(cfg.n_layers):
            at = cfg.attn_settings(cfg.layer_kind(i))
            w = min(at.window, s) if at.kind in ("local", "chunk") else s
            cache += 2 * rows * w * at.n_kv_heads * at.d_head * el
        seq_k = _prod(mesh_shape.get(a, 1)
                        for a in cell.decisions["seq_axes"])
        cache //= seq_k
    return {"flops": flops, "bytes accessed": float(w_bytes + cache
                                                    + logits)}


def lm_collectives(cell, mesh_shape):
    """The port's collectives in one step of an LM cell on one device:
    the cell's schedule (``transformer_mesh.collective_schedule``)."""
    from ..models.transformer_mesh import merge_records
    from .hlo_analysis import collective_stats

    sch = _lm_schedule(cell, mesh_shape)
    return collective_stats(merge_records(sch["global"], *sch["layers"],
                                          sch["final"]))


def _lm_placement(cell, mesh_shape) -> dict:
    """Per-device argument and output bytes of an LM cell under its
    specs (outputs: a train step's new parameters and moments, a
    prefill's last logits and caches, a decode step's logits and
    caches)."""
    arg = _tree_bytes(cell.args, cell.in_shardings, mesh_shape)
    rows = _lm_rows(cell, mesh_shape)
    m = mesh_shape.get("model", 1)
    logits = rows * cell.config.vocab_padded // m * 4
    if cell.kind == "train":
        out = _tree_bytes(cell.args[:2], cell.in_shardings[:2], mesh_shape)
    elif cell.kind == "decode":
        out = logits + _tree_bytes(cell.args[1], cell.in_shardings[1],
                                   mesh_shape)
    else:
        out = logits + _tree_bytes(
            _prefill_cache_args(cell), cell.decisions["out_specs"][1],
            mesh_shape)
    return {"argument_bytes": arg, "output_bytes": out}


def _prefill_cache_args(cell) -> list:
    """The prefill's caches (meta), as the decode cell of its batch and
    length holds them."""
    from ..models import transformer as tfm

    return tfm.init_model_cache(cell.config, cell.dims["global_batch"],
                                cell.dims["seq_len"], torch.bfloat16,
                                "meta")


def _lm_layout_fields(arch, shape, mesh_tag) -> dict:
    from .mesh import make_production_mesh
    from . import steps

    multi = mesh_tag == "multi"
    layout = make_production_mesh(multi_pod=multi)
    cell = steps.build_cell(arch, shape, layout, multi)
    p = _lm_placement(cell, layout.shape)
    mem = {
        "argument_size_in_bytes": p["argument_bytes"],
        "output_size_in_bytes": p["output_bytes"],
        "temp_size_in_bytes": None,
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": None,
        "total_bytes_per_device": p["argument_bytes"] + p["output_bytes"],
    }
    return dict(cell=cell, n_devices=layout.size, memory=mem,
                cost=lm_cost(cell, layout.shape),
                coll=lm_collectives(cell, layout.shape), measured=False)


def lm_card_cut(arch: str, kind: str) -> dict:
    """``LM_CARD_CUTS[kind]``, a train batch rounded up to the arch's
    ``n_micro`` (the cell splits the batch into that many blocks)."""
    from .steps import _N_MICRO

    cut = dict(LM_CARD_CUTS[kind])
    if kind == "train":
        n = _N_MICRO.get(arch, 1)
        cut["global_batch"] = -(-cut["global_batch"] // n) * n
    return cut


def lm_state_bytes(cell) -> int:
    """The bytes a one-rank LM cell holds before its activations: the
    parameters, a train step's AdamW moments and gradients (float32 sums
    too when it accumulates microbatches), a serving cell's caches."""
    params = cell.args[0]
    n = sum(t.numel() for t in params.values())
    total = sum(t.numel() * t.element_size() for t in params.values())
    if cell.kind == "train":
        mom = cell.args[1].mu["embed.table"].element_size()
        el = params["embed.table"].element_size()
        total += n * (2 * mom + el + (4 if cell.decisions["n_micro"] > 1
                                      else 0))
    else:
        caches = (cell.args[1] if cell.kind == "decode"
                  else _prefill_cache_args(cell))
        total += sum(t.numel() * t.element_size() for c in caches
                     for t in c)
    return int(total)


def _lm_card_fields(arch, shape, device, cut, keep) -> dict:
    """A dense cell on a one-rank ``Mesh`` of the card, at ``cut``
    (default ``LM_CARD_CUTS``): seeded weights (``transformer.init``,
    seed 0) and tokens, one cold call, then ``REPS`` timed calls (a
    decode step at position ``seq_len - 32`` against empty caches: the
    same work as a full cache, every slot scored; a train step on one
    seeded batch, from fresh AdamW moments)."""
    import numpy as np

    from ..configs import base as cfgbase
    from ..kernels.flash_attention import flash_attention as fa
    from ..models import transformer as tfm
    from ..models import transformer_mesh as tmesh
    from ..nn import attention as attn
    from ..optim.adamw import AdamWConfig, adamw_init
    from .hlo_analysis import HBM_BW, PEAK_FLOPS, collective_stats
    from .mesh import make_mesh
    from . import steps

    spec = cfgbase.get(arch)
    s = next(x for x in spec.shapes if x.name == shape)
    s = dataclasses.replace(s, dims={**s.dims, **cut})
    mesh = make_mesh((1, 1), ("data", "model"), device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    cell = steps._lm_cell(spec, s, mesh, False)
    need = lm_state_bytes(cell)
    if need > HBM_BYTES:
        raise ValueError(f"{arch} {shape}: its state needs {need:,} bytes "
                         f"({need / 1e9:.1f} GB: parameters, and moments "
                         "and gradients to train), more than one card's "
                         f"{HBM_BYTES / 1e9:.0f} GB")
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    model = tfm.init(cell.config, torch.Generator(device=dev).manual_seed(0),
                     dev)
    steps.shard_lm(cell, model, mesh)
    b, seq = cell.dims["global_batch"], cell.dims["seq_len"]
    rng = np.random.default_rng(0)
    cfg = cell.config
    caches = None
    if cell.kind == "train":
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, seq + 1))).to(
            dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        model.requires_grad_(True)
        opt = adamw_init(steps.params_dict(model), AdamWConfig(
            moment_dtype=steps._moment_dtype(cfg)))

        def call():
            return cell.fn(model, opt, batch)[2:]
    elif cell.kind == "prefill":
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, seq))).to(
            dev)

        def call():
            return cell.fn(model, tokens)
    else:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1))).to(dev)
        caches = tmesh.init_cache(cfg, b, seq, mesh,
                                  cell.decisions["seq_axes"])

        def call():
            return cell.fn(model, caches, tokens, seq - 32)
    t_bind = time.perf_counter() - t0

    def run():
        t = time.perf_counter()
        res = call()
        if cuda:
            torch.cuda.synchronize(dev)
        return res, (time.perf_counter() - t) * 1e3

    launches = fa.flash_attention.launches
    routes = dict(attn.route_calls)
    res, cold_ms = run()
    launches = fa.flash_attention.launches - launches
    routes = {k: v - routes[k] for k, v in attn.route_calls.items()}
    mesh.wire.reset()
    walls = []
    for _ in range(REPS):
        res, ms = run()
        walls.append(ms)
    peak = int(torch.cuda.max_memory_allocated(dev)) - held if cuda \
        else None
    p = _lm_placement(cell, mesh.shape)
    wall = statistics.median(walls)
    tokens_run = b if cell.kind == "decode" else b * seq
    if keep is not None:
        keep.update(cell=cell, model=model, result=res, caches=caches)
    cost = lm_cost(cell, mesh.shape)
    mem = {
        "argument_size_in_bytes": p["argument_bytes"],
        "output_size_in_bytes": p["output_bytes"],
        "temp_size_in_bytes": None if peak is None
        else max(peak - p["argument_bytes"] - p["output_bytes"], 0),
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": 0,
        "total_bytes_per_device": peak,
    }
    return dict(
        cell=cell, n_devices=1, memory=mem, cost=cost,
        coll=collective_stats(mesh.wire), measured=True, device=str(dev),
        device_name=torch.cuda.get_device_name(dev) if cuda else "cpu",
        bind_s=t_bind, cold_ms=cold_ms, wall_ms=wall, wall_ms_runs=walls,
        tokens_per_s=tokens_run / (wall / 1e3),
        mha_launches=launches, route_calls=routes,
        bound_ms=max(cost["flops"] / PEAK_FLOPS, cost["bytes accessed"]
                     / HBM_BW) * 1e3,
    )


# ------------------------------------------------- GNN and recsys cells ----

#: ``--mesh card`` cuts of the GNN cells: ``ogb_products`` (2,449,029
#: nodes, 61.9M edges; 37 GB of PNA messages a layer) to a thousandth
GNN_CARD_CUTS = {"ogb_products": {"n_nodes": 2449, "n_edges": 61859}}
GNN_CUT_WHY = ("one card: ogb_products needs several (its messages and "
               "EquiformerV2's per-edge irrep tensors exceed 80 GB); cut to "
               "a thousandth of its nodes and edges, d_feat kept")


def _edge_width(cell) -> int:
    """Elements an edge of a GNN cell's main per-layer message tensor:
    PNA's and SchNet's ``d_hidden``, MACE's and EquiformerV2's irreps
    ``(l_max + 1)^2 x d_hidden``."""
    cfg = cell.config
    if cell.arch_id in ("pna", "schnet"):
        return cfg.d_hidden
    return (cfg.l_max + 1) ** 2 * cfg.d_hidden


def _gnn_layers(cell) -> int:
    cfg = cell.config
    return cfg.n_interactions if cell.arch_id == "schnet" else cfg.n_layers


def _rank_edges(cell, mesh_shape) -> int:
    return cell.decisions["e_pad"] // _prod(mesh_shape.values())


def family_placement(cell, mesh_shape) -> dict:
    """Per-device argument and output bytes of a GNN or recsys cell under
    its specs (outputs: a train step's new parameters and moments with
    its loss and norm, a serve step's logits block, a retrieval step's
    top ``k`` values and int64 indices), and a GNN cell's per-edge
    message tensor of the device's edges."""
    from . import steps

    arg = _tree_bytes(cell.args, cell.in_shardings, mesh_shape)
    out = {"argument_bytes": arg}
    if cell.kind == "retrieval":
        out["output_bytes"] = steps.RETRIEVAL_TOP_K * 12
    elif cell.kind in ("serve", "bulk"):
        out["output_bytes"] = _dev_bytes(cell.args[1]["dense"][:, 0],
                                         cell.in_shardings[1]["dense"][:1],
                                         mesh_shape)
    else:
        out["output_bytes"] = _tree_bytes(cell.args[:2],
                                          cell.in_shardings[:2],
                                          mesh_shape) + 8
    if cell.decisions.get("e_pad") is not None:
        out["edge_tensor_bytes"] = _rank_edges(cell, mesh_shape) * \
            _edge_width(cell) * 4
    return out


def family_cost(cell, mesh_shape) -> dict:
    """Analytic per-device work of a GNN or recsys step, in XLA's cost
    keys: the model FLOPs over the devices (a train step adds AdamW's
    ``ADAMW_FLOPS`` a parameter); bytes: the arguments read and the
    outputs written, and for a GNN each layer's message tensor of the
    device's edges written and read, three times in a train step
    (forward, backward's read and write)."""
    n_dev = _prod(mesh_shape.values())
    p = family_placement(cell, mesh_shape)
    flops = cell.model_flops / n_dev
    nbytes = p["argument_bytes"] + p["output_bytes"]
    if cell.kind not in ("serve", "bulk", "retrieval"):
        n_p = sum(t.numel() for t in cell.args[0].values())
        flops += ADAMW_FLOPS * n_p / n_dev
    if "edge_tensor_bytes" in p:
        nbytes += 2 * 3 * _gnn_layers(cell) * p["edge_tensor_bytes"]
    return {"flops": flops, "bytes accessed": float(nbytes)}


def family_collectives(cell, mesh_shape):
    """The family's analytic schedule of one step on one device, by
    kind (``steps.gnn_collective_schedule`` /
    ``recsys_collective_schedule``)."""
    from . import steps
    from .hlo_analysis import collective_stats

    sched = (steps.gnn_collective_schedule if cell.decisions.get("e_pad")
             is not None else steps.recsys_collective_schedule)
    return collective_stats(steps.schedule_by_kind(
        sched(cell, mesh_shape), mesh_shape))


def _family_layout_fields(arch, shape, mesh_tag) -> dict:
    from .mesh import make_production_mesh
    from . import steps

    multi = mesh_tag == "multi"
    layout = make_production_mesh(multi_pod=multi)
    cell = steps.build_cell(arch, shape, layout, multi)
    p = family_placement(cell, layout.shape)
    total = p["argument_bytes"] + p["output_bytes"] + p.get(
        "edge_tensor_bytes", 0)
    mem = {
        "argument_size_in_bytes": p["argument_bytes"],
        "output_size_in_bytes": p["output_bytes"],
        "temp_size_in_bytes": None,
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": None,
        "total_bytes_per_device": total,
    }
    extra = {}
    if "edge_tensor_bytes" in p:
        extra = dict(edge_tensor_bytes=p["edge_tensor_bytes"],
                     edges_a_device=_rank_edges(cell, layout.shape))
    return dict(cell=cell, n_devices=layout.size, memory=mem,
                cost=family_cost(cell, layout.shape),
                coll=family_collectives(cell, layout.shape), measured=False,
                **extra)


def _family_card_fields(arch, shape, device, cut, keep) -> dict:
    """A GNN or recsys cell's step on a one-rank ``Mesh`` of the card at
    its shape (``cut`` changes the dims): seeded weights (seed 0) and
    batch (``steps.cell_batch``/``recsys_batch``, seeded candidates),
    one cold call, then ``REPS`` timed calls."""
    from ..configs import base as cfgbase
    from ..optim.adamw import adamw_init
    from .hlo_analysis import HBM_BW, PEAK_FLOPS, collective_stats
    from .mesh import make_mesh
    from . import steps

    mesh = make_mesh((1, 1), ("data", "model"), device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    cell = steps.build_cell(arch, shape, mesh, False, dims=cut or None)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gnn = cfgbase.get(arch).family == "gnn"
    if gnn:
        gc = steps.gnn_cell(arch, shape, dims=cut or None)
        model = steps.shard_gnn(cell, steps.init_model(gc, gen, dev), mesh)
        batch, _ = steps.gnn_rank_batch(
            cell, mesh, steps.pad_gnn_batch(cell, steps.cell_batch(gc)))
        opt = adamw_init(steps.params_dict(model), steps.GNN_ADAMW)
        args = (model, opt, batch)
    else:
        rc = steps.recsys_cell(arch, shape, dims=cut or None)
        model = steps.dcn.init(rc.cfg, gen, dev)[0]
        if rc.kind == "train":
            model.requires_grad_(True)
        steps.shard_recsys(cell, model, mesh)
        cand = None
        if rc.kind == "retrieval":
            cand = torch.randn(
                (cell.decisions["n_candidates_padded"], rc.cfg.retrieval_dim),
                generator=gen, device=dev)
        batch, cand = steps.recsys_rank_batch(
            cell, mesh, steps.recsys_batch(rc), cand)
        args = (model,)
        if rc.kind == "train":
            args += (adamw_init(steps.params_dict(model),
                                steps.RECSYS_ADAMW),)
        args += (batch,) + ((cand,) if cand is not None else ())
    t_bind = time.perf_counter() - t0

    def run():
        t = time.perf_counter()
        res = cell.fn(*args)
        if cuda:
            torch.cuda.synchronize(dev)
        return res, (time.perf_counter() - t) * 1e3

    res, cold_ms = run()
    mesh.wire.reset()
    walls = []
    for _ in range(REPS):
        res, ms = run()
        walls.append(ms)
    peak = int(torch.cuda.max_memory_allocated(dev)) - held if cuda \
        else None
    p = family_placement(cell, mesh.shape)
    cost = family_cost(cell, mesh.shape)
    wall = statistics.median(walls)
    if keep is not None:
        keep.update(cell=cell, model=model, result=res)
    mem = {
        "argument_size_in_bytes": p["argument_bytes"],
        "output_size_in_bytes": p["output_bytes"],
        "temp_size_in_bytes": None if peak is None
        else max(peak - p["argument_bytes"] - p["output_bytes"], 0),
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": 0,
        "total_bytes_per_device": peak,
    }
    return dict(
        cell=cell, n_devices=1, memory=mem, cost=cost,
        coll=collective_stats(mesh.wire), measured=True, device=str(dev),
        device_name=torch.cuda.get_device_name(dev) if cuda else "cpu",
        bind_s=t_bind, cold_ms=cold_ms, wall_ms=wall, wall_ms_runs=walls,
        bound_ms=max(cost["flops"] / PEAK_FLOPS, cost["bytes accessed"]
                     / HBM_BW) * 1e3,
    )


def _layout_fields(arch, shape, mesh_tag, overrides) -> dict:
    from .mesh import make_production_mesh
    from . import steps

    layout = make_production_mesh(multi_pod=mesh_tag == "multi")
    cell = steps.build_cell(arch, shape, layout, mesh_tag == "multi",
                            **(overrides or {}))
    p = placement(cell)
    mem = {
        "argument_size_in_bytes": p["argument_bytes"],
        "output_size_in_bytes": p["output_bytes"],
        "temp_size_in_bytes": None,
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": None,
        # arguments and outputs: a floor, the temporaries unknown
        "total_bytes_per_device": p["argument_bytes"] + p["output_bytes"],
    }
    return dict(cell=cell, n_devices=layout.size, memory=mem,
                cost=paper_cost(cell),
                coll=paper_collectives(cell, layout.shape), measured=False,
                state_plus_contribution_bytes=p["state_bytes"]
                + p["contribution_bytes"])


def run_cell(arch: str, shape: str, mesh_tag: str, out_dir: str,
             force: bool = False, tag: str = "",
             overrides: dict | None = None, device=None,
             cut: dict | None = None, keep: dict | None = None,
             csr=None) -> dict:
    """One cell's record (written to ``out_dir``; a cached record is
    returned unless ``force``). ``mesh_tag`` is ``single``, ``multi``
    (analytic) or ``card`` (run on ``device``, ``cuda`` unless the caller
    passes ``"cpu"``; ``cut`` changes the shape's dims; ``keep``, if
    given, receives the cell, the bound inputs and the result). A paper
    cell on the ``card`` binds ``csr`` if given (the shape's seeded graph
    at the cell's node count, made beforehand; its ``bind_s`` then leaves
    the generation out), else generates it."""
    from .hlo_analysis import roofline_terms

    name = f"{arch}__{shape}__{mesh_tag}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, name + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        print(f"[skip] {name}: cached ({rec.get('status')})")
        return rec
    from ..configs import base as cfgbase

    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_tag,
        "status": "error", "tag": tag,
    }
    if cut:
        rec["reduced"] = dict(cut)
    try:
        if mesh_tag not in MESHES:
            raise ValueError(f"unknown mesh {mesh_tag!r}: one of {MESHES}")
        family = cfgbase.get(arch).family
        lm = family == "lm"
        if mesh_tag == "card" and family in ("gnn", "recsys"):
            if not cut and shape in GNN_CARD_CUTS and family == "gnn":
                cut = dict(GNN_CARD_CUTS[shape])
                rec["reduced"] = dict(cut, why=GNN_CUT_WHY)
            f = _family_card_fields(arch, shape, device, cut, keep)
        elif family in ("gnn", "recsys"):
            f = _family_layout_fields(arch, shape, mesh_tag)
        elif mesh_tag == "card" and lm:
            kind = next(x.kind for x in cfgbase.get(arch).shapes
                        if x.name == shape)
            if not cut and kind in LM_CARD_CUTS:
                cut = lm_card_cut(arch, kind)
                rec["reduced"] = dict(cut, why=LM_CUT_WHY)
            f = _lm_card_fields(arch, shape, device, cut or {}, keep)
        elif mesh_tag == "card":
            f = _card_fields(arch, shape, device, overrides, cut, keep,
                             csr)
        elif lm:
            f = _lm_layout_fields(arch, shape, mesh_tag)
        else:
            f = _layout_fields(arch, shape, mesh_tag, overrides)
        cell, coll, mem = f.pop("cell"), f.pop("coll"), f.pop("memory")
        cost, n_dev, measured = f.pop("cost"), f.pop("n_devices"), \
            f.pop("measured")
        rl = roofline_terms(cost, coll, n_dev, cell.model_flops,
                            cell.iters_scale)
        rec.update(
            status="ok",
            kind=cell.kind,
            notes=cell.notes,
            decisions=_jsonable(cell.decisions),
            n_devices=n_dev,
            memory=mem,
            cost=cost,
            measured=measured,
            collective_counts=None if not measured else
            {k: v for k, v in coll.counts.items() if v},
            collective_out_bytes=None if not measured else
            {k: v for k, v in coll.out_bytes.items() if v},
            collective_wire_bytes=None if not measured else
            {k: v for k, v in coll.wire_bytes.items() if v},
            roofline=rl.as_dict(),
            **f,
        )
        total = mem["total_bytes_per_device"]
        fit = total is None or total <= HBM_BYTES
        rec["fits_80g_hbm"] = None if total is None else bool(fit)
        print(
            f"[ok]   {name}: {cell.notes}  mem/dev "
            + ("not measured" if total is None else
               f"{total / 1e9:.3f} GB{'' if fit else ' (EXCEEDS 80G)'}")
            + (f"  wall {rec['wall_ms']:.2f} ms"
               + (f" iters {max(rec['iterations'])} {rec['gteps']:.3f} GTEPS"
                  if "gteps" in rec else
                  f" {rec['tokens_per_s']:.0f} tokens/s"
                  if "tokens_per_s" in rec else "")
               if mesh_tag == "card" else "")
            + f"  dominant={rl.dominant} terms c/m/x = {rl.compute_s:.2e}/"
            f"{rl.memory_s:.2e}/{rl.collective_s:.2e} s"
        )
    except Exception as e:  # noqa: BLE001: record and carry on, as JAX's
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {name}: {rec['error']}")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def _jsonable(x):
    """Decisions as JSON: tuples as lists, NamedTuples as dicts."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if hasattr(x, "_asdict"):
        return {k: _jsonable(v) for k, v in x._asdict().items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def component_terms(c, mesh_shape) -> dict:
    """The port's analytic FLOPs, bytes and collective records of one
    ``steps.lm_components`` entry, one trip on one device:

    - ``layer_group_prefill`` / ``decode_group``: the group's layers of
      the prefill or decode schedule (``collective_schedule``); FLOPs
      2 x the group's weights a token plus its attention (``_lm_attn_
      flops`` of the group's layers), over the devices; bytes: the
      group's weights as gathered, the activations read and written, the
      device's cache written or read;
    - ``layer_group_fwd_bwd``: the group's layers of the train schedule
      (the forward, its recompute and the transposes; an MoE layer's
      counts and aux sums without a transpose); FLOPs 4 x the
      forward's (forward, recompute, backward);
    - ``ce_chunk``: logits of one chunk forward and backward (6 x its
      tokens x vocab x d_model), the table read, the chunk's logits
      written and read in float32; the table's FSDP gather, and the
      vocab-parallel softmax's max and sum over ``model``;
    - ``optimizer``: ``ADAMW_FLOPS`` a parameter, AdamW's bytes;
    - ``unembed``: the table read and the logits written, the table's
      FSDP gather (and, for a prefill, the last position's gather)."""
    from ..models import transformer_mesh as tmesh
    from ..nn.module import param_specs, sharding_rules
    from . import steps

    cfg, dims = c.config, c.dims
    key = c.decisions["component"]
    n_dev = _prod(mesh_shape.values())
    m = mesh_shape.get("model", 1)
    ba = c.decisions["batch_axes"]
    B, S = dims["global_batch"], dims["seq_len"]
    data = _prod(mesh_shape.get(a, 1) for a in ba)
    rows = B // data if B % data == 0 else B
    el = torch.tensor([], dtype=cfg.dtype).element_size()
    d = cfg.d_model
    kind = "decode" if key in ("decode_group",) or (
        key == "unembed" and c.notes == "unembed token") else "prefill"
    model = steps.tfm.init(cfg, None, "meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rules = sharding_rules(len(ba) > 1, kind == "prefill")
    specs = param_specs(model, rules, mesh_shape)
    seq_axes, _ = tmesh.decode_seq_axes(B, mesh_shape, ba)
    sch = tmesh.collective_schedule(cfg, kind, rows, S, mesh_shape, rules,
                                    specs, shapes, seq_axes)
    gs = cfg.group_size
    group = [n for n in shapes if n.startswith("blocks.")
             and int(n.split(".")[1]) < gs]
    w_group = sum(tmesh.block_numel(shapes[n], specs[n], {"model": m})
                  for n in group) * el
    n_group = sum(_active_layer_params(cfg, j) for j in range(gs))
    tok = B * (S if kind == "prefill" else 1)
    if key in ("layer_group_prefill", "decode_group",
               "layer_group_fwd_bwd"):
        attn = 0.0
        for j in range(gs):
            one = dataclasses.replace(cfg, n_layers=1,
                                      layer_pattern=(cfg.layer_kind(j),))
            attn += steps._lm_attn_flops(
                one, B, S, cache_w=S if kind == "decode" else None)
        flops = (2.0 * n_group * tok + attn) / n_dev
        recs = tmesh.merge_records(*sch["layers"][:gs])
        act = 2 * tok // (data if B % data == 0 else 1) * d * el
        cache = 0
        for j in range(gs):
            at = cfg.attn_settings(cfg.layer_kind(j))
            w = min(at.window, S) if at.kind in ("local", "chunk") else S
            cache += 2 * rows * w * at.n_kv_heads * at.d_head * 2
        cache //= _prod(mesh_shape.get(a, 1) for a in seq_axes)
        nbytes = w_group + act + cache
        if key == "layer_group_fwd_bwd":  # one microbatch's layers
            flops *= 4.0
            recs = tmesh.merge_records(*tmesh.collective_schedule(
                cfg, "train", rows, S, mesh_shape, rules, specs,
                shapes)["layers"][:gs])
            nbytes = 3 * w_group + 4 * act
    elif key == "ce_chunk":
        C = min(cfg.ce_chunk, S)
        tname = "embed.table" if cfg.tie_embeddings else "unembed.table"
        table = tmesh.block_numel(shapes[tname], specs[tname], {"model": m})
        flops = 6.0 * B * C * cfg.vocab_padded * d / n_dev
        logits = rows * C * cfg.vocab_padded // m * 4
        nbytes = table * el * 2 + 2 * logits
        recs = {}
        tmesh._add(recs, "all-gather", mesh_shape.get(ba[-1], 1),
                   table * el)
        tmesh._add(recs, "all-reduce", m, rows * C * 4, calls=2)
        recs = tmesh.merge_records(recs, tmesh.transpose(
            {k: v for k, v in recs.items() if k == "all-gather"}))
    elif key == "optimizer":
        n_p = sum(int(_prod(v)) for v in shapes.values())
        flops = ADAMW_FLOPS * n_p / n_dev
        mom = steps._moment_dtype(cfg).itemsize
        nbytes = n_p / n_dev * (3 * el + 4 * mom + 4)
        recs = {}
    elif key == "unembed":
        tname = "embed.table" if cfg.tie_embeddings else "unembed.table"
        table = tmesh.block_numel(shapes[tname], specs[tname], {"model": m})
        flops = 2.0 * B * d * cfg.vocab_padded / n_dev
        nbytes = table * el + rows * cfg.vocab_padded // m * 4
        recs = tmesh.merge_records(sch["global"], sch["final"])
        if kind == "prefill":  # the embedding lookup is not in this probe
            recs = {k: v for k, v in recs.items() if k != "reduce-scatter"}
    else:
        raise ValueError(key)
    return {"flops": float(flops), "bytes": float(nbytes), "records": recs}


def _active_layer_params(cfg, j: int) -> int:
    """Layer ``j``'s active parameters (``TransformerConfig.
    active_params``'s per-layer terms: top-k and shared experts only)."""
    d, hd = cfg.d_model, cfg.d_head
    n = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    if cfg.layer_is_moe(j):
        m = cfg.moe
        return n + 3 * d * m.d_ff * (m.top_k + m.n_shared) + d * m.n_experts
    return n + 3 * d * cfg.d_ff


def run_components(arch: str, shape: str, mesh_tag: str, out_dir: str,
                   force: bool = False) -> dict:
    """Compositional roofline of an LM cell (``steps.lm_components``):
    sums trips x per-component terms. JAX asks XLA's cost analysis of
    each compiled component; the port counts each analytically
    (``component_terms``), its wire from the port's own collective
    schedule. Analytic layouts only (``single``, ``multi``)."""
    from .hlo_analysis import HBM_BW, NVLINK_BW, PEAK_FLOPS, collective_stats
    from .mesh import make_production_mesh
    from .steps import build_cell, lm_components

    if mesh_tag not in ("single", "multi"):
        raise ValueError(f"--components counts JAX's production layouts "
                         f"(single, multi), not {mesh_tag!r}")
    name = f"{arch}__{shape}__{mesh_tag}__comp"
    path = os.path.join(out_dir, name + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        print(f"[skip] {name}: cached ({rec.get('status')})")
        return rec
    multi_pod = mesh_tag == "multi"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
           "tag": "comp", "status": "error"}
    try:
        layout = make_production_mesh(multi_pod=multi_pod)
        mono = build_cell(arch, shape, layout, multi_pod)
        comps = lm_components(arch, shape, layout, multi_pod)
        total = {"flops": 0.0, "bytes": 0.0, "wire": 0.0}
        breakdown = []
        for c in comps:
            t = component_terms(c, layout.shape)
            coll = collective_stats(t["records"])
            f = t["flops"] * c.iters_scale
            b = t["bytes"] * c.iters_scale
            w = coll.total_wire_bytes * c.iters_scale
            total["flops"] += f
            total["bytes"] += b
            total["wire"] += w
            breakdown.append({
                "component": c.notes, "trips": c.iters_scale,
                "flops": f, "bytes": b, "wire": w,
                "collectives": {k: v for k, v in coll.counts.items() if v},
            })
        terms = {
            "compute_s": total["flops"] / PEAK_FLOPS,
            "memory_s": total["bytes"] / HBM_BW,
            "collective_s": total["wire"] / NVLINK_BW,
        }
        dom = max(terms, key=terms.get).replace("_s", "")
        model_fpd = mono.model_flops / layout.size
        bound = max(terms.values())
        rec.update(
            status="ok",
            measured=False,
            n_devices=layout.size,
            components=breakdown,
            roofline={
                "flops_per_device": total["flops"],
                "hbm_bytes_per_device": total["bytes"],
                "wire_bytes_per_device": total["wire"],
                **terms,
                "dominant": dom,
                "model_flops_per_device": model_fpd,
                "useful_fraction": model_fpd / max(total["flops"], 1.0),
                "roofline_fraction": (model_fpd / PEAK_FLOPS)
                / max(bound, 1e-30),
                "iters_scale": 1.0,
            },
        )
        rl = rec["roofline"]
        print(f"[ok]   {name}: flops/dev {rl['flops_per_device']:.3e} "
              f"useful {rl['useful_fraction']:.2f} dominant={dom} terms "
              f"c/m/x = {terms['compute_s']:.2e}/{terms['memory_s']:.2e}/"
              f"{terms['collective_s']:.2e} s roofline "
              f"{rl['roofline_fraction'] * 100:.1f}%")
    except Exception as e:  # noqa: BLE001: record and carry on, as JAX's
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {name}: {rec['error']}")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def iter_cells():
    from ..configs import base as cfgbase

    return cfgbase.all_cells()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both", "card"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag for perf sweeps")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--subprocess", action="store_true",
                    help="isolate each cell in a fresh process")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--override", action="append", default=[],
                    help="key=value cell overrides (paper cells: "
                    "state_layout, or_impl)")
    ap.add_argument("--components", action="store_true",
                    help="compositional roofline for LM cells")
    ap.add_argument("--device", default=None,
                    help="--mesh card: the card (default cuda) or cpu")
    args = ap.parse_args(argv)

    cells, skips = iter_cells()
    if args.list:
        for a, s in cells:
            print(f"{a:28s} {s}")
        for a, s, why in skips:
            print(f"{a:28s} {s}  [SKIP: {why}]")
        return 0
    if args.components and args.mesh == "card":
        ap.error("--components counts JAX's production layouts (--mesh "
                 "single, multi or both); --mesh card measures a cell")

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        overrides[k] = v

    if args.all:
        todo = [(a, s, m) for a, s in cells for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    if args.components:
        from ..configs import base as cfgbase

        lm = [(a, s, m) for a, s, m in todo if cfgbase.get(a).family == "lm"]
        if not lm:
            ap.error("--components takes LM cells")
        for arch, shape, mesh_tag in lm:
            rec = run_components(arch, shape, mesh_tag, args.out,
                                 force=args.force)
            failures += rec.get("status") != "ok"
        print(f"done: {len(lm) - failures}/{len(lm)} ok")
        return 1 if failures else 0
    for arch, shape, mesh_tag in todo:
        if args.subprocess:
            import subprocess

            name = f"{arch}__{shape}__{mesh_tag}"
            path = os.path.join(
                args.out,
                name + (f"__{args.tag}" if args.tag else "") + ".json",
            )
            if os.path.exists(path) and not args.force:
                with open(path) as f:
                    rec = json.load(f)
                print(f"[skip] {name}: cached ({rec.get('status')})")
                failures += rec.get("status") != "ok"
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_tag,
                   "--out", args.out]
            if args.force:
                cmd.append("--force")
            if args.tag:
                cmd += ["--tag", args.tag]
            if args.device:
                cmd += ["--device", args.device]
            for kv in args.override:
                cmd += ["--override", kv]
            try:
                r = subprocess.run(cmd, timeout=args.timeout)
                failures += r.returncode != 0
            except subprocess.TimeoutExpired:
                print(f"[FAIL] {name}: timeout {args.timeout}s")
                os.makedirs(args.out, exist_ok=True)
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "mesh": mesh_tag, "status": "error",
                               "error": f"timeout {args.timeout}s"}, f)
                failures += 1
        else:
            rec = run_cell(arch, shape, mesh_tag, args.out,
                           force=args.force, tag=args.tag,
                           overrides=overrides, device=args.device)
            failures += rec.get("status") != "ok"
    print(f"done: {len(todo) - failures}/{len(todo)} ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
