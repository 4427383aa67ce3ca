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
A cell that fails records its error and the run carries on, as JAX's
does; the exit code counts the failures. Only the paper family builds
(``steps.build_cell``); the LM, GNN and recsys cells record
``NotImplementedError`` until the logical-axis rules are ported, and
``--components`` (JAX's per-component LM roofline) raises.

Usage:
    python -m repro_torch.launch.dryrun --list
    python -m repro_torch.launch.dryrun --arch paper-bfs-engine --shape ldbc100 --mesh card
    python -m repro_torch.launch.dryrun --all --mesh both [--subprocess]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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


def _card_fields(arch, shape, device, overrides, cut, keep) -> dict:
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
    bound = steps.bind_cell(cell, mesh)
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
             cut: dict | None = None, keep: dict | None = None) -> dict:
    """One cell's record (written to ``out_dir``; a cached record is
    returned unless ``force``). ``mesh_tag`` is ``single``, ``multi``
    (analytic) or ``card`` (run on ``device``, ``cuda`` unless the caller
    passes ``"cpu"``; ``cut`` changes the shape's dims; ``keep``, if
    given, receives the cell, the bound inputs and the result)."""
    from .hlo_analysis import roofline_terms

    name = f"{arch}__{shape}__{mesh_tag}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, name + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        print(f"[skip] {name}: cached ({rec.get('status')})")
        return rec
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_tag,
        "status": "error", "tag": tag,
    }
    if cut:
        rec["reduced"] = dict(cut)
    try:
        if mesh_tag not in MESHES:
            raise ValueError(f"unknown mesh {mesh_tag!r}: one of {MESHES}")
        f = (_card_fields(arch, shape, device, overrides, cut, keep)
             if mesh_tag == "card"
             else _layout_fields(arch, shape, mesh_tag, overrides))
        cell, coll, mem = f.pop("cell"), f.pop("coll"), f.pop("memory")
        cost, n_dev, measured = f.pop("cost"), f.pop("n_devices"), \
            f.pop("measured")
        rl = roofline_terms(cost, coll, n_dev, cell.model_flops,
                            cell.iters_scale)
        rec.update(
            status="ok",
            kind=cell.kind,
            notes=cell.notes,
            decisions=cell.decisions,
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
            + (f"  wall {rec['wall_ms']:.2f} ms iters {max(rec['iterations'])}"
               f" {rec['gteps']:.3f} GTEPS" if mesh_tag == "card" else "")
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
    if args.components:
        raise NotImplementedError(
            "--components sums the LM cells' per-component terms; the LM "
            "mesh cells wait for the logical-axis rules (ROADMAP section 1)"
        )

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
