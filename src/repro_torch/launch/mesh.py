"""Mesh of ranks (port of ``repro.launch.mesh``).

The JAX package runs a policy as one ``shard_map`` program over a
``Mesh`` of devices. The port runs it as one process per rank: a
``Mesh`` here names the axes and their sizes, holds this rank's
coordinates, one ``torch.distributed`` process group per axis line the
rank sits on, and the ``torch.device`` the rank computes on. Ranks are
laid out row-major over the axes, as JAX lays devices out.

A one-rank mesh needs no process group: every axis has size 1, every
collective is the identity, and a bare ``device`` argument anywhere in
the port means exactly that mesh.

The backend is explicit and never chosen by catching an error: NCCL for
one rank a card, gloo for ``--device cpu`` and for ranks that share one
card (``core.collectives`` then stages every message through host
memory and counts the bytes).

``run_ranks`` spawns a group of ranks on this host (tests, the smoke
script), each under a hang timeout that dumps its traceback and exits.

``make_production_mesh`` gives JAX's production meshes (16 x 16 ranks,
or 2 x 16 x 16 across two pods) as a ``MeshLayout``: axis names and
sizes only. One process cannot hold 256 or 512 ranks, so a layout has no
ranks, groups or device; the cell builder and the dry-run read shard
counts from it, and running a cell needs a real ``Mesh``.
"""
from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import math
import os
import sys
import time
import traceback
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.common import resolve_device

#: seconds a collective may wait before its process group gives up
DEFAULT_TIMEOUT_S = 300


@dataclasses.dataclass
class WireStats:
    """What the collectives moved on one rank: calls, payload bytes,
    bytes staged through host memory (gloo with CUDA tensors, both ways)
    and host wall milliseconds spent inside them. ``by_kind`` keeps the
    same calls by collective kind (JAX's HLO names: ``all-reduce``,
    ``all-gather``, ``collective-permute``, ...) and group size:
    ``{kind: {group: [calls, result bytes]}}`` (JSON-ready, like the
    rest), what ``launch.hlo_analysis.collective_stats`` reads;
    ``by_axis`` the same calls by mesh axis and kind: ``{axis: {kind:
    [calls, result bytes]}}``; ``staged_by_kind`` the staged bytes by
    kind, ``ms_by_kind`` the host milliseconds by kind."""

    calls: int = 0
    bytes: int = 0
    staged_bytes: int = 0
    ms: float = 0.0
    by_kind: dict = dataclasses.field(default_factory=dict)
    by_axis: dict = dataclasses.field(default_factory=dict)
    staged_by_kind: dict = dataclasses.field(default_factory=dict)
    ms_by_kind: dict = dataclasses.field(default_factory=dict)

    def record(self, kind: str, out_bytes: int, group: int,
               axis: str | None = None) -> None:
        rec = self.by_kind.setdefault(kind, {}).setdefault(int(group),
                                                           [0, 0])
        rec[0] += 1
        rec[1] += int(out_bytes)
        if axis is not None:
            rec = self.by_axis.setdefault(axis, {}).setdefault(kind, [0, 0])
            rec[0] += 1
            rec[1] += int(out_bytes)

    def reset(self) -> None:
        self.calls = self.bytes = self.staged_bytes = 0
        self.ms = 0.0
        self.by_kind = {}
        self.by_axis = {}
        self.staged_by_kind = {}
        self.ms_by_kind = {}


class Mesh:
    """Axis names and sizes, this rank's coordinates, its per-axis
    process groups and its device."""

    def __init__(self, axis_shapes: Sequence[int], axis_names: Sequence[str],
                 device, rank: int = 0, backend: str | None = None):
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_shapes)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        self.size = int(math.prod(self.axis_sizes))
        self.rank = int(rank)
        self.device = torch.device(device)
        self.backend = backend
        self.wire = WireStats()
        self._coords = tuple(int(c) for c in np.unravel_index(
            self.rank, self.axis_sizes)) if self.axis_sizes else ()
        self._groups: dict[str, object] = {}
        if self.size > 1:
            self._make_groups()

    @property
    def shape(self) -> dict:
        """``{axis: size}``, like ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def coord(self, axis: str) -> int:
        return self._coords[self.axis_names.index(axis)]

    def rank_at(self, **coords) -> int:
        """Global rank of this rank's coordinates with ``coords`` replaced."""
        c = list(self._coords)
        for a, v in coords.items():
            c[self.axis_names.index(a)] = int(v)
        return int(np.ravel_multi_index(c, self.axis_sizes))

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self._groups[axis]

    def axes(self, names) -> "Axes":
        if isinstance(names, str):
            names = (names,)
        return Axes(self, tuple(names))

    @property
    def wire_device(self) -> torch.device:
        """Where small control tensors (loop flags, stats) live for the
        backend: the card for NCCL, host memory for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def _make_groups(self) -> None:
        if dist.get_world_size() != self.size:
            raise ValueError(
                f"mesh of {self.size} ranks in a world of "
                f"{dist.get_world_size()}"
            )
        ids = np.arange(self.size).reshape(self.axis_sizes)
        # every rank creates every group, in one order
        for i, a in enumerate(self.axis_names):
            if self.axis_sizes[i] == 1:
                continue
            lines = np.moveaxis(ids, i, -1).reshape(-1, self.axis_sizes[i])
            for line in lines:
                g = dist.new_group([int(r) for r in line],
                                   backend=self.backend)
                if self.rank in line:
                    self._groups[a] = g

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device},"
                f" backend={self.backend})")


@dataclasses.dataclass(frozen=True)
class Axes:
    """A tuple of mesh axis names bound to their mesh: what the
    collectives reduce over (JAX binds names through ``shard_map``)."""

    mesh: Mesh
    names: tuple

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)

    def __bool__(self) -> bool:
        return bool(self.names)

    def __add__(self, other: "Axes") -> "Axes":
        return Axes(self.mesh, self.names + tuple(other))

    @property
    def size(self) -> int:
        # an axis a one-rank mesh does not name has size 1 there
        shape = self.mesh.shape
        return int(math.prod(shape.get(a, 1) for a in self.names))

    def index(self) -> int:
        """This rank's flat coordinate over the axes (major to minor)."""
        idx = 0
        for a in self.names:
            if self.mesh.shape.get(a, 1) > 1:
                idx = idx * self.mesh.shape[a] + self.mesh.coord(a)
        return idx


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes, with ``shape`` and ``size`` as on
    ``Mesh``, and no ranks, groups or device."""

    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(math.prod(self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """JAX's production mesh as a layout: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def batch_axes(multi_pod: bool = False):
    return ("pod", "data") if multi_pod else ("data",)


def all_axes(multi_pod: bool = False):
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """This rank's ``Mesh``. A one-rank mesh needs no process group; a
    larger one needs ``torch.distributed`` initialised with one rank per
    mesh position. ``device`` defaults to ``cuda`` (the rank's card under
    ``init_distributed``)."""
    size = int(math.prod(axis_shapes))
    if size == 1:
        return Mesh(axis_shapes, axis_names, resolve_device(device))
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {size}-rank mesh needs torch.distributed: call "
            "init_distributed (or run under run_ranks / torchrun)"
        )
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return Mesh(axis_shapes, axis_names, resolve_device(device),
                rank=dist.get_rank(), backend=dist.get_backend())


def as_mesh(mesh_or_device) -> Mesh:
    """A ``Mesh`` as it is, anything else as the one-rank mesh on that
    device (``None`` = cuda)."""
    if isinstance(mesh_or_device, Mesh):
        return mesh_or_device
    return make_mesh((1, 1), ("data", "model"), mesh_or_device)


def init_distributed(backend: str, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Initialise the default process group from torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (or the arguments) and return the
    rank's device: ``cuda:LOCAL_RANK`` for NCCL, the CPU for gloo unless
    the caller places gloo ranks on a card itself."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world = (int(os.environ["WORLD_SIZE"]) if world_size is None
             else int(world_size))
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device("cpu")
    if backend == "nccl":
        device = resolve_device(f"cuda:{local}")
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return device


def _rank_main(rank, world, store, backend, timeout_s, threads, env, fn,
               args, queue):
    os.environ.update(env)  # the caller's, as a spawned process has it
    faulthandler.dump_traceback_later(timeout_s, exit=True)
    torch.set_num_threads(threads)
    try:
        init_distributed(backend, f"file://{store}", rank, world,
                         timeout_s=timeout_s)
        out = fn(rank, world, *args)
        queue.put((rank, "ok", out))
    except Exception:  # report, then exit non-zero
        queue.put((rank, "error", traceback.format_exc()))
        queue.close()
        queue.join_thread()
        sys.stderr.flush()
        os._exit(1)
    finally:
        faulthandler.cancel_dump_traceback_later()
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), backend: str = "gloo",
              timeout_s: float = 120.0, threads: int = 1) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes on this
    host (one rank each, process group initialised, ``fn`` importable by
    name, ``threads`` intra-op threads a rank, the caller's environment)
    and return their results by rank. The ranks fork from a server
    process that imported torch once (``forkserver``: a group starts in
    a fraction of a second after the first, where a spawned rank imports
    torch anew, 7-9 s on the chip machine), and meet through a file
    store in a directory of their own (no port to race for). A rank that
    raises, dies or hangs past ``timeout_s`` (it dumps its traceback and
    exits) fails the whole group: the others are stopped and this
    raises."""
    import multiprocessing as mp
    import shutil
    import tempfile

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    queue = ctx.Queue()
    where = tempfile.mkdtemp(prefix="ranks-")
    procs = [
        ctx.Process(target=_rank_main,
                    args=(r, world, os.path.join(where, "store"), backend,
                          timeout_s, threads, dict(os.environ), fn, args,
                          queue))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout_s + 30
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"ranks {sorted(set(range(world)) - set(results))}"
                              f" gave no result in {timeout_s:.0f} s")
                break
            try:
                rank, status, out = queue.get(timeout=min(left, 1.0))
            except Exception:  # queue.Empty: check for dead ranks
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    time.sleep(0.5)  # let a dying rank's report land
                    while not queue.empty():
                        rank, status, out = queue.get()
                        (results.__setitem__(rank, out) if status == "ok"
                         else errors.append(f"rank {rank}:\n{out}"))
                    errors.append(f"ranks {dead} exited with "
                                  f"{[procs[r].exitcode for r in dead]}")
                    break
                continue
            if status == "ok":
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
        shutil.rmtree(where, ignore_errors=True)
    if errors:
        raise RuntimeError("rank group failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world)]
