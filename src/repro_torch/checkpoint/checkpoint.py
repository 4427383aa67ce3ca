"""Fault-tolerant checkpointing: npz + JSON manifest (port of
``repro.checkpoint.checkpoint``, in its on-disk format).

- atomic: write to ``step_N.tmp/`` then rename: a crash mid-write never
  corrupts the latest checkpoint;
- async: a background writer thread overlaps serialization with training;
  ``save`` takes its device-to-host snapshot before it returns, because
  the next optimizer step writes the parameters and moments in place;
- elastic: the manifest stores the LOGICAL tree structure + global shapes,
  not device layouts: ``restore(..., shardings=)`` re-shards onto whatever
  mesh of ranks the new job has (scale up/down across restarts);
- self-pruning: keep the last ``keep`` checkpoints.

A checkpoint is ``shards.npz`` (arrays ``a0, a1, ...``, one per leaf in
sorted key order) and ``manifest.json`` (step, time, and per leaf its
file, shape and dtype). Leaf keys are the strings JAX's
``_flatten_with_paths`` makes: dict keys as ``['key']`` (sorted), named
tuple fields as ``.field``, sequence items as ``[i]``, joined by ``/``.
So a checkpoint of the same train state written by either package
restores in the other. bfloat16 is stored as its raw ``uint16`` bits with
dtype ``"bfloat16"`` (npz has no bfloat16) and read back through a
``torch.int16`` view.

Trees are nested dicts, named tuples, tuples and lists; leaves are
tensors (any device), numpy arrays, numbers, or ``Stacked`` (per-group
tensors that JAX's layout stacks along a leading axis). ``restore``
writes into the tensors of ``like`` in place, as ``load_state_dict``
does, and returns new CPU tensors for its other leaves.

On a mesh of ranks (``shardings``: a tree like the state's with an
``nn.module.NamedSharding`` at every leaf) each rank holds its block of
every leaf. ``save`` gathers the leaves' global tensors one at a time
(every rank takes part: a collective) and rank 0 alone snapshots, writes
and prunes, so the files equal a one-rank save of the same state byte
for byte. ``restore`` reads one leaf's global array at a time on each
rank and writes the rank's block into ``like``; the mesh may differ from
the writer's in shape and in size. Once a manager has seen a mesh of
several ranks, ``wait`` returns on every rank only after rank 0 has
published what it queued, and ``latest_step`` is rank 0's answer on
every rank. The ranks share one directory (as JAX's hosts do).
"""
from __future__ import annotations

import json
import math
import os
import queue
import shutil
import struct
import threading
import time
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..nn.module import block_of, gather_block_to_root


class Stacked:
    """One leaf of JAX's tree held as one tensor a group: stacked along a
    new leading axis on its way to the host, split back on restore."""

    __slots__ = ("tensors",)

    def __init__(self, tensors):
        self.tensors = tuple(tensors)


def _walk(tree, path, visit):
    if isinstance(tree, dict):
        return {k: _walk(tree[k], path + (f"[{k!r}]",), visit)
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(getattr(tree, f), path + (f".{f}",), visit)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(x, path + (f"[{i}]",), visit)
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return visit("/".join(path), tree)


def _flatten_with_paths(tree) -> dict:
    out = {}

    def visit(key, leaf):
        out[key] = leaf
        return leaf

    _walk(tree, (), visit)
    return out


def _host_bits(host: torch.Tensor) -> tuple[np.ndarray, str]:
    """A CPU tensor as (numpy array, logical dtype); bfloat16 as its
    uint16 bits."""
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = host.numpy()
    return arr, str(arr.dtype)


def snapshot_leaf(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf: (array, logical dtype); bfloat16 arrays
    hold the raw bits."""
    if isinstance(leaf, Stacked):
        first = leaf.tensors[0]
        host = torch.empty((len(leaf.tensors), *first.shape),
                           dtype=first.dtype)
        for g, t in enumerate(leaf.tensors):
            host[g].copy_(t.detach())
        return _host_bits(host)
    if isinstance(leaf, torch.Tensor):
        return _host_bits(leaf.detach().to("cpu", copy=True))
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":  # a JAX-made leaf (ml_dtypes)
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"stored dtype {arr.dtype} is labelled {dtype}")
    return torch.from_numpy(arr)


class _Shards:
    """The arrays of a ``shards.npz``, read one at a time. ``np.savez``
    (both packages' writer) stores its members uncompressed: a member is
    mapped from the file (copy on write) and checked against the CRC-32
    the zip holds for it, as ``zipfile`` checks it, so a rank that takes
    a block of a leaf copies only the block, and no fresh buffer is
    faulted in page by page (``np.load`` reads at about 0.6 GB/s into
    one)."""

    def __init__(self, path: str):
        self._file = open(path, "rb")
        self._zip = zipfile.ZipFile(self._file)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._zip.close()
        self._file.close()

    def __getitem__(self, name: str) -> np.ndarray:
        info = self._zip.getinfo(name + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{name}: the npz member is compressed; "
                             "np.savez stores its members")
        f = self._file
        f.seek(info.header_offset)
        local = f.read(30)  # the member's local header, then name, extra
        start = info.header_offset + 30 + sum(struct.unpack("<HH",
                                                            local[26:30]))
        f.seek(start)
        version = np.lib.format.read_magic(f)
        shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f)
                                 if version == (1, 0) else
                                 np.lib.format.read_array_header_2_0(f))
        head = f.tell() - start
        nbytes = math.prod(shape) * dtype.itemsize
        if head + nbytes != info.file_size:
            raise ValueError(f"{name}: the npz member holds "
                             f"{info.file_size - head} bytes of data, its "
                             f"header says {nbytes}")
        f.seek(start)
        crc = zlib.crc32(f.read(head))
        order = "F" if fortran else "C"
        if nbytes == 0:  # an mmap cannot be empty
            arr = np.empty(shape, dtype, order=order)
        else:
            arr = np.memmap(f, dtype=dtype, mode="c", offset=start + head,
                            shape=shape, order=order)
        words = memoryview(arr.reshape(-1, order="A")).cast("B")
        if zlib.crc32(words, crc) != info.CRC:
            raise ValueError(f"{name}: the npz member fails its CRC-32")
        return arr


def _restore_into(key: str, like, value: torch.Tensor):
    if isinstance(like, Stacked):
        members = like.tensors
        want = (len(members), *members[0].shape)
    elif isinstance(like, torch.Tensor):
        members, want = (like,), tuple(like.shape)
    else:
        return value.clone()  # not a view of the mapped file
    if tuple(value.shape) != want or any(
            m.dtype != value.dtype for m in members):
        raise ValueError(f"{key}: checkpoint holds {value.dtype} "
                         f"{tuple(value.shape)}, the tree {members[0].dtype} "
                         f"{tuple(want)}")
    with torch.no_grad():
        if isinstance(like, Stacked):
            for g, m in enumerate(members):
                m.copy_(value[g])
        else:
            like.copy_(value)
    return like


def _mesh_of(shardings: dict):
    """The one mesh of a flattened ``shardings`` tree."""
    meshes = {id(s.mesh): s.mesh for s in shardings.values()}
    if len(meshes) != 1:
        raise ValueError(f"shardings over {len(meshes)} meshes: a "
                         "checkpoint is saved or restored over one")
    return next(iter(meshes.values()))


def _same_keys(shardings: dict, leaves: dict) -> None:
    if set(shardings) != set(leaves):
        odd = sorted(set(shardings) ^ set(leaves))
        raise ValueError(f"the shardings and the tree differ at {odd[:5]}")


def _group_spec(key: str, spec: tuple) -> tuple:
    """A ``Stacked`` leaf's member spec: its spec less the group dim,
    which must not be sharded."""
    if spec and spec[0] is not None:
        raise ValueError(f"{key}: a Stacked leaf's spec starts with its "
                         f"group dim, unsharded; got {spec}")
    return tuple(spec[1:])


def _block(key: str, value: torch.Tensor, like, sharding) -> torch.Tensor:
    """This rank's block of the global ``value`` under ``sharding`` (a
    spec that does not divide raises)."""
    if isinstance(like, Stacked):
        _group_spec(key, sharding.spec)
    try:
        return block_of(value, sharding.spec, sharding.mesh)
    except ValueError as e:
        raise ValueError(f"{key}: {e}") from None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._async = async_write
        self._ranks = False  # one of a mesh's ranks (``_joined``)
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False,
             shardings: Any = None):
        """Snapshot (device->host copy) is taken NOW; writing may be async.

        With ``shardings`` each leaf of ``tree`` is this rank's block
        (module docstring): the gathers run here on every rank, rank 0
        writes. ``blocking`` on a mesh returns once rank 0 has
        published the step."""
        if self._err:
            raise RuntimeError("async checkpoint writer died") from self._err
        if shardings is None:
            leaves = {k: snapshot_leaf(v)
                      for k, v in _flatten_with_paths(tree).items()}
        else:
            leaves = self._gathered(tree, shardings)
        if leaves is not None:
            if self._async and not blocking:
                self._q.put((step, leaves))
            else:
                self._write(step, leaves)
        if blocking and self._ranks:
            self._sync()

    def _joined(self, shardings: dict):
        """The mesh of ``shardings``; a mesh of several ranks makes this
        manager one of its ranks' (``wait`` and ``latest_step`` agree
        across them from now on)."""
        mesh = _mesh_of(shardings)
        self._ranks = self._ranks or mesh.size > 1
        return mesh

    def _gathered(self, tree: Any, shardings: Any) -> Optional[dict]:
        """``{key: (array, dtype)}`` of every leaf's global tensor on rank
        0, None on the others. Leaves go in sorted key order, one at a
        time, on the mesh's wire device (host memory for gloo), each
        block once from its first holder to rank 0, so rank 0 holds one
        global leaf beside its state and the others none."""
        sh = _flatten_with_paths(shardings)
        leaves = _flatten_with_paths(tree)
        _same_keys(sh, leaves)
        mesh = self._joined(sh)
        root = mesh.rank == 0
        out = {}
        for key in sorted(leaves):
            leaf, spec = leaves[key], sh[key].spec
            if isinstance(leaf, Stacked):
                member = _group_spec(key, spec)
                host = None
                for g, t in enumerate(leaf.tensors):
                    full = gather_block_to_root(
                        t.detach().to(mesh.wire_device), member, mesh)
                    if root:
                        if host is None:
                            host = torch.empty((len(leaf.tensors),
                                                *full.shape),
                                               dtype=full.dtype)
                        host[g].copy_(full)
                    del full
                if root:
                    out[key] = _host_bits(host)
            elif isinstance(leaf, torch.Tensor):
                full = gather_block_to_root(
                    leaf.detach().to(mesh.wire_device), spec, mesh)
                if root:  # a new tensor: no second copy
                    out[key] = _host_bits(full.cpu())
                del full
            elif root:
                out[key] = snapshot_leaf(leaf)
        return out if root else None

    def _sync(self):
        """Every rank waits for rank 0 (whose queue has drained) and
        raises if its writer died."""
        ok = [self._err is None]
        dist.broadcast_object_list(ok, src=0)
        if not ok[0]:
            raise RuntimeError("rank 0's checkpoint writer died")

    def wait(self):
        if self._async:
            self._q.join()
        if self._ranks:
            self._sync()
        if self._err:
            raise RuntimeError("async checkpoint writer died") from self._err

    def _worker(self):
        while True:
            step, leaves = self._q.get()
            try:
                self._write(step, leaves)
            except BaseException as e:  # surfaced on next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, leaves: dict):
        tmp = os.path.join(self.directory, f"step_{step}.tmp")
        final = os.path.join(self.directory, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        arrays = {}
        for i, (key, (arr, dtype)) in enumerate(sorted(leaves.items())):
            name = f"a{i}"
            arrays[name] = arr
            manifest["leaves"][key] = {
                "file": name,
                "shape": list(arr.shape),
                "dtype": dtype,
            }
        np.savez(os.path.join(tmp, "shards.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s}"), ignore_errors=True
            )

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        latest = steps[-1] if steps else None
        if self._ranks:  # rank 0's answer on every rank
            box = [latest]
            dist.broadcast_object_list(box, src=0)
            latest = box[0]
        return latest

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> tuple[Any, int]:
        """Restore into the structure of ``like``: its tensor and
        ``Stacked`` leaves are written in place (a leaf of another shape or
        dtype raises), its other leaves come back as new CPU tensors.

        With ``shardings`` (a tree of ``NamedSharding`` like ``like``)
        this is the elastic path: each leaf of ``like`` is this rank's
        block and receives ``block_of`` the stored global array under its
        sharding, read one leaf at a time. The stored checkpoint is
        mesh-agnostic, so the mesh can differ from the writer's."""
        sh = None
        if shardings is not None:
            sh = _flatten_with_paths(shardings)
            _same_keys(sh, _flatten_with_paths(like))
            self._joined(sh)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with _Shards(os.path.join(d, "shards.npz")) as data:

            def visit(key, leaf):
                meta = manifest["leaves"][key]
                value = _tensor(data[meta["file"]], meta["dtype"])
                if sh is not None:
                    value = _block(key, value, leaf, sh[key])
                return _restore_into(key, leaf, value)

            return _walk(like, (), visit), step
