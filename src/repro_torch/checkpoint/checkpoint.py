"""Fault-tolerant checkpointing: npz + JSON manifest (port of
``repro.checkpoint.checkpoint``, in its on-disk format).

- atomic: write to ``step_N.tmp/`` then rename: a crash mid-write never
  corrupts the latest checkpoint;
- async: a background writer thread overlaps serialization with training;
  ``save`` takes its device-to-host snapshot before it returns, because
  the next optimizer step writes the parameters and moments in place;
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
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


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


def _restore_into(key: str, like, value: torch.Tensor):
    if isinstance(like, Stacked):
        members = like.tensors
        want = (len(members), *members[0].shape)
    elif isinstance(like, torch.Tensor):
        members, want = (like,), tuple(like.shape)
    else:
        return value
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


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._async = async_write
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False):
        """Snapshot (device->host copy) is taken NOW; writing may be async."""
        if self._err:
            raise RuntimeError("async checkpoint writer died") from self._err
        leaves = {k: snapshot_leaf(v)
                  for k, v in _flatten_with_paths(tree).items()}
        if self._async and not blocking:
            self._q.put((step, leaves))
        else:
            self._write(step, leaves)

    def wait(self):
        if self._async:
            self._q.join()
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
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None
                ) -> tuple[Any, int]:
        """Restore into the structure of ``like``: its tensor and
        ``Stacked`` leaves are written in place (a leaf of another shape or
        dtype raises), its other leaves come back as new CPU tensors."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "shards.npz")) as data:

            def visit(key, leaf):
                meta = manifest["leaves"][key]
                return _restore_into(key, leaf,
                                     _tensor(data[meta["file"]],
                                             meta["dtype"]))

            return _walk(like, (), visit), step
