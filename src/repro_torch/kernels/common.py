"""Device resolution and tensor-tree helpers shared by the port.

The JAX package resolves ``interpret=None`` per kernel call; the port's
rule is simpler and per tensor: a kernel wrapper runs its plain PyTorch
version for a CPU tensor and launches its CUDA kernel for a CUDA tensor.
Entry points pick the device once, here: ``cuda`` unless the caller asks
for the CPU, and never a silent fall back to the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (explicitly
    or by default) and this process has no usable GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this process; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


def init_device(device) -> torch.device:
    """``resolve_device``, and ``meta`` for shapes without storage (a
    model's init builds any size there)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def map_tensors(fn, obj):
    """Apply ``fn`` to every tensor in a tree of dataclasses, tuples,
    lists, dicts and NamedTuples; other leaves pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # fields with init=False are derived: __post_init__ rebuilds them
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(fn, x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, x) for x in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    return obj


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy leaf carried across from the JAX package as a tensor on
    ``device``; a bfloat16 leaf (``ml_dtypes``) by its bits. On the CPU
    the tensor shares memory with a writable contiguous ``a``
    (``torch.from_numpy``): callers that write it, or whose source is
    written later, copy."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of a JAX array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def to_device(obj, device):
    """Copy every tensor of a tree onto ``device``."""
    dev = torch.device(device)
    return map_tensors(lambda t: t.to(dev), obj)


def derived(obj, key: str, build):
    """What ``build()`` derives from ``obj``'s tensors, built on first use
    and kept on ``obj`` (outside its dataclass fields, so a copy made by
    ``map_tensors``/``to_device`` builds its own). Code that writes
    ``obj``'s tensors in place calls ``drop_derived``."""
    key = "_derived_" + key
    val = obj.__dict__.get(key)
    if val is None:
        val = obj.__dict__[key] = build()
    return val


def drop_derived(obj) -> None:
    """Forget everything ``derived`` kept on ``obj``."""
    for key in [k for k in obj.__dict__ if k.startswith("_derived_")]:
        del obj.__dict__[key]


def synchronize(device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
