"""Roofline terms of a cell on the H100 (port of
``repro.launch.hlo_analysis``).

JAX reads per-device FLOPs and bytes from a compiled XLA artifact and
parses the optimized HLO for its collectives. The port compiles nothing,
so it has no HLO: the collectives come from the records ``Wire`` keeps
on a ``Mesh`` (``launch.mesh.WireStats.by_kind``: kind, result bytes,
group size), and a cell's FLOPs and bytes from an analytic count
(``launch.dryrun.paper_cost``). Each kind is weighted by JAX's ring wire
factor, unchanged:

    all-reduce          2·(K−1)/K · bytes     (reduce-scatter + all-gather)
    all-gather          (K−1)/K · out_bytes   (out is the gathered shape)
    reduce-scatter      (K−1)   · out_bytes   (in = K · out)
    all-to-all          (K−1)/K · bytes
    collective-permute  1 · bytes

Hardware model: one NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU
datasheet): 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, and 450 GB/s a
direction of NVLink (900 GB/s bidirectional).

As in JAX, a dynamic-trip-count loop (the IFE frontier loop) is counted
once a trip, and its terms carry an ``iters_scale`` multiplier.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # bf16 dense per card
HBM_BW = 3.35e12  # bytes/s per card (HBM3)
NVLINK_BW = 450e9  # bytes/s per card, one direction

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    counts: dict  # kind -> op count
    out_bytes: dict  # kind -> sum of result bytes
    wire_bytes: dict  # kind -> ring-weighted bytes on the wire per device

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def wire_factor(kind: str, k: int) -> float:
    """JAX's ring factor of one op of ``kind`` over a group of ``k``."""
    if kind == "all-reduce":
        return 2.0 * (k - 1) / k
    if kind in ("all-gather", "all-to-all"):
        return (k - 1) / k
    if kind == "reduce-scatter":
        return float(k - 1)
    if kind == "collective-permute":
        return 1.0
    raise ValueError(f"unknown collective kind: {kind}")


def collective_stats(records) -> CollectiveStats:
    """``records``: ``{kind: {group size: [calls, result bytes]}}``, as
    ``Mesh.wire.by_kind`` keeps them (or a ``WireStats``)."""
    records = getattr(records, "by_kind", records)
    counts = {k: 0 for k in COLLECTIVES}
    out_bytes = {k: 0.0 for k in COLLECTIVES}
    wire = {k: 0.0 for k in COLLECTIVES}
    for kind, groups in records.items():
        for k, (calls, b) in groups.items():
            counts[kind] += int(calls)
            out_bytes[kind] += float(b)
            wire[kind] += wire_factor(kind, int(k)) * float(b)
    return CollectiveStats(counts=counts, out_bytes=out_bytes, wire_bytes=wire)


@dataclasses.dataclass
class Roofline:
    flops: float  # per-device flops
    hbm_bytes: float  # per-device bytes accessed
    wire_bytes: float  # per-device ring-weighted collective bytes
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_device: float
    iters_scale: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much counted compute is useful."""
        return self.model_flops_per_device / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at
        the dominant term's rate: (useful flop time) / (bound time)."""
        ideal = self.model_flops_per_device / PEAK_FLOPS
        return ideal / max(self.bound_s, 1e-30)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "wire_bytes_per_device": self.wire_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
            "iters_scale": self.iters_scale,
        }


def roofline_terms(
    cost: dict,
    coll: CollectiveStats,
    n_devices: int,
    model_flops_total: float,
    iters_scale: float = 1.0,
) -> Roofline:
    flops = float(cost.get("flops", 0.0)) * iters_scale
    hbm = float(cost.get("bytes accessed", 0.0)) * iters_scale
    wire = coll.total_wire_bytes * iters_scale
    return Roofline(
        flops=flops,
        hbm_bytes=hbm,
        wire_bytes=wire,
        compute_s=flops / PEAK_FLOPS,
        memory_s=hbm / HBM_BW,
        collective_s=wire / NVLINK_BW,
        model_flops_per_device=model_flops_total / n_devices,
        iters_scale=iters_scale,
    )
