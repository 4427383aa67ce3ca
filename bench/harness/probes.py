"""Launch probes: wrappers that the benchmark puts around the program's
kernel launchers in a traced run, to count the bytes each launch needs
(``kernel_bytes``).

A probe reads a launch's arguments, counts on the card what the launch
needs (for ``msbfs_extend``, the tiles under an active stripe) and then
calls the launcher unchanged. The count runs on a CUDA
stream of the benchmark's own, after an event of the launching stream,
so that the trace can tell its kernels from the program's (``tracing``
leaves that stream out) and the program's stream never waits for it.
The counts stay on the card until the window has closed.
"""
from __future__ import annotations

import torch

from . import kernel_bytes


def active_tiles(lanes: torch.Tensor, block_rows: torch.Tensor,
                 block_cols: torch.Tensor, g_out: int) -> torch.Tensor:
    """Tiles whose source stripe of ``lanes [g_in, B, L]`` holds a set
    lane and whose destination block is inside ``[0, g_out)`` (0-dim)."""
    g_in = lanes.shape[0]
    stripe = lanes.reshape(g_in, -1).amax(dim=1) != 0
    rows = block_rows.long()
    ok = (rows >= 0) & (rows < g_in) & (block_cols >= 0) & (
        block_cols < g_out)
    return (stripe[rows.clamp(0, max(g_in - 1, 0))] & ok).sum()


class LaunchProbes:
    """Installs the probes; ``active`` is read at each launch, and only
    launches made while it returns True are counted."""

    def __init__(self, device: torch.device, active):
        self.device = device
        self.active = active
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        # kernel -> [(bytes, or a 0-dim tensor of its part that depends
        # on the data, and the fixed part)]
        self.launches: dict[str, list] = {}
        self._undo: list = []

    def _count(self, fn, *tensors):
        """Run ``fn`` (which returns a 0-dim count) on the probe stream
        after the current stream's work so far."""
        if self.stream is None:
            value = fn()
        else:
            ready = torch.cuda.current_stream(self.device).record_event()
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(ready)
                for t in tensors:
                    if t is not None:
                        t.record_stream(self.stream)
                value = fn()
        return value

    def install_msbfs_extend(self) -> None:
        from repro_torch.kernels.msbfs_extend import ops

        launch = ops.msbfs_extend_blocks
        probes = self

        def probed(blocks, block_rows, block_cols, lanes, g_out=None):
            if probes.active():
                g_in, bsz, n_lanes = lanes.shape
                g = g_in if g_out is None else int(g_out)
                n_act = probes._count(
                    lambda: active_tiles(lanes, block_rows, block_cols, g),
                    lanes, block_rows, block_cols)
                fixed = kernel_bytes.extend_bytes(0, bsz, g_in, n_lanes)
                per_tile = kernel_bytes.extend_bytes(1, bsz, 0, n_lanes)
                probes.launches.setdefault("msbfs_extend", []).append(
                    (n_act, per_tile, fixed))
            return launch(blocks, block_rows, block_cols, lanes, g_out)

        ops.msbfs_extend_blocks = probed
        self._undo.append((ops, "msbfs_extend_blocks", launch))

    def uninstall(self) -> None:
        while self._undo:
            mod, name, fn = self._undo.pop()
            setattr(mod, name, fn)

    def totals(self) -> dict[str, tuple[int, int]]:
        """Per kernel: (launches counted, bytes they need). Reads the
        counts back from the card: call once the window has closed."""
        if self.stream is not None:
            self.stream.synchronize()
        out = {}
        for name, recs in self.launches.items():
            counts = torch.stack([n for n, _, _ in recs]).cpu().tolist()
            total = sum(int(n) * per + fixed
                        for n, (_, per, fixed) in zip(counts, recs))
            out[name] = (len(recs), total)
        return out


def attach(run) -> LaunchProbes:
    """The run's probes, made at the first reader that asks; they count
    only while the run is tracing."""
    if run.probes is None:
        run.install_probes(LaunchProbes(run.device, lambda: run.tracing))
    return run.probes


def roofline(run, kernel: str, device_name: str) -> float | None:
    """Roofline share of ``kernel`` in the traced window (None where it did
    not run there)."""
    from .tracing import kernel_seconds

    ts = run.trace_summary
    totals = getattr(run, "launch_totals", {}) or {}
    if ts is None or kernel not in totals:
        return None
    _, device_s = kernel_seconds(ts, device_name)
    return kernel_bytes.roofline_share(totals[kernel][1], device_s)
